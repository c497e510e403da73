"""Trajectory-data access helpers.

Port of `wiw_tpu/data/dataset_utils.py` (a copy: it holds no JAX, but the
port imports nothing of `wiw_tpu`). PIL is imported inside
`get_pixel_values`, as in the reference.

Data layout (FTsvd/README.md "Expected pattern", HabitatRender.py:443-453):
  <root>/<scene>/traj-<i>/waypoint-<j>/step-<k>_type-rgb.png
  <root>/<scene>/traj-<i>/waypoint-<j>/metadata.json
    {"steps": {"waypoint-<j>": {"step-<k>": {"action": <name-or-id>,
     "coord": ..., "habitat_camera_coord": ...}}}}  (per-waypoint copy)

Action augmentation conversions are re-derived from the pano semantics:
  * reverse (time-flip + 180-deg pano rotation, dataset.py:249-266): the
    reversed transition t -> t-1 is the inverse action of a[T-t]; inverse
    of forward is forward (after the 180 rotation), inverse of turn_left is
    turn_right and vice versa; the stop/placeholder frame-0 slot persists.
  * horizontal flip: mirrors yaw, so turn_left <-> turn_right.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import re
from typing import List, Optional, Sequence

import numpy as np

from wiw_tpu_torch.core.actions import (
    ACTION_FORWARD,
    ACTION_STOP,
    ACTION_TURN_LEFT,
    ACTION_TURN_RIGHT,
)

ACTION_NAME_TO_ID = {
    "move_forward": ACTION_FORWARD,
    "forward": ACTION_FORWARD,
    "turn_left": ACTION_TURN_LEFT,
    "turn_right": ACTION_TURN_RIGHT,
    "stop": ACTION_STOP,
}

_STEP_RE = re.compile(r"step-(\d+)_type-rgb\.png$")


def glob_all_imgleaf_folders(base_folder: str) -> List[str]:
    """All waypoint metadata.json paths under a dataset root."""
    pattern = osp.join(str(base_folder), "*", "traj-*", "waypoint-*", "metadata.json")
    return sorted(glob.glob(pattern))


def check_metadata(folders: Sequence[str]) -> List[str]:
    """Keep only folders that contain a metadata.json."""
    return [f for f in folders if osp.exists(osp.join(f, "metadata.json"))]


def get_sorted_frame_paths(folder_path: str, min_frames: Optional[int] = None
                           ) -> List[str]:
    """Frame filenames sorted by step index (not lexically)."""
    names = [
        osp.basename(p)
        for p in glob.glob(osp.join(folder_path, "*_type-rgb.png"))
    ]
    withidx = []
    for n in names:
        m = _STEP_RE.search(n)
        if m:
            withidx.append((int(m.group(1)), n))
    withidx.sort()
    frames = [n for _, n in withidx]
    if min_frames is not None and len(frames) < min_frames:
        raise ValueError(
            f"{folder_path} has {len(frames)} frames < required {min_frames}"
        )
    return frames


def gen_frame_idxs(folder_path: str, num_frames: int, rng=None):
    """Pick a random window start; returns (sorted frame names, start_idx)."""
    import random as _random

    frames = get_sorted_frame_paths(folder_path)
    max_start = len(frames) - num_frames
    if max_start < 0:
        raise ValueError(f"{folder_path}: {len(frames)} < {num_frames} frames")
    r = rng if rng is not None else _random
    start = r.randint(0, max_start) if max_start > 0 else 0
    return frames, start


def load_metadata(folder_path: str) -> dict:
    with open(osp.join(folder_path, "metadata.json")) as f:
        return json.load(f)


def _action_to_id(action) -> int:
    if isinstance(action, (int, np.integer)):
        return int(action)
    return ACTION_NAME_TO_ID.get(str(action), ACTION_STOP)


def get_actions(scene_id: str, traj_id: str, waypoint_id: str,
                folder_path: str, frame_idxs: Sequence[int]) -> List[int]:
    """Per-frame action ids for the selected window.

    Reads the waypoint metadata.json; accepts both the per-waypoint layout
    {"steps": {"waypoint-j": {"step-k": {...}}}} and a flat
    {"step-k": {...}} fallback.
    """
    meta = load_metadata(folder_path)
    steps = meta.get("steps", meta)
    if isinstance(steps, dict) and f"waypoint-{waypoint_id}" in steps:
        steps = steps[f"waypoint-{waypoint_id}"]
    actions = []
    for k in frame_idxs:
        entry = steps.get(f"step-{k}", {})
        actions.append(_action_to_id(entry.get("action", "stop")))
    return actions


def get_pixel_values(folder_path: str, frame_names: Sequence[str],
                     channels: int = 3, width: int = 1024, height: int = 576
                     ) -> np.ndarray:
    """Load + resize frames -> float32 [F, H, W, C] in [-1, 1]
    (channels-last; the reference returns torch NCHW)."""
    from PIL import Image

    out = np.empty((len(frame_names), height, width, channels), np.float32)
    for i, name in enumerate(frame_names):
        img = Image.open(osp.join(folder_path, name)).convert("RGB")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32) / 127.5 - 1.0
    return out


def revert_pixel_values(pixel_values: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 [0,255]."""
    return np.clip((pixel_values + 1.0) * 127.5, 0, 255).astype(np.uint8)


def action_reverse_convert(actions: Sequence[int]) -> List[int]:
    """Action ids for the time-reversed (and 180-rotated) clip."""
    inv = {ACTION_FORWARD: ACTION_FORWARD,
           ACTION_TURN_LEFT: ACTION_TURN_RIGHT,
           ACTION_TURN_RIGHT: ACTION_TURN_LEFT,
           ACTION_STOP: ACTION_STOP, 0: 0}
    a = list(actions)
    # transition into reversed frame t is the inverse of the original
    # transition out of frame T-t; slot 0 keeps the stop/placeholder
    rev = [a[0]] + [inv[int(x)] for x in a[1:][::-1]]
    return rev


def action_flip_convert(actions: Sequence[int]) -> List[int]:
    """Action ids after horizontal mirroring: left <-> right."""
    flip = {ACTION_FORWARD: ACTION_FORWARD,
            ACTION_TURN_LEFT: ACTION_TURN_RIGHT,
            ACTION_TURN_RIGHT: ACTION_TURN_LEFT,
            ACTION_STOP: ACTION_STOP, 0: 0}
    return [flip[int(x)] for x in actions]
