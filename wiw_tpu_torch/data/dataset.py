"""Training datasets over collected Habitat trajectories.

Port of `wiw_tpu/data/dataset.py` (a copy: it holds no JAX, but the port
imports nothing of `wiw_tpu`). As in the reference:
  * TrajectoryDataset (ref: DummyDataset): folders weighted by frame count;
    random window of `sample_frames`; actions from metadata.json; optional
    reverse (time-flip + 180 pano roll) and horizontal-flip augmentation
    with action remapping
  * WeightedDataset: (traj, start_step) entries weighted by mean point-cloud
    void ratio from overlap_Nframe-<F>_1.json with linear / exponential /
    cutoff / uniform schemes (data_filtering/filter_util.py:282-408)
  * StraightDataset (ref: DummyDataset_Straight): keeps only all-forward
    windows

Emits channels-last numpy batches for the trainer
(wiw_tpu_torch/train/trainer.py); `iterate_batches` stacks them in order,
`data/loader.PrefetchLoader` in the background.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wiw_tpu_torch.core.actions import ACTION_FORWARD
from wiw_tpu_torch.data import dataset_utils as du


def glob_all_overlap_json(base_folder: str, n_frame: int) -> List[str]:
    pattern = osp.join(
        str(base_folder), "*", "traj-*", "waypoint-*",
        f"overlap_Nframe-{n_frame}_1.json",
    )
    files = sorted(glob.glob(pattern))
    if not files:
        raise ValueError(f"no overlap_Nframe-{n_frame}_1.json under {base_folder}")
    return files


def get_all_trajs_voidratios(json_files: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """{traj_folder: {"StartStep-k": mean_void_ratio}}
    (filter_util.py:282-316)."""
    out: Dict[str, Dict[str, float]] = {}
    for jf in json_files:
        try:
            with open(jf) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        ratios = data.get("VoidRatio")
        if not ratios:
            continue
        out[osp.dirname(jf)] = {
            k: float(np.mean(np.asarray(v, float))) for k, v in ratios.items()
        }
    return out


def assign_sample_weights(
    all_trajs_voidratios: Dict[str, Dict[str, float]],
    method: str = "linear",
    cutoff: Optional[float] = None,
    alpha: float = 1.0,
    slope: float = -1.0,
    intercept: float = 2.0,
) -> Tuple[List[Tuple[str, str]], np.ndarray]:
    """Flatten to (traj, step) entries + raw weights
    (filter_util.py:319-397): normalize valid void ratios to [0,1], then
    linear (slope*v + intercept), exponential exp(-alpha*v), or uniform;
    entries at/above `cutoff` get weight 0."""
    entries = [
        (traj, step, v)
        for traj, d in all_trajs_voidratios.items()
        for step, v in d.items()
    ]
    values = np.array([e[2] for e in entries], float)
    valid = values < cutoff if cutoff is not None else np.ones_like(values, bool)
    weights = np.zeros_like(values)
    if valid.any():
        vv = values[valid]
        span = vv.max() - vv.min()
        norm = (vv - vv.min()) / span if span > 0 else np.zeros_like(vv)
        if method == "linear":
            weights[valid] = slope * norm + intercept
        elif method == "exponential":
            weights[valid] = np.exp(-alpha * norm)
        elif method == "uniform":
            weights = np.ones_like(values)
        elif method == "uniform2":
            weights[valid] = 1.0
        else:
            raise ValueError(f"unknown weighting method {method}")
    return [(t, s) for t, s, _ in entries], weights


class TrajectoryDataset:
    """Frame-count-weighted folder sampler (ref: DummyDataset)."""

    def __init__(
        self,
        base_folders: Sequence[str],
        sample_frames: int = 14,
        width: int = 1024,
        height: int = 576,
        num_samples: int = 100000,
        fix_seed: bool = False,
        reverse_aug: bool = False,
    ):
        self.base_folders = list(base_folders)
        self.sample_frames = sample_frames
        self.width, self.height = width, height
        self.num_samples = num_samples
        self.enable_aug = reverse_aug
        self.rng = random.Random(42) if fix_seed else random.Random()
        self._prepare()

    # ------------------------------------------------------------------
    def _prepare(self):
        metas = []
        for root in self.base_folders:
            metas.extend(du.glob_all_imgleaf_folders(root))
        folders = [osp.dirname(m) for m in metas]
        self.folder_counts = {}
        for f in folders:
            n = len(glob.glob(osp.join(f, "*rgb.png")))
            if n >= self.sample_frames:
                self.folder_counts[f] = n
        if not self.folder_counts:
            raise ValueError(f"no usable trajectory folders under {self.base_folders}")
        self._folders = sorted(self.folder_counts)
        self._weights = [self.folder_counts[f] for f in self._folders]

    def __len__(self):
        return self.num_samples

    def _select_window(self):
        folder = self.rng.choices(self._folders, weights=self._weights, k=1)[0]
        frames, start = du.gen_frame_idxs(folder, self.sample_frames, self.rng)
        idxs = list(range(start, start + self.sample_frames))
        return folder, frames, start, idxs

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        folder, frames, start, idxs = self._select_window()
        parts = folder.rstrip("/").split("/")
        scene, traj, waypoint = parts[-3], parts[-2].split("-")[-1], parts[-1].split("-")[-1]
        actions = np.asarray(
            du.get_actions(scene, traj, waypoint, folder, idxs), np.int32
        )
        names = [frames[i] for i in idxs]
        pixels = du.get_pixel_values(
            folder, names, width=self.width, height=self.height
        )
        reverse = flip = False
        if self.enable_aug:
            # reverse kept off by default in the reference too
            # (dataset.py:251 hard-codes do_reverse=False)
            flip = self.rng.choice([True, False])
            if flip:
                pixels = pixels[:, :, ::-1]
                actions = np.asarray(du.action_flip_convert(actions), np.int32)
        return {
            "pixel_values": pixels,
            "past_obs": pixels[0],
            "actions": actions,
            "frame_paths": [osp.join(folder, n) for n in names],
            "folder_path": folder,
            "start_idx": start,
            "reverse_aug": reverse,
            "flip_aug": flip,
        }


class WeightedDataset(TrajectoryDataset):
    """Void-ratio-weighted (traj, start) sampler (ref: WeightedDataset)."""

    def __init__(self, *args, weighted_method: str = "exponential",
                 cutoff_thr: float = 0.45, **kwargs):
        self.weighted_method = weighted_method
        self.cutoff_thr = cutoff_thr
        super().__init__(*args, **kwargs)

    def _prepare(self):
        json_files = []
        for root in self.base_folders:
            json_files.extend(glob_all_overlap_json(root, self.sample_frames))
        paths = [osp.dirname(f) for f in json_files]
        if len(du.check_metadata(paths)) != len(paths):
            raise ValueError("some folders have overlap json but no metadata.json")
        ratios = get_all_trajs_voidratios(json_files)
        self.traj_entries, self.sample_weights = assign_sample_weights(
            ratios, method=self.weighted_method, cutoff=self.cutoff_thr
        )
        if not self.traj_entries or not np.any(self.sample_weights > 0):
            raise ValueError("no positively-weighted trajectory windows")

    def _select_window(self):
        folder, step_key = self.rng.choices(
            self.traj_entries, weights=self.sample_weights, k=1
        )[0]
        start = int(step_key.split("-")[-1])
        frames = du.get_sorted_frame_paths(folder, self.sample_frames)
        idxs = list(range(start, start + self.sample_frames))
        return folder, frames, start, idxs


class StraightDataset(TrajectoryDataset):
    """Keeps only all-forward windows (ref: DummyDataset_Straight,
    dataset.py:366-459)."""

    def __getitem__(self, idx: int) -> dict:
        for _ in range(1000):
            item = super().__getitem__(idx)
            if np.all(item["actions"][1:] == ACTION_FORWARD):
                return item
        raise RuntimeError("no all-forward window found in 1000 draws")


def iterate_batches(dataset, batch_size: int, num_steps: int) -> Iterator[dict]:
    """Yields stacked channels-last numpy batches for the trainer."""
    for step in range(num_steps):
        items = [dataset[step * batch_size + i] for i in range(batch_size)]
        yield {
            "pixel_values": np.stack([it["pixel_values"] for it in items]),
            "actions": np.stack([it["actions"] for it in items]),
        }
