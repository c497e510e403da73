"""Paths and media writers the port's workers and clients need (port of
`wiw_tpu/agents/saver.py`: `Saver.get_igenex_save_dirs`, `save_image`,
`load_image`, `save_video`, `load_video_frames`). Where imageio is not
installed, videos are written as animated GIFs by PIL."""

from __future__ import annotations

import datetime
import os
import os.path as osp
from typing import List

import numpy as np


class Saver:
    """Only the reference Saver's per-candidate directories: the paths of
    the solvers' datasets stay with the host logic (`wiw_tpu.agents`)."""

    @staticmethod
    def get_igenex_save_dirs(base_dir: str, action_ids_list: List) -> List[str]:
        """Timestamped `<base_dir>/PredA-<i>_<mmdd_HHMMSS>` per candidate,
        made on disk."""
        dirs = []
        stamp = datetime.datetime.now().strftime("%m%d_%H%M%S")
        for action_id in action_ids_list:
            path = osp.join(base_dir, f"PredA-{action_id}_{stamp}")
            os.makedirs(path, exist_ok=True)
            dirs.append(path)
        return dirs


def save_image(path: str, img: np.ndarray) -> None:
    """uint8 [H, W, C] (or float [0,1]) -> PNG."""
    from PIL import Image

    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)


def load_image(path: str) -> np.ndarray:
    """Image file -> uint8 RGB [H, W, 3]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_gif(path: str, frames: np.ndarray, fps: int = 7) -> str:
    """uint8 [T, H, W, C] -> an animated GIF (PIL). Returns the path."""
    from PIL import Image

    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return path


def save_video(path: str, frames: np.ndarray, fps: int = 7) -> str:
    """uint8 [T, H, W, C] -> mp4; falls back to an animated GIF (PIL) beside
    it when imageio or its ffmpeg codec is missing. Returns the path
    actually written."""
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:  # no imageio or no video codec: any backend failure
        return save_gif(path.rsplit(".", 1)[0] + ".gif", frames, fps)


def load_video_frames(path: str) -> np.ndarray:
    """Video file -> uint8 [T, H, W, C]."""
    import imageio

    return np.stack(list(imageio.get_reader(path)), axis=0)
