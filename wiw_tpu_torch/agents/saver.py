"""Media writers the port's workers need (port of `wiw_tpu/agents/saver.py`
`save_video`)."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def save_video(path: str, frames: np.ndarray, fps: int = 7) -> str:
    """uint8 [T, H, W, C] -> mp4; falls back to an animated GIF (PIL)
    when no ffmpeg codec is installed. Returns the path actually written."""
    import imageio

    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    try:
        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:  # no video codec: any imageio backend failure
        from PIL import Image

        gif = path.rsplit(".", 1)[0] + ".gif"
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=max(1, int(1000 / fps)), loop=0)
        return gif
