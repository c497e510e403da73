"""Shared WM-worker machinery: the zoo base class.

The port's own copy of `wiw_tpu/workers/base.py` (which imports no JAX;
the port imports nothing of the reference package):
  * `process_input_dict`: actions -> per-task text prompts for
    text-conditioned WMs; conditioning images from the in-band `b_image`
    (BCHW or BHWC) or `<save_dir>/cond_rgb.png`, resized with PIL
  * `process_output_dict`: uint8 frames returned in-band when
    `return_objects`, else written to each save_dir as pred.mp4
  * `WorkerModelBase`: subclass, implement `generate`, and the instance
    answers the serving contract's input dicts
"""

from __future__ import annotations

import os.path as osp
from typing import List, Tuple

import numpy as np

from wiw_tpu_torch.core.actions import actions_to_prompt

OUT_WIDTH_DEFAULT = 480
OUT_HEIGHT_DEFAULT = 480


def load_cond_images(input_dict: dict, width: int, height: int) -> np.ndarray:
    """[B, H, W, 3] uint8 from b_image (BCHW or BHWC) or cond_rgb.png."""
    from PIL import Image

    from wiw_tpu_torch.agents.saver import load_image

    if input_dict.get("b_image") is not None:
        imgs = np.asarray(input_dict["b_image"])
        if imgs.ndim == 4 and imgs.shape[1] in (3, 4):
            imgs = np.transpose(imgs[:, :3], (0, 2, 3, 1))
    else:
        imgs = np.stack([load_image(osp.join(d, "cond_rgb.png"))
                         for d in input_dict["save_dirs"]])
    return np.stack([
        np.asarray(Image.fromarray(im.astype(np.uint8)).resize((width, height)))
        for im in imgs])


def process_input_dict(input_dict: dict, task_type: str, width: int,
                       height: int) -> Tuple[np.ndarray, List[str], list,
                                             List[str], np.ndarray]:
    """-> (b_action, save_dirs, return_objects, prompts, cond_images)."""
    b_action = np.asarray(input_dict["b_action"])
    save_dirs = list(input_dict["save_dirs"])
    return_objects = input_dict.get("return_objects") or [False] * len(save_dirs)
    prompts = [actions_to_prompt(b_action[i], task_type)
               for i in range(b_action.shape[0])]
    images = load_cond_images(input_dict, width, height)
    return b_action, save_dirs, return_objects, prompts, images


def process_output_dict(save_dirs: List[str], return_objects: list,
                        frames_bthwc: np.ndarray,
                        out_width: int = OUT_WIDTH_DEFAULT,
                        out_height: int = OUT_HEIGHT_DEFAULT) -> dict:
    """frames [B, T, H, W, 3] uint8 -> the serving contract's output
    (resized with PIL), in-band as pred_frames [B, T, 3, H, W] when any
    `return_objects`, else written to `<save_dir>/pred.mp4`."""
    from PIL import Image

    B, T = frames_bthwc.shape[:2]
    out = np.empty((B, T, out_height, out_width, 3), np.uint8)
    for b in range(B):
        for t in range(T):
            out[b, t] = np.asarray(
                Image.fromarray(frames_bthwc[b, t]).resize((out_width, out_height)))
    result = {"save_dirs": save_dirs}
    if any(return_objects):
        result["pred_frames"] = np.transpose(out, (0, 1, 4, 2, 3))
    else:
        from wiw_tpu_torch.agents.saver import save_video

        for b, d in enumerate(save_dirs):
            save_video(osp.join(d, "pred.mp4"), out[b])
    return result


class WorkerModelBase:
    """The zoo contract: subclass, implement `generate`, and the instance
    answers input dicts (`inference_batch`, or call it). External workers
    implement the same input/output dicts in their own process."""

    task_type: str = "navigation"
    width: int = 1024
    height: int = 576
    out_width: int = OUT_WIDTH_DEFAULT
    out_height: int = OUT_HEIGHT_DEFAULT

    def generate(self, images: np.ndarray, actions: np.ndarray,
                 prompts: List[str]) -> np.ndarray:
        """[B, H, W, 3] uint8 + actions -> frames [B, T, H, W, 3] uint8."""
        raise NotImplementedError

    def inference_batch(self, input_dict: dict) -> dict:
        b_action, save_dirs, return_objects, prompts, images = (
            process_input_dict(input_dict, self.task_type, self.width,
                               self.height))
        frames = self.generate(images, b_action, prompts)
        return process_output_dict(save_dirs, return_objects, frames,
                                   self.out_width, self.out_height)

    __call__ = inference_batch
