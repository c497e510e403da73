"""The action-conditioned SVD world-model worker, on PyTorch.

Port of `wiw_tpu/workers/svd_action.py`, with the same contract:
  in : {b_action [B, F], save_dirs, request_model_name,
        b_image? [B, C, H, W] uint8, return_objects?}
  out: {save_dirs, pred_frames? uint8 [B, T, C, H, W]}

Runs in-process (`worker(input_dict)`) or as a subprocess through the
reference's jax-free worker SDK (`wiw_tpu.serve.worker.main_from_argv`).
Serving precision is bf16: the reference's W8A8 int8 mode is not ported
yet (ROADMAP M6/K7) and asking for it raises.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional

import numpy as np
import torch

from wiw_tpu_torch.core.schedule import SERVING_CFG, CFGSchedule
from wiw_tpu_torch.models.unet import UNetConfig
from wiw_tpu_torch.ops.resize import resize_cubic
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline


def _load_safetensors_dir(path: str) -> dict:
    from safetensors.torch import load_file

    files = sorted(f for f in os.listdir(path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state = {}
    for f in files:
        state.update(load_file(osp.join(path, f)))
    return state


class SVDActionWorker:
    def __init__(
        self,
        unet_path: str = "",
        svd_path: str = "",
        task_type: str = "navigation",
        action_strategy: str = "micro_cond",
        action_input_channel: int = 14,
        width: int = 1024,
        height: int = 576,
        num_frames: int = 14,
        num_inference_steps: int = 30,
        out_width: int = 480,
        out_height: int = 480,
        dtype: str = "bfloat16",
        seed: int = 0,
        quantize: str = "bf16",
        cfg_schedule: str = "serving",
        device: str = "cuda",
    ):
        if quantize == "int8":
            raise NotImplementedError(
                "W8A8 int8 serving is not ported to the GPU yet (ROADMAP "
                "M6 / kernel K7); serve with --quantize bf16")
        if quantize not in ("", "bf16"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if cfg_schedule not in ("serving", "full"):
            raise ValueError(f"unknown cfg_schedule {cfg_schedule!r}")
        self.out_size = (out_width, out_height)
        self.device = torch.device(device)
        self.gen = GenerationConfig(
            height=height, width=width, num_frames=num_frames,
            num_inference_steps=num_inference_steps, task_type=task_type,
            cfg=SERVING_CFG if cfg_schedule == "serving" else CFGSchedule(),
        )
        self.pipe = SVDPipeline(
            UNetConfig(num_frames=num_frames,
                       action_strategy=action_strategy or None,
                       action_input_channel=action_input_channel,
                       dtype=dtype),
            device=self.device,
        )
        if unet_path:
            self._load_weights(unet_path, svd_path)
        else:
            print("[svd_action] no unet_path: random-init weights (debug)",
                  flush=True)
            self.pipe.init_params(
                torch.Generator(device=self.device).manual_seed(0))
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def _load_weights(self, unet_path: str, svd_path: str):
        """diffusers checkpoints: the UNet from the fine-tuned dir, the VAE
        and image encoder from the SVD base dir."""
        unet_dir = (osp.join(unet_path, "unet")
                    if osp.isdir(osp.join(unet_path, "unet")) else unet_path)
        clip = {k: v for k, v in _load_safetensors_dir(
            osp.join(svd_path, "image_encoder")).items()
            if not k.endswith("position_ids")}
        self.pipe.load_state_dicts(
            _load_safetensors_dir(unet_dir),
            _load_safetensors_dir(osp.join(svd_path, "vae")), clip)

    def _load_cond_images(self, input_dict: dict) -> torch.Tensor:
        """[B, H, W, 3] fp32 in [-1, 1] on the device, from b_image or
        <save_dir>/cond_rgb.png, resized to the generation size with the
        cubic antialiased resize when it differs."""
        if input_dict.get("b_image") is not None:
            imgs = np.asarray(input_dict["b_image"])
            if imgs.ndim == 4 and imgs.shape[1] in (3, 4):  # BCHW -> BHWC
                imgs = np.transpose(imgs[:, :3], (0, 2, 3, 1))
        else:
            from PIL import Image

            imgs = np.stack([
                np.asarray(Image.open(osp.join(d, "cond_rgb.png")).convert("RGB"))
                for d in input_dict["save_dirs"]])
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(
            self.device, torch.float32) / 127.5 - 1.0
        x = resize_cubic(x, (self.gen.height, self.gen.width), dims=(1, 2))
        return x.clamp(-1.0, 1.0)

    def __call__(self, input_dict: dict) -> dict:
        actions = torch.as_tensor(np.asarray(input_dict["b_action"]))
        save_dirs = list(input_dict["save_dirs"])
        return_objects = input_dict.get("return_objects")
        images = self._load_cond_images(input_dict)
        ow, oh = self.out_size
        out = self.pipe.generate(
            images, self.gen, actions=actions, generator=self._generator,
            out_uint8_hw=(oh, ow)).cpu().numpy()  # [B, F, oh, ow, 3] uint8
        result = {"save_dirs": save_dirs}
        if return_objects and any(return_objects):
            result["pred_frames"] = np.transpose(out, (0, 1, 4, 2, 3))  # BTCHW
        else:
            from wiw_tpu.agents.saver import save_video  # jax-free host module

            for b, d in enumerate(save_dirs):
                save_video(osp.join(d, "pred.mp4"), out[b])
        return result


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--unet_path", default="")
    ap.add_argument("--svd_path", default="")
    ap.add_argument("--task_type", default="navigation")
    ap.add_argument("--action_strategy", default="micro_cond")
    ap.add_argument("--action_input_channel", type=int, default=14)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--num_frames", type=int, default=14)
    ap.add_argument("--num_inference_steps", type=int, default=30)
    ap.add_argument("--out_width", type=int, default=480)
    ap.add_argument("--out_height", type=int, default=480)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument(
        "--quantize", default="bf16", choices=["", "bf16", "int8"],
        help="serving precision of the UNet. bf16 (default); int8 W8A8 is "
             "not ported yet and raises.")
    ap.add_argument(
        "--cfg_schedule", default="serving", choices=["serving", "full"],
        help="CFG row schedule: 'serving' = stale-uncond tail below sigma "
             "0.2; 'full' = both rows every step.")
    args, _unknown = ap.parse_known_args(argv)

    worker = SVDActionWorker(
        unet_path=args.unet_path, svd_path=args.svd_path,
        task_type=args.task_type, action_strategy=args.action_strategy,
        action_input_channel=args.action_input_channel,
        width=args.width, height=args.height, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        out_width=args.out_width, out_height=args.out_height,
        quantize=args.quantize, cfg_schedule=args.cfg_schedule,
        device=args.device,
    )
    if args.debug:
        out = worker({
            "b_action": np.full((1, args.num_frames), 1, np.int64),
            "b_image": np.zeros((1, 3, 64, 64), np.uint8),
            "save_dirs": ["debug"],
            "request_model_name": "igenex",
            "return_objects": [True],
        })
        print("debug pred_frames:", out["pred_frames"].shape)
        return
    from wiw_tpu.serve.worker import main_from_argv

    main_from_argv(worker)


if __name__ == "__main__":
    main()
