"""The action-conditioned SVD world-model worker, on PyTorch.

Port of `wiw_tpu/workers/svd_action.py` (`igenex`, and `igenex_manip` with
task_type="manipulation"), with the same contract:
  in : {b_action [B, F] nav ids or [B, F, 8] poses, save_dirs,
        request_model_name, b_image? [B, C, H, W] uint8, return_objects?}
  out: {save_dirs, pred_frames? uint8 [B, T, C, H, W]}

Action strategies as the reference's: micro_cond (the default; nav ids or,
with action_input_channel 10, manipulation poses) and action_block /
action_block_nocfg (nav ids as one-hot tokens cross-attended in every
transformer).

Runs in-process (`worker(input_dict)`) or as a subprocess through the
port's copy of the worker SDK (`wiw_tpu_torch.serve.worker`), whose wire
format is the reference manager's. Serving precision, as in the
reference: the CLI serves W8A8 int8 unless told `--quantize bf16`; the
class serves int8 with `quantize="int8"` or WIW_QUANT=int8, else bf16. In
int8 the UNet trunk's 3x3 convs and GEGLU in-projections run kernel K7
(ops/quant.py). The fused-kernel configuration (K4 frame attention, K6
LN + GEGLU feed-forward) is selected with `fused_ff=True,
temporal_attention="pallas"` or the reference's WIW_FUSED_FF=1 and
WIW_TEMPORAL_ATTN=pallas; WIW_FUSED_FF_GATE=bf16 takes K6's bf16 gate
(K6-bf16) there.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional

import numpy as np
import torch

from wiw_tpu_torch.agents.saver import save_video
from wiw_tpu_torch.core.schedule import SERVING_CFG, CFGSchedule
from wiw_tpu_torch.models.convert import load_safetensors_dir
from wiw_tpu_torch.models.unet import UNetConfig, env_switches
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline
from wiw_tpu_torch.serve.worker import main_from_argv

QUANTIZE_CHOICES = ("", "bf16", "int8")
CFG_CHOICES = ("", "serving", "full")


def resolve_switches(cfg_schedule: str = "", quantize: str = "",
                     fused_ff: Optional[bool] = None,
                     temporal_attention: Optional[str] = None) -> dict:
    """The deployment switches of the reference worker, resolved as it
    resolves them: an explicit argument wins, else the environment, else
    the default.

      WIW_CFG            'serving' (default) -> SERVING_CFG, else full CFG
      WIW_QUANT          'int8' -> W8A8 int8, else bf16
      and the model's switches, as `unet.env_switches` reads them
      (WIW_FUSED_FF, WIW_TEMPORAL_ATTN, WIW_FUSED_FF_GATE; the train CLI
      reads the same)

    Environment values keep the reference's readings; an explicit
    `quantize` or `cfg_schedule` outside the CLI's choices raises
    ValueError rather than serving something else.

    Returns {cfg, quantize ('int8' or 'bf16'), fused_ff,
    temporal_attention, fused_ff_gate}."""
    if quantize not in QUANTIZE_CHOICES:
        raise ValueError(f"quantize {quantize!r} not in {QUANTIZE_CHOICES}")
    if cfg_schedule not in CFG_CHOICES:
        raise ValueError(f"cfg_schedule {cfg_schedule!r} not in {CFG_CHOICES}")
    env = os.environ
    int8 = (quantize or env.get("WIW_QUANT", "")) == "int8"
    cfg = cfg_schedule or env.get("WIW_CFG", "serving")
    return {"cfg": SERVING_CFG if cfg == "serving" else CFGSchedule(),
            "quantize": "int8" if int8 else "bf16",
            **env_switches(fused_ff, temporal_attention)}


def cond_images(input_dict: dict, height: int, width: int) -> np.ndarray:
    """[B, H, W, 3] fp32 in [-1, 1] on the host, from b_image or
    <save_dir>/cond_rgb.png, as the reference makes it: truncated to uint8,
    resized to (height, width) by PIL's default filter, then scaled."""
    from PIL import Image

    if input_dict.get("b_image") is not None:
        imgs = np.asarray(input_dict["b_image"])
        if imgs.ndim == 4 and imgs.shape[1] in (3, 4):  # BCHW -> BHWC
            imgs = np.transpose(imgs[:, :3], (0, 2, 3, 1))
    else:
        imgs = np.stack([
            np.asarray(Image.open(osp.join(d, "cond_rgb.png")).convert("RGB"))
            for d in input_dict["save_dirs"]])
    resized = np.stack([
        np.asarray(Image.fromarray(im.astype(np.uint8)).resize((width, height)))
        for im in imgs])
    return resized.astype(np.float32) / 127.5 - 1.0


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
        quantize: str = "",
        cfg_schedule: str = "",
        device: str = "cuda",
        fused_ff: Optional[bool] = None,
        temporal_attention: Optional[str] = None,
    ):
        """`quantize`, `cfg_schedule`, `fused_ff` and `temporal_attention`
        left unset take the environment, as `resolve_switches` says."""
        sw = resolve_switches(cfg_schedule, quantize, fused_ff,
                              temporal_attention)
        self.task_type = task_type
        self.out_size = (out_width, out_height)
        self.device = torch.device(device)
        self.gen = GenerationConfig(
            height=height, width=width, num_frames=num_frames,
            num_inference_steps=num_inference_steps, task_type=task_type,
            cfg=sw["cfg"],
        )
        self.pipe = SVDPipeline(
            UNetConfig(num_frames=num_frames,
                       action_strategy=action_strategy or None,
                       action_input_channel=action_input_channel,
                       dtype=dtype, fused_ff=sw["fused_ff"],
                       temporal_attention=sw["temporal_attention"],
                       fused_ff_gate=sw["fused_ff_gate"]),
            device=self.device,
        )
        self.quantize = sw["quantize"]
        if self.quantize == "int8":
            n = self.pipe.quantize_unet()
            print(f"[svd_action] W8A8 serving mode: {n} int8 kernels",
                  flush=True)
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
        clip = {k: v for k, v in load_safetensors_dir(
            osp.join(svd_path, "image_encoder")).items()
            if not k.endswith("position_ids")}
        self.pipe.load_state_dicts(
            load_safetensors_dir(unet_dir),
            load_safetensors_dir(osp.join(svd_path, "vae")), clip)

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run one generation per batch size before serving, so the first
        client does not pay for the first calls; on the card this first
        builds every CUDA kernel of the package (one nvcc per source, in
        parallel)."""
        if self.device.type == "cuda":
            from wiw_tpu_torch.ops import native

            native.load_libraries(*native.LIBRARIES)
        F = self.gen.num_frames
        for b in batch_sizes:
            img = torch.zeros((b, self.gen.height, self.gen.width, 3),
                              device=self.device)
            cfg = self.pipe.unet_config
            if cfg.action_strategy is None:
                acts = None
            elif self.task_type == "manipulation" and not cfg.uses_action_block:
                # poses at the identity rotation (xyz, quaternion xyzw, grip)
                acts = torch.zeros((b, F, 8))
                acts[..., 6] = 1.0
            else:
                acts = torch.full((b, F), 1, dtype=torch.int64)
            self.pipe.generate(img, self.gen, actions=acts,
                               generator=torch.Generator(
                                   device=self.device).manual_seed(0))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"[svd_action] warmed batch={b}", flush=True)

    def _load_cond_images(self, input_dict: dict) -> torch.Tensor:
        """`cond_images` at the generation size, on the device."""
        return torch.from_numpy(cond_images(
            input_dict, self.gen.height, self.gen.width)).to(self.device)

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
        "--quantize", default="int8", choices=QUANTIZE_CHOICES,
        help="serving precision of the UNet trunk. Default int8 (selective "
             "W8A8 through kernel K7, ops/quant.py), as the reference's CLI; "
             "--quantize bf16 opts out; '': $WIW_QUANT, else bf16.")
    ap.add_argument(
        "--cfg_schedule", default="", choices=CFG_CHOICES,
        help="CFG row schedule; unset: $WIW_CFG, else 'serving' = "
             "stale-uncond tail below sigma 0.2; 'full' = both rows every "
             "step.")
    ap.add_argument(
        "--fused_ff", default=None, type=int, choices=[0, 1],
        help="1: LN + GEGLU feed-forward + residual through kernel K6 where "
             "C <= 640; unset: $WIW_FUSED_FF, else 0.")
    ap.add_argument(
        "--temporal_attention", default=None,
        choices=["batched", "xla", "pallas"],
        help="frame attention formulation ('pallas' = kernel K4 where "
             "S % 64 == 0); unset: $WIW_TEMPORAL_ATTN, else 'batched'.")
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
        fused_ff=None if args.fused_ff is None else bool(args.fused_ff),
        temporal_attention=args.temporal_attention,
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
    main_from_argv(worker)


if __name__ == "__main__":
    main()
