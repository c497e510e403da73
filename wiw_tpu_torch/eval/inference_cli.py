"""Offline eval-inference CLI: generate clips from a trajectory dataset
with a (trained or random-init) SVD-dagger pipeline, save stitched
gen|GT videos, and print the metric table.

Port of `wiw_tpu/eval/inference_cli.py`: walk windows of the dataset,
condition on frame 0 and the window's actions, generate, save
`clip{i}_stitch.mp4` (and `clip{i}.gif` with --save_gif), then score the
generated clips against the ground truth with PSNR, SSIM, LPIPS (when
WIW_LPIPS_WEIGHTS names weights) and FVD (clips of >= 10 frames, when
WIW_I3D_WEIGHTS does) into `metrics.json`. The UNet takes the
environment's model switches (`unet.env_switches`: WIW_FUSED_FF,
WIW_TEMPORAL_ATTN, WIW_FUSED_FF_GATE). Runs on --device, the card by
default.

Departure from the reference, which swallows any error of the FVD tower:
FVD is skipped only when no I3D weights are configured (said on stderr);
any other error raises.

  python -m wiw_tpu_torch.eval.inference_cli --data_root <traj root> \
      [--unet_path <diffusers dir> --svd_path <svd dir>] --num_clips 4 \
      --out_dir runs/eval_inf [--unet_channels 32 32 64 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.vae import VAEConfig

# the frozen towers' configurations: the reference pipeline's defaults;
# tests swap in tiny ones
VAE_CONFIG = VAEConfig(dtype="bfloat16")
CLIP_CONFIG = CLIPVisionConfig()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", nargs="+", required=True)
    ap.add_argument("--out_dir", default="runs/eval_inference")
    ap.add_argument("--unet_path", default="",
                    help="trained UNet (diffusers dir); empty = random init")
    ap.add_argument("--svd_path", default="",
                    help="SVD dir for vae/image_encoder weights")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--sample_frames", type=int, default=14)
    ap.add_argument("--num_clips", type=int, default=4)
    ap.add_argument("--num_inference_steps", type=int, default=30)
    ap.add_argument("--action_strategy", default="micro_cond")
    ap.add_argument("--action_input_channel", type=int, default=14)
    ap.add_argument("--fps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--unet_channels", type=int, nargs="*", default=[])
    ap.add_argument("--unet_heads", type=int, nargs="*", default=[])
    ap.add_argument("--save_gif", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_or_init(pipe, unet_path: str, svd_path: str, seed: int, tag: str) -> None:
    """diffusers checkpoints (the UNet from `unet_path`, or its unet/
    subdirectory; the VAE and image encoder from `svd_path`), else random
    weights from `seed`, said on stderr."""
    if unet_path:
        from wiw_tpu_torch.models.convert import load_safetensors_dir

        unet_dir = (osp.join(unet_path, "unet")
                    if osp.isdir(osp.join(unet_path, "unet")) else unet_path)
        clip = {k: v for k, v in load_safetensors_dir(
            osp.join(svd_path, "image_encoder")).items()
            if not k.endswith("position_ids")}
        pipe.load_state_dicts(load_safetensors_dir(unet_dir),
                              load_safetensors_dir(osp.join(svd_path, "vae")), clip)
    else:
        print(f"[{tag}] no --unet_path: random-init weights", file=sys.stderr)
        pipe.init_params(torch.Generator(device=pipe.device).manual_seed(seed))


def stitch(gen: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[T,H,W,C] x2 -> side-by-side [T,H,2W+4,C] with a white divider
    strip; `gen` resized (PIL) to the ground truth's size first."""
    t = min(len(gen), len(gt))
    gen, gt = gen[:t], gt[:t]
    if gen.shape[1:3] != gt.shape[1:3]:
        from PIL import Image

        gen = np.stack([np.asarray(Image.fromarray(f).resize((gt.shape[2], gt.shape[1])))
                        for f in gen])
    bar = np.full((t, gt.shape[1], 4, gt.shape[3]), 255, np.uint8)
    return np.concatenate([gen, bar, gt], axis=2)


def main(argv=None):
    args = parse_args(argv)
    from wiw_tpu_torch.agents.saver import save_gif, save_video
    from wiw_tpu_torch.data.dataset import TrajectoryDataset
    from wiw_tpu_torch.eval.metrics import evaluate_video_metrics
    from wiw_tpu_torch.models.unet import UNetConfig, env_switches
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

    size_kw = {}
    if args.unet_channels:
        size_kw["block_out_channels"] = tuple(args.unet_channels)
        size_kw["num_attention_heads"] = tuple(
            args.unet_heads or [max(1, c // 64) for c in args.unet_channels])
    cfg = UNetConfig(num_frames=args.sample_frames,
                     action_strategy=args.action_strategy,
                     action_input_channel=args.action_input_channel,
                     dtype="bfloat16", **env_switches(), **size_kw)
    pipe = SVDPipeline(cfg, VAE_CONFIG, CLIP_CONFIG, device=args.device)
    gen_cfg = GenerationConfig(height=args.height, width=args.width,
                               num_frames=args.sample_frames,
                               num_inference_steps=args.num_inference_steps)
    load_or_init(pipe, args.unet_path, args.svd_path, args.seed, "eval_inference")

    ds = TrajectoryDataset(args.data_root, sample_frames=args.sample_frames,
                           width=args.width, height=args.height)
    os.makedirs(args.out_dir, exist_ok=True)
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    gens, gts = [], []
    for i in range(args.num_clips):
        item = ds[i]
        gt = np.asarray(item["pixel_values"])  # [T,H,W,C] in [-1,1]
        gt_u8 = ((gt + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        t0 = time.time()
        video = pipe.generate(torch.from_numpy(gt[None, 0]), gen_cfg,
                              actions=torch.from_numpy(item["actions"])[None],
                              generator=generator)
        gen_u8 = (video[0].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        print(f"[eval_inference] clip {i}: {gen_u8.shape} "
              f"({time.time() - t0:.1f}s)", flush=True)
        save_video(osp.join(args.out_dir, f"clip{i}_stitch.mp4"),
                   stitch(gen_u8, gt_u8), fps=args.fps)
        if args.save_gif:
            save_gif(osp.join(args.out_dir, f"clip{i}.gif"), gen_u8, fps=args.fps)
        gens.append(gen_u8)
        gts.append(gt_u8)

    v_gen, v_gt = (torch.from_numpy(np.stack(v)).to(pipe.device).float() / 255.0
                   for v in (gens, gts))
    metrics = {k: float(v) for k, v in evaluate_video_metrics(v_gen, v_gt).items()}
    if v_gen.shape[1] >= 10:  # FVD needs >= 10-frame clips
        from wiw_tpu_torch.eval.fvd import FVDEvaluator

        ev = FVDEvaluator()
        if ev.model is not None:
            metrics["fvd"] = ev.fvd(v_gen, v_gt)
        else:
            print("[eval_inference] FVD skipped: no I3D weights "
                  "(WIW_I3D_WEIGHTS)", file=sys.stderr)
    with open(osp.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
