"""Generation + video-metric evaluation CLI.

Port of `wiw_tpu/sampling/eval_cli.py`: generate clips from conditioning
images with an action sequence, save `gen_{i}.mp4` per clip, and, given
ground-truth clips (`--gt`, mp4), print and save SSIM, PSNR and LPIPS
(when WIW_LPIPS_WEIGHTS names weights) in `metrics.json`. Runs on
--device, the card by default.

  python -m wiw_tpu_torch.sampling.eval_cli --cond image1.png image2.png \
      --actions 1,1,2,2,1 [--unet_path ... --svd_path ...] --out_dir gen/
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.vae import VAEConfig

# the frozen towers' configurations: the reference pipeline's defaults;
# tests swap in tiny ones
VAE_CONFIG = VAEConfig(dtype="bfloat16")
CLIP_CONFIG = CLIPVisionConfig()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cond", nargs="+", required=True,
                    help="conditioning image path(s)")
    ap.add_argument("--gt", nargs="*", default=[],
                    help="optional ground-truth clips (mp4) for metrics")
    ap.add_argument("--actions", default="",
                    help="comma-separated action ids per frame (nav)")
    ap.add_argument("--unet_path", default="")
    ap.add_argument("--svd_path", default="")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--num_frames", type=int, default=14)
    ap.add_argument("--num_inference_steps", type=int, default=30)
    ap.add_argument("--action_strategy", default="micro_cond")
    ap.add_argument("--out_dir", default="generated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from wiw_tpu_torch.agents.saver import save_video
    from wiw_tpu_torch.eval.inference_cli import load_or_init
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

    gen = GenerationConfig(height=args.height, width=args.width,
                           num_frames=args.num_frames,
                           num_inference_steps=args.num_inference_steps)
    unet_cfg = UNetConfig(num_frames=args.num_frames,
                          action_strategy=args.action_strategy or None,
                          dtype="bfloat16")
    pipe = SVDPipeline(unet_cfg, VAE_CONFIG, CLIP_CONFIG, device=args.device)
    load_or_init(pipe, args.unet_path, args.svd_path, 0, "eval")

    imgs = np.stack([
        np.asarray(Image.open(p).convert("RGB").resize((args.width, args.height)))
        for p in args.cond]).astype(np.float32) / 127.5 - 1.0
    actions = None
    if args.actions:
        ids = [int(x) for x in args.actions.split(",")]
        ids = (ids + [1] * args.num_frames)[: args.num_frames]
        actions = torch.tensor(ids)[None].repeat(imgs.shape[0], 1)

    video = pipe.generate(torch.from_numpy(imgs), gen, actions=actions,
                          generator=torch.Generator(device=pipe.device
                                                    ).manual_seed(args.seed))
    frames = torch.round(video * 255.0).to(torch.uint8).cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(frames.shape[0]):
        save_video(osp.join(args.out_dir, f"gen_{i:02d}.mp4"), frames[i])
    print(f"saved {frames.shape[0]} clips to {args.out_dir}")

    if args.gt:
        from wiw_tpu_torch.eval.metrics import evaluate_video_metrics
        from wiw_tpu_torch.eval.video_metrics_cli import mp4_to_frames

        gts = np.stack([mp4_to_frames(p)[: args.num_frames] for p in args.gt])
        m = evaluate_video_metrics(
            torch.from_numpy(frames).to(pipe.device).float() / 255.0,
            torch.from_numpy(gts).to(pipe.device).float() / 255.0)
        print(json.dumps(m))
        with open(osp.join(args.out_dir, "metrics.json"), "w") as f:
            json.dump(m, f)


if __name__ == "__main__":
    main()
