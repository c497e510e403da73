"""Video-metrics CLI: SSIM, PSNR, LPIPS (and FVD) between generated and
ground-truth clips.

Port of `wiw_tpu/eval/video_metrics_cli.py`: takes two sets of clips (mp4
files or directories of frame PNGs), cuts each pair to its common length
(and `--max_frames`), optionally resizes (JAX's antialiased bilinear,
ops/resize.py), stacks them and prints the metric dict as JSON. LPIPS needs
WIW_LPIPS_WEIGHTS, FVD WIW_I3D_WEIGHTS (`"fvd": null` without them, or for
clips under 10 frames). The metrics run on --device, the card by default.

  python -m wiw_tpu_torch.eval.video_metrics_cli --gen gen/*.mp4 \
      --gt gt/*.mp4 [--resize 256 256] [--fvd] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np
import torch


def mp4_to_frames(path: str) -> np.ndarray:
    """Saved clip -> uint8 [T, H, W, C]."""
    from wiw_tpu_torch.agents.saver import load_video_frames

    return load_video_frames(path)


def load_clip(path: str, max_frames: int = 0) -> np.ndarray:
    """mp4 file or directory of frame PNGs (sorted by name) -> uint8
    [T, H, W, 3]."""
    if osp.isdir(path):
        from wiw_tpu_torch.agents.saver import load_image

        clip = np.stack([load_image(p)
                         for p in sorted(glob.glob(osp.join(path, "*.png")))])
    else:
        clip = mp4_to_frames(path)
    if max_frames:
        clip = clip[:max_frames]
    return clip


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", nargs="+", required=True)
    ap.add_argument("--gt", nargs="+", required=True)
    ap.add_argument("--resize", nargs=2, type=int, default=None)
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--fvd", action="store_true",
                    help="also compute FVD (needs WIW_I3D_WEIGHTS)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    assert len(args.gen) == len(args.gt), "gen/gt counts must match"

    from wiw_tpu_torch.eval.metrics import evaluate_video_metrics
    from wiw_tpu_torch.ops.resize import resize_bilinear

    gens, gts = [], []
    for g, t in zip(args.gen, args.gt):
        cg, ct = load_clip(g, args.max_frames), load_clip(t, args.max_frames)
        n = min(len(cg), len(ct))
        cg, ct = (torch.from_numpy(c[:n]).float() for c in (cg, ct))
        if args.resize:
            cg, ct = (resize_bilinear(c, args.resize, dims=(1, 2)) for c in (cg, ct))
        gens.append(cg)
        gts.append(ct)
    n = min(map(len, gens + gts))
    v1, v2 = (torch.stack([c[:n] for c in clips]).to(args.device) / 255.0
              for clips in (gens, gts))

    out = evaluate_video_metrics(v1, v2)
    if args.fvd:
        from wiw_tpu_torch.eval.fvd import FVDEvaluator

        ev = FVDEvaluator()
        out["fvd"] = (ev.fvd(v1, v2) if ev.model is not None and v1.shape[1] >= 10
                      else None)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
