"""WM manager server CLI, on PyTorch.

Port of `wiw_tpu/serve/server_cli.py` (the original's worker_manager.py
__main__ + init_worldmodel_manager.sh). Default: ONE in-process
`SVDActionWorker` owning the card, served by the continuous executor
(4 slots, step-level admission), W8A8 int8, 30 steps, the serving CFG
schedule; `--external_cmd` attaches protocol-compatible subprocess workers
instead (the heterogeneous WM zoo path). `--wm_type nwm` takes its own
worker and nothing else (the reference serves an SVD action worker under
that name when no command is given; here that raises):

  python -m wiw_tpu_torch.serve.server_cli --wm_type nwm \
      --external_cmd "python -m wiw_tpu_torch.workers.nwm_worker"

Usage:
  python -m wiw_tpu_torch.serve.server_cli --wm_type igenex --port 7000 \
      --unet_path ... --svd_path ...
  (add --device cpu for a CPU run)
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from wiw_tpu_torch.serve.continuous import ContinuousEngine
from wiw_tpu_torch.serve.manager import (
    ContinuousExecutor,
    InProcessExecutor,
    ManagerServer,
    SubprocessExecutor,
)
from wiw_tpu_torch.utils.config import WM_REGISTRY, parse_extra_cli
from wiw_tpu_torch.workers.svd_action import SVDActionWorker, cond_images

NWM_WORKER = "wiw_tpu_torch.workers.nwm_worker"


def build_executors(args, extra):
    if args.external_cmd:
        return [
            SubprocessExecutor(
                args.external_cmd.split(),
                restart_on_death=not args.no_restart_workers,
                max_restarts=args.max_worker_restarts,
            )
            for _ in range(args.num_workers)
        ]
    spec = WM_REGISTRY.get(args.wm_type, {})
    if spec.get("worker") in (None, "external"):
        raise SystemExit(
            f"wm_type {args.wm_type} needs --external_cmd (torch-ecosystem "
            "worker) or is not servable")
    if spec["worker"] == NWM_WORKER:
        # the reference builds an SVD action worker at 224x224 here and
        # serves it under the NWM name (ROADMAP Queue 3, R6); NWM runs its
        # own worker
        raise SystemExit(
            f"wm_type {args.wm_type} is served by its own worker: add "
            f'--external_cmd "python -m {NWM_WORKER}"')
    worker = SVDActionWorker(
        unet_path=args.unet_path,
        svd_path=args.svd_path,
        task_type="manipulation" if args.wm_type == "igenex_manip" else "navigation",
        action_input_channel=spec.get("action_input_channel", 14),
        width=spec.get("width", 1024),
        height=spec.get("height", 576),
        out_width=args.out_width,
        out_height=args.out_height,
        num_inference_steps=args.num_inference_steps,
        quantize=args.quantize,
        device=args.device,
    )
    if args.warmup_batches:
        worker.warmup(tuple(int(b) for b in args.warmup_batches.split(",")))
    if args.executor == "continuous":
        # --per_device: one engine per CUDA device, each on its own replica
        # of the weights (least-pending dispatch spreads requests); every
        # bucket engine on a device shares that device's replica
        home = worker.pipe.device
        devices = [home]
        if args.per_device and home.type == "cuda":
            if home.index is None:
                home = torch.device("cuda", torch.cuda.current_device())
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        pipes = {d: worker.pipe if d == home else worker.pipe.replica(d)
                 for d in devices}
        execs = [make_continuous_executor(worker, args.num_slots, pipe=p)
                 for p in pipes.values()]
        execs[0].is_default = True
        # extra generation buckets: one engine (own slot pool) per (H, W);
        # requests route by extra['gen_size'] (the manager's accepts filter)
        for spec_str in filter(None, (args.buckets or "").split(",")):
            h, w = (int(x) for x in spec_str.lower().split("x"))
            for p in pipes.values():
                execs.append(make_continuous_executor(
                    worker, args.num_slots, bucket=(h, w), pipe=p))
        return execs
    return [InProcessExecutor(worker, max_batch=args.max_batch)]


def make_continuous_executor(worker, num_slots: int, bucket=None, pipe=None):
    """Step-level continuous batching over the worker's pipeline (or
    `pipe`, a replica of it on another device): items join between Euler
    steps. `bucket` = (height, width) for a non-default generation size
    sharing the same resident weights."""
    gen = worker.gen
    if bucket is not None:
        gen = dataclasses.replace(gen, height=bucket[0], width=bucket[1])
    ow, oh = worker.out_size
    engine = ContinuousEngine(pipe or worker.pipe, gen, num_slots=num_slots,
                              out_hw=(oh, ow), out_uint8=True)

    def encode_item(payload, i):
        # [B, H, W, 3] in [-1, 1], resized to the worker's size on the host
        images = cond_images(payload, worker.gen.height, worker.gen.width)
        if images.shape[1:3] != (gen.height, gen.width):
            from PIL import Image

            u8 = ((images[i] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            r = np.asarray(Image.fromarray(u8).resize((gen.width, gen.height)))
            img = r.astype(np.float32) / 127.5 - 1.0
        else:
            img = images[i]
        return img, np.asarray(payload["b_action"])[i]

    def postprocess(video_u8):
        # resize and uint8 are fused into the engine's decode: one transpose
        return np.transpose(np.asarray(video_u8), (0, 3, 1, 2))  # TCHW

    return ContinuousExecutor(engine, encode_item, postprocess, bucket=bucket)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wm_type", default="igenex")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7000)
    ap.add_argument("--server_type", default="world_model",
                    choices=["world_model", "sam2", "gd_sam2"])
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--no_restart_workers", action="store_true",
                    help="disable the crashed-worker restart + replay")
    ap.add_argument("--max_worker_restarts", type=int, default=2)
    ap.add_argument("--unet_path", default="")
    ap.add_argument("--svd_path", default="")
    ap.add_argument("--out_width", type=int, default=480)
    ap.add_argument("--out_height", type=int, default=480)
    ap.add_argument("--num_inference_steps", type=int, default=30)
    ap.add_argument("--quantize", default="int8", choices=["", "bf16", "int8"],
                    help="UNet trunk serving precision: int8 (W8A8 through "
                         "kernel K7, the default) or bf16")
    ap.add_argument("--executor", default="continuous",
                    choices=["batch", "continuous"],
                    help="'continuous' (default): each request item claims a "
                         "denoise slot and joins BETWEEN Euler steps; "
                         "'batch': whole-request micro-batching")
    ap.add_argument("--num_slots", type=int, default=4)
    ap.add_argument("--per_device", action="store_true",
                    help="one continuous engine per CUDA device (weights "
                         "replicated; least-pending dispatch spreads requests)")
    ap.add_argument("--buckets", default="",
                    help="extra continuous-engine generation buckets, e.g. "
                         "'256x256,320x576'; requests select one via "
                         "extra={'gen_size': [H, W]}")
    ap.add_argument("--warmup_batches", default="1",
                    help="comma-separated batch sizes to run once before "
                         "serving ('' to skip); on the card this also builds "
                         "every kernel")
    ap.add_argument("--external_cmd", default="",
                    help="launch this command as subprocess worker(s) "
                         "speaking the pipe protocol")
    ap.add_argument("--device", default="cuda",
                    help="where the in-process worker runs ('cpu' for a CPU run)")
    ap.add_argument("--exp_id", default="server")
    return ap


def main(argv=None):
    args, unknown = build_parser().parse_known_args(argv)
    extra = parse_extra_cli(unknown)

    from wiw_tpu_torch.utils.logging import setup_logger

    setup_logger(args.exp_id, f"manager_{args.wm_type}")
    server = ManagerServer(
        build_executors(args, extra),
        host=args.host, port=args.port,
        batch_size=args.batch_size, server_type=args.server_type,
    )
    port = server.start()
    print(f"[manager] {args.wm_type} serving on {args.host}:{port}", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
