"""SVD-dagger post-training CLI, on one GPU or a (dp, fsdp) mesh of them.

Port of `wiw_tpu/train/train_cli.py`, with the reference's flags and
defaults (bf16 compute, per-device batch 1, grad-accum 4, lr 2e-5, 14
frames, micro_cond, the three optimizers) plus `--device` (default
`cuda`): the trainer on collected Habitat trajectories, with checkpoints,
inline validation metrics (SSIM/PSNR) and TensorBoard logging
(tensorboardX, imported inside `main` as in the reference).

The UNet keeps fp32 parameters that compute in bf16 (the reference's flax
`param_dtype` beside `dtype`); the VAE and CLIP keep the reference's
configurations and stay frozen. `build(args, mesh)` returns (pipeline,
trainer, state) and is what `main` and `chip_smoke.py` call.

Under `python -m torch.distributed.run`, `main` joins the process group
(NCCL on the card, gloo with `--device cpu`) and trains on the mesh
dp = world / fsdp, fsdp = `--fsdp`: the global batch is `--per_device_batch`
times the world size, each rank's loader fetches its rows, the UNet is
sharded by FSDP2, validation generates on every rank (the sharded UNet's
forward needs all of them) and rank 0 alone logs and writes checkpoints.
Without the launcher it trains on one device, and `--fsdp` above 1 raises.

    python -m wiw_tpu_torch.train.train_cli --data_root DATA [--device cpu]
    python -m torch.distributed.run --nproc_per_node 2 \
        -m wiw_tpu_torch.train.train_cli --data_root DATA --fsdp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.unet import UNetConfig, env_switches
from wiw_tpu_torch.models.vae import VAEConfig
from wiw_tpu_torch.parallel.mesh import batch_rows, gather_rows, make_mesh
from wiw_tpu_torch.parallel.multihost import initialize_distributed, is_primary
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline
from wiw_tpu_torch.train.trainer import TrainConfig, Trainer

# the frozen towers' configurations: the reference CLI's (its pipeline's
# defaults); tests swap in tiny ones
VAE_CONFIG = VAEConfig(dtype="bfloat16")
CLIP_CONFIG = CLIPVisionConfig()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", nargs="+", required=True)
    ap.add_argument("--output_dir", default="runs/svd_ft")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--sample_frames", type=int, default=14)
    ap.add_argument("--per_device_batch", type=int, default=1)
    ap.add_argument("--grad_accum", type=int, default=4)
    ap.add_argument("--learning_rate", type=float, default=2e-5)
    ap.add_argument("--lr_scheduler", default="constant",
                    choices=["constant", "constant_with_warmup", "linear",
                             "cosine"])
    ap.add_argument("--lr_warmup_steps", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw_bf16m", "adafactor"],
                    help="adamw_bf16m = bf16 first moment; adafactor = "
                         "factored second moment")
    ap.add_argument("--max_steps", type=int, default=20000)
    ap.add_argument("--checkpointing_steps", type=int, default=500)
    ap.add_argument("--checkpoints_total_limit", type=int, default=3)
    ap.add_argument("--async_checkpointing", action="store_true",
                    help="overlap checkpoint disk writes with training "
                         "(device->host snapshot is sync, the write runs in "
                         "a background thread)")
    ap.add_argument("--validation_steps", type=int, default=500)
    ap.add_argument("--resume_from_checkpoint", default="")
    ap.add_argument("--action_strategy", default="micro_cond")
    ap.add_argument("--action_input_channel", type=int, default=14)
    ap.add_argument("--train_params", default="full",
                    choices=["full", "new", "new+temp_layer"])
    ap.add_argument("--gradient_checkpointing", action="store_true",
                    help="recompute UNet blocks in the backward pass (remat)")
    ap.add_argument("--conditioning_dropout", default="discrete")
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--weighted_dataset", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="parameter shards (under torch.distributed.run)")
    ap.add_argument("--unet_path", default="", help="initial weights (diffusers dir)")
    ap.add_argument("--svd_path", default="")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--loader_workers", type=int, default=4,
                    help="concurrent item-fetch threads in the prefetch loader")
    ap.add_argument("--unet_channels", type=int, nargs="*", default=[],
                    help="override block_out_channels (smoke runs / CI; "
                         "empty = the full SVD widths)")
    ap.add_argument("--unet_heads", type=int, nargs="*", default=[],
                    help="override num_attention_heads (pair with "
                         "--unet_channels)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args, mesh=None):
    """(pipeline, trainer, state) for `args`: the towers placed on the
    device (random weights from --seed, or --unet_path / --svd_path; the
    same on every rank), the trainer (its UNet sharded over `mesh`) and its
    initial state. The UNet takes the environment's model
    switches (`env_switches`: WIW_FUSED_FF, WIW_TEMPORAL_ATTN,
    WIW_FUSED_FF_GATE), as the reference's trainer does: WIW_FUSED_FF=1
    trains through K6 and its recompute backward. K4 has no gradient, as
    the reference's bare pallas_call defines none, so
    WIW_TEMPORAL_ATTN=pallas raises at the first step on the card; on the
    CPU both packages take a differentiable form (the reference's K4 is
    TPU-only, the port's CPU path its plain version)."""
    if args.fsdp > 1 and mesh is None:
        raise ValueError(
            f"--fsdp {args.fsdp} shards over several processes: launch with "
            "python -m torch.distributed.run --nproc_per_node N ... (N a "
            "multiple of --fsdp)")
    device = torch.device(args.device)
    size_kw = {}
    if args.unet_channels:
        size_kw["block_out_channels"] = tuple(args.unet_channels)
        size_kw["num_attention_heads"] = tuple(
            args.unet_heads or [max(1, c // 64) for c in args.unet_channels])
    unet_cfg = UNetConfig(
        num_frames=args.sample_frames,
        action_strategy=args.action_strategy or None,
        action_input_channel=args.action_input_channel,
        dtype="bfloat16", param_dtype="float32",
        remat=args.gradient_checkpointing, **env_switches(), **size_kw)
    pipe = SVDPipeline(unet_cfg, VAE_CONFIG, CLIP_CONFIG, device=device)
    if args.unet_path:
        pipe.load_checkpoint_dirs(args.unet_path, args.svd_path)
    else:
        pipe.init_params(torch.Generator(device=device).manual_seed(args.seed))
    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        grad_accum_steps=args.grad_accum,
        use_ema=args.use_ema,
        conditioning_dropout=args.conditioning_dropout,
        train_params=args.train_params,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_total_steps=args.max_steps,
        optimizer=args.optimizer,
    )
    trainer = Trainer(pipe, tcfg, mesh=mesh)
    return pipe, trainer, trainer.init_state()


def accum_transform(grad_accum: int):
    """The reference's grad-accum batch: the batch repeated on a leading
    [A, ...] axis."""
    def transform(batch):
        if grad_accum > 1:
            batch = {k: np.broadcast_to(v[None], (grad_accum,) + v.shape).copy()
                     for k, v in batch.items()}
        return batch
    return transform


def main(argv=None):
    args = parse_args(argv)
    info = initialize_distributed(args.device)
    mesh = None
    if dist.is_initialized():
        world = info["process_count"]
        mesh = make_mesh(dp=world // args.fsdp, fsdp=args.fsdp)
        if is_primary():
            print(f"process group: backend {dist.get_backend()}, world {world}, "
                  f"mesh dp {world // args.fsdp} x fsdp {args.fsdp}", flush=True)
        if torch.device(args.device).type == "cuda":
            args.device = f"cuda:{torch.cuda.current_device()}"
    try:
        _train(args, mesh, info)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, mesh, info):
    from wiw_tpu_torch.data.dataset import TrajectoryDataset, WeightedDataset
    from wiw_tpu_torch.data.loader import PrefetchLoader
    from wiw_tpu_torch.train.checkpoints import CheckpointManager

    primary = is_primary()
    pipe, trainer, state = build(args, mesh)
    gen = GenerationConfig(height=args.height, width=args.width,
                           num_frames=args.sample_frames)
    ckpts = CheckpointManager(args.output_dir, args.checkpoints_total_limit,
                              async_save=args.async_checkpointing)
    if args.resume_from_checkpoint:
        step = (None if args.resume_from_checkpoint == "latest"
                else int(args.resume_from_checkpoint.rsplit("-", 1)[-1]))
        state.load_state_dict(ckpts.restore(step))
        if primary:
            print(f"resumed at step {state.step}")

    def save(step):  # every rank gathers; rank 0 writes
        sd = state.state_dict()
        if primary:
            ckpts.save(step, sd)

    ds_cls = WeightedDataset if args.weighted_dataset else TrajectoryDataset
    dataset = ds_cls(args.data_root, sample_frames=args.sample_frames,
                     width=args.width, height=args.height)

    from tensorboardX import SummaryWriter

    writer = SummaryWriter(args.output_dir) if primary else None
    generator = torch.Generator(device=trainer.device).manual_seed(args.seed)
    t0 = time.time()
    # each batch is assembled, transformed and copied to the device on the
    # loader's background thread, so batch N+1's copy overlaps step N
    global_batch = args.per_device_batch * info["process_count"]
    loader = PrefetchLoader(
        dataset, global_batch, args.max_steps,
        transform=accum_transform(args.grad_accum), place=trainer.place_batch,
        num_workers=args.loader_workers, prefetch_batches=2,
        rows=None if mesh is None else batch_rows(mesh, dist.get_rank(), global_batch))
    for batch in loader:
        if state.step >= args.max_steps:
            break
        metrics = trainer.train_step(state, batch, generator)
        step = state.step
        if step % 10 == 0 and primary:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step} loss {loss:.4f} ({dt / max(step, 1):.2f}s/step)")
            writer.add_scalar("train/loss", loss, step)
        if step % args.checkpointing_steps == 0 and step > 0:
            save(step)
        if args.validation_steps and step % args.validation_steps == 0 and step > 0:
            metrics_val = run_validation(pipe, gen, batch, mesh)
            if primary:
                for k, v in metrics_val.items():
                    writer.add_scalar(f"val/{k}", v, step)
                print(f"validation @ {step}: {metrics_val}")
        if step >= args.max_steps:
            break
    save(state.step)
    if primary:
        ckpts.wait()  # join the final (possibly async) write before exit
        writer.close()


def run_validation(pipe, gen, batch, mesh=None):
    """Inline validation: generate clips from the current parameters (the
    pipeline's UNet is the one that trains), conditioned on the batch's
    first frames, and score them against the ground-truth clips. Under a
    mesh every rank takes part: the clips are the first max(1, 2 // world)
    rows of every rank's batch, split over the mesh again by `generate`,
    and every rank gets the same metrics."""
    from wiw_tpu_torch.eval.metrics import evaluate_video_metrics

    px, acts = batch["pixel_values"], batch["actions"]
    if px.ndim == 6:  # grad-accum leading axis
        px, acts = px[0], acts[0]
    if mesh is None:
        n = min(2, px.shape[0])
        px, acts = px[:n], acts[:n]
    else:
        k = max(1, 2 // mesh.size())
        px, acts = gather_rows(mesh, px[:k]), gather_rows(mesh, acts[:k])
    vgen = dataclasses.replace(gen, num_inference_steps=8)
    video = pipe.generate(px[:, 0], vgen, actions=acts, mesh=mesh,
                          generator=torch.Generator(device=pipe.device).manual_seed(0))
    gt = px.float() * 0.5 + 0.5
    return evaluate_video_metrics(video, gt, metrics=("psnr", "ssim"))


if __name__ == "__main__":
    main()
