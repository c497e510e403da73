#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`wiw_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. the card: nvidia-smi name and power limit; TF32 off for matmul and cuDNN
  2. build: every CUDA kernel of the serving path, from wiw_tpu_torch/csrc
  3. kernels: each kernel against its plain PyTorch version on the same bf16
     inputs, at the shapes the serving path gives it (max/mean |error|
     against the stated tolerance, kernel ms vs plain ms by CUDA events)
  4. small-input reference: a tiny bf16 pipeline on the card against the
     same weights run in fp32 on the CPU (plain attention there)
  5. slice: the full-width SVDActionWorker (1.5 B-parameter UNet with
     micro_cond, bf16, random weights from a seed) answers two 576x1024,
     14-frame, 25-step requests with output 480x480; per request: seconds,
     denoise frames/s, output checks, peak memory and kernel launches
Then one JSON line with the kernels, the card line again, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports no jax and needs no network.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# K1 tolerance against the plain version: about two bf16 ulps of the
# output (the kernel rounds P to bf16 before PV, the plain version rounds
# the softmax weights; both round the output to bf16)
K1_ATOL, K1_RTOL = 2e-2, 1e-2
# the UNet's spatial self-attentions at 576x1024, 14 frames, CFG pair
# folded: (batch = 2 rows x 14 frames, heads, S, calls per UNet forward)
K1_SHAPES = [(28, 5, 9216, 5), (28, 10, 2304, 5), (28, 20, 576, 5),
             (28, 20, 144, 1)]
STEPS = 25
FRAMES = 14
# small-input phase: frames in [0, 1] from a bf16 card run vs an fp32 CPU
# run. bf16 alone drifts this tiny random-weight pipeline by max 0.045 /
# mean 0.0057 (the CPU's own bf16 path against fp32); the bounds are ~3x
# that, well below the tens-of-percent error of a wrong kernel or layout
SMALL_ATOL, SMALL_MEAN_ATOL = 0.15, 0.02


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(flash_attention, flash_attention_plain, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    worst, total_ms, total_plain_ms = 0.0, 0.0, 0.0
    for B, H, S, calls in K1_SHAPES:
        # q, k, v as head views of [B, S, H*64] projections, as in the UNet
        q, k, v = (torch.randn(B, S, H * 64, generator=g, device=dev,
                               dtype=torch.bfloat16).view(B, S, H, 64)
                   .transpose(1, 2) for _ in range(3))
        chunk = max(1, int(2e9 // (H * S * S * 4)))  # fp32 logits per chunk

        def plain():
            return torch.cat([flash_attention_plain(q[i:i + chunk], k[i:i + chunk],
                                                    v[i:i + chunk])
                              for i in range(0, B, chunk)])

        out = flash_attention(q, k, v)
        ref = plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        bound = K1_ATOL + K1_RTOL * ref.float().abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        ok = bool((err <= bound).all())
        reps = max(3, int(3e4 // S))
        # alternate plain, kernel, kernel, plain on one card
        p1 = cuda_ms(plain, 2)
        k1 = cuda_ms(lambda: flash_attention(q, k, v), reps)
        k2 = cuda_ms(lambda: flash_attention(q, k, v), reps)
        p2 = cuda_ms(plain, 2)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        tflops = 4 * B * H * S * S * 64 / ms / 1e9
        print(f"K1 B*H={B * H} S={S} D=64: max|err| {max_err:.6g} "
              f"mean|err| {mean_err:.6g} (tol {K1_ATOL} + {K1_RTOL}*|ref|) "
              f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms",
              flush=True)
        if not ok:
            raise RuntimeError(f"K1 disagrees with its plain version at S={S}")
        worst = max(worst, max_err)
        total_ms += calls * ms
        total_plain_ms += calls * plain_ms
        del q, k, v, out, ref, err, bound
    print(f"K1 per UNet forward (16 calls): kernel {total_ms:.4f} ms, "
          f"plain {total_plain_ms:.4f} ms", flush=True)
    return worst, total_ms, total_plain_ms


def small_reference_phase(dev):
    """Tiny bf16 pipeline on the card vs the same weights in fp32 on the CPU
    (where attention takes the plain version)."""
    from wiw_tpu_torch.core.schedule import SERVING_CFG
    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

    unet = UNetConfig(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                      layers_per_block=1, cross_attention_dim=32, num_frames=3,
                      action_strategy="micro_cond", action_input_channel=3)
    vae = VAEConfig(block_out_channels=(32, 64), layers_per_block=1)
    clip = CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                            num_heads=2, patch_size=32, projection_dim=32)
    gen = GenerationConfig(height=64, width=64, num_frames=3,
                           num_inference_steps=4, noise_aug_strength=0.0,
                           cfg=SERVING_CFG)
    cpu = SVDPipeline(unet, vae, clip, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    card = SVDPipeline(*(dataclasses.replace(c, dtype="bfloat16")
                         for c in (unet, vae, clip)), device=dev)
    card.load_state_dicts(cpu.unet.state_dict(), cpu.vae.state_dict(),
                          cpu.clip.state_dict())
    # the CPU reference keeps fp32 compute on the card's bf16-rounded weights
    for tower, ref in ((card.unet, cpu.unet), (card.vae, cpu.vae),
                       (card.clip, cpu.clip)):
        ref.load_state_dict({k: v.float().cpu() for k, v in
                             tower.state_dict().items()})
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 3, 32, 32, 4)).astype(np.float32))
    actions = torch.tensor([[4, 2, 1]])
    before = card_launches()
    got = card.generate(image, gen, actions, init_latents=noise,
                        generator=torch.Generator(device=dev).manual_seed(1))
    ref = cpu.generate(image, gen, actions, init_latents=noise,
                       generator=torch.Generator().manual_seed(1))
    diff = (got.float().cpu() - ref).abs()
    print(f"small input (3f 64x64, 4 steps): card bf16 vs CPU fp32 "
          f"max|diff| {diff.max().item():.6g} mean|diff| {diff.mean().item():.6g} "
          f"(tol {SMALL_ATOL} / mean {SMALL_MEAN_ATOL}); K1 launches "
          f"{card_launches() - before}", flush=True)
    if not (torch.isfinite(got).all() and diff.max() <= SMALL_ATOL
            and diff.mean() <= SMALL_MEAN_ATOL):
        raise RuntimeError("small-input card run disagrees with the CPU reference")


def card_launches() -> int:
    from wiw_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention.launches


def slice_phase(dev):
    from wiw_tpu_torch.ops.flash_attention import flash_attention
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    t0 = time.perf_counter()
    worker = SVDActionWorker(
        width=1024, height=576, num_frames=FRAMES, num_inference_steps=STEPS,
        out_width=480, out_height=480, action_strategy="micro_cond",
        action_input_channel=14, dtype="bfloat16", quantize="bf16",
        cfg_schedule="serving", device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in worker.pipe.unet.parameters())
    print(f"worker built: UNet {n_params / 1e9:.3f} B params, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # device-side probes: denoise window (first UNet call -> last), and a
    # finiteness flag over every UNet and decoder output, read after each
    # request (no sync inside the request)
    marks = {}
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def pre(_m, _a):
        if "start" not in marks:
            marks["start"] = torch.cuda.Event(enable_timing=True)
            marks["start"].record()

    def post(_m, _a, out):
        finite.logical_and_(torch.isfinite(out).all())
        marks["end"] = torch.cuda.Event(enable_timing=True)
        marks["end"].record()

    def decoded(_m, _a, out):  # a hook that returns a value replaces the output
        finite.logical_and_(torch.isfinite(out).all())

    worker.pipe.unet.register_forward_pre_hook(pre)
    worker.pipe.unet.register_forward_hook(post)
    worker.pipe.vae.decoder.register_forward_hook(decoded)

    rng = np.random.default_rng(0)
    request = {
        "b_action": np.array([[4, 1, 1, 2, 2, 1, 3, 3, 1, 1, 2, 1, 3, 1]]),
        "b_image": rng.integers(0, 256, (1, 3, 576, 1024), dtype=np.uint8),
        "save_dirs": ["unused"],
        "request_model_name": "igenex",
        "return_objects": [True],
    }
    per_request = 16 * STEPS
    flash_attention.launches = 0  # count the main path only
    for i in range(2):
        marks.clear()
        torch.cuda.reset_peak_memory_stats()
        before = flash_attention.launches
        t = time.perf_counter()
        out = worker(request)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        frames = out["pred_frames"]
        denoise_s = marks["start"].elapsed_time(marks["end"]) / 1e3
        delta = flash_attention.launches - before
        print(f"request {i}: {secs:.3f} s, denoise {denoise_s:.3f} s = "
              f"{FRAMES / denoise_s:.4f} frames/s, pred_frames {frames.shape} "
              f"{frames.dtype}, finite {bool(finite)}, "
              f"std {frames.std():.3f}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"K1 launches {delta}", flush=True)
        if frames.shape != (1, FRAMES, 3, 480, 480) or frames.dtype != np.uint8:
            raise RuntimeError(f"bad pred_frames {frames.shape} {frames.dtype}")
        if not bool(finite) or frames.min() == frames.max():
            raise RuntimeError("non-finite or constant output")
        if delta != per_request:
            raise RuntimeError(f"{delta} K1 launches, expected {per_request}")
    return flash_attention.launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from wiw_tpu_torch.ops import native
    from wiw_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    native.load_library("flash_attn_fwd")
    ptxas = [ln.strip() for ln in native.build_info["flash_attn_fwd"][1].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build flash_attn_fwd (sm_90a): {time.perf_counter() - t0:.2f} s; "
          + "; ".join(ptxas), flush=True)

    max_err, ms, plain_ms = kernel_phase(flash_attention, flash_attention_plain, dev)
    small_reference_phase(dev)
    launches = slice_phase(dev)

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd_d64", "route": "cuda",
        "source": "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "wiw_tpu/ops/pallas_attention.py:121",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
