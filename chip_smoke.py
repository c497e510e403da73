#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`wiw_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. the card: nvidia-smi name and power limit; TF32 off for matmul and cuDNN
  2. build: every CUDA kernel of the serving and training paths, from
     wiw_tpu_torch/csrc, one nvcc per source, all at once (ptxas
     registers/spills printed; fails if ptxas serialises the wgmma of K7,
     K5/K6, K10 or K1 (with K2's and K9's modes), or spills in any of them
     but K7, or in K8 or K4)
  3. kernels: K1 (flash attention), K2 (the reference's v1 attention, with
     and without unroll2, at S = 9216 and 144: both launch K1's kernel and
     must give the same bits), K4 (frame attention), K5, K6
     and K6-bf16 (fused GEGLU feed-forward, fp32 and bf16 gate) each against
     its plain PyTorch version on the same bf16 inputs at the shapes the
     serving path gives it (max/mean |error| and relative Frobenius error
     against the stated tolerance, which scales with the plain output;
     K6-bf16 also differs from K6 and equals its own plain version at more
     elements than it equals K6's; for K5, K6 and K6-bf16 also `ffn_plan`'s
     choice and cluster size, TFLOP/s, the gate's CUDA-core floor (an
     estimate) beside the bound, and the device time by kernel name);
     kernel, plain and library-call ms by CUDA events in turns (plain,
     kernel, kernel, plain); the least time the card could take (bound) from
     the bytes and flops of each call; the device kernels the library call
     ran at the largest shape
  4. small-input reference: a tiny bf16 pipeline on the card, in the default,
     the fused-kernel and the W8A8 configuration, against the same weights
     run in fp32 on the CPU (plain versions there; W8A8 with the same int8
     weights)
  5. slices: the full-width SVDActionWorker (1.5 B-parameter UNet with
     micro_cond, bf16, random weights from a seed) answers 576x1024,
     14-frame requests with output 480x480: one 25-step request in the
     default configuration, one 10-step request (a cut depth) in the
     fused-kernel one (fused_ff, temporal_attention='pallas'), one in the
     fused one with WIW_FUSED_FF_GATE=bf16 (K6-bf16); per request: seconds, denoise
     frames/s, output checks, peak memory and each kernel's launches (counts
     set to 0 just before a path and read just after; K8's must equal the
     GroupNorm calls, counted by hooks); then one 2-row UNet forward of each
     configuration under torch.profiler (device time by op)
  5b. K8 (GroupNorm + SiLU), after the default slice: at every distinct
     GroupNorm shape that slice's request and its profiled 2-row forward
     ran (collected by hooks), with and without SiLU, against the plain
     version; kernel, plain and library ms (`F.group_norm` on the
     [N, C, L] view, its internal layout copy included, then `F.silu`),
     and the kernel's device time by torch.profiler (`device_ms`: the
     event-timed loop of a small shape is bound by the host's dispatch;
     the kernels' time over the launches the profiler recorded), the bound
     (one read and one write of x where one (row, group) slab of x,
     L x C/G values, fits in the 50 MB L2, two reads and one write where
     not) and the copy kernel's GB/s at each shape, `k8_plan`'s path,
     slab and cluster, and a table of them by shape; sums over a 2-row
     forward and over a request; on both paths a row alone against the
     same row batched between two rows offset by 1e4 (bit-equal), and in
     fp32 against float64: |mean|/std ~ 1200, and rows whose mean and
     scale change along the positions with a partial last block
  5c. W8A8 int8 (`SVDActionWorker(quantize="int8")`): one full-width
     request through K7 (the int8 kernel count, seconds, denoise frames/s,
     peak, launches: K7's must equal the int8 layers' calls, counted by
     hooks; the decoded frames' PSNR against the default request's, same
     seed and weights: random weights, so no quality figure), a profiled
     2-row forward, the feed-forwards where K6 steps aside for int8, then
     K7 (dense and conv) at every int8 shape of that request and forward
     and at the VAE decoder's largest conv (`quantize_vae`), against its
     plain version (exact int32 sums in float64: the bits must be equal),
     with `torch._int_mm` on the same int8 operands as the dense library
     call (the product alone); each call's device time split by
     torch.profiler into the quantisation passes (quant_rows; amax_abs,
     quant_tensor) and the product (w8a8_wgmma), with the product's TOPS
     and the share of the bound
  5d. K9 (the attention ablations floor, noexp, v2) and K10 (int8 q k^T,
     bf16 and int8 PV) at the reference probes' shape, B*H 140, S 9216,
     against their plain versions at the kernels' kv block width (128:
     K1's stage for K9, K10's own); K10's repack of v and its kernel
     timed apart, and the probe's decision ratio, K9-v2's time over K10's,
     against its bar of 1.15
  5e. serve (after the fused slices): the WM server's default path as
     `python -m wiw_tpu_torch.serve.server_cli --wm_type igenex` builds it
     (`build_executors` with the CLI's defaults: the continuous executor's
     4 slots, W8A8 int8, 30 steps, SERVING_CFG, warmup of batch 1, which
     also builds every kernel), a `ManagerServer` on a free local port and
     two `WMClient` threads of 2 candidates each, the second ~3 ticks after
     the first; each answer [2, 14, 3, 480, 480] uint8; per tick (8 UNet
     rows, or 4 in a cond-only tail tick) CUDA events and the K1 / K7 / K8
     launches against 16 and the int8 layer and GroupNorm calls counted by
     hooks in that tick; each request's seconds, the tick counts and the
     tail share, served frames/s, `phase_s`, peak memory; then K8 and K7
     held to their plain versions at every shape that run gave them (112
     and 56 rows, the whole-clip 14-frame decode); then the engine held to
     the pipeline in bf16 (one request alone in the 4-slot pool against
     `SVDPipeline.denoise` from the same initial latents); one full-width
     action_block request (K1 32 a forward) and one igenex_manip request
     (448x448, [1, 14, 8] poses), int8, at a cut depth
  5e'. manip: the manipulation benchmark's igenex arms as `python -m
     wiw_tpu_torch.manip.run_manip --env fake` runs them, against a
     continuous 4-slot engine (`server_cli.make_continuous_executor`)
     around that igenex_manip worker behind a `ManagerServer`, and a policy
     server whose subprocess worker is `python -m
     wiw_tpu_torch.workers.diff_policy --fake_pipe` (`server_cli
     --external_cmd`): one episode of --solver_env vlm-igenex (3 candidates
     a request) and one of diff-igenex --max_plan_rounds 1; each tick's
     K1 / K7 / K8 launches against hooks, every WM answer [B, 14, 3, 480,
     480] uint8, every policy answer with proposals, the result files; s an
     episode and a planning round, the requests, the shares of the wall time
     waiting on each server and on the host, the peak
  5f. rollouts: the serving target, 8 concurrent closed-loop agent
     rollouts: 8 threads of the port's `serve.benchmarks.run_benchmark`
     (heuristic candidates -> WM request -> pick -> step; 2 decision steps
     of 2 candidates, 14 frames) against `server_cli`'s default engine (4
     slots, int8, SERVING_CFG) at 10 steps (a cut depth); every answer
     [2, 14, 3, 480, 480] uint8, no error, no worker restart, each tick's
     K1 / K7 / K8 launches against hooks; the benchmark's own keys
     (rollout steps/s, latency p50 / p95), served frames/s, the tick
     figures, the idle-slot share, phase_s and the peak
  5f'. solvers, on the rollouts' server: the solvers' warps at full size on
     the card against the CPU (`aligned_front_crops` of a 14-frame
     576x1024 uint8 clip with its mask channel to 384x512,
     `cube_to_equirect` from 6 faces of 512^2 to 576x1024,
     `get_perspective_views` at 512, A-EQA's `annotated_surround_views`
     of a 576x1024 pano to 4 views of 256^2 at hfov 105: the largest
     difference in uint8 steps and the share of values that differ against
     WARP_SHARE, ms a call by CUDA events, device operations a call), and
     `geo.pointcloud.compute_window_void_ratios` on 14 depth faces of 512^2
     against the CPU (VOID_RATIO_PIXELS, ms, operations); then `run_solver
     --task AR`, `--task IGNav` and `--task AEQA` (the CLI's `main`: 2
     episodes each, --simulator fake --use_heur --wm_type igenex, cut by
     --max_action_num to 1 decision step an episode; IGNav's LPIPS reward
     from random upstream-layout weights; A-EQA with --use_wm_imagination
     --use_detector against a gd_sam2 server built as `server_cli
     --server_type gd_sam2 --external_cmd "python -m
     wiw_tpu_torch.workers.grounding_worker"` builds it, its fake
     simulator given a constant depth), each episode's metrics.jsonl
     counted, every episode's exception recorded, no error in the
     manager's stats, every detector request served, K1 / K7 / K8
     launched, the LPIPS calls, A-EQA's backprojection and surround views
     on the card; s an episode and a decision step, the WM and detector
     requests served, the shares of the wall time in warps, in waiting on
     the server and on the detector, IGNav's ranking and strips
  5f''. habitat: `run_solver --task AR --simulator habitat` on the same
     server under the habitat-sim double (tests/habitat_sim_double.py,
     installed as `habitat_sim` for the phase: habitat-sim is not on the
     card's host), one episode, --use_heur --max_action_num 1; the panos
     576x1024 from 512^2 faces, each warped on the card
  5f'''. collect: `python -m wiw_tpu_torch.data.collect_cli` (`main`) at its
     defaults (512^2 faces to a 1000x2000 pano, warped on the card) on one
     scene of the double, 6 points and one trajectory; one pano of the same
     faces on the card against the CPU (at most one uint8 step), its ms by
     CUDA events and its device operations; the port's
     `data/dataset_utils` reads the tree; s a step with its PNG writes, the
     double's render share, the steps and files written
  5g. eval: a trajectory tree (2 clips of 14 PNG frames at 576x1024),
     random LPIPS and I3D weights in the upstream layouts named by
     WIW_LPIPS_WEIGHTS / WIW_I3D_WEIGHTS; `eval.inference_cli` at full
     width and 10 steps (random weights: the metrics check the route, not
     quality) whose metrics.json must hold psnr, ssim, lpips and fvd;
     `eval.video_metrics_cli --fvd` on PNG directories of the same frames
     (the same numbers); I3D features, LPIPS distances and
     `frechet_distance` on the card against the CPU (tolerances stated
     below)
  5h. past_images + alt: one full-width request through
     `SVDPipeline.generate` with Np = 2 past images and the 'alt' CFG tail
     (odd), 10 steps; seconds, peak, K1's launches against the count hooks
     make; then K1 against its plain version at Skv = 3 and at the
     temporal fold of level 0, split into two launches (B*H 92160 > 65535)
     (the small-input phase also runs past_images + alt, tiny, against the
     CPU in fp32)
  5i. nwm: the NWM world model (CDiT-XL/2, 1.0 B parameters, 224x224,
     context 4, bf16, random weights from a seed): K1's head_dim 72
     instance at the CDiT's shapes (self-attention B*H 32, Sq = Skv = 196;
     cross-attention Skv 785) and at S 2304 against its plain version,
     with kernel, plain, SDPA and device ms and the bound; one request (2
     candidates x 14 actions, 13 rollouts of 20 DDIM steps) through
     `NWMWorker` in-process: seconds, generated frames/s, peak, K1-D72 and
     K8 launches against the attention and GroupNorm calls counted by
     hooks; a CDiT forward's ms and TFLOP/s, one profiled DDIM step
     (device busy, idle share, top kernels); the bf16 forward against an
     fp32 forward of the same weights with the plain attention (CDIT_REL_FRO,
     errors by block); K8 at every GroupNorm shape of the request (the VAE
     encoder and single-frame decoder at 224x224); then `server_cli
     --wm_type nwm`, which must refuse to run without --external_cmd and
     with `--external_cmd "python -m wiw_tpu_torch.workers.nwm_worker"`
     answers two concurrent requests from `WMClient`s with [2, 14, 3, 480,
     480] uint8 through the subprocess worker, then stops it
  6. training: K1 with its LSE output and K3 (flash-attention backward) at
     the four training shapes against the plain forward, LSE and backward
     (K1's output bits the same with and without the LSE), K6's gradients
     against autograd through its plain version, then the training slice:
     `train_cli.build` with the reference recipe at full width (fp32
     parameters computing in bf16, remat, grad-accum 2, AdamW, clip 1.0,
     discrete dropout, EMA), 3 optimizer steps on 576x1024 14-frame clips
     from an in-memory dataset through the port's PrefetchLoader; per step:
     seconds, loss, peak memory and the K1/K3/K8 launches, then clips/s,
     the model-FLOPs utilisation and the checkpoint snapshot's seconds
  7. optim, on the training slice's pipeline: 2 steps each of adamw_bf16m
     and adafactor (s/step, peak, optimizer-state GiB, the first moment's
     dtype, optimizer.step ms, the K1/K3/K8 launches of every step) beside
     AdamW's, then one step of each of the three optimizers on real UNet
     leaves on the card against the CPU (OPT_LEAF_ATOL, OPT_MU_REL)
  8. dist, last: a 1-rank NCCL group in this process and make_mesh(1, 1);
     an FSDP2-sharded step of the training recipe against an unsharded one
     from the same seed and generator (DIST_* tolerances), a timed second
     step of each; generate(mesh=) against generate (DIST_GEN_ATOL); then
     `python -m torch.distributed.run --nproc_per_node 1 -m
     wiw_tpu_torch.train.train_cli` at a cut width (NCCL, validation, a
     rank-0 checkpoint that must load into an unsharded TrainState)
  9. shard_clip, last: the split entries at a rank's shapes at fsdp 2 and 4
     (`split_checks`: K8-stats on each shape, with its plan, GB/s and
     bound, its statistics against the plain version within STATS_RTOL and
     equal to the bit over two calls, one launch a call; K8-combine of the
     shards' parts against its plain version; K8-apply; K7-amax on the
     level-0 shard and on a decoder-sized tensor, bit for bit, beside
     `torch.linalg.vector_norm(ord=inf)`; K7-conv with the amax given; K1
     on a padded head shard), then on a 1-rank NCCL group and make_mesh(1,
     1) one request through `generate` and `generate(shard_clip=True)` in
     bf16 and W8A8 (s/request, peak, the latents apart, every split
     entry's launches), in bf16 one request of each traced (device time by
     kernel class, device idle), one split 2-row forward against the whole
     and its device events beside the whole forward's and the previous
     design's count,
     one split GroupNorm layer's device events in order, and the
     frame-parallel decode's peak
Then one JSON line with each kernel's time before this version of the
kernels (`prev_kernels`, copied from PERF.md, not measured here), one JSON
line with the kernels as this run measured them, the card line again, and
last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports no jax and needs no network.
"""

import dataclasses
import functools
import gc
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# every kernel against its plain version, scaled by the plain output (K1's
# shrinks as 1/sqrt(S): rms 0.017 at S = 9216): each element within
# ATOL_RMS * rms(ref) + RTOL * |ref| (RTOL: two bf16 ulps at worst), and
# ||out - ref|| / ||ref|| within REL_FRO over the whole output, so that a
# fault which moves every element by a little (a mis-scaled row sum) fails
# too. Both sides round to bf16 at the same places but sum in another order;
# K1 rounds P where its plain version rounds the softmax weights.
ATOL_RMS, RTOL, REL_FRO = 0.05, 2.0 ** -6, 5e-3
STEPS = 25
# the fused-kernel slices run at a cut depth, to leave the script's time to
# the serve phase; their per-forward figures do not depend on it
FUSED_STEPS = 10
FRAMES = 14
# the UNet's spatial self-attentions at 576x1024, 14 frames, CFG pair
# folded: (batch = 2 rows x 14 frames, heads, S, calls per UNet forward)
K1_SHAPES = [(28, 5, 9216, 5), (28, 10, 2304, 5), (28, 20, 576, 5),
             (28, 20, 144, 1)]
# frame attentions with S % 64 == 0 (levels 0-2): (rows, F, S, heads, calls)
K4_SHAPES = [(2, 14, 9216, 5, 5), (2, 14, 2304, 10, 5), (2, 14, 576, 20, 5)]
# feed-forwards with C <= 640 (levels 0-1): (rows x 14 x S, C, calls); five
# transformers per level, three feed-forwards each
FF_SHAPES = [(2 * 14 * 9216, 320, 15), (2 * 14 * 2304, 640, 15)]
# launches per UNet forward (one forward a step, whether of 2 rows or, in
# the stale tail, 1): 16 / 15 / 30; every other counter 0, but K8's, which
# must equal the GroupNorm calls, and K7's, which must equal the int8
# layers' calls
PER_FORWARD = {"default": {"K1": 16},
               "fused": {"K1": 16, "K4": 15, "K6": 30},
               "fused-bf16": {"K1": 16, "K4": 15, "K6-bf16": 30},
               "int8": {"K1": 16}}
# K2 (no model caller): the level-0 and level-3 spatial attentions
K2_SHAPES = [K1_SHAPES[0][:3], K1_SHAPES[3][:3]]
# the same attentions when training at batch 1 (one row of 14 frames):
# (batch = 14 frames, heads, S, calls per UNet forward)
K3_SHAPES = [(FRAMES, H, S, calls) for _, H, S, calls in K1_SHAPES]
# K1's LSE is fp32 sums of fp32 exponentials in another order than its plain
# version's: within 2e-3 of values ~log(S) (a wrong scale or a dropped tile
# moves it by > 0.1)
LSE_ATOL = 2e-3
TRAIN_STEPS, TRAIN_ACCUM = 3, 2
# launches per optimizer step: each micro-batch runs the 16 spatial
# attentions forward, and again in the backward pass (remat), then 16
# backwards; every other counter 0, but K8's (the GroupNorm calls)
PER_STEP = {"K1": TRAIN_ACCUM * 2 * 16, "K3": TRAIN_ACCUM * 16}
# the optim phase: steps of adamw_bf16m and adafactor after the train
# phase's AdamW. Card against CPU, one step of each optimizer on real UNet
# leaves at lr 1e-3 (an update of up to 1e-3 an element): the parameters
# within 1e-6 (fp32 in another order, fused multiply-adds: ulps of the
# update and of a weight ~0.1), adamw_bf16m's first moment within one bf16
# step (2^-7 of its value)
OPTIM_STEPS = 2
OPT_LEAF_ATOL, OPT_MU_REL = 1e-6, 2.0 ** -7
# the dist phase: the world-size-1 sharded step against the unsharded one
# from the same weights and draws. The forward is the same computation;
# K3's dQ sum order changes from run to run and bf16 roundings carry it on,
# and AdamW's first update is lr * g / (|g| + eps), the gradient's sign: an
# element whose gradient lies within that noise of zero may move 2 lr the
# other way. So the loss within 1e-5 relative, the gradient norm within
# 1e-3, every parameter within 2 lr + 1e-6 of the unsharded step's and at
# most 1% of them further than 1e-6. generate(mesh=) at world size 1 is the
# same computation as generate: its frames within 1e-3 (a wrong cut of the
# rows or the noise moves them by ~0.1)
DIST_LOSS_REL, DIST_NORM_REL, DIST_FAR_SHARE = 1e-5, 1e-3, 0.01
DIST_GEN_STEPS, DIST_GEN_ATOL = 10, 1e-3
# tensorboardX, which train_cli imports as the reference's does, is not on
# the card's host: the dist phase runs the CLI with this stand-in
TENSORBOARD_STANDIN = '''"""A stand-in for tensorboardX: scalars as JSON lines."""
import json
import os


class SummaryWriter:
    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\\n")

    def close(self):
        self._f.close()
'''
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_S, BF16_FLOPS_S, FP32_FLOPS_S = 3.35e12, 989e12, 67e12
INT8_OPS_S = 1979e12
# K9 and K10 at the reference probes' shape (scripts/tune_attention2.py,
# scripts/probe_int8_attention.py): B, H, S; K10's qk_scale as the probe's
K9_SHAPE = (28, 5, 9216)
K10_QK_SCALE = 1e-3
# small-input phase: frames in [0, 1] from a bf16 card run vs an fp32 CPU
# run. bf16 alone drifts this tiny random-weight pipeline by max 0.045 /
# mean 0.0057 (the CPU's own bf16 path against fp32); the bounds are ~3x
# that, well below the tens-of-percent error of a wrong kernel or layout
SMALL_ATOL, SMALL_MEAN_ATOL = 0.15, 0.02
FUSED = dict(fused_ff=True, temporal_attention="pallas")
INT8 = dict(quantize="int8")
# the small-input phase in W8A8: the int8 forward is chaotic at the level of
# activation codes (a ~1e-7 difference moves a code by one step of
# amax/127 and the next int8 layers carry it on; between two fp32
# implementations at this size the CPU tests measure max 0.1 / mean 0.009),
# on top of bf16's drift: twice the bf16 bounds
INT8_SMALL_ATOL, INT8_SMALL_MEAN_ATOL = 0.3, 0.04
# K8 against float64 at |mean|/std ~ 1200 (fp32 input), the CPU test's bound
ILL_ATOL = 2e-3
# the H100's L2 (data sheet): K8's floor is one read of x where one (row,
# group) slab (the unit its statistics cover, L x C/G values) fits here,
# two where it does not
L2_BYTES = 50 * 2 ** 20


# each row's time as PERF.md §6 recorded it before this version of the
# kernels (runs of this script on an H100 80GB HBM3 at 700 W; K6 and
# K6-bf16: the mma.sync kernel's; K4 and K8: the eight-lane fp32 K4's and
# the three-launch K8's; K2-unroll2, K10 and K10-i8pv: the mma.sync
# kernels'; K5, K9-floor and K9-noexp: the mma.sync kernels', PR 10's run
# 1; K8-stats and K7-amax: their first designs, at commit bdf6e88); K1-D72,
# K8-combine, K8-apply and K7-conv-given are on their first: none), printed
# on a line of its own before the measured `kernels` line
PREV_MS = {"K1": 99.0636, "K1-D72": None, "K2": 17.1462, "K2-unroll2": 18.9899,
           "K3": 150.7475, "K4": 7.4117, "K5": 247.7191, "K6": 275.2729, "K6-bf16": 363.8384,
           "K8": 14.1938, "K7-dense": 64.8478, "K7-conv": 91.8242,
           "K9-floor": 13.6274, "K9-noexp": 14.8971, "K9-v2": 17.7919,
           "K10": 30.4349, "K10-i8pv": 30.1989, "K8-stats": 1.1223, "K8-combine": None,
           "K8-apply": None, "K7-amax": 0.0754, "K7-conv-given": None}
PREV_FROM = "PERF.md §6, the time before this version (H100 80GB HBM3, 700 W)"


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


def self_dev(e) -> float:
    """A profiler event's own device time, us (the name changed in torch 2.4)."""
    if hasattr(e, "self_device_time_total"):
        return e.self_device_time_total
    return e.self_cuda_time_total


def kernel_names(fn) -> str:
    """The top device kernels of one call of `fn`: which backend a library
    call took."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if self_dev(e) > 0),
                    key=self_dev, reverse=True)
    return "; ".join(f"{e.key[:70]} {self_dev(e) / 1e3:.2f} ms"
                     for e in events[:3])


def device_ms(fn, keys, reps: int, launches: int = 1) -> float:
    """Device time of one call of `fn` in the kernels whose names hold one
    of `keys`, from torch.profiler over `reps` calls: the kernels' own
    time, whatever the host's dispatch rate. The profiler may drop
    launches late in a long run, so the time is divided by the launches it
    recorded and multiplied by `launches`, the kernel launches of a call;
    a profile that recorded none is taken again, up to four times."""
    for _ in range(4):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if any(k in e.key for k in keys)]
        recorded = sum(e.count for e in events)
        if recorded:
            return sum(self_dev(e) for e in events) / 1e3 / recorded * launches
    raise RuntimeError(f"the profiler recorded no kernel named {keys} in four tries")


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / peak) * 1e3


def compare(name: str, out, ref, raises: bool = True) -> tuple[float, str]:
    """max |out - ref| and a line of the error against the tolerance;
    raises beyond it (see ATOL_RMS, RTOL, REL_FRO) unless `raises` is
    False."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    rms = ref.square().mean().sqrt().item()
    atol = ATOL_RMS * rms
    beyond = (err > atol + RTOL * ref.abs()).float().mean().item()
    rel_fro = (torch.linalg.vector_norm(out - ref)
               / torch.linalg.vector_norm(ref)).item()
    line = (f"max|err| {max_err:.6g} mean|err| {mean_err:.6g} rel_fro "
            f"{rel_fro:.6g} (tol {atol:.6g} + {RTOL:.6g}*|ref| with rms(ref) "
            f"{rms:.6g}, rel_fro {REL_FRO}; beyond: {beyond:.6g} of elements)")
    if raises and (beyond > 0 or rel_fro > REL_FRO):
        raise RuntimeError(f"{name} disagrees with its plain version: {line}")
    return max_err, line


class Row:
    """One kernel's line of the JSON summary, summed over the calls of one
    2-row UNet forward."""

    def __init__(self, name, source, replaces, per, library):
        self.d = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "per": per, "launches": 0,
                  "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None,
                  "library_ms": 0.0 if library else None}

    def add(self, calls, max_err, ms, plain_ms, bound, bound_by, library_ms=None):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], max_err)
        d["ms"] += calls * ms
        d["plain_ms"] += calls * plain_ms
        d["bound_ms"] += calls * bound
        d["bound_by"] = bound_by
        if d["library_ms"] is not None:
            d["library_ms"] += calls * library_ms


def timed(label, plain, kernel, library, reps, plain_reps, bound, rate):
    """Times in turns on one card: plain, kernel, kernel, plain (and the
    library call twice, after one untimed call: a backend such as cuDNN
    builds its plan for a new shape on the first call). `rate(ms)` says
    what the kernel's time achieves."""
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    lib = None
    if library:
        library()
        lib = cuda_ms(library, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    if library:
        lib = (lib + cuda_ms(library, reps)) / 2
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms, library "
          + (f"{lib:.4f} ms" if library else "none") + f" ({rate(ms)})",
          flush=True)
    return ms, plain_ms, lib


def k1_phase(row: Row, dev, g):
    import torch.nn.functional as F

    from wiw_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

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

        max_err, err_line = compare(f"K1 S={S}", flash_attention(q, k, v),
                                    plain())
        flops = 4 * B * H * S * S * 64
        bound = bound_ms(4 * B * H * S * 64 * 2, flops, BF16_FLOPS_S)
        ms, plain_ms, lib = timed(
            f"K1 B*H={B * H} S={S} D=64 {err_line}",
            plain, lambda: flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            max(3, int(3e4 // S)), 2, bound,
            lambda ms: f"{flops / ms / 1e9:.1f} TFLOP/s")
        if S == K1_SHAPES[0][2]:
            print("  its library call's kernels: " + kernel_names(
                lambda: F.scaled_dot_product_attention(q, k, v)), flush=True)
        row.add(calls, max_err, ms, plain_ms, bound, "operations", lib)
        del q, k, v


def k2_phase(rows: dict, dev, g):
    """K2, the reference's v1 attention (`flash_attention(kernel="v1")`),
    without and with unroll2, at K2_SHAPES on head views of [B, S, H*64]
    projections, against its plain version (chunked over the batch). Both
    launch K1's kernel and must give the same bits; at S = 144 (not a
    multiple of 128) unroll2 counts as v1, as the reference takes its
    one-block loop there."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import flash_attention as TFA

    for B, H, S in K2_SHAPES:
        q, k, v = (torch.randn(B, S, H * 64, generator=g, device=dev,
                               dtype=torch.bfloat16).view(B, S, H, 64)
                   .transpose(1, 2) for _ in range(3))
        chunk = max(1, int(2e9 // (H * S * S * 4)))

        def plain():
            return torch.cat([TFA.flash_attention_v1_plain(
                q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                for i in range(0, B, chunk)])

        ref = plain()
        flops = 4 * B * H * S * S * 64
        bound = bound_ms(4 * B * H * S * 64 * 2, flops, BF16_FLOPS_S)
        outs = {}
        for key, unroll2 in (("K2", False), ("K2-unroll2", True)):
            def kernel(unroll2=unroll2):
                return TFA.flash_attention(q, k, v, kernel="v1", unroll2=unroll2)

            outs[key] = kernel()
            max_err, err_line = compare(f"{key} S={S}", outs[key], ref)
            ms, plain_ms, lib = timed(
                f"{key} B*H={B * H} S={S} D=64 {err_line}", plain, kernel,
                lambda: F.scaled_dot_product_attention(q, k, v),
                max(3, int(3e4 // S)), 2, bound,
                lambda ms: f"{flops / ms / 1e9:.1f} TFLOP/s")
            rows[key].add(1, max_err, ms, plain_ms, bound, "operations", lib)
        # unroll2's pair of 64-row blocks is one of K1's 128-row stages: the
        # same launch as v1's, so the same bits
        if not torch.equal(outs["K2"], outs["K2-unroll2"]):
            raise RuntimeError(f"K2-unroll2 at S={S} differs from K2's bits")
        print(f"K2-unroll2 S={S}: bit-equal to K2 (v1)", flush=True)
        del q, k, v, ref, outs


def k4_phase(row: Row, dev, g):
    import torch.nn.functional as F

    from wiw_tpu_torch.ops.temporal_attention import (
        frame_attention,
        frame_attention_plain,
    )

    for B, Fr, S, H, calls in K4_SHAPES:
        q, k, v = (torch.randn(B, Fr, S, H * 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        max_err, err_line = compare(f"K4 S={S}", frame_attention(q, k, v, H),
                                    frame_attention_plain(q, k, v, H))
        # q, k, v read once, o written once; fp32 FMA work on the CUDA cores
        nbytes, flops = 4 * q.numel() * 2, 4 * B * S * H * Fr * Fr * 64
        bound = bound_ms(nbytes, flops, FP32_FLOPS_S)
        # the library call sees (position, head) pairs as its heads and the
        # frames as its sequence: 4-D [B, S*H, F, 64] views, which its fused
        # backends take (5-D [B, S, H, F, 64] views fall to its math path)
        heads = [t.view(B, Fr, S * H, 64).transpose(1, 2) for t in (q, k, v)]
        ms, plain_ms, lib = timed(
            f"K4 [{B},{Fr},{S},{H * 64}] {err_line}",
            lambda: frame_attention_plain(q, k, v, H),
            lambda: frame_attention(q, k, v, H),
            lambda: F.scaled_dot_product_attention(*heads), 20, 3, bound,
            lambda ms: f"{nbytes / ms / 1e6:.0f} GB/s")
        if S == K4_SHAPES[0][2]:
            print("  its library call's kernels: " + kernel_names(
                lambda: F.scaled_dot_product_attention(*heads)), flush=True)
        row.add(calls, max_err, ms, plain_ms, bound, "bytes", lib)
        del q, k, v, heads


# the feed-forwards' gate on the CUDA cores, an estimate: operations a
# hidden value, counted from csrc/geglu_ffn.cu where the source spells them
# out (a bf16x2 instruction, add, product or packed conversion, 0.5 a
# value; a widening to fp32, an fp32 add, product, FMA, copysign,
# compare-select or approximate reciprocal 1) and costed where it calls
# libdevice (expf, and K6-bf16's IEEE reciprocal, 4 each; not counted): the
# bias adds and their roundings 2.5 (K6: on bf16x2) or 3 (K5: two fp32
# adds, one packed rounding), then the fp32 gate 29.5 (K5, K6: the
# reference's Abramowitz-Stegun erf in fp32, its reciprocal an rcp.approx
# and two FMAs) or the bf16 gate 25.5 (K6-bf16: the same erf on bf16x2
# instructions). Its floor is ops x M x I over the fp32 issue rate, one
# operation a lane a clock on 132 SMs: 33.5 T/s at 700 W. Printed beside
# the bound, not part of the `kernels` line
GATE_OPS = {"K5": 3 + 29.5, "K6": 2.5 + 29.5, "K6-bf16": 2.5 + 25.5}
FP32_OPS_S = 33.5e12


def device_by_kernel(fn, reps: int) -> dict:
    """Device time of one call of `fn` by kernel name, ms (torch.profiler
    over `reps` calls)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: self_dev(e) / 1e3 / reps for e in prof.key_averages()
            if self_dev(e) > 0}


def ffn_phase(k5: Row, k6: Row, k6_bf16: Row, dev, g):
    """K5, K6 and K6-bf16 at the UNet's two feed-forward shapes against
    their plain versions, timed in turns; K5's and K6's plans (`ffn_plan`)
    and cluster size, the TFLOP/s, the gate's CUDA-core floor beside the
    bound, and the device time by kernel name. Returns the gate floor a UNet
    forward, ms, of K5, K6 and K6-bf16."""
    from functools import partial

    from wiw_tpu_torch.ops import fused_mlp as TF

    gate_floors = dict.fromkeys(GATE_OPS, 0.0)
    for M, C, calls in FF_SHAPES:
        inner = 4 * C

        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        x = r(M, C).bfloat16()
        ln_w, ln_b = 1 + r(C, scale=0.1), r(C, scale=0.1)
        w1 = r(2 * inner, C, scale=C ** -0.5).bfloat16()
        b1 = r(2 * inner, scale=0.1).bfloat16()
        w2 = r(C, inner, scale=inner ** -0.5).bfloat16()
        b2 = r(C, scale=0.1).bfloat16()
        flops = 6 * M * C * inner  # two products: 2*M*C*2I + 2*M*I*C
        nbytes = 2 * (2 * M * C + 3 * inner * C)  # x, out; W1, W2 once
        bound = bound_ms(nbytes, flops, BF16_FLOPS_S)
        for key, residual in (("K6", True), ("K5", False)):
            plan = TF.ffn_plan(C, C, residual)
            print(f"{key} plan at C={C}, C_out={C}: {plan._asdict()}, cluster "
                  f"{TF.FFN_CLUSTER}", flush=True)
        lnff = (x, ln_w, ln_b, w1, b1, w2, b2)
        outs = {}
        for key, row, kern, plain, args in (
                ("K6", k6, TF.ln_geglu_ffn_residual, TF.ln_geglu_ffn_residual_plain,
                 lnff),
                ("K6-bf16", k6_bf16, partial(TF.ln_geglu_ffn_residual, gate="bf16"),
                 partial(TF.ln_geglu_ffn_residual_plain, gate="bf16"), lnff),
                ("K5", k5, TF.geglu_ffn, TF.geglu_ffn_plain, (x, w1, b1, w2, b2))):
            name = row.d["name"]
            outs[name] = out, ref = kern(*args), plain(*args)
            max_err, err_line = compare(f"{name} C={C}", out, ref)
            gate_floor = GATE_OPS[key] * M * inner / FP32_OPS_S * 1e3
            floor = (f", gate floor {gate_floor:.4f} ms ({GATE_OPS[key]} ops a "
                     f"value, estimated)")
            gate_floors[key] += calls * gate_floor
            ms, plain_ms, _ = timed(
                f"{name} M={M} C={C} inner={inner} {err_line}",
                lambda: plain(*args), lambda: kern(*args), None, 5, 3, bound,
                lambda ms: f"{flops / ms / 1e9:.1f} TFLOP/s{floor}")
            row.add(calls, max_err, ms, plain_ms, bound, "operations")
            split = device_by_kernel(lambda: kern(*args), 3)
            print(f"  {name} C={C} device time a call by kernel: " + "; ".join(
                f"{k[:60]} {v:.4f} ms" for k, v in
                sorted(split.items(), key=lambda kv: -kv[1])), flush=True)
        gate_check(outs[k6.d["name"]], outs[k6_bf16.d["name"]], M, C)
        del x, w1, w2, outs
    return gate_floors


def gate_check(k6, k6_bf16, M, C):
    """K6-bf16 ran its bf16-gate template: (kernel, plain) outputs of K6
    and K6-bf16 on the same inputs. The two gates move outputs by about an
    ulp, inside `compare`'s slack, so K6-bf16 must also differ from K6 and
    equal its own plain version at more elements than it equals K6's (a
    lost gate flag gives K6's bits, and so fails both)."""
    out, ref = k6_bf16
    same_own = (out == ref).float().mean().item()
    same_f32 = (out == k6[1]).float().mean().item()
    print(f"K6-bf16 M={M} C={C}: equal to its plain version at {same_own:.6g} "
          f"of elements, to K6's plain version at {same_f32:.6g}", flush=True)
    if torch.equal(out, k6[0]) or not same_own > same_f32:
        raise RuntimeError(f"K6-bf16 at C={C} did not compute the bf16 gate")


def k8_shape(key, calls: str, dev, g, sms: int) -> dict:
    """K8 at one GroupNorm shape `key` = (shape, dtype, groups, eps, silu)
    (`count_group_norms`' keys; `calls` says how often a path runs it):
    checked with and without SiLU against the plain version, then kernel,
    plain and library ms by events in turns, the device time by
    torch.profiler, the bound (one read and one write of x where one (row,
    group) slab fits in L2, a second read where not) and `k8_plan`'s path."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import group_norm as TG

    shape, dtype, groups, eps, silu = key
    N, C = shape[0], shape[-1]
    L = int(np.prod(shape[1:-1]))
    plan = TG.k8_plan(N, L, C, groups, dtype, sms)
    x = (torch.randn(*shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype)
    w = 1 + 0.2 * torch.randn(C, generator=g, device=dev)
    b = 0.3 * torch.randn(C, generator=g, device=dev)
    errs = {}
    for flag in (silu, not silu):
        errs[flag] = compare(f"K8 {shape} {dtype} silu={flag}",
                             TG.group_norm(x, w, b, groups, eps, flag),
                             TG.group_norm_plain(x, w, b, groups, eps, flag))
    nbytes = x.numel() * x.element_size()
    # a (row, group) slab's statistics precede its normalisation: a slab
    # that fits in L2 is read once from HBM, a larger one twice
    passes = 2 if L * (C // groups) * x.element_size() <= L2_BYTES else 3
    bound = bound_ms(passes * nbytes, 0, BF16_FLOPS_S)
    # the library call on the [N, C, L] view it wants, weights in x's
    # dtype (its kernel's rule); F.group_norm copies to its layout inside
    xt = x.reshape(N, -1, C).transpose(1, 2)
    wl, bl = w.to(dtype), b.to(dtype)

    def library():
        y = F.group_norm(xt, groups, wl, bl, eps)
        return F.silu(y) if silu else y

    reps = min(200, max(5, int(4e9 // nbytes)))
    copy, gb_s = "", None
    if dtype == torch.bfloat16 and x.numel() % 8 == 0:
        if not torch.equal(TG.copy_plus_one(x), x + 1):
            raise RuntimeError(f"copy_plus_one disagrees with x + 1 at {shape}")
        gb_s = 2 * nbytes / cuda_ms(lambda: TG.copy_plus_one(x), reps) / 1e6
        copy = f", copy kernel {gb_s:.0f} GB/s"
    where = (f"path {plan.path}, slab {plan.slab}, cluster {plan.cluster}"
             + ("" if plan.path == "R" else
                f", {plan.slabs_per_batch} slabs a batch, a row "
                f"{'within' if plan.resident else 'beyond'} the L2 share"))
    ms, plain_ms, lib = timed(
        f"K8 {list(shape)} {str(dtype)[6:]} G={groups} silu={silu} ({where}; "
        f"{calls}) " + errs[silu][1]
        + f" | other flag: max|err| {errs[not silu][0]:.6g}",
        lambda: TG.group_norm_plain(x, w, b, groups, eps, silu),
        lambda: TG.group_norm(x, w, b, groups, eps, silu), library,
        reps, 3, bound,
        lambda ms: f"{passes * nbytes / ms / 1e6:.0f} GB/s of its floor's "
                   f"{passes} passes{copy}")
    dev_ms = device_ms(lambda: TG.group_norm(x, w, b, groups, eps, silu),
                       KERNEL_CLASSES[0][1], min(reps, 20))
    print(f"  its device time (torch.profiler): {dev_ms:.4f} ms a call", flush=True)
    return {"plan": plan, "max_err": max(e for e, _ in errs.values()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib, "device_ms": dev_ms,
            "bound": bound, "passes": passes,
            "gb_s": passes * nbytes / dev_ms / 1e6, "copy_gb_s": gb_s}


def k8_phase(row: Row, forward: dict, request: dict, dev, g):
    """K8 at every distinct GroupNorm shape of `request` (a default
    request's calls, every tower) and `forward` (a 2-row UNet forward's):
    {(shape, dtype, groups, eps, silu): calls} (`count_group_norms`). Each
    shape is checked with and without SiLU against the plain version and
    timed with the path's flag; the row sums one 2-row forward,
    `request_ms` one request; then a table by shape with `k8_plan`'s path,
    and its sums by path."""
    d = row.d
    d["request_ms"] = d["request_plain_ms"] = d["request_bound_ms"] = 0.0
    d["request_library_ms"] = d["device_ms"] = d["request_device_ms"] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    copy_gb_s, table = [], []
    print("K8: library = F.group_norm on the [N, C, L] view of x (its internal "
          "copy to its layout included), then F.silu where the path has it; "
          "bound = x read once (twice where one (row, group) slab of x, L x "
          "C/G values, exceeds the 50 MB L2) and y written once, over 3.35 "
          "TB/s; device time by torch.profiler over the launches it recorded",
          flush=True)
    for key in sorted(set(forward) | set(request),
                      key=lambda k: -int(np.prod(k[0]))):
        fwd, req = forward.get(key, 0), request.get(key, 0)
        r = k8_shape(key, f"{fwd} a 2-row forward, {req} a request", dev, g, sms)
        if r["copy_gb_s"] is not None:
            copy_gb_s.append(r["copy_gb_s"])
        table.append((key[0], str(key[1])[6:], r["plan"], fwd, req, r["ms"],
                      r["device_ms"], r["bound"], r["passes"], r["gb_s"],
                      r["copy_gb_s"]))
        row.add(fwd, r["max_err"], r["ms"], r["plain_ms"], r["bound"], "bytes",
                r["library_ms"])
        d["device_ms"] += fwd * r["device_ms"]
        d["request_device_ms"] += req * r["device_ms"]
        d["request_ms"] += req * r["ms"]
        d["request_plain_ms"] += req * r["plain_ms"]
        d["request_bound_ms"] += req * r["bound"]
        d["request_library_ms"] += req * r["library_ms"]
    torch.cuda.empty_cache()
    d["copy_gb_s_max"] = max(copy_gb_s)
    print("K8 by shape (ms a call; GB/s = the floor's bytes over the device "
          "time; copy = the copy kernel's GB/s on x):\n"
          "  shape | dtype | path | slab | cluster | calls a forward | a "
          "request | ms events | ms device | bound (passes) | GB/s | copy GB/s",
          flush=True)
    by_path = {}
    for (shape, dt, plan, fwd, req, ms, dev_ms, bound, passes, gb, cp) in table:
        print(f"  {list(shape)} | {dt} | {plan.path} | {plan.slab} | {plan.cluster} | "
              f"{fwd} | {req} | {ms:.4f} | {dev_ms:.4f} | {bound:.4f} ({passes}) | "
              f"{gb:.0f} | {'-' if cp is None else f'{cp:.0f}'}", flush=True)
        sums = by_path.setdefault(plan.path, dict.fromkeys(
            ("ms", "device_ms", "bound_ms", "request_device_ms",
             "request_bound_ms", "calls"), 0.0))
        sums["ms"] += fwd * ms
        sums["device_ms"] += fwd * dev_ms
        sums["bound_ms"] += fwd * bound
        sums["request_device_ms"] += req * dev_ms
        sums["request_bound_ms"] += req * bound
        sums["calls"] += fwd
    d["forward_by_path"] = by_path
    for path, sums in sorted(by_path.items()):
        print(f"K8 path {path}, a 2-row forward ({sums['calls']:.0f} calls): "
              f"events {sums['ms']:.4f} ms, device {sums['device_ms']:.4f} ms, "
              f"bound {sums['bound_ms']:.4f} ms; a request: device "
              f"{sums['request_device_ms']:.4f} ms, bound "
              f"{sums['request_bound_ms']:.4f} ms", flush=True)
    print(f"K8 copy kernel (x + 1, bf16): {max(copy_gb_s):.0f} GB/s at best over "
          f"the shapes above, against the 3350 GB/s data-sheet rate", flush=True)
    print(f"K8 a 2-row forward: events {d['ms']:.4f} ms, device "
          f"{d['device_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms", flush=True)
    print(f"K8 per request ({sum(request.values())} calls): kernel "
          f"{d['request_ms']:.4f} ms (device {d['request_device_ms']:.4f} ms), "
          f"plain {d['request_plain_ms']:.4f} ms, bound "
          f"{d['request_bound_ms']:.4f} ms, library "
          f"{d['request_library_ms']:.4f} ms", flush=True)


def k8_checks(dev, g):
    """K8 on both of its paths: a row's bits alone and between two rows
    offset by 1e4 (row independence), and the same on a second call (no
    atomics); its statistics in fp32 against float64 at |mean|/std ~ 1200
    (the CPU test's case, and at level 0) and on rows whose mean and scale
    change along the positions with a partial last block (a block's range
    merged with the wrong count or dropped moves the mean by about one
    step of the ramp), on path R and path S."""
    from wiw_tpu_torch.ops import group_norm as TG

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def path(x, groups):
        N, C = x.shape[0], x.shape[-1]
        return TG.k8_plan(N, x.numel() // (N * C), C, groups, x.dtype, sms).path

    paths = []
    for shape in ((1, 9216, 320), (1, 70001, 96)):
        C = shape[-1]
        w = 1 + 0.2 * torch.randn(C, generator=g, device=dev)
        b = 0.3 * torch.randn(C, generator=g, device=dev)
        good = torch.randn(*shape, generator=g, device=dev).bfloat16()
        bad = (torch.randn(*shape, generator=g, device=dev) + 1e4).bfloat16()
        alone = TG.group_norm(good, w, b, 32, 1e-5, True)
        batched = TG.group_norm(torch.cat([bad, good, bad]), w, b, 32, 1e-5, True)
        if not torch.equal(batched[1], alone[0]):
            raise RuntimeError(f"K8 {shape}: a co-batched row changed another row's bits")
        if not torch.equal(TG.group_norm(good, w, b, 32, 1e-5, True), alone):
            raise RuntimeError(f"K8 {shape}: the bits changed from one call to the next")
        paths.append(f"{shape} path {path(good, 32)}")
    worst = {}
    for what, shape, groups in (("|mean|/std ~ 1200", (1, 64, 16), 4),
                                ("|mean|/std ~ 1200", (2, 4000, 320), 4),
                                ("|mean|/std ~ 1200", (2, 9216, 320), 4),
                                ("|mean|/std ~ 1200", (2, 40000, 320), 4),
                                ("|mean|/std ~ 1200", (1, 500001, 16), 4),
                                ("ramped rows", (2, 9253, 320), 32),
                                ("ramped rows", (3, 2, 2, 75, 96), 32),
                                ("ramped rows", (2, 9253, 960), 32),
                                ("ramped rows", (1, 500001, 16), 4)):
        x = torch.randn(*shape, generator=g, device=dev)
        Cx = shape[-1]
        if what.startswith("ramped"):
            x = ramped(x)
        else:
            x[..., :Cx // 4] += 1200.0
        out = TG.group_norm(x, torch.ones(Cx, device=dev), torch.zeros(Cx, device=dev),
                            groups, 1e-5)
        g64 = x.double().reshape(shape[0], -1, groups, Cx // groups)
        ref = ((g64 - g64.mean(dim=(1, 3), keepdim=True)) / torch.sqrt(
            g64.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)).reshape(shape)
        err = ((out.double() - ref).abs() / (ILL_ATOL + ILL_ATOL * ref.abs())).max().item()
        where = f"{what}, path {path(x, groups)}"
        worst[where] = max(worst.get(where, 0.0), (out.double() - ref).abs().max().item())
        if err > 1:
            raise RuntimeError(f"K8 on {what} {shape}: beyond {ILL_ATOL} against "
                               f"float64 (ratio {err:.3g})")
        del x, out, g64, ref
    print("K8 checks: a row's bits equal alone, between rows offset by 1e4 and "
          "on a second call (" + "; ".join(paths) + "); fp32 vs float64 "
          + ", ".join(f"{w} max|err| {e:.3g}" for w, e in worst.items())
          + f" (tol {ILL_ATOL} + {ILL_ATOL}*|ref|)", flush=True)


def ramped(x):
    """x [N, ..., C] with every batch row's mean and scale changed from one
    block of 256 positions of its [L, C] view to the next, each row by
    another ramp: offset 4 * block * (n + 1) - 9 n, scale 1 + block / 8."""
    N, C = x.shape[0], x.shape[-1]
    flat = x.reshape(N, -1, C)
    tile = (torch.arange(flat.shape[1], device=x.device) // 256).float()[None, :, None]
    n = torch.arange(N, device=x.device).float()[:, None, None]
    return (flat * (1 + tile / 8) + 4 * tile * (n + 1) - 9 * n).reshape(x.shape)


def k3_phase(k1: Row, k3: Row, dev, g):
    """K1 with its LSE flag and K3 at the training shapes, on head views of
    [B, S, H*64] projections, against the plain LSE and backward (chunked
    over the batch: the plain versions hold fp32 [S, S] tensors)."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import flash_attention as TFA

    k1.d["lse_ms"] = k1.d["lse_off_ms"] = 0.0
    for B, H, S, calls in K3_SHAPES:
        q, k, v, dout = (torch.randn(B, S, H * 64, generator=g, device=dev,
                                     dtype=torch.bfloat16).view(B, S, H, 64)
                         .transpose(1, 2) for _ in range(4))
        chunk = max(1, int(2e9 // (H * S * S * 4)))

        def chunked(fn, *ts):
            parts = [fn(*(t[i:i + chunk] for t in ts)) for i in range(0, B, chunk)]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts)
            return [torch.cat(p) for p in zip(*parts)]

        with torch.no_grad():
            serving = TFA.flash_attention(q, k, v)
        out, lse = TFA._forward(q, k, v, with_lse=True)
        if not torch.equal(out, serving):
            raise RuntimeError(f"K1's output bits change with its LSE flag at S={S}")
        lse_ref = chunked(TFA.flash_attention_lse_plain, q, k)
        compare(f"K1 LSE S={S}", lse, lse_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        if not lse_err <= LSE_ATOL:
            raise RuntimeError(f"K1's LSE at S={S}: max|err| {lse_err} > {LSE_ATOL}")
        off = (cuda_ms(lambda: TFA.flash_attention(q, k, v), 5),
               cuda_ms(lambda: TFA._forward(q, k, v, True), 5),
               cuda_ms(lambda: TFA._forward(q, k, v, True), 5),
               cuda_ms(lambda: TFA.flash_attention(q, k, v), 5))
        k1.d["lse_off_ms"] += calls * (off[0] + off[3]) / 2
        k1.d["lse_ms"] += calls * (off[1] + off[2]) / 2
        print(f"K1 B*H={B * H} S={S}: LSE max|err| {lse_err:.3g} (tol {LSE_ATOL}), "
              f"output bits equal with and without it; {(off[0] + off[3]) / 2:.4f} "
              f"ms without, {(off[1] + off[2]) / 2:.4f} ms with", flush=True)

        def plain():
            return chunked(TFA.flash_attention_bwd_plain, q, k, v, out, lse, dout)

        def kernel():
            return TFA.flash_attention_bwd(q, k, v, out, lse, dout)

        got, ref = kernel(), plain()
        errs = [compare(f"K3 d{n} S={S}", a, b) for n, a, b in zip("qkv", got, ref)]
        del got, ref
        max_err = max(e for e, _ in errs)
        # the library yardstick: autograd through SDPA on the same views
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves)
        flops = 10 * B * H * S * S * 64  # dV, dP, dQ, dK and the recomputed S
        # q, k, v, O, dO read and dq, dk, dv written once; fp32 LSE and Delta
        nbytes = 8 * B * H * S * 64 * 2 + 3 * B * H * S * 4
        bound = bound_ms(nbytes, flops, BF16_FLOPS_S)
        ms, plain_ms, lib = timed(
            f"K3 B*H={B * H} S={S} D=64 " + " | ".join(
                f"d{n}: {line}" for n, (_, line) in zip("qkv", errs)),
            plain, kernel,
            lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True),
            max(3, int(1e4 // S)), 2, bound,
            lambda ms: f"{flops / ms / 1e9:.1f} TFLOP/s")
        if S == K3_SHAPES[0][2]:
            print("  its library call's kernels: " + kernel_names(
                lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True)),
                flush=True)
        k3.add(calls, max_err, ms, plain_ms, bound, "operations", lib)
        del q, k, v, dout, out, lse, leaves, o_lib
        torch.cuda.empty_cache()


def k6_backward_check(dev, g):
    """K6's autograd Function (K6 forward, backward recomputed through the
    unfused formulation) against autograd through K6's plain version, at
    level 0 of one training row: all seven gradients."""
    from wiw_tpu_torch.ops import fused_mlp as TF

    M, C = FRAMES * 9216, 320
    inner = 4 * C

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    args = (r(M, C).bfloat16(), 1 + r(C, scale=0.1), r(C, scale=0.1),
            r(2 * inner, C, scale=C ** -0.5).bfloat16(),
            r(2 * inner, scale=0.1).bfloat16(),
            r(C, inner, scale=inner ** -0.5).bfloat16(), r(C, scale=0.1).bfloat16())
    dout = r(M, C).bfloat16()

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in args]
        fn(*leaves).backward(dout)
        return [t.grad for t in leaves]

    before = TF.ln_geglu_ffn_residual.launches
    got = grads(TF.ln_geglu_ffn_residual)
    if TF.ln_geglu_ffn_residual.launches != before + 1:
        raise RuntimeError("K6's autograd Function did not launch K6")
    ref = grads(TF.ln_geglu_ffn_residual_plain)
    for name, a, b in zip(("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), got, ref):
        _, line = compare(f"K6 d{name}", a, b)
        print(f"K6 backward M={M} C={C} d{name}: {line}", flush=True)


class MemoryClips:
    """Seeded clips held in memory, as the trajectory dataset yields them:
    frames [F, H, W, 3] fp32 in [-1, 1] and nav actions [F] in {1, 2, 3}."""

    def __init__(self, n: int, frames: int, height: int, width: int, seed: int):
        rng = np.random.default_rng(seed)
        self.items = [{
            "pixel_values": rng.uniform(-1, 1, (frames, height, width, 3)
                                        ).astype(np.float32),
            "actions": rng.integers(1, 4, frames).astype(np.int32)}
            for _ in range(n)]

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


def unet_forward_flops(unet, dev, height: int, width: int) -> float:
    """FLOPs of one 1-row UNet forward at the training shape: the aten
    products counted by FlopCounterMode, plus K1's 4*B*H*S^2*64 per spatial
    attention (a ctypes call the counter cannot see)."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = height // 8, width // 8
    args = (torch.zeros(1, FRAMES, h, w, 8, device=dev), torch.full((1,), 0.5, device=dev),
            torch.zeros(1, 1, 1024, device=dev),
            torch.tensor([[7.0, 127.0, 0.05]], device=dev),
            torch.zeros(1, FRAMES, 14, device=dev))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        unet(*args)
    attn = sum(calls * 4 * B * H * S * S * 64 for B, H, S, calls in K3_SHAPES)
    return counter.get_total_flops() + attn


def train_phase(dev) -> tuple:
    """The training slice at full width: `train_cli.build` with the
    reference recipe, TRAIN_STEPS optimizer steps through the port's
    PrefetchLoader. Returns the kernels' launches over the steps and what
    the optim phase takes over: the pipeline, the config, AdamW's s/step,
    peak, state GiB and optimizer.step ms."""
    from wiw_tpu_torch.data.loader import PrefetchLoader
    from wiw_tpu_torch.train import train_cli

    args = train_cli.parse_args([
        "--data_root", "in-memory", "--grad_accum", str(TRAIN_ACCUM),
        "--learning_rate", "2e-5", "--use_ema", "--gradient_checkpointing",
        "--conditioning_dropout", "discrete", "--seed", "42", "--device", "cuda"])
    t0 = time.perf_counter()
    pipe, trainer, state = train_cli.build(args)
    torch.cuda.synchronize()
    unet = pipe.unet
    n_params = sum(p.numel() for p in unet.parameters())
    n_train = sum(p.numel() for g_ in state.optimizer.param_groups for p in g_["params"])
    print(f"train built: UNet {n_params / 1e9:.3f} B params ({n_train / 1e9:.3f} B "
          f"trained, {unet.conv_in.weight.dtype} computing in {unet.dtype}), "
          f"remat {unet.config.remat}, grad-accum {args.grad_accum}, EMA on, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fwd_flops = unet_forward_flops(unet, dev, args.height, args.width)

    names = list(state.params)
    watch = [names.index(n) for n in (
        "conv_in.weight", "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
        "up_blocks.3.resnets.2.spatial_res_block.conv2.weight", "conv_out.weight")]
    before = [state.params[names[i]].detach().clone() for i in watch]
    dataset = MemoryClips(2, FRAMES, args.height, args.width, seed=args.seed)
    loader = PrefetchLoader(
        dataset, args.per_device_batch, TRAIN_STEPS,
        transform=train_cli.accum_transform(args.grad_accum),
        place=trainer.place_batch, num_workers=2, prefetch_batches=2)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    total = dict.fromkeys(_counters(), 0)
    secs_all, peaks = [], []
    norms, hooks = count_group_norms(unet, pipe.vae)
    for i, batch in enumerate(loader):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        norms.clear()
        reset_launches()  # count this step of this path only
        t = time.perf_counter()
        metrics = trainer.train_step(state, batch, generator)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = launches()
        want = expected(PER_STEP, sum(norms.values()))
        secs_all.append(secs)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"train step {i}: {secs:.3f} s, loss {loss:.6g}, grad norm "
              f"{float(metrics['grad_norm']):.6g}, peak "
              f"{peaks[-1]:.2f} GiB, launches "
              f"{counts}", flush=True)
        if not np.isfinite(loss):
            raise RuntimeError(f"train step {i}: loss {loss}")
        if counts != want or not counts["K8"]:
            raise RuntimeError(f"train step {i}: launches {counts}, expected {want}")
        for k in total:
            total[k] += counts[k]
    if len(secs_all) != TRAIN_STEPS or state.step != TRAIN_STEPS:
        raise RuntimeError(f"ran {len(secs_all)} steps, state at {state.step}")
    for j, i in enumerate(watch):
        if torch.equal(state.params[names[i]], before[j]):
            raise RuntimeError(f"{names[i]} did not change in training")
        if torch.equal(state.ema[i], before[j]):
            raise RuntimeError(f"the EMA of {names[i]} did not change in training")
    # the first step carries cuDNN/cuBLAS plan building; the rate is read
    # from the later ones
    step_s = sum(secs_all[1:]) / (len(secs_all) - 1)
    clips = args.per_device_batch * args.grad_accum
    mfu = 3 * fwd_flops * clips / step_s / BF16_FLOPS_S
    print(f"train: {step_s:.3f} s/step (steps 1..{TRAIN_STEPS - 1}), "
          f"{clips / step_s:.4f} clips/s, UNet forward {fwd_flops / 1e12:.3f} "
          f"TFLOP a clip (counted), MFU {100 * mfu:.2f}% (3 x forward FLOPs "
          f"against {BF16_FLOPS_S / 1e12:.0f} TFLOP/s bf16); params and EMA "
          f"changed", flush=True)
    # one more step under torch.profiler (outside the counted steps): where
    # the device time goes, and how much of the step the device is idle
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_step(state, batch, generator)
        torch.cuda.synchronize()
    busy = busy_ms(prof)
    print(f"profile train: one optimizer step, device busy {busy:.1f} ms of the "
          f"unprofiled {1e3 * step_s:.1f} ms step (idle "
          f"{100 * (1 - busy / (1e3 * step_s)):.1f}%)", flush=True)
    print_top(prof, 16)
    for h in hooks:
        h.remove()
    snap_s, snap_gib = checkpoint_snapshot(state)
    print(f"train: checkpoint snapshot (TrainState.state_dict + to_host, what a save "
          f"blocks the loop for, no disk write) {snap_s:.3f} s for {snap_gib:.3f} GiB "
          f"on the host", flush=True)
    info = {"s_step": step_s, "peak_gib": peaks[-1], "state_gib": state_gib(state.optimizer),
            "opt_ms": optimizer_step_ms(state.optimizer), "first_moment": "float32",
            "pipe": pipe, "cfg": trainer.cfg, "args": args}
    del trainer, state, loader, batch
    gc.collect()
    torch.cuda.empty_cache()
    return total, info


def checkpoint_snapshot(state) -> tuple:
    """The synchronous part of a checkpoint save at full width: the
    trainer's `state_dict()` and the manager's host copy (`to_host`).
    Returns its seconds and the copy's GiB."""
    from wiw_tpu_torch.train.checkpoints import to_host

    torch.cuda.synchronize()
    t = time.perf_counter()
    snap = to_host(state.state_dict())
    secs = time.perf_counter() - t
    tensors = [snap["params"], snap["ema_params"], *snap["opt_state"]["state"].values()]
    gib = sum(v.numel() * v.element_size() for d in tensors for v in d.values()
              if torch.is_tensor(v)) / 2**30
    if snap["step"] != state.step or len(snap["params"]) != len(state.params):
        raise RuntimeError("checkpoint snapshot: not the trainer's state")
    return secs, gib


def state_gib(optimizer) -> float:
    """The optimizer state's size: its tensors' bytes (their local shards)."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if torch.is_tensor(t)) / 2**30


def optimizer_step_ms(optimizer) -> float:
    """One `optimizer.step()` on the gradients it holds (an update more),
    by the host clock between two synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    optimizer.step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def optim_phase(train: dict, dev) -> dict:
    """The memory-saving optimizers on the training slice's pipeline (the
    reference recipe at full width, its UNet as the train phase left it):
    OPTIM_STEPS steps of each through the PrefetchLoader, against AdamW's
    figures from the train phase; then one step of each of the three on
    real UNet leaves, card against CPU. Returns the launches."""
    from wiw_tpu_torch.data.loader import PrefetchLoader
    from wiw_tpu_torch.train import train_cli
    from wiw_tpu_torch.train.trainer import Trainer

    pipe, args = train["pipe"], train["args"]
    unet = pipe.unet
    total = dict.fromkeys(_counters(), 0)
    rows = {"adamw": train}
    norms, hooks = count_group_norms(unet, pipe.vae)
    for name in ("adamw_bf16m", "adafactor"):
        for p in unet.parameters():
            p.grad = None
        trainer = Trainer(pipe, dataclasses.replace(train["cfg"], optimizer=name))
        state = trainer.init_state()
        first = {"adamw_bf16m": lambda st: str(st["mu"].dtype).replace("torch.", ""),
                 "adafactor": lambda st: "none"}[name](next(iter(state.optimizer.state.values())))
        loader = PrefetchLoader(
            MemoryClips(2, FRAMES, args.height, args.width, seed=args.seed),
            args.per_device_batch, OPTIM_STEPS,
            transform=train_cli.accum_transform(args.grad_accum),
            place=trainer.place_batch, num_workers=2, prefetch_batches=2)
        generator = torch.Generator(device=dev).manual_seed(args.seed)
        secs_all, peaks = [], []
        for i, batch in enumerate(loader):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            norms.clear()
            reset_launches()  # count this step of this path only
            t = time.perf_counter()
            metrics = trainer.train_step(state, batch, generator)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            secs_all.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            counts = launches()
            want = expected(PER_STEP, sum(norms.values()))
            print(f"optim {name} step {i}: {secs_all[-1]:.3f} s, loss {loss:.6g}, peak "
                  f"{peaks[-1]:.2f} GiB, launches {counts}", flush=True)
            if not np.isfinite(loss):
                raise RuntimeError(f"optim {name} step {i}: loss {loss}")
            if counts != want or not counts["K8"]:
                raise RuntimeError(f"optim {name} step {i}: launches {counts}, "
                                   f"expected {want}")
            for k in total:
                total[k] += counts[k]
        if len(secs_all) != OPTIM_STEPS or state.step != OPTIM_STEPS:
            raise RuntimeError(f"optim {name}: ran {len(secs_all)} steps")
        rows[name] = {"s_step": secs_all[-1], "peak_gib": peaks[-1],
                      "state_gib": state_gib(state.optimizer),
                      "opt_ms": optimizer_step_ms(state.optimizer), "first_moment": first}
        del trainer, state, loader, batch
        gc.collect()
        torch.cuda.empty_cache()
    for h in hooks:
        h.remove()
    for name, r in rows.items():
        print(f"optim {name}: {r['s_step']:.3f} s/step (the last step), peak "
              f"{r['peak_gib']:.2f} GiB, optimizer state {r['state_gib']:.3f} GiB, first "
              f"moment {r['first_moment']}, optimizer.step {r['opt_ms']:.2f} ms", flush=True)
    print(json.dumps({"optim": {k: {f: v for f, v in r.items()
                                    if f in ("s_step", "peak_gib", "state_gib", "opt_ms",
                                             "first_moment")}
                                for k, r in rows.items()}}), flush=True)
    optimizer_leaf_check(unet, dev)
    return total


def optimizer_leaf_check(unet, dev) -> None:
    """One step of each optimizer on real UNet leaves (1-D, a dense weight,
    3x3 convs, a temporal conv) with seeded gradients, on the card and on
    the CPU: parameters within OPT_LEAF_ATOL, adamw_bf16m's first moment
    within OPT_MU_REL."""
    from wiw_tpu_torch.train.trainer import TrainConfig, build_optimizer

    named = dict(unet.named_parameters())
    pick = [next(n for n, p in named.items() if p.ndim == 1 and "norm" in n),
            next(n for n in named if n.endswith("attn1.to_q.weight")),
            next(n for n, p in named.items() if n.startswith("mid_block.") and p.ndim == 4),
            [n for n, p in named.items() if n.endswith("conv2.weight") and p.ndim == 4][-1],
            next(n for n, p in named.items() if p.ndim == 5)]
    g = torch.Generator().manual_seed(9)
    grads = {n: torch.randn(named[n].shape, generator=g) * 1e-3 for n in pick}
    for name in ("adamw", "adamw_bf16m", "adafactor"):
        cfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-2, optimizer=name)
        out = []  # (leaves, optimizer) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            leaves = [(n, named[n].detach().to(d, torch.float32).clone().requires_grad_(True))
                      for n in pick]
            for n, p in leaves:
                p.grad = grads[n].to(d)
            opt = build_optimizer(cfg, leaves, fused=d.type == "cuda")
            opt.step()
            out.append((leaves, opt))
        worst, mu_worst = 0.0, 0.0
        for (n, pc), (_, pu) in zip(out[0][0], out[1][0]):
            diff = float((pc.detach().cpu() - pu.detach()).abs().max())
            moved = float((pu.detach() - named[n].detach().cpu().float()).abs().max())
            worst = max(worst, diff)
            if moved < 1e-4:
                raise RuntimeError(f"{name} did not move {n} ({moved})")
            if name == "adamw_bf16m":
                mc = out[0][1].state[pc]["mu"].float().cpu()
                mu = out[1][1].state[pu]["mu"].float()
                mu_worst = max(mu_worst, float(((mc - mu).abs() / mu.abs().clamp_min(1e-30)).max()))
        print(f"optim leaves {name}: card vs CPU max |dp| {worst:.3e} (tolerance "
              f"{OPT_LEAF_ATOL})" + (f", first moment bf16 max rel {mu_worst:.3e} "
                                     f"(tolerance {OPT_MU_REL:.3e})"
                                     if name == "adamw_bf16m" else ""), flush=True)
        if worst > OPT_LEAF_ATOL or mu_worst > OPT_MU_REL:
            raise RuntimeError(f"optimizer {name}: card and CPU disagree")


def dist_phase(dev) -> dict:
    """The distributed path at world size 1 on the card: a 1-rank NCCL
    group in this process and `make_mesh(1, 1)`; one FSDP2-sharded step of
    the training recipe against an unsharded step from the same weights
    (the seed) and draws (the generator); `generate(mesh=)` against
    `generate` from the same generator on the sharded UNet; then
    `train_cli` under `torch.distributed.run` (one process, NCCL), whose
    rank-0 checkpoint must load strictly into an unsharded TrainState.
    Returns the launches of the sharded step and the mesh generate."""
    import tempfile

    import torch.distributed as dist

    from wiw_tpu_torch.parallel import make_mesh
    from wiw_tpu_torch.parallel.multihost import initialize_distributed
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig
    from wiw_tpu_torch.train import train_cli
    from wiw_tpu_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="wiw_dist_")
    args = train_cli.parse_args([
        "--data_root", "in-memory", "--grad_accum", str(TRAIN_ACCUM),
        "--learning_rate", "2e-5", "--use_ema", "--gradient_checkpointing",
        "--conditioning_dropout", "discrete", "--seed", "42", "--device", "cuda"])
    clip = MemoryClips(1, FRAMES, args.height, args.width, seed=7).items[0]
    batch = train_cli.accum_transform(args.grad_accum)({k: v[None] for k, v in clip.items()})
    total = dict.fromkeys(_counters(), 0)

    def one_step(mesh):
        """The recipe's first step from the seed's weights and draws (its
        parameters on the host after it), then a second, timed one."""
        pipe, trainer, state = train_cli.build(args, mesh)
        norms, hooks = count_group_norms(pipe.unet, pipe.vae)
        placed = trainer.place_batch(batch)
        torch.cuda.synchronize()
        reset_launches()
        m = trainer.train_step(state, placed, torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        counts = launches()
        for h in hooks:
            h.remove()
        if counts != expected(PER_STEP, sum(norms.values())):
            raise RuntimeError(f"dist step (mesh {mesh}): launches {counts}")
        after = {n: (p.detach().full_tensor() if mesh is not None else p.detach()
                     ).to("cpu", copy=True) for n, p in state.params.items()}
        t = time.perf_counter()
        trainer.train_step(state, placed, torch.Generator(device=dev).manual_seed(12))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return pipe, after, {k: float(v) for k, v in m.items()}, secs, counts

    pipe, ref, m0, s0, _ = one_step(None)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    initialize_distributed("cuda", init_method=f"file://{tmp}/pg", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        print(f"dist: process group backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} {tuple(mesh.shape)}",
              flush=True)
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"dist: backend {dist.get_backend()}, expected nccl")
        pipe, got, m1, s1, counts = one_step(mesh)
        for k in total:
            total[k] += counts[k]
        far, worst, n_all = 0, 0.0, 0
        for n, p in got.items():
            d = (p - ref[n]).abs()
            worst = max(worst, float(d.max()))
            far += int((d > 1e-6).sum())
            n_all += d.numel()
        bound = 2 * args.learning_rate + 1e-6
        print(f"dist: sharded step {s1:.3f} s, unsharded {s0:.3f} s (the second step of "
              f"each); the first step: loss {m1['loss']:.7g} vs {m0['loss']:.7g}, grad norm "
              f"{m1['grad_norm']:.7g} vs {m0['grad_norm']:.7g}; parameters: max |d| "
              f"{worst:.3e} (bound {bound:.3e}), {far} of {n_all} ({100 * far / n_all:.4f}%) "
              f"further than 1e-6 (bound {100 * DIST_FAR_SHARE}%)", flush=True)
        if (abs(m1["loss"] - m0["loss"]) > DIST_LOSS_REL * abs(m0["loss"])
                or abs(m1["grad_norm"] - m0["grad_norm"]) > DIST_NORM_REL * m0["grad_norm"]
                or worst > bound or far > DIST_FAR_SHARE * n_all):
            raise RuntimeError("dist: the sharded step departs from the unsharded one")
        del ref, got
        gc.collect()
        torch.cuda.empty_cache()

        clips = MemoryClips(2, FRAMES, args.height, args.width, seed=8).items
        image = torch.from_numpy(np.stack([c["pixel_values"][0] for c in clips])).to(dev)
        acts = torch.from_numpy(np.stack([c["actions"] for c in clips])).to(dev)
        gen = GenerationConfig(num_inference_steps=DIST_GEN_STEPS)
        outs, secs = [], []
        norms, hooks = count_group_norms(pipe.unet, pipe.vae)
        for with_mesh in (False, True):
            norms.clear()
            reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(pipe.generate(image, gen, actions=acts, mesh=mesh if with_mesh else None,
                                      generator=torch.Generator(device=dev).manual_seed(5)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        counts = launches()
        for h in hooks:
            h.remove()
        want = expected({"K1": PER_FORWARD["default"]["K1"] * DIST_GEN_STEPS},
                        sum(norms.values()))
        if counts != want:
            raise RuntimeError(f"dist generate(mesh=): launches {counts}, expected {want}")
        for k in total:
            total[k] += counts[k]
        diff = float((outs[1] - outs[0]).abs().max())
        print(f"dist: generate(mesh=) {secs[1]:.3f} s, generate {secs[0]:.3f} s (2 rows, "
              f"{DIST_GEN_STEPS} steps, the sharded UNet); frames {tuple(outs[1].shape)}, "
              f"max |d| {diff:.3e} (tolerance {DIST_GEN_ATOL})", flush=True)
        if (outs[1].shape != (2, FRAMES, args.height, args.width, 3)
                or not torch.isfinite(outs[1]).all() or diff > DIST_GEN_ATOL):
            raise RuntimeError("dist: generate(mesh=) departs from generate")
        del pipe, outs
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI under the launcher: one process, NCCL, a cut width (the frozen
    # towers at full size), validation and a checkpoint at step 2
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    write_trajectories(root, clips=2, frames=6, h=128, w=256, seed=3)
    argv = ["--data_root", root, "--output_dir", out, "--device", "cuda", "--fsdp", "1",
            "--max_steps", "2", "--checkpointing_steps", "2", "--validation_steps", "2",
            "--unet_channels", "64", "128", "--unet_heads", "1", "2", "--sample_frames", "4",
            "--action_input_channel", "4", "--width", "256", "--height", "128",
            "--grad_accum", "2", "--use_ema", "--gradient_checkpointing"]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    scalars = None
    if importlib.util.find_spec("tensorboardX") is None:
        # tensorboardX is not on the card's host: a stand-in SummaryWriter
        # that writes the CLI's scalars as JSON lines
        stub = os.path.join(tmp, "stub", "tensorboardX")
        os.makedirs(stub)
        with open(os.path.join(stub, "__init__.py"), "w") as f:
            f.write(TENSORBOARD_STANDIN)
        env["PYTHONPATH"] = repo + os.pathsep + os.path.dirname(stub)
        scalars = os.path.join(out, "scalars.jsonl")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "wiw_tpu_torch.train.train_cli", *argv],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t
    tail = (proc.stdout + proc.stderr)[-3000:]
    if proc.returncode != 0 or "process group: backend nccl" not in proc.stdout:
        raise RuntimeError(f"dist: train_cli under torch.distributed.run: rc "
                           f"{proc.returncode}\n{tail}")
    if "validation @ 2" not in proc.stdout:
        raise RuntimeError(f"dist: train_cli did not validate\n{tail}")
    if scalars is not None:
        with open(scalars) as f:
            tags = {json.loads(line)["tag"] for line in f}
        print(f"dist: the stand-in SummaryWriter got {sorted(tags)}", flush=True)
        if "val/psnr" not in tags:
            raise RuntimeError(f"dist: train_cli logged {tags}")
    _, _, state = train_cli.build(train_cli.parse_args(argv))
    state.load_state_dict(CheckpointManager(out).restore(2))
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.values())
    print(f"dist: train_cli under torch.distributed.run (1 process, nccl) {cli_s:.1f} s, "
          f"rc 0; checkpoint-2 loaded into an unsharded TrainState at step {state.step}, "
          f"{len(state.params)} parameters, finite {finite}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if state.step != 2 or not finite:
        raise RuntimeError("dist: the CLI's checkpoint does not restore")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return total


# shard_clip: the full-width shapes a rank holds at fsdp 2 and 4 (576x1024,
# 14 frames, the CFG pair folded at dp 1): GroupNorms (x, silu) split along
# the height (axis -3), a level-0 3x3 conv (x, output channels) and the
# level-0 spatial attention (rows x frames, heads, S); the generate runs at
# SHARD_STEPS Euler steps
SPLIT_FSDP = (2, 4)
SPLIT_GN_SHAPES = [((28, 72, 128, 320), True), ((2, 14, 72, 128, 320), True),
                   ((28, 9, 16, 1280), True)]
SPLIT_CONV = ((28, 72, 128, 320), 320)
SPLIT_K1 = (28, 5, 9216)
SHARD_STEPS = 10


# K8-stats against its plain version: the counts equal, each mean within
# STATS_RTOL of its group's standard deviation and each M2 within STATS_RTOL
# of it (both sides sum fp32 values in another order: ~1e-7 apart at
# commit bdf6e88); the combine entry's mean and rstd within COMBINE_RTOL (both take
# Chan's rule in double and round once to fp32: at most an fp32 ulp or two)
STATS_RTOL = 1e-5
COMBINE_RTOL = 2.0 ** -22
AMAX_DECODER = (4, 288, 512, 512)  # the frame-parallel decode's int8 convs
# `forward_launches` run once against the package of commit bdf6e88 (the
# first designs of K8-stats and K7-amax; a `git archive` of it on an H100
# 80GB HBM3 at 700 W), beside this run's counts
PREVIOUS_SPLIT_EVENTS = {"split": {"events": 5898, "memsets": 326, "copies": 153, "K1": 16},
                     "whole": {"events": 2625, "memsets": 346, "copies": 0, "K1": 16}}


def device_line(row, label, kernel, keys, library, bound) -> None:
    """The device time of one launch of the kernel (named by `keys`) and of
    the library call's reduction kernel (`device_ms`: torch.profiler; a
    short kernel's CUDA-event time is its wrapper's host dispatch; the
    memset before each is not counted), printed and kept in the row's
    `device` entry by label."""
    try:
        k = device_ms(kernel, keys, 10)
        lib = device_ms(library, ("reduce_kernel",), 10)
    except RuntimeError as e:  # the profiler recorded nothing: no device time
        print(f"{label} device time: not measured ({e})", flush=True)
        return
    print(f"{label} device time a launch (torch.profiler): kernel {k:.4f} ms "
          f"({bound / k:.3f} of the bound {bound:.4f} ms), library's reduce_kernel "
          f"{lib:.4f} ms", flush=True)
    row.d.setdefault("device", {})[label] = {"ms": k, "library_ms": lib, "bound_ms": bound}


def stats_err(st, ref) -> float:
    """K8-stats' error against its plain version (see STATS_RTOL); inf
    where a count differs."""
    if not torch.equal(st[..., 0], ref[..., 0]):
        return float("inf")
    std = (ref[..., 2] / ref[..., 0]).sqrt()
    return max(float(((st[..., 1] - ref[..., 1]).abs() / std).max()),
               float(((st[..., 2] - ref[..., 2]).abs() / ref[..., 2]).max()))


def amax_decoder(row, dev, g):
    """K7-amax on a decoder-sized bf16 tensor (AMAX_DECODER, 604 MB), bits
    against its plain version, timed beside its library call; kept in the
    row's `decoder` entry (the row's own numbers are the level-0 shard's)."""
    from wiw_tpu_torch.ops import quant as TQ

    x = torch.randn(AMAX_DECODER, generator=g, device=dev).to(torch.bfloat16)
    x.view(-1)[-1] = -300.0  # the extreme negative, in the last vector
    if not torch.equal(TQ.conv_amax(x), TQ.conv_amax_plain(x)):
        raise RuntimeError("K7-amax departs from its plain version at the decoder's size")
    nbytes = x.numel() * x.element_size()
    bound = bound_ms(nbytes, 0, BF16_FLOPS_S)
    ms, plain_ms, lib = timed(
        f"K7-amax a decoder-sized {AMAX_DECODER} bf16 (bits equal to its plain version)",
        lambda: TQ.conv_amax_plain(x), lambda: TQ.conv_amax(x),
        lambda: torch.linalg.vector_norm(x, ord=float("inf")), 5, 1, bound,
        lambda ms: f"{nbytes / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bound")
    row.d["decoder"] = {"shape": list(AMAX_DECODER), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "library_ms": lib}
    device_line(row, f"K7-amax {AMAX_DECODER}", lambda: TQ.conv_amax(x), ("amax_abs",),
                lambda: torch.linalg.vector_norm(x, ord=float("inf")), bound)


def split_checks(rows: dict, dev, g):
    """The split kernel entries inside one process, at the shapes of a rank
    at fsdp 2 and 4: K8's statistics over each row shard, combined
    (`combine_stats`, Chan's rule) and applied on each shard, against the
    plain version and the one-launch K8; K8's and K7's amax entry and
    K7-conv with the global amax on each halo'd row shard (a zero column
    each side, padding 0), bit for bit against the rows of the one-launch
    conv; K1 on the padded head shard that holds the last real head and a
    pad head. Each new entry is timed on the largest shard at fsdp 4
    against its plain version (and the library call where one computes the
    same function): K8-stats per shape with its plan, GB/s and bound, and
    its statistics held to STATS_RTOL and to their own bits on a second
    call; K8-combine on that shape's parts; K7-amax also on a
    decoder-sized tensor (`amax_decoder`)."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import group_norm as TG
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from wiw_tpu_torch.parallel.clip_sharding import split_rows

    def shards(x, n):
        return [x.narrow(-3, r.start, len(r)).contiguous()
                for r in split_rows(x.shape[-3], n) if len(r)]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, silu in SPLIT_GN_SHAPES:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(torch.bfloat16)
        C = shape[-1]
        w = torch.randn(C, generator=g, device=dev)
        b = torch.randn(C, generator=g, device=dev)
        plain = TG.group_norm_plain(x, w, b, 32, 1e-5, silu)
        whole = TG.group_norm(x, w, b, 32, 1e-5, silu)
        one_ms = cuda_ms(lambda: TG.group_norm(x, w, b, 32, 1e-5, silu), 5)
        for n in SPLIT_FSDP:
            parts = shards(x, n)

            def split():
                st = torch.stack([TG.group_norm_stats(s, 32) for s in parts])
                mean, rstd = TG.combine_stats(st, 1e-5)
                return [TG.group_norm_apply(s, mean, rstd, w, b, silu) for s in parts]

            out = torch.cat(split(), dim=-3)
            err, line = compare(f"K8 split {shape} fsdp {n}", out, plain)
            d1 = float((out.float() - whole.float()).abs().max())
            split_ms = cuda_ms(split, 5)
            print(f"K8 split {shape} bf16 silu over fsdp {n} ({len(parts)} shards, stats "
                  f"+ combine + apply of every shard in one process): {split_ms:.4f} ms vs "
                  f"the one-launch K8 on the whole x {one_ms:.4f} ms; against the plain "
                  f"version {line}; max|split - one-launch| {d1:.6g}", flush=True)
            if n != SPLIT_FSDP[-1]:
                continue
            s0 = parts[0]
            N, L = s0.shape[0], s0.numel() // (s0.shape[0] * C)
            plan = TG.stats_plan(N, L, C, 32, s0.dtype, sms)
            before = (TG.group_norm_stats.launches, TG.combine_stats.launches)
            st = TG.group_norm_stats(s0, 32)
            every = torch.stack([TG.group_norm_stats(s, 32) for s in parts])
            mean, rstd = TG.combine_stats(every, 1e-5)
            done = (TG.group_norm_stats.launches - before[0],
                    TG.combine_stats.launches - before[1])
            if done != (1 + len(parts), 1):
                raise RuntimeError(f"K8-stats / K8-combine launched {done} times for "
                                   f"{1 + len(parts)} / 1 calls")
            e1 = stats_err(st, TG.group_norm_stats_plain(s0, 32))
            if not e1 <= STATS_RTOL:
                raise RuntimeError(f"K8-stats departs from its plain version: {e1:.3g} "
                                   f"(tol {STATS_RTOL})")
            if not torch.equal(st, TG.group_norm_stats(s0, 32)):
                raise RuntimeError("K8-stats' bits differ between two calls")
            view = s0.view(N, L, 32, C // 32)
            nbytes = s0.numel() * s0.element_size()
            bound = bound_ms(nbytes, 0, BF16_FLOPS_S)
            ms, plain_ms, lib = timed(
                f"K8-stats a rank's shard {tuple(s0.shape)} ({plan}; against the plain "
                f"version: max of |mean - mean'| / std' and |M2 - M2'| / M2' {e1:.3g}, tol "
                f"{STATS_RTOL})",
                lambda: TG.group_norm_stats_plain(s0, 32), lambda: TG.group_norm_stats(s0, 32),
                lambda: torch.var_mean(view, dim=(1, 3), correction=0), 10, 3, bound,
                lambda ms: f"{nbytes / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bound")
            rows["K8-stats"].add(1, e1, ms, plain_ms, bound, "bytes", lib)
            device_line(rows["K8-stats"], f"K8-stats {tuple(s0.shape)}",
                        lambda: TG.group_norm_stats(s0, 32), ("gn_stats",),
                        lambda: torch.var_mean(view, dim=(1, 3), correction=0), bound)
            m_p, r_p = TG.combine_stats_plain(every, 1e-5)
            e3 = max(float((mean - m_p).abs().max()),
                     float(((rstd - r_p).abs() / r_p).max()))
            if not e3 <= COMBINE_RTOL:
                raise RuntimeError(f"K8-combine departs from its plain version: {e3:.3g}")
            cbytes = every.numel() * 8 + 2 * mean.numel() * 4
            cbound = bound_ms(cbytes, 0, BF16_FLOPS_S)
            ms, plain_ms, _ = timed(
                f"K8-combine of {len(parts)} parts {tuple(every.shape)} (max of |mean - "
                f"mean'| and |rstd - rstd'| / rstd' against the plain version {e3:.3g})",
                lambda: TG.combine_stats_plain(every, 1e-5),
                lambda: TG.combine_stats(every, 1e-5), None, 10, 3, cbound,
                lambda ms: f"{cbytes / ms / 1e6:.1f} GB/s")
            rows["K8-combine"].add(1, e3, ms, plain_ms, cbound, "bytes")
            ap = TG.group_norm_apply(s0, mean, rstd, w, b, silu)
            e2, line = compare("K8-apply", ap, TG.group_norm_apply_plain(s0, mean, rstd, w, b,
                                                                          silu))
            ms, plain_ms, _ = timed(
                f"K8-apply a rank's shard {tuple(s0.shape)} {line}",
                lambda: TG.group_norm_apply_plain(s0, mean, rstd, w, b, silu),
                lambda: TG.group_norm_apply(s0, mean, rstd, w, b, silu), None, 10, 3,
                bound_ms(2 * nbytes, 0, BF16_FLOPS_S),
                lambda ms: f"{2 * nbytes / ms / 1e6:.1f} GB/s")
            rows["K8-apply"].add(1, e2, ms, plain_ms, bound_ms(2 * nbytes, 0, BF16_FLOPS_S),
                                 "bytes")
        del x, plain, whole

    xshape, O = SPLIT_CONV
    x = torch.randn(xshape, generator=g, device=dev).to(torch.bfloat16)
    C = xshape[-1]
    w8 = torch.randint(-127, 128, (O, 3, 3, C), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand(O, generator=g, device=dev) * 1e-3
    bias = torch.randn(O, generator=g, device=dev)
    whole = TQ.w8a8_conv(x, w8, ws, bias, padding=1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    for n in SPLIT_FSDP:
        rs = [r for r in split_rows(xshape[1], n) if len(r)]
        amax = torch.stack([TQ.conv_amax(x[:, r.start:r.stop].contiguous())
                            for r in rs]).amax(0)
        halo = [xp[:, r.start:r.stop + 2].contiguous() for r in rs]
        out = torch.cat([TQ.w8a8_conv(e, w8, ws, bias, padding=0, amax=amax)
                         for e in halo], dim=1)
        same_amax = bool(torch.equal(amax, TQ.conv_amax_plain(x)))
        same = bool(torch.equal(out, whole))
        print(f"K7-conv split {xshape} over fsdp {n}: the amax of the shards' amax "
              f"equals the whole x's: {same_amax}; the given-amax conv on each halo'd "
              f"shard equals the one-launch conv's rows bit for bit: {same}", flush=True)
        if not (same_amax and same):
            raise RuntimeError("K7's split entries depart from the one-launch conv")
        if n != SPLIT_FSDP[-1]:
            continue
        s0, e0 = x[:, rs[0].start:rs[0].stop].contiguous(), halo[0]
        nbytes = s0.numel() * s0.element_size()
        ms, plain_ms, lib = timed(
            f"K7-amax a rank's shard {tuple(s0.shape)} (bits equal to its plain version)",
            lambda: TQ.conv_amax_plain(s0), lambda: TQ.conv_amax(s0),
            lambda: torch.linalg.vector_norm(s0, ord=float("inf")), 10, 3,
            bound_ms(nbytes, 0, BF16_FLOPS_S),
            lambda ms: f"{nbytes / ms / 1e6:.1f} GB/s, "
                       f"{bound_ms(nbytes, 0, BF16_FLOPS_S) / ms:.3f} of the bound")
        rows["K7-amax"].add(1, 0.0, ms, plain_ms, bound_ms(nbytes, 0, BF16_FLOPS_S),
                            "bytes", lib)
        device_line(rows["K7-amax"], f"K7-amax {tuple(s0.shape)}", lambda: TQ.conv_amax(s0),
                    ("amax_abs",), lambda: torch.linalg.vector_norm(s0, ord=float("inf")),
                    bound_ms(nbytes, 0, BF16_FLOPS_S))
        amax_decoder(rows["K7-amax"], dev, g)
        plain = TQ.w8a8_conv_plain(e0, w8, ws, bias, padding=0, amax=amax)
        got = TQ.w8a8_conv(e0, w8, ws, bias, padding=0, amax=amax)
        if not torch.equal(got, plain):
            raise RuntimeError("the given-amax K7-conv departs from its plain version")
        ops, nb, _ = k7_ops_bytes(("conv", tuple(e0.shape), e0.dtype, tuple(w8.shape), 1, 0,
                                   True, torch.bfloat16))
        bound = bound_ms(nb, ops, INT8_OPS_S)
        ms, plain_ms, _ = timed(
            f"K7-conv with the amax given, a rank's halo'd shard {tuple(e0.shape)} (bits "
            "equal to its plain version)",
            lambda: TQ.w8a8_conv_plain(e0, w8, ws, bias, padding=0, amax=amax),
            lambda: TQ.w8a8_conv(e0, w8, ws, bias, padding=0, amax=amax), None, 5, 1,
            bound, lambda ms: f"{ops / ms / 1e9:.1f} TOPS")
        rows["K7-conv-given"].add(1, 0.0, ms, plain_ms, bound,
                                  "operations" if ops / INT8_OPS_S > nb / HBM_BYTES_S
                                  else "bytes")
    del x, xp, whole

    B, H, S = SPLIT_K1
    q, k, v = (torch.randn(B, S, H, 64, generator=g, device=dev, dtype=torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    for n in SPLIT_FSDP:
        hs = -(-H // n)
        p = (H - 1) // hs  # the shard that holds the last real head
        padded = [torch.zeros(B, n * hs, S, 64, device=dev, dtype=torch.bfloat16)
                  for _ in range(3)]
        for t, src in zip(padded, (q, k, v)):
            t[:, :H] = src
        qs, ks, vs = (t[:, p * hs:(p + 1) * hs] for t in padded)
        out = flash_attention(qs, ks, vs)
        chunk = max(1, int(2e9 // (hs * S * S * 4)))
        ref = torch.cat([flash_attention_plain(qs[i:i + chunk], ks[i:i + chunk],
                                               vs[i:i + chunk]) for i in range(0, B, chunk)])
        real = H - p * hs
        err, line = compare(f"K1 head shard fsdp {n}", out[:, :real], ref[:, :real])
        pad_zero = bool((out[:, real:] == 0).all())
        ms = cuda_ms(lambda: flash_attention(qs, ks, vs), 3)
        print(f"K1 on the padded head shard at fsdp {n} ({H} heads -> {n * hs}, shard {p} "
              f"of {hs} heads, {real} real; B={B}, S={S}): {ms:.4f} ms; {line}; pad heads "
              f"all zero: {pad_zero}", flush=True)
        if not pad_zero:
            raise RuntimeError("K1's pad heads are not zero")
        del padded, qs, ks, vs, out, ref


def shard_clip_phase(rows: dict, dev, g) -> dict:
    """`generate(shard_clip=True)` on the card: the split kernel entries
    (`split_checks`), then, on an in-process 1-rank NCCL group and
    `make_mesh(1, 1)`, one full-width request (576x1024, 14 frames,
    SHARD_STEPS steps, the serving CFG schedule) through `generate` and
    through `generate(shard_clip=True)` from the same generator, in bf16
    and in W8A8, with s/request and peak memory; the denoised latents held
    together within the bounds the engine is held to `generate` by (the
    two sum bf16 in another order: split GroupNorm statistics, a halo'd
    conv at padding 0, the frame-parallel decode's batched groups), the
    frames printed (the shard_clip request timed after an untimed one of its
    own); in bf16 also one request of each under torch.profiler
    (the gap between the two split into device time and device idle time)
    and one 2-row UNet forward split against the whole one, held to the
    yardstick of a sample moved by one bf16 step. Then the frame-parallel
    decode's peak at world size 1 (all complete groups live at once) against
    the sequential decode's.
    Returns the launches of the shard_clip runs."""
    import tempfile

    import torch.distributed as dist

    from wiw_tpu_torch.parallel import clip_sharding, make_mesh
    from wiw_tpu_torch.parallel.multihost import initialize_distributed
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    t_phase = time.perf_counter()
    split_checks(rows, dev, g)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="wiw_clip_")
    total = dict.fromkeys(_counters(), 0)
    initialize_distributed("cuda", init_method=f"file://{tmp}/pg", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        rng = np.random.default_rng(9)
        image = torch.from_numpy(rng.uniform(-1, 1, (1, 576, 1024, 3)).astype(np.float32))
        acts = torch.tensor([[4, 1, 1, 2, 2, 1, 3, 3, 1, 1, 2, 1, 3, 1]])
        for label, bounds in (("bf16", (SMALL_ATOL, SMALL_MEAN_ATOL)),
                              ("int8", (INT8_SMALL_ATOL, INT8_SMALL_MEAN_ATOL))):
            worker = SVDActionWorker(
                width=1024, height=576, num_frames=FRAMES, num_inference_steps=SHARD_STEPS,
                out_width=480, out_height=480, quantize=label, cfg_schedule="serving",
                device="cuda", seed=0, fused_ff=False, temporal_attention="batched")
            pipe = worker.pipe
            gen = worker.gen
            seen = {}
            decode = pipe._decode_chunked

            def capture(latents, *a, **kw):
                seen["latents"] = latents
                return decode(latents, *a, **kw)

            pipe._decode_chunked = capture

            def request(shard):
                return pipe.generate(image, gen, actions=acts,
                                     generator=torch.Generator(device=dev).manual_seed(5),
                                     mesh=mesh if shard else None, shard_clip=shard)

            # untimed: the label's first shard_clip request sets up what
            # later ones reuse (NCCL's communicator and its collectives,
            # cuDNN's choices for the halo'd shapes); `generate` is warm
            # from the earlier phases
            request(True)
            res = {}
            for shard in (False, True):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t = time.perf_counter()
                frames = request(shard)
                torch.cuda.synchronize()
                res[shard] = (frames, seen.pop("latents"), time.perf_counter() - t,
                              torch.cuda.max_memory_allocated() / 2**30, launches())
            del pipe._decode_chunked
            if label == "bf16":
                request_gap(request, {k: res[k][2] for k in res},
                            {k: res[k][4]["K1"] for k in res})
            (f0, l0, s0, p0, c0), (f1, l1, s1, p1, c1) = res[False], res[True]
            dl = (l1 - l0).abs()
            max_rel = float(dl.max() / l0.abs().max())
            mean_rel = float(dl.mean() / l0.abs().mean())
            df = (f1 - f0).abs()
            new = {k: c1[k] for k in ("K8-stats", "K8-combine", "K8-apply", "K7-amax",
                                      "K7-conv-given")}
            print(f"shard_clip {label}: generate(shard_clip=True) on make_mesh(1, 1) "
                  f"{s1:.3f} s/request, peak {p1:.2f} GiB; generate {s0:.3f} s/request, peak "
                  f"{p0:.2f} GiB ({SHARD_STEPS} steps, 576x1024, 14 frames, serving CFG); "
                  f"denoised latents max|d| {float(dl.max()):.6g} ({max_rel:.6g} of max|ref|, "
                  f"tol {bounds[0]}), mean|d| {float(dl.mean()):.6g} ({mean_rel:.6g} of "
                  f"mean|ref|, tol {bounds[1]}); frames max|d| {float(df.max()):.6g} mean|d| "
                  f"{float(df.mean()):.6g}; launches: K1 {c1['K1']} (generate: {c0['K1']}), "
                  f"K8 {c1['K8']} (generate: {c0['K8']}), {new}, K7-conv {c1['K7-conv']} "
                  f"(generate: {c0['K7-conv']}), K7-dense {c1['K7-dense']} (generate: "
                  f"{c0['K7-dense']})", flush=True)
            if (f1.shape != (1, FRAMES, 576, 1024, 3) or not torch.isfinite(f1).all()
                    or max_rel > bounds[0] or mean_rel > bounds[1]):
                raise RuntimeError(f"shard_clip {label}: departs from generate")
            if (c1["K1"] != c0["K1"] or c1["K8-stats"] != c1["K8-apply"] or not c1["K8-stats"]
                    or c1["K8-combine"] != c1["K8-stats"]
                    or (label == "int8") != bool(c1["K7-amax"])
                    or c1["K7-amax"] != c1["K7-conv-given"]):
                raise RuntimeError(f"shard_clip {label}: launches {c1} against {c0}")
            for k in total:
                total[k] += c1[k]
            if label == "bf16":
                # one 2-row UNet forward, split against whole (the same
                # inputs). At world size 1 no halo row is exchanged and the
                # all-to-alls are copies, so this sees what the split layers
                # compute on their own: the split GroupNorm (statistics,
                # Chan's rule, apply), the 3x3 convs at padding 0 on rows
                # padded by hand, the resamplers' windows and re-splits, and
                # the reshard's layouts around K1. The faults between ranks
                # are held on the CPU (tests/test_torch_clip_sharding.py).
                args = forward_args(dev)
                # the yardstick: the whole forward of a sample moved by one
                # bf16 step (2^-8 of its value) in every other element
                step = torch.ones_like(args[0])
                step.view(-1)[::2] += 2.0 ** -8
                with torch.inference_mode():
                    whole = pipe.unet(*args)
                    moved = pipe.unet(args[0] * step, *args[1:])
                    with clip_sharding.activate(mesh, None, 72, 128):
                        split = pipe.unet(*args)

                def rel_fro(a):
                    return float(torch.linalg.vector_norm(a - whole)
                                 / torch.linalg.vector_norm(whole))

                rel, tol = rel_fro(split), rel_fro(moved)
                print(f"shard_clip: one 2-row UNet forward under activate(make_mesh(1, 1)) "
                      f"against the whole forward: max|d| {float((split - whole).abs().max()):.6g}"
                      f", rel_fro {rel:.6g} (tol {tol:.6g}: the whole forward of the sample "
                      f"moved by one bf16 step in every other element)", flush=True)
                if not rel <= tol:
                    raise RuntimeError("shard_clip: the split UNet forward departs by more "
                                       "than one bf16 step of its input")
                counts = forward_launches(pipe.unet, args, mesh)
                now, before = (c["split"]["events"] for c in (counts, PREVIOUS_SPLIT_EVENTS))
                print(f"shard_clip: device events of one 2-row UNet forward (torch.profiler): "
                      f"split {counts['split']}, whole {counts['whole']}; commit bdf6e88's "
                      f"package, counted the same way: {PREVIOUS_SPLIT_EVENTS}; the split "
                      f"forward's events {now} against bdf6e88's {before} "
                      f"({now - before:+d})", flush=True)
                split_group_norm_events(mesh, dev, torch.Generator(device=dev).manual_seed(3))
                del args, whole, split, moved, step
                peaks = {}
                for name, m in (("sequential", None), ("frame-parallel", mesh)):
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
                    with torch.inference_mode():
                        pipe._decode_chunked(l0, gen, None, m)
                    torch.cuda.synchronize()
                    peaks[name] = torch.cuda.max_memory_allocated() / 2**30 - base
                chunk = gen.resolved_decode_chunk(dtype_bytes=2)
                print(f"shard_clip decode at world size 1 (bf16 VAE, chunk {chunk}: "
                      f"{FRAMES // chunk} complete groups live at once and a tail of "
                      f"{FRAMES % chunk}): peak above the latents {peaks['frame-parallel']:.2f} "
                      f"GiB, the sequential decode's {peaks['sequential']:.2f} GiB", flush=True)
            del worker, res, f0, f1, l0, l1
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"shard_clip phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def device_events(fn) -> list:
    """The names of the device events (kernels, memsets, copies) of one call
    of `fn` under torch.profiler, in the order they started."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if "CUDA" in str(e.device_type)),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events]


def forward_launches(unet, args, mesh) -> dict:
    """The device events of one 2-row UNet forward, whole and split
    (`clip_sharding.activate(mesh, None, 72, 128)`), each counted in one
    profiled forward after an unprofiled one: all events, of them memsets
    and copies, and K1's kernels (16 a forward: fewer means the profiler
    dropped events)."""
    from wiw_tpu_torch.parallel import clip_sharding

    out = {}
    for label in ("whole", "split"):
        def forward():
            with torch.inference_mode():
                if label == "whole":
                    unet(*args)
                    return
                with clip_sharding.activate(mesh, None, 72, 128):
                    unet(*args)

        forward()
        for _ in range(4):  # a profile that dropped events (K1's 16) is taken again
            names = device_events(forward)
            out[label] = {"events": len(names),
                          "memsets": sum("Memset" in n for n in names),
                          "copies": sum("Memcpy" in n for n in names),
                          "K1": sum("flash_attn" in n for n in names)}
            if out[label]["K1"] == 16:
                break
    return out


def split_group_norm_events(mesh, dev, g) -> list:
    """The device events of one split GroupNorm (+ SiLU) layer, bf16
    parameters as served, on a level-0 temporal input under
    `activate(mesh, ...)`: checks that K8-stats is a memset and one kernel,
    that only the all-gather runs between it and the combine entry, and
    only the combine entry between the all-gather and K8-apply, the last
    event."""
    from wiw_tpu_torch.models.layers import GroupNorm
    from wiw_tpu_torch.parallel import clip_sharding

    norm = GroupNorm(320, silu=True).to(device=dev, dtype=torch.bfloat16)
    x = torch.randn(2, FRAMES, 72, 128, 320, generator=g, device=dev).to(torch.bfloat16)

    def layer():
        with torch.inference_mode(), clip_sharding.activate(mesh, None, 72, 128):
            norm(x)

    def layers():
        for _ in range(3):
            layer()

    def in_order(names) -> bool:
        at = {k: [i for i, n in enumerate(names) if k in n]
              for k in ("gn_stats", "gn_combine", "gn_apply")}
        if not all(len(v) == 1 for v in at.values()):
            return False
        i, j, k = at["gn_stats"][0], at["gn_combine"][0], at["gn_apply"][0]
        return (i > 0 and "Memset" in names[i - 1] and k == j + 1 == len(names) - 1
                and all("nccl" in n.lower() or "Memcpy" in n for n in names[i + 1:j]))

    layer()
    # the profiler may miss events of a short profile (the first ones, or
    # all late in a long run): read the last of three calls, the events
    # after the second K8-apply, and take a profile that missed some again
    for _ in range(4):
        names = device_events(layers)
        applies = [i for i, n in enumerate(names) if "gn_apply" in n]
        recorded = len(applies) == 3
        names = names[applies[-2] + 1:] if recorded else names
        ok = recorded and in_order(names)
        if ok:
            break
    print(f"shard_clip: one split GroupNorm layer's device events, in order (the last of "
          f"three calls): {[n[:60] for n in names]}"
          + ("" if recorded else " (not checked: the profiler missed events in four "
             "profiles)"), flush=True)
    if recorded and not ok:
        raise RuntimeError("the split GroupNorm runs more than memset + K8-stats, the "
                           "all-gather, K8-combine and K8-apply in that order")
    return names


def request_gap(request, wall: dict, k1: dict) -> None:
    """One request of `generate` (request(False)) and one of
    `generate(shard_clip=True)` (request(True)) under torch.profiler: each
    one's device busy time (its kernels' self time) and device time by
    kernel class, and the gap between the unprofiled wall times `wall`
    split into device time and the rest (the device idle: host work the
    kernels wait on). The K1 kernels the profiler recorded are printed
    beside the launch counts `k1`: fewer means it dropped events."""
    busy, classes, seen = {}, {}, {}
    for shard in (False, True):
        with torch.inference_mode(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            request(shard)
            torch.cuda.synchronize()
        classes[shard] = class_ms(prof)
        busy[shard] = sum(classes[shard].values()) / 1e3
        seen[shard] = sum(e.count for e in prof.key_averages() if "flash_attn" in e.key)
        del prof
    gap, dev_gap = wall[True] - wall[False], busy[True] - busy[False]
    print(f"shard_clip bf16 request traced (torch.profiler): device busy generate "
          f"{busy[False]:.4f} s of {wall[False]:.4f} s, shard_clip {busy[True]:.4f} s of "
          f"{wall[True]:.4f} s; the {gap:.4f} s gap: device {dev_gap:.4f} s, device idle "
          f"{gap - dev_gap:.4f} s; K1 kernels recorded {seen[False]}, {seen[True]} "
          f"(launched {k1[False]}, {k1[True]})", flush=True)
    for c in sorted(set(classes[False]) | set(classes[True]),
                    key=lambda c: -classes[True].get(c, 0.0)):
        a, b = classes[False].get(c, 0.0), classes[True].get(c, 0.0)
        print(f"  {c}: generate {a:.2f} ms, shard_clip {b:.2f} ms ({b - a:+.2f})",
              flush=True)


def small_reference_phase(dev):
    """Tiny bf16 pipelines on the card (default, fused and W8A8
    configurations) vs the same weights in fp32 on the CPU (where every
    kernel wrapper takes its plain version; W8A8 with the same int8
    weights). Sized so that K4 and K6 launch at both levels: head_dim 64,
    S = 1024 and 256, rows of 3072..6144; channels 64 and 128, which K7
    takes."""
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
    bf16 = [dataclasses.replace(c, dtype="bfloat16") for c in (unet, vae, clip)]
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 3, 32, 32, 4)).astype(np.float32))
    actions = torch.tensor([[4, 2, 1]])
    ref = None
    for label, extra in (("default", {}), ("fused", FUSED), ("int8", {})):
        card = SVDPipeline(dataclasses.replace(bf16[0], **extra), bf16[1],
                           bf16[2], device=dev)
        want = ref
        if label == "int8":
            # both sides quantise the same fp32 (bf16-rounded) weights to
            # the same codes: the CPU side with K7's plain versions
            card.quantize_unet()
            cpu8 = SVDPipeline(unet, vae, clip, device="cpu")
            cpu8.quantize_unet()
            cpu8.load_state_dicts(cpu.unet.state_dict(), cpu.vae.state_dict(),
                                  cpu.clip.state_dict())
            want = cpu8.generate(image, gen, actions, init_latents=noise,
                                 generator=torch.Generator().manual_seed(1))
        card.load_state_dicts(cpu.unet.state_dict(), cpu.vae.state_dict(),
                              cpu.clip.state_dict())
        if ref is None:
            # the CPU reference keeps fp32 compute on the card's bf16-rounded
            # weights (rounding again for the next card run changes nothing)
            for tower, cpu_tower in ((card.unet, cpu.unet), (card.vae, cpu.vae),
                                     (card.clip, cpu.clip)):
                cpu_tower.load_state_dict({k: v.float().cpu() for k, v in
                                           tower.state_dict().items()})
            ref = want = cpu.generate(image, gen, actions, init_latents=noise,
                                      generator=torch.Generator().manual_seed(1))
        reset_launches()
        got = card.generate(image, gen, actions, init_latents=noise,
                            generator=torch.Generator(device=dev).manual_seed(1))
        counts = launches()
        diff = (got.float().cpu() - want).abs()
        atol, mean_atol = ((INT8_SMALL_ATOL, INT8_SMALL_MEAN_ATOL) if label == "int8"
                           else (SMALL_ATOL, SMALL_MEAN_ATOL))
        print(f"small input {label} (3f 64x64, 4 steps): card bf16 vs CPU fp32 "
              f"max|diff| {diff.max().item():.6g} mean|diff| "
              f"{diff.mean().item():.6g} (tol {atol} / mean {mean_atol}); "
              f"launches {counts}", flush=True)
        if not (torch.isfinite(got).all() and diff.max() <= atol
                and diff.mean() <= mean_atol):
            raise RuntimeError(f"small-input card run ({label}) disagrees with "
                               "the CPU reference")
        took = (counts["K1"] > 0, counts["K4"] > 0, counts["K6"] > 0,
                counts["K7-dense"] > 0 and counts["K7-conv"] > 0, counts["K8"] > 0)
        if took != (True, label == "fused", label == "fused", label == "int8", True):
            raise RuntimeError(f"small-input {label} run took the wrong kernels: {counts}")
        del card
    # past_images (Np = 2: three context tokens, every cross-attention
    # multi-token) with the 'alt' tail (5 steps: full 0-2, alt 2-5, odd), on
    # the default configuration's weights, against the CPU in fp32
    from wiw_tpu_torch.core.schedule import CFGSchedule

    gen_alt = dataclasses.replace(gen, num_inference_steps=5, cfg=CFGSchedule(
        tail_sigma=20.0, tail_policy="alt"))
    past = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 64, 64, 3)).astype(np.float32))
    card = SVDPipeline(*bf16, device=dev)
    card.load_state_dicts(cpu.unet.state_dict(), cpu.vae.state_dict(),
                          cpu.clip.state_dict())
    want = cpu.generate(image, gen_alt, actions, past, init_latents=noise)
    reset_launches()
    got = card.generate(image, gen_alt, actions, past, init_latents=noise)
    counts = launches()
    diff = (got.float().cpu() - want).abs()
    print(f"small input past_images + alt (3f 64x64, Np 2, 5 steps, segments "
          f"{segments_of(gen_alt)}): card bf16 vs CPU fp32 max|diff| "
          f"{diff.max().item():.6g} mean|diff| {diff.mean().item():.6g} (tol "
          f"{SMALL_ATOL} / mean {SMALL_MEAN_ATOL}); launches {counts}", flush=True)
    if not (torch.isfinite(got).all() and diff.max() <= SMALL_ATOL
            and diff.mean() <= SMALL_MEAN_ATOL):
        raise RuntimeError("small-input past_images + alt run disagrees with the CPU")
    if counts != expected({"K1": counts["K1"]}, counts["K8"]) or not counts["K1"]:
        raise RuntimeError(f"small-input past_images + alt took the wrong kernels: {counts}")
    del card


def count_int8_calls(*towers):
    """Forward pre-hooks on every int8 Linear/Conv2d of `towers`: returns (a
    Counter of the calls by (kind, x shape, x dtype, weight shape, stride,
    padding, bias, output dtype), the hook handles)."""
    from collections import Counter

    from wiw_tpu_torch.models.layers import Conv2d, Linear

    seen = Counter()

    def pre(m, args):
        x = args[0]
        conv = isinstance(m, Conv2d)
        seen[("conv" if conv else "dense", tuple(x.shape), x.dtype,
              tuple(m.weight.shape), m.stride[0] if conv else 1,
              m.padding[0] if conv else 0, m.bias is not None,
              m.compute_dtype)] += 1

    handles = [m.register_forward_pre_hook(pre) for tower in towers
               for m in tower.modules()
               if isinstance(m, (Linear, Conv2d)) and m.int8]
    return seen, handles


def k7_ops_bytes(key) -> tuple[int, int, int]:
    """(int8 ops, bytes: x read once, w8 and the output written once,
    output elements) of one K7 call."""
    kind, xshape, xdtype, wshape, stride, pad, _, odt = key
    xbytes = int(np.prod(xshape)) * xdtype.itemsize
    if kind == "dense":
        N, K = wshape
        M = int(np.prod(xshape[:-1]))
    else:
        N, kh, kw, C = wshape
        Nb, H, W, _ = xshape
        M = Nb * ((H + 2 * pad - kh) // stride + 1) * ((W + 2 * pad - kw) // stride + 1)
        K = kh * kw * C
    return 2 * M * N * K, xbytes + N * K + M * N * odt.itemsize, M * N


# K7's kernels by name: the quantisation passes before the product and
# the product
K7_PASSES = {"dense": ("quant_rows",), "conv": ("amax_abs", "quant_tensor")}
K7_PRODUCT = "w8a8_wgmma"


def k7_split(fn, kind: str, reps: int, retries: int = 4) -> tuple[float, float]:
    """Device time of one call of `fn` (a K7 wrapper of `kind`) in its
    quantisation passes and in its product, ms, from torch.profiler over
    `reps` calls. Each kernel runs once a call; its time is averaged over
    the launches the profile recorded (late in a long run it records only
    some, or none of a kernel: then the profile is taken again)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    per_call = {k: 0.0 for k in K7_PASSES[kind] + (K7_PRODUCT,)}
    for e in events:
        for k in per_call:
            if k in e.key and e.count:
                per_call[k] += self_dev(e) / e.count
    missing = [k for k, ms in per_call.items() if not ms]
    if missing:
        print(f"  (the profile held no {missing}: "
              + "; ".join(f"{e.key[:60]} x{e.count} {self_dev(e):.1f} us"
                          for e in events) + ")", flush=True)
        if retries:
            return k7_split(fn, kind, reps, retries - 1)
        raise RuntimeError(f"no {missing} kernel in the profile of a K7 call")
    product = per_call.pop(K7_PRODUCT)
    return sum(per_call.values()) / 1e3, product / 1e3


def k7_phase(dense: Row, conv: Row, forward: dict, request: dict, vae: dict,
             dev, g):
    """K7 at every distinct int8 call of `request` (one int8 request) and
    `forward` (a 2-row UNet forward) and at the largest int8 conv of a VAE
    decode (`vae`): {key: calls} (`count_int8_calls`). Each against its
    plain version (exact int32 sums in float64, the same dequantisation
    order): the bits must be equal, and the phase fails where one element
    differs (the tolerance line is printed too), timed in turns; the
    rows sum one 2-row forward (request_*: one request; vae_*: the VAE
    conv). Library: `torch._int_mm` on the same int8 operands for dense
    (the int8 product alone: no quantisation, no epilogue); none for the
    conv (PyTorch has no int8 conv on CUDA)."""
    from wiw_tpu_torch.ops import quant as TQ

    vae_key = max(vae, key=lambda k: k7_ops_bytes(k)[0])
    for row in (dense, conv):
        for f in ("request_ms", "request_plain_ms", "request_bound_ms",
                  "request_library_ms"):
            row.d[f] = 0.0 if (f != "request_library_ms" or row is dense) else None
    print("K7: bound = max(x read once + w8 + output written once over 3.35 "
          "TB/s, 2*M*N*K int8 ops over 1979 TOPS)", flush=True)
    for key in sorted(set(forward) | set(request) | {vae_key},
                      key=lambda k: -k7_ops_bytes(k)[0]):
        kind, xshape, xdtype, wshape, stride, pad, has_bias, odt = key
        x = (torch.randn(*xshape, generator=g, device=dev) * 2).to(xdtype)
        w8, ws = TQ.quantize_kernel(
            torch.randn(*wshape, generator=g, device=dev) * 0.05)
        b = torch.randn(wshape[0], generator=g, device=dev) if has_bias else None
        lib = None
        if kind == "dense":
            def kern():
                return TQ.w8a8_dense(x, w8, ws, b, odt)

            def plain():
                return TQ.w8a8_dense_plain(x, w8, ws, b, odt)

            x8 = TQ._quant_rows(x.reshape(-1, x.shape[-1]))[0]
            w8t = w8.t()

            def lib():
                return torch._int_mm(x8, w8t)

            try:  # the yardstick only: its own shape rules (M > 16, ...)
                lib()
            except RuntimeError as e:
                print(f"  torch._int_mm refuses {tuple(x8.shape)}: {e}", flush=True)
                lib = None
        else:
            def kern():
                return TQ.w8a8_conv(x, w8, ws, b, stride=stride, padding=pad,
                                    dtype=odt)

            def plain():
                return TQ.w8a8_conv_plain(x, w8, ws, b, stride=stride,
                                          padding=pad, dtype=odt)
        out, ref = kern(), plain()
        same = (out == ref).float().mean().item()
        max_err, line = compare(f"K7-{kind} {xshape} {tuple(wshape)}", out, ref)
        if not torch.equal(out, ref):
            raise RuntimeError(
                f"K7-{kind} x {list(xshape)} w8 {list(wshape)}: bits equal at "
                f"only {same:.9g} of elements; the kernel must equal its plain "
                "version bit for bit")
        del out, ref
        ops, nbytes, _ = k7_ops_bytes(key)
        bound = bound_ms(nbytes, ops, INT8_OPS_S)
        fwd, req = forward.get(key, 0), request.get(key, 0)
        where = "VAE decoder's largest int8 conv" if key == vae_key else (
            f"{fwd} a 2-row forward, {req} a request")
        reps = max(3, min(50, int(2e11 // ops)))
        ms, plain_ms, lib_ms = timed(
            f"K7-{kind} x {list(xshape)} {str(xdtype)[6:]} w8 {list(wshape)} "
            f"stride {stride} -> {str(odt)[6:]} ({where}) {line}; bits equal "
            f"at {same:.6g} of elements", plain, kern, lib, reps, 1, bound,
            lambda ms: f"{ops / ms / 1e9:.1f} TOPS, {nbytes / ms / 1e6:.0f} GB/s")
        passes_ms, product_ms = k7_split(kern, kind, min(reps, 10))
        print(f"  device time a call: passes {passes_ms:.4f} ms + product "
              f"{product_ms:.4f} ms; product {ops / product_ms / 1e9:.1f} TOPS; "
              f"bound {100 * bound / (passes_ms + product_ms):.1f}% of the "
              f"device time ({100 * bound / ms:.1f}% of the event time)",
              flush=True)
        row = dense if kind == "dense" else conv
        by = "operations" if ops / INT8_OPS_S > nbytes / HBM_BYTES_S else "bytes"
        row.add(fwd, max_err, ms, plain_ms, bound, by,
                lib_ms if lib_ms is not None else 0.0)
        d = row.d
        # the row's bound_by: what bounds most of a forward's bound time
        d.setdefault("bound_ms_by", {"operations": 0.0, "bytes": 0.0})[by] += fwd * bound
        d["bound_by"] = max(d["bound_ms_by"], key=d["bound_ms_by"].get)
        for f, v in (("passes_ms", passes_ms), ("product_ms", product_ms)):
            d[f] = d.get(f, 0.0) + fwd * v
        d["request_ms"] += req * ms
        d["request_plain_ms"] += req * plain_ms
        d["request_bound_ms"] += req * bound
        if d["request_library_ms"] is not None:
            d["request_library_ms"] += req * lib_ms
        if key == vae_key:
            conv.d["vae_conv"] = {"x": list(xshape), "w8": list(wshape),
                                  "ms": ms, "plain_ms": plain_ms,
                                  "passes_ms": passes_ms, "product_ms": product_ms,
                                  "bound_ms": bound, "max_abs_err": max_err}
        del x, w8, ws, b
        if kind == "dense":
            del x8, w8t
        torch.cuda.empty_cache()
    for row in (dense, conv):
        d = row.d
        print(f"{d['name']} a 2-row forward, device time: passes "
              f"{d['passes_ms']:.4f} ms + product {d['product_ms']:.4f} ms "
              f"(event time {d['ms']:.4f} ms, bound {d['bound_ms']:.4f} ms)",
              flush=True)
        print(f"{d['name']} per request: kernel {d['request_ms']:.4f} ms, plain "
              f"{d['request_plain_ms']:.4f} ms, bound {d['request_bound_ms']:.4f}"
              f" ms, library {d['request_library_ms']}", flush=True)


def vae_int8_calls(dev):
    """The VAE decoder in W8A8 (`SVDPipeline.quantize_vae`) decoding one
    4-frame chunk at 576x1024 (the bf16 decode's chunk): its int8 conv
    calls ({key: calls}), the decode checked finite. The pipeline's other
    towers are tiny: only the VAE runs."""
    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    pipe = SVDPipeline(
        UNetConfig(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                   layers_per_block=1, cross_attention_dim=32, num_frames=4),
        VAEConfig(dtype="bfloat16"),
        CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=2, patch_size=32, projection_dim=32),
        device=dev)
    n = pipe.quantize_vae()
    pipe.init_params(torch.Generator(device=dev).manual_seed(0))
    calls, hooks = count_int8_calls(pipe.vae)
    before = TQ.w8a8_conv.launches
    with torch.inference_mode():
        z = torch.randn(4, 72, 128, 4, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        video = pipe.vae.decode(z, 4)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launched = TQ.w8a8_conv.launches - before
    print(f"VAE decoder in W8A8: {n} int8 convs (count_quantized "
          f"{TQ.count_quantized(pipe.vae)}), one 4-frame 576x1024 decode: "
          f"{launched} K7-conv launches, output {tuple(video.shape)} finite "
          f"{bool(torch.isfinite(video).all())}", flush=True)
    if (n != TQ.count_quantized(pipe.vae) or launched != sum(calls.values())
            or not launched or not torch.isfinite(video).all()):
        raise RuntimeError("the W8A8 VAE decode did not run as expected")
    del pipe, video
    torch.cuda.empty_cache()
    return calls


def k6_bypass(unet, dev) -> int:
    """With the fused feed-forward switched on, a 2-row int8 forward: K6
    steps aside at every feed-forward whose int8 in-projection would
    otherwise take it (the reference's rule under WIW_QUANT=int8
    WIW_FUSED_FF=1). Returns that count; raises if K6 launched."""
    from wiw_tpu_torch.models.layers import FeedForward
    from wiw_tpu_torch.ops import fused_mlp as TF

    would = []

    def pre(m, args):
        x = args[0]
        if (m.net[0].proj.int8 and x.shape[-1] % TF.C_STEP == 0
                and TF.lnff_eligible(x, x, m.net[2].weight)):
            would.append(1)

    blocks = [m for m in unet.modules() if hasattr(m, "fused_ff")]
    hooks = [m.register_forward_pre_hook(pre) for m in unet.modules()
             if isinstance(m, FeedForward)]
    for m in blocks:
        m.fused_ff = True
    reset_launches()
    try:
        with torch.inference_mode():
            unet(*forward_args(dev))
        torch.cuda.synchronize()
    finally:
        for m in blocks:
            m.fused_ff = False
        for h in hooks:
            h.remove()
    counts = launches()
    print(f"int8 with the fused feed-forward on: K6 stepped aside at "
          f"{len(would)} feed-forwards of a 2-row forward that it takes in "
          f"bf16; launches {counts}", flush=True)
    if counts["K6"] or counts["K6-bf16"] or not would:
        raise RuntimeError("K6 did not step aside for int8 projections")
    return len(would)


def attention_probe_phase(rows: dict, dev, g):
    """K9 (floor, noexp, v2) on bf16 [B, H, S, 64] head views and K10 (bf16
    and int8 PV) on the probe's int8 q, k and [B*H, S, 65] v (column 64
    = 1), at K9_SHAPE, each against its plain version at the kernels' kv
    block width. Bound: the two products over the peak of their types
    (K10: q k^T int8, PV bf16 or int8), or q, k, v read and o written
    once. Library: SDPA for v2 (K1's function); none for the others."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import flash_attention as TFA
    from wiw_tpu_torch.ops import int8_attention as TI

    B, H, S = K9_SHAPE
    q, k, v = (torch.randn(B, S, H * 64, generator=g, device=dev,
                           dtype=torch.bfloat16).view(B, S, H, 64).transpose(1, 2)
               for _ in range(3))
    flops = 4 * B * H * S * S * 64
    bound = bound_ms(4 * B * H * S * 64 * 2, flops, BF16_FLOPS_S)
    for key, fn, plain in (("K9-floor", TFA.attention_floor, TFA.attention_floor_plain),
                           ("K9-noexp", TFA.attention_noexp, TFA.attention_noexp_plain),
                           ("K9-v2", TFA.attention_v2, TFA.attention_v2_plain)):
        def kern(fn=fn):
            return fn(q, k, v)

        # all three run K1's kernel and its 128-row kv stages (KV_TILE)
        def ref(plain=plain):
            return plain(q, k, v, bkv=TFA.KV_TILE)

        out = kern()
        if key == "K9-noexp":
            # out = acc / (d + 1) has a pole where a row's denominator d (a
            # sum of S - m <= 0) nears -1: there the two sides' ~1e-6
            # difference in S is amplified without bound. The rows with
            # |d + 1| >= 1 are held to the tolerance; the others must be
            # finite (their count and error are printed). They must be under
            # 1e-4 of the rows: at these random inputs d is spread over
            # thousands, so |d + 1| < 1 is rare (4 of 1.29 M rows on the
            # H100); more would leave a real part of the output unchecked.
            # The reference is the plain version's arithmetic with float64
            # sums: at KV_TILE 128, rows with |d + 1| of a few units are
            # off by up to ~1% in fp32 on either side; the line printed
            # after the check holds the fp32 plain version to the same
            # reference (not a check)
            want, d1 = plain(q, k, v, bkv=TFA.KV_TILE, with_denominator=True,
                             dtype=torch.float64)
            well = (d1.abs() >= 1).expand_as(want)
            ill_err = (out.float() - want.float())[~well].abs()
            n_ill, n_rows = int((~well).sum()) // 64, want.numel() // 64
            print(f"  {key}: {n_ill} of {n_rows} rows with |d + 1| < 1, max|err| "
                  f"there {ill_err.max().item() if ill_err.numel() else 0.0:.6g}",
                  flush=True)
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{key}: non-finite output")
            if n_ill > 1e-4 * n_rows:
                raise RuntimeError(f"{key}: {n_ill} of {n_rows} rows left "
                                   "unchecked, more than 1e-4 of them")
            max_err, line = compare(f"{key} S={S}", out[well], want[well])
            _, f32_line = compare(f"{key} fp32 plain", ref()[well], want[well],
                                  raises=False)
            print(f"  {key}: the fp32 plain version against the same float64 "
                  f"reference: {f32_line}", flush=True)
            del want, d1, well
        else:
            max_err, line = compare(f"{key} S={S}", out, ref())
        del out
        library = ((lambda: F.scaled_dot_product_attention(q, k, v))
                   if key == "K9-v2" else None)
        ms, plain_ms, lib = timed(f"{key} B*H={B * H} S={S} D=64 {line}", ref,
                                  kern, library, 5, 1, bound,
                                  lambda ms: f"{flops / ms / 1e9:.1f} TFLOP/s")
        rows[key].add(1, max_err, ms, plain_ms, bound, "operations", lib)
    del q, k, v

    def i8(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 40).round().clamp(
            -127, 127).to(torch.int8)

    q8, k8 = i8(B * H, S, 64), i8(B * H, S, 64)
    for key, i8pv in (("K10", False), ("K10-i8pv", True)):
        v = i8(B * H, S, 65) if i8pv else torch.randn(
            B * H, S, 65, generator=g, device=dev).bfloat16()
        v[..., 64] = 1

        def kern(v=v, i8pv=i8pv):
            return TI.int8_qk_attention(q8, k8, v, K10_QK_SCALE, i8pv)

        def ref(v=v, i8pv=i8pv):
            return TI.int8_qk_attention_plain(q8, k8, v, K10_QK_SCALE, i8pv)

        # the plain version at the kernel's 128-row kv block (TI.KV_TILE)
        max_err, line = compare(f"{key} S={S}", kern(), ref())
        half = 2 * B * H * S * S * 64
        k10_bound = max(
            (2 * B * H * S * 64 + B * H * S * 65 * (v.element_size() + 2))
            / HBM_BYTES_S,
            half / INT8_OPS_S + 2 * B * H * S * S * 65 / (
                INT8_OPS_S if i8pv else BF16_FLOPS_S)) * 1e3
        ms, plain_ms, _ = timed(f"{key} B*H={B * H} S={S} D=64 (+ ones column) "
                                f"{line}", ref, kern, None, 5, 1, k10_bound,
                                lambda ms: f"{4 * B * H * S * S * 64 / ms / 1e9:.1f}"
                                           " T(FL)OP/s")
        rows[key].add(1, max_err, ms, plain_ms, k10_bound, "operations")
        # the call's two steps apart: v's repack (a layout copy) and the kernel
        packed = TI.repack_v(v, i8pv)
        repack_ms = cuda_ms(lambda v=v, i8pv=i8pv: TI.repack_v(v, i8pv), 5)
        kernel_ms = cuda_ms(lambda packed=packed, i8pv=i8pv: TI.int8_qk_attention_packed(
            q8, k8, *packed, K10_QK_SCALE, i8pv), 5)
        v2_ms = rows["K9-v2"].d["ms"]
        print(f"  {key}: repack {repack_ms:.4f} ms ({100 * repack_ms / ms:.1f}% of "
              f"the call), kernel alone {kernel_ms:.4f} ms; the probe's decision "
              f"ratio, K9-v2 (K1's kernel, bf16) {v2_ms:.4f} ms / K10 {ms:.4f} ms "
              f"= {v2_ms / ms:.3f} (kernel alone {v2_ms / kernel_ms:.3f}; the "
              f"probe's bar to build an int8 kernel: >= 1.15)", flush=True)
        rows[key].d.update(repack_ms=repack_ms, kernel_alone_ms=kernel_ms,
                           decision_ratio=v2_ms / ms)
        del v, packed
    del q8, k8
    torch.cuda.empty_cache()


def _counters() -> dict:
    """Each kernel's launch count: (wrapper, attribute)."""
    from wiw_tpu_torch.ops import flash_attention as TFA
    from wiw_tpu_torch.ops import fused_mlp as TF
    from wiw_tpu_torch.ops import group_norm as TG
    from wiw_tpu_torch.ops import int8_attention as TI
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.ops import temporal_attention as TT

    return {"K1": (TFA.flash_attention, "launches"),
            "K1-D72": (TFA.flash_attention, "launches_d72"),
            "K2": (TFA.flash_attention_v1, "launches"),
            "K2-unroll2": (TFA.flash_attention_v1, "launches_unroll2"),
            "K3": (TFA.flash_attention_bwd, "launches"),
            "K4": (TT.frame_attention, "launches"),
            "K5": (TF.geglu_ffn, "launches"),
            "K6": (TF.ln_geglu_ffn_residual, "launches"),
            "K6-bf16": (TF.ln_geglu_ffn_residual, "launches_bf16_gate"),
            "K7-dense": (TQ.w8a8_dense, "launches"),
            "K7-conv": (TQ.w8a8_conv, "launches"),
            "K8": (TG.group_norm, "launches"),
            "K9-floor": (TFA.attention_floor, "launches"),
            "K9-noexp": (TFA.attention_noexp, "launches"),
            "K9-v2": (TFA.attention_v2, "launches"),
            "K10": (TI.int8_qk_attention, "launches"),
            "K10-i8pv": (TI.int8_qk_attention, "launches_i8pv"),
            "K8-stats": (TG.group_norm_stats, "launches"),
            "K8-combine": (TG.combine_stats, "launches"),
            "K8-apply": (TG.group_norm_apply, "launches"),
            "K7-amax": (TQ.conv_amax, "launches"),
            "K7-conv-given": (TQ.w8a8_conv, "launches_given")}


def reset_launches():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def expected(fixed: dict, group_norms: int, int8_calls=None) -> dict:
    """The launches a path must show: `fixed`, K8 once per GroupNorm call,
    K7 once per int8 layer call (`count_int8_calls`), every other kernel
    0."""
    k7 = {f"K7-{kind}": sum(n for key, n in (int8_calls or {}).items()
                            if key[0] == kind) for kind in ("dense", "conv")}
    return {**dict.fromkeys(_counters(), 0), **fixed, "K8": group_norms, **k7}


def count_group_norms(*towers):
    """Forward pre-hooks on every GroupNorm of `towers`: returns (a Counter
    of the calls by (shape, dtype, groups, eps, silu), the hook handles)."""
    from collections import Counter

    from wiw_tpu_torch.models.layers import GroupNorm

    seen = Counter()

    def pre(m, args):
        seen[(tuple(args[0].shape), args[0].dtype, m.groups, m.eps, m.silu)] += 1

    handles = [m.register_forward_pre_hook(pre) for tower in towers
               for m in tower.modules() if isinstance(m, GroupNorm)]
    return seen, handles


def forward_args(dev):
    """A 2-row UNet forward's inputs at 576x1024, 14 frames, from a seed."""
    g = torch.Generator(device=dev).manual_seed(2)
    return (torch.randn(2, FRAMES, 72, 128, 8, generator=g, device=dev),
            torch.full((2,), 0.5, device=dev),
            torch.randn(2, 1, 1024, generator=g, device=dev),
            torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev),
            torch.zeros(2, FRAMES, 14, device=dev))


def profile_forward(unet, dev, label):
    """One 2-row UNet forward at 576x1024 under torch.profiler: device time
    by op (top 14 by self time), busy time and the forward's event time.
    Returns the GroupNorm and int8 layer calls of one such forward
    (`count_group_norms`, `count_int8_calls`) and its event time."""
    args = forward_args(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    norms, hooks = count_group_norms(unet)
    int8_calls, int8_hooks = count_int8_calls(unet)
    with torch.inference_mode():
        unet(*args)
        for h in hooks + int8_hooks:
            h.remove()
        fwd_ms = cuda_ms(lambda: unet(*args), 3)
        with torch.profiler.profile(activities=acts) as prof:
            unet(*args)
            torch.cuda.synchronize()

    print(f"profile {label}: 2-row UNet forward {fwd_ms:.2f} ms (CUDA events, "
          f"mean of 3); device busy {busy_ms(prof):.2f} ms in the profiled "
          "forward", flush=True)
    print_top(prof)
    return norms, int8_calls, fwd_ms


def busy_ms(prof) -> float:
    """The device's busy time in a profile: its kernels' self time."""
    return sum(self_dev(e) for e in prof.key_averages()
               if "CUDA" in str(e.device_type)) / 1e3


# device kernels by class, matched on the kernel's name in this order: the
# port's hand-written kernels, products (cuBLAS, cuDNN, CUTLASS), norms,
# and the rest (elementwise, copies, reductions)
KERNEL_CLASSES = (
    ("K8 GroupNorm", ("gn_resident", "gn_stream", "gn_stats", "gn_combine", "gn_apply")),
    ("port attention and feed-forward kernels",
     ("flash_attn", "frame_attn", "geglu_ffn")),
    ("K7 W8A8 product and conv", ("w8a8_wgmma", "quant_rows", "amax_abs",
                                  "quant_tensor")),
    ("GEMM and conv", ("gemm", "xmma", "nvjet", "cutlass", "cudnn", "conv",
                       "wgmma", "sm80_", "sm90_")),
    ("LayerNorm", ("layer_norm",)),
)


def kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise, copies and reductions"


def class_ms(prof) -> dict:
    """A profile's device time by kernel class (KERNEL_CLASSES), ms."""
    by_class = {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            c = kernel_class(e.key)
            by_class[c] = by_class.get(c, 0.0) + self_dev(e) / 1e3
    return by_class


def print_top(prof, n: int = 12) -> None:
    """The top ops and kernels of a profile by self device time, and the
    device time by kernel class (KERNEL_CLASSES)."""
    events = prof.key_averages()
    kernels = sorted((e for e in events if "CUDA" in str(e.device_type)),
                     key=self_dev, reverse=True)
    by_class = class_ms(prof)
    busy = sum(by_class.values())
    print("  device time by kernel class: " + "; ".join(
        f"{c} {ms:.2f} ms ({100 * ms / busy:.1f}%)"
        for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1])), flush=True)
    ops = sorted((e for e in events if "CUDA" not in str(e.device_type)),
                 key=self_dev, reverse=True)
    for what, rows in (("ops", ops), ("kernels", kernels)):
        print(f"  top {what} by self device time:", flush=True)
        for e in rows[:n]:
            print(f"  {self_dev(e) / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:100]}",
                  flush=True)


def slice_phase(dev, label: str, requests: int, steps: int = STEPS, **config):
    """`requests` full-width requests of one configuration at `steps` Euler
    steps (K6's gate from the environment, WIW_FUSED_FF_GATE, as the worker
    reads it). Returns
    the launches, the GroupNorm and int8 layer calls of the last request
    and of a 2-row forward, the last request's frames and the forward's
    event time."""
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    t0 = time.perf_counter()
    worker = SVDActionWorker(
        width=1024, height=576, num_frames=FRAMES, num_inference_steps=steps,
        out_width=480, out_height=480, action_strategy="micro_cond",
        action_input_channel=14, dtype="bfloat16", cfg_schedule="serving",
        device="cuda", seed=0, **{"fused_ff": False, "quantize": "bf16",
                                  "temporal_attention": "batched", **config})
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in worker.pipe.unet.parameters())
    n_int8 = TQ.count_quantized(worker.pipe.unet)
    print(f"{label} worker built: UNet {n_params / 1e9:.3f} B params, "
          f"config fused_ff={worker.pipe.unet_config.fused_ff} "
          f"temporal_attention={worker.pipe.unet_config.temporal_attention} "
          f"quantize={worker.quantize} ({n_int8} int8 weights), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if (n_int8 > 0) != (worker.quantize == "int8"):
        raise RuntimeError(f"{label}: {n_int8} int8 weights in {worker.quantize}")

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

    hooks = [worker.pipe.unet.register_forward_pre_hook(pre),
             worker.pipe.unet.register_forward_hook(post),
             worker.pipe.vae.decoder.register_forward_hook(decoded)]
    norms, norm_hooks = count_group_norms(worker.pipe.unet, worker.pipe.vae)
    int8_calls, int8_hooks = count_int8_calls(worker.pipe.unet, worker.pipe.vae)

    rng = np.random.default_rng(0)
    request = {
        "b_action": np.array([[4, 1, 1, 2, 2, 1, 3, 3, 1, 1, 2, 1, 3, 1]]),
        "b_image": rng.integers(0, 256, (1, 3, 576, 1024), dtype=np.uint8),
        "save_dirs": ["unused"],
        "request_model_name": "igenex",
        "return_objects": [True],
    }
    total = dict.fromkeys(_counters(), 0)
    for i in range(requests):
        marks.clear()
        norms.clear()
        int8_calls.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # count this request of this path only
        t = time.perf_counter()
        out = worker(request)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = launches()
        want = expected({k: n * steps for k, n in PER_FORWARD[label].items()},
                        sum(norms.values()), int8_calls)
        frames = out["pred_frames"]
        denoise_s = marks["start"].elapsed_time(marks["end"]) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label} request {i} ({steps} steps): {secs:.3f} s, denoise "
              f"{denoise_s:.3f} s = "
              f"{FRAMES / denoise_s:.4f} frames/s, pred_frames {frames.shape} "
              f"{frames.dtype}, finite {bool(finite)}, std {frames.std():.3f}, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {counts}", flush=True)
        if frames.shape != (1, FRAMES, 3, 480, 480) or frames.dtype != np.uint8:
            raise RuntimeError(f"bad pred_frames {frames.shape} {frames.dtype}")
        if not bool(finite) or frames.min() == frames.max():
            raise RuntimeError("non-finite or constant output")
        if counts != want or not counts["K8"] or (
                (counts["K7-dense"] > 0) != (worker.quantize == "int8")):
            raise RuntimeError(f"{label}: launches {counts}, expected {want}")
        for k in total:
            total[k] += counts[k]
    for h in hooks + norm_hooks + int8_hooks:
        h.remove()
    reset_launches()
    forward_norms, forward_int8, fwd_ms = profile_forward(worker.pipe.unet, dev,
                                                          label)
    info = {"request": norms, "forward": forward_norms, "frames": frames,
            "int8_request": int8_calls, "int8_forward": forward_int8,
            "s": secs, "frames_s": FRAMES / denoise_s, "forward_ms": fwd_ms,
            "peak_gib": peak,
            "int8_weights": n_int8}
    if worker.quantize == "int8":
        info["k6_bypass"] = k6_bypass(worker.pipe.unet, dev)
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    # the GroupNorm and int8 calls of the last request and of one 2-row
    # forward, for K8's and K7's phases
    return total, info


# the serve phase: server_cli's defaults (igenex, the continuous executor's
# 4 slots, W8A8 int8, 30 steps, SERVING_CFG, --warmup_batches 1), two
# clients of 2 candidates each, the second ~3 ticks after the first
SERVE_CLIENTS = (("A", 2, 0), ("B", 2, 3))  # (name, candidates, ticks before)
# the engine against the pipeline (bf16, one request alone in the pool),
# and the action_block and manipulation requests: a cut depth
CHECK_STEPS = 8
WORLD_STEPS = 10
# the rollouts phase: the serving target of at least 8 concurrent
# closed-loop agent rollouts (BASELINE.md), against server_cli's default
# engine at a cut depth of 10 steps (its default is 30)
ROLLOUT_CLIENTS, ROLLOUT_DECISIONS, ROLLOUT_CANDIDATES = 8, 2, 2
ROLLOUT_STEPS = 10
# the solvers phase (after the rollouts, on their server): SOLVER_EPISODES
# episodes of AR, IGNav and A-EQA through `run_solver`, each cut to
# SOLVER_ACTIONS[task] actions (--max_action_num; the solvers' own limits
# are 10, 50 and 250): one decision step an episode each (IGNav's of 3
# actions, A-EQA's high-level round of 2), so that the three tasks fit the
# script's time. A decision step is one request the 4-slot engine computes
# alone, all 8 rows a tick: ~14 s at 10 steps
SOLVER_EPISODES = 2
SOLVER_ACTIONS = {"AR": 1, "IGNav": 3, "AEQA": 2}
# A-EQA's episodes (--use_heur --use_wm_imagination --use_detector): the
# fake simulator wrapped with a constant depth of AEQA_DEPTH_M at the pano's
# size (beyond nav's 2.4 m open-space threshold, so every high-level round
# imagines its direction), against a gd_sam2 server that server_cli builds
# with the port's grounding worker as its external command; 2 actions an
# episode: one high-level round (a detector request, a WM request of one
# candidate, the heuristic plan's 2 forwards)
AEQA_DEPTH_M = 3.0
GD_SAM2_CMD = "python -m wiw_tpu_torch.workers.grounding_worker"
# the full-size warps on the card against the CPU: both sample at the same
# cached grid (built on the CPU) with the same fp32 ops, so the uint8 values
# may differ by at most one step, on at most WARP_SHARE of the values
WARP_SHARE = 1e-4
# geo/pointcloud's window at full size (14 faces of habitat_configs'
# face_size 512, hfov 90): void ratios card against CPU within
# VOID_RATIO_PIXELS pixels of a frame, tests/test_torch_pointcloud.py's
# tolerance (the pose inverse and the transform's products sum in other
# orders on the card: a last-bit difference moves points across pixel
# edges; a 1e-7 relative perturbation of the poses moved <= 3 pixels)
VOID_WINDOW = (14, 512, 512)
VOID_RATIO_PIXELS = 8
# the eval phase: inference_cli on EVAL_CLIPS clips at a cut depth; LPIPS
# held card vs CPU on LPIPS_FRAMES frame pairs at 576x1024
EVAL_CLIPS, EVAL_STEPS, LPIPS_FRAMES = 2, 10, 4
EVAL_HW = (576, 1024)  # inference_cli's default size
# the eval towers on the card against the CPU, fp32 with TF32 off: both sum
# fp32 products in their own orders through ~22 layers (I3D) or 5 (AlexNet),
# ~1e-6 relative a layer, so every element within TOWER_REL of max |ref|
# and a relative Frobenius error within TOWER_REL. frechet_distance (which
# computes on the host): FD_REL relative on well-conditioned features
# (256 x 64) given on the card and on the CPU; on the run's own
# features (2 clips a side: rank-1 400 x 400 covariances, whose fp32
# eigendecomposition is ~1% of their traces off float64 on either side,
# tests/test_torch_eval.py) within FD_TRACE_REL of the traces' sum
TOWER_REL, FD_REL, FD_TRACE_REL = 1e-4, 1e-4, 2e-2
# the past_images + alt request: 10 steps (a cut depth); tail from sigma
# 1.0 makes the segments full 0-7, alt 7-10 (odd: stale, full, stale)
PAST_STEPS, PAST_TAIL_SIGMA = 10, 1.0
# the habitat-sim double (numpy; habitat-sim is not on the card's host): the
# collect phase and the habitat AR episode run under it
HABITAT_DOUBLE = "tests/habitat_sim_double.py"
# the collect phase: collect_cli at its defaults (512^2 faces to a 1000x2000
# pano) on one scene, COLLECT_POINTS points and one trajectory; one pano of
# the same faces on the card at most COLLECT_STEP uint8 steps from the CPU's
# (the grid is the same; the warps of the solvers phase showed 0)
COLLECT_POINTS, COLLECT_STEP = 6, 1
# the manip phase: run_manip's igenex arms on the fake environment, one
# episode of MANIP_TASK each, against a 4-slot engine around world_phase's
# igenex_manip worker and a policy server whose subprocess worker is the
# diffusion policy's fake pipe (no trained 3D-Diffuser-Actor checkpoint)
MANIP_TASK = "push_buttons"
DIFF_POLICY_CMD = "python -m wiw_tpu_torch.workers.diff_policy --fake_pipe"


def segments_of(gen) -> tuple:
    from wiw_tpu_torch.core.schedule import cfg_row_segments

    return cfg_row_segments(gen.num_inference_steps, gen.cfg, gen.edm)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_request(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"b_action": rng.integers(1, 4, (n, FRAMES)),
            "b_image": rng.integers(0, 256, (n, 3, 576, 1024), dtype=np.uint8),
            "save_dirs": [f"c{seed}_{i}" for i in range(n)],
            "request_model_name": "igenex", "return_objects": [True] * n}


def shape_checks(label: str, norms: dict, int8_calls: dict, dev, g):
    """K8 at every GroupNorm shape and K7 at every int8 call a path ran
    (`count_group_norms`, `count_int8_calls`), each against its plain
    version once: K8 within the tolerance, K7 bit for bit (K7-dense's plain
    version in blocks of rows: its scales are per row)."""
    from wiw_tpu_torch.ops import group_norm as TG
    from wiw_tpu_torch.ops import quant as TQ

    for (shape, dtype, groups, eps, silu), calls in sorted(
            norms.items(), key=lambda kv: -int(np.prod(kv[0][0]))):
        C = shape[-1]
        x = (torch.randn(*shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype)
        w = 1 + 0.2 * torch.randn(C, generator=g, device=dev)
        b = 0.3 * torch.randn(C, generator=g, device=dev)
        _, line = compare(f"K8 {shape}", TG.group_norm(x, w, b, groups, eps, silu),
                          TG.group_norm_plain(x, w, b, groups, eps, silu))
        print(f"  {label} K8 {list(shape)} {str(dtype)[6:]} G={groups} silu={silu} "
              f"({calls} calls): {line}", flush=True)
        del x
    for key, calls in sorted(int8_calls.items(), key=lambda kv: -k7_ops_bytes(kv[0])[0]):
        kind, xshape, xdtype, wshape, stride, pad, has_bias, odt = key
        x = (torch.randn(*xshape, generator=g, device=dev) * 2).to(xdtype)
        w8, ws = TQ.quantize_kernel(torch.randn(*wshape, generator=g, device=dev) * 0.05)
        b = torch.randn(wshape[0], generator=g, device=dev) if has_bias else None
        if kind == "dense":
            out = TQ.w8a8_dense(x, w8, ws, b, odt).reshape(-1, wshape[0])
            flat = x.reshape(-1, x.shape[-1])
            same = all(torch.equal(out[i:i + 65536], TQ.w8a8_dense_plain(
                flat[i:i + 65536], w8, ws, b, odt)) for i in range(0, len(flat), 65536))
        else:
            out = TQ.w8a8_conv(x, w8, ws, b, stride=stride, padding=pad, dtype=odt)
            same = torch.equal(out, TQ.w8a8_conv_plain(x, w8, ws, b, stride=stride,
                                                       padding=pad, dtype=odt))
        print(f"  {label} K7-{kind} x {list(xshape)} w8 {list(wshape)} ({calls} "
              f"calls): bits equal {same}", flush=True)
        if not same:
            raise RuntimeError(f"K7-{kind} at {xshape} differs from its plain version")
        del x, out
    torch.cuda.empty_cache()


def build_server(*flags):
    """`server_cli.build_executors` with the CLI's defaults and `flags`, on
    a free local port (warmup included): (args, executors, the default
    continuous executor, its engine, the engine's pipeline, int8 weights)."""
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.serve import server_cli

    t0 = time.perf_counter()
    args, extra = server_cli.build_parser().parse_known_args(
        ["--host", "127.0.0.1", "--port", str(free_port()), *flags])
    execs = server_cli.build_executors(args, extra)
    torch.cuda.synchronize()
    ex = execs[0]
    eng, pipe = ex.engine, ex.engine.pipe
    n_int8 = TQ.count_quantized(pipe.unet)
    print(f"server_cli {' '.join(flags) or 'defaults'} (wm_type {args.wm_type}, "
          f"executor {args.executor}, {eng.S} slots, quantize {args.quantize} "
          f"({n_int8} int8 weights), {eng.num_steps} steps, tail from step "
          f"{eng._tail_start}, {eng.gen.height}x{eng.gen.width}, {eng.F} frames, out "
          f"{eng.out_hw}, warmup batches {args.warmup_batches!r}): built and warmed "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if (len(execs), eng.S, eng.num_steps, n_int8) != (1, 4, args.num_inference_steps,
                                                       98) or eng._tail_start is None:
        raise RuntimeError("server_cli's defaults did not build the 4-slot int8 engine")
    return args, execs, ex, eng, pipe


def watch_ticks(eng, pipe):
    """Wraps the engine's `_step_once`: per tick CUDA events, the active
    slots and the launches, with what they must be (K1 16 a tick, K8 the
    GroupNorm calls and K7 the int8 layer calls hooks counted in that
    tick, every other kernel 0). Returns (the ticks, the GroupNorm and int8
    call counters, a function that undoes it all)."""
    norms, norm_hooks = count_group_norms(pipe.unet, pipe.vae)
    int8_calls, int8_hooks = count_int8_calls(pipe.unet, pipe.vae)
    ticks = []
    real_step = eng._step_once

    def int8_by_kind():
        return {k: sum(n for key, n in int8_calls.items() if key[0] == k)
                for k in ("dense", "conv")}

    def tick(state, cond_only=False):
        before, gn, i8 = launches(), sum(norms.values()), int8_by_kind()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_step(state, cond_only)
        end.record()
        after, i8_after = launches(), int8_by_kind()
        counts = {k: after[k] - before[k] for k in after}
        want = expected({"K1": 16}, sum(norms.values()) - gn,
                        {("dense",): i8_after["dense"] - i8["dense"],
                         ("conv",): i8_after["conv"] - i8["conv"]})
        ticks.append({"cond_only": cond_only, "events": (start, end),
                      "counts": counts, "want": want,
                      "active": sum(s.active for s in eng._slots)})
        return out

    def restore():
        del eng._step_once  # the class's method again: no cycle through eng
        for h in norm_hooks + int8_hooks:
            h.remove()

    eng._step_once = tick
    return ticks, norms, int8_calls, restore


def tick_summary(label: str, ticks: list, slots: int) -> dict:
    """Checks every tick's launches against what it must be, prints the
    first full and cond-only tick's, and returns the tick figures: counts,
    median ms of each kind, the tail share, the active slots by tick and
    the idle-slot share (slot-ticks computed with no request in them)."""
    by_kind = {False: [], True: []}
    for t in ticks:
        by_kind[t["cond_only"]].append(t["events"][0].elapsed_time(t["events"][1]))
        if t["counts"] != t["want"]:
            raise RuntimeError(f"{label} tick launches {t['counts']}, expected {t['want']}")
    full, cond = by_kind[False], by_kind[True]
    first = {c: next(t for t in ticks if t["cond_only"] == c) for c in (False, True)
             if any(t["cond_only"] == c for t in ticks)}
    for c, t in first.items():
        keep = {k: t["counts"][k] for k in ("K1", "K7-dense", "K7-conv", "K8")}
        print(f"{label} launches a {'cond-only (4-row)' if c else 'full (8-row)'} "
              f"tick: {keep}, expected {({k: t['want'][k] for k in keep})} (every "
              f"other kernel 0)", flush=True)
    active = [t["active"] for t in ticks]
    return {"ticks": len(ticks), "full_ticks": len(full), "cond_ticks": len(cond),
            "tail_share": len(cond) / len(ticks),
            "full_tick_ms": float(np.median(full)),
            "full_tick_ms_range": (float(np.mean(full)), min(full), max(full)),
            "cond_tick_ms": float(np.median(cond)) if cond else None,
            "active": active, "ticks_s": (sum(full) + sum(cond)) / 1e3,
            "idle_slot_share": 1.0 - sum(active) / (slots * len(ticks))}


def serve_phase(rows: dict, dev, g) -> dict:
    """The WM server's default path: `server_cli.build_executors` with the
    CLI's defaults (warmup included), a `ManagerServer` on a free port,
    two `WMClient` threads (SERVE_CLIENTS). Per tick (the engine's
    `_step_once`, wrapped): CUDA events and the launches against the
    GroupNorm and int8 calls counted by hooks in that tick, K1 16 a tick.
    Then each request's seconds, served frames/s, the tail share, phase_s
    and peak memory, and K8/K7 held to their plain versions at every shape
    the run gave them (112 and 56 UNet rows, the whole-clip decode).
    Returns the launches over the served run."""
    from wiw_tpu_torch.serve.manager import ManagerServer, WMClient

    args, execs, ex, eng, pipe = build_server()
    ticks, norms, int8_calls, restore = watch_ticks(eng, pipe)
    server = ManagerServer(execs, host="127.0.0.1", port=args.port)
    port = server.start()
    results, errors = {}, []

    def client(name, n, after_ticks, seed):
        try:
            deadline = time.time() + 600
            while len(ticks) < after_ticks and time.time() < deadline:
                time.sleep(0.005)
            c = WMClient(port=port)
            t = time.perf_counter()
            out = c.send_batch(serve_request(n, seed))
            results[name] = (time.perf_counter() - t, len(ticks), out)
            c.close()
        except Exception as e:  # reported below: the phase fails
            errors.append(f"client {name}: {e!r}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(name, n, after, i + 1))
               for i, (name, n, after) in enumerate(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    total = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    server.stop()
    restore()
    if errors or any(t.is_alive() for t in threads) or len(results) != len(SERVE_CLIENTS):
        raise RuntimeError(f"serve clients failed: {errors}")
    frames = 0
    for name, n, _ in SERVE_CLIENTS:
        secs, at_tick, out = results[name]
        pred = out.get("pred_frames")
        print(f"serve client {name}: {n} candidates in {secs:.3f} s (answered "
              f"after tick {at_tick}); pred_frames "
              f"{None if pred is None else (pred.shape, str(pred.dtype))}, "
              f"error {out.get('error')}", flush=True)
        if pred is None or pred.shape != (n, FRAMES, 3, 480, 480) or (
                pred.dtype != np.uint8) or pred.min() == pred.max():
            raise RuntimeError(f"serve client {name}: bad answer {out.get('error')}")
        frames += n * FRAMES
    info = tick_summary("serve", ticks, eng.S)
    info.update({"wall_s": wall, "frames_s": frames / wall, "peak_gib": peak,
                 "phase_s": dict(ex.phase_s),
                 "request_s": {name: results[name][0] for name, _, _ in SERVE_CLIENTS}})
    mean, lo, hi = info.pop("full_tick_ms_range")
    print(f"serve: {info['ticks']} ticks, {info['full_ticks']} full (8 UNet rows) at "
          f"median {info['full_tick_ms']:.2f} ms (mean {mean:.2f}, min {lo:.2f}, max "
          f"{hi:.2f}), {info['cond_ticks']} cond-only (4 rows) at median "
          f"{info['cond_tick_ms']} ms; tail share {info['tail_share']:.4f}; active "
          f"slots by tick {info['active']}; wall {wall:.3f} s, served {frames} frames "
          f"= {info['frames_s']:.4f} frames/s; phase_s {info['phase_s']}; peak "
          f"{peak:.2f} GiB; launches {total}", flush=True)
    if not info["cond_ticks"] or not total["K1"] or not total["K7-dense"] or not total["K8"]:
        raise RuntimeError("the serve run missed the tail or a kernel of its path")
    rows["K8"].d["serve"] = rows["K7-dense"].d["serve"] = info
    shape_checks("serve", norms, int8_calls, dev, g)
    del execs, ex, eng, pipe, server
    gc.collect()
    torch.cuda.empty_cache()
    return total


def rollouts_phase(rows: dict) -> tuple:
    """The serving target, concurrent closed-loop rollouts: ROLLOUT_CLIENTS
    threads of the port's `serve.benchmarks.run_benchmark` (each agent:
    heuristic candidates -> one WM request -> pick -> step, ROLLOUT_DECISIONS
    times, ROLLOUT_CANDIDATES candidates of 14 frames) against one
    `server_cli` default engine at ROLLOUT_STEPS steps (a cut depth).
    Every answer must be [2, 14, 3, 480, 480] uint8 with no error, no
    worker restarted, and every tick's launches what hooks say (as the
    serve phase's). Prints the benchmark's own figures, served frames/s,
    the tick figures, the idle-slot share, phase_s and the peak. Then the
    solvers phase and the habitat AR episode run against the same server
    (`solvers_phase`, `habitat_phase`). Returns the launches over the
    rollouts, over the solvers phase and over the habitat episode."""
    import shutil
    import tempfile

    from wiw_tpu_torch.serve import benchmarks
    from wiw_tpu_torch.serve.manager import ManagerServer, WMClient

    args, execs, ex, eng, pipe = build_server(
        "--num_inference_steps", str(ROLLOUT_STEPS))
    ticks, norms, int8_calls, restore = watch_ticks(eng, pipe)
    answers, lock = [], threading.Lock()
    real_send = WMClient.send_batch

    def send(self, input_dict):  # every client's answers, for the checks
        out = real_send(self, input_dict)
        with lock:
            answers.append(out)
        return out

    server = ManagerServer(execs, host="127.0.0.1", port=args.port)
    port = server.start()
    root = tempfile.mkdtemp(prefix="wiw_rollouts_")
    WMClient.send_batch = send
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        bench = benchmarks.run_benchmark(
            port, clients=ROLLOUT_CLIENTS, steps=ROLLOUT_DECISIONS,
            candidates=ROLLOUT_CANDIDATES, frames=FRAMES, save_root=root)
        wall = time.perf_counter() - t0
        WMClient.send_batch = real_send
        torch.cuda.synchronize()
        total = launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = server.get_stats()
        ticks = list(ticks)  # the solvers' ticks are checked, not summed here
        solver_total = solvers_phase(port, server, torch.device("cuda"))
        habitat_total = habitat_phase(port, server, torch.device("cuda"))
    finally:
        WMClient.send_batch = real_send
        server.stop()
        restore()
        shutil.rmtree(root, ignore_errors=True)
    requests = ROLLOUT_CLIENTS * ROLLOUT_DECISIONS
    bad = [(a.get("error"), None if a.get("pred_frames") is None else
            (a["pred_frames"].shape, str(a["pred_frames"].dtype))) for a in answers
           if "error" in a or a.get("pred_frames") is None
           or a["pred_frames"].shape != (ROLLOUT_CANDIDATES, FRAMES, 3, 480, 480)
           or a["pred_frames"].dtype != np.uint8]
    print(f"rollouts ({ROLLOUT_CLIENTS} clients x {ROLLOUT_DECISIONS} decision "
          f"steps x {ROLLOUT_CANDIDATES} candidates, server_cli defaults at "
          f"{ROLLOUT_STEPS} steps, a cut depth): run_benchmark {json.dumps(bench)}; "
          f"{len(answers)} answers, {len(bad)} bad; manager stats requests "
          f"{stats['requests']} items {stats['items']} errors {stats['errors']} "
          f"worker restarts {stats['worker_restarts']} workers alive "
          f"{stats['workers_alive']}", flush=True)
    if bad or len(answers) != requests or stats["errors"] or stats["worker_restarts"] or (
            stats["requests"], stats["items"]) != (requests, requests * ROLLOUT_CANDIDATES):
        raise RuntimeError(f"rollouts: bad answers {bad[:3]} or stats {stats}")
    info = tick_summary("rollouts", ticks, eng.S)
    frames = requests * ROLLOUT_CANDIDATES * FRAMES
    mean, lo, hi = info.pop("full_tick_ms_range")
    info.update({**bench, "wall_s": wall, "frames_s": frames / wall, "peak_gib": peak,
                 "phase_s": dict(ex.phase_s), "steps": ROLLOUT_STEPS})
    print(f"rollouts: {info['ticks']} ticks, {info['full_ticks']} full (8 UNet rows) at "
          f"median {info['full_tick_ms']:.2f} ms (mean {mean:.2f}, min {lo:.2f}, max "
          f"{hi:.2f}), {info['cond_ticks']} cond-only (4 rows) at median "
          f"{info['cond_tick_ms']} ms; tail share {info['tail_share']:.4f}; active "
          f"slots by tick {info['active']}; idle-slot share "
          f"{info['idle_slot_share']:.4f}; wall {wall:.3f} s, served {frames} frames "
          f"= {info['frames_s']:.4f} frames/s; rollout steps/s "
          f"{bench['rollout_steps_per_sec']}, latency p50 {bench['latency_p50_s']} s "
          f"p95 {bench['latency_p95_s']} s; the ticks' device time {info['ticks_s']:.3f} "
          f"s of the engine phase's {info['phase_s']['engine']:.3f} s (host clock: the "
          f"rest is the whole-clip decodes and host waits between ticks); phase_s "
          f"{info['phase_s']}; peak "
          f"{peak:.2f} GiB; launches {total}", flush=True)
    if not total["K1"] or not total["K7-dense"] or not total["K7-conv"] or not total["K8"]:
        raise RuntimeError("the rollouts missed a kernel of their path")
    rows["K1"].d["rollouts"] = info
    del execs, ex, eng, pipe, server
    gc.collect()
    torch.cuda.empty_cache()
    return total, solver_total, habitat_total


def device_launches(fn) -> int:
    """Device operations (kernels, copies, memsets) of one call of `fn`, by
    torch.profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if self_dev(e) > 0)


def warp_checks() -> dict:
    """`measure_warps` in a process of its own (`chip_smoke.py --warps
    PATH`, which writes its result to PATH): late in a long run
    torch.profiler drops device events (PR 15's final run counted 4, 0 and
    0 operations a call where a fresh process counts 28, 14 and 14)."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="wiw_warps_", suffix=".json")
    os.close(fd)
    try:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--warps", path],
                       check=True, timeout=600)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def measure_warps(dev) -> dict:
    """The solvers' warps at full size on the card, each against the same
    function on the CPU (uint8 values: clipped and cast as the solvers do):
    `aligned_front_crops` of a 14-frame 576x1024 uint8 clip with its mask
    channel (the AR path's crop, 384x512), `cube_to_equirect` from 6 faces
    of 512^2 to 576x1024, `get_perspective_views` at 512. Prints the
    largest difference in uint8 steps, the share of values that differ,
    the ms a call by CUDA events (aligned_front_crops from host uint8 to
    host uint8, the copies included; the other two from uint8 on the card
    to fp32 on the card) and the device operations a call; raises above 1
    step or above WARP_SHARE."""
    from wiw_tpu_torch.geo import equirect as TE

    from wiw_tpu_torch.agents import surround

    rng = np.random.default_rng(31)
    clip = rng.integers(0, 256, (FRAMES, 576, 1024, 4), dtype=np.uint8)
    clip[..., 3] = 0
    clip[:, 200:330, 600:760, 3] = 255  # the mask channel of the target
    shifts = rng.integers(-512, 512, FRAMES).astype(np.int32)
    faces = rng.integers(0, 256, (6, 512, 512, 3), dtype=np.uint8)
    pano = rng.integers(0, 256, (576, 1024, 3), dtype=np.uint8)
    faces_d, pano_d = torch.from_numpy(faces).to(dev), torch.from_numpy(pano).to(dev)

    def u8(x):
        return x.clamp(0, 255).to(torch.uint8).cpu().numpy()

    cases = {
        "aligned_front_crops 14x576x1024x4 -> 384x512": (
            lambda: TE.aligned_front_crops(clip, shifts, 90.0, 384, 512, device=dev),
            lambda: TE.aligned_front_crops(clip, shifts, 90.0, 384, 512, device="cpu"),
            lambda out: out),
        "cube_to_equirect 6x512^2 -> 576x1024": (
            lambda: TE.cube_to_equirect(faces_d, 576, 1024, device=dev),
            lambda: TE.cube_to_equirect(faces, 576, 1024, device="cpu"), u8),
        "get_perspective_views 576x1024 -> 4x512^2": (
            lambda: TE.get_perspective_views(pano_d, 90.0, 512, device=dev),
            lambda: TE.get_perspective_views(pano, 90.0, 512, device="cpu"), u8),
        # A-EQA's planner views, host uint8 to labelled host uint8
        "annotated_surround_views 576x1024 -> 4x256^2, hfov 105": (
            lambda: surround.annotated_surround_views(pano, 256, 105.0, device=dev),
            lambda: surround.annotated_surround_views(pano, 256, 105.0, device="cpu"),
            np.stack),
    }
    out = {}
    for label, (card, cpu, home) in cases.items():
        got, want = home(card()), home(cpu())  # the first call builds the grid
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        ms = cuda_ms(card, 10)
        n = device_launches(card)
        out[label] = {"max_steps": int(d.max()), "share": float((d != 0).mean()),
                      "ms": ms, "launches": n}
        print(f"warp {label} on {dev} against the CPU: max {int(d.max())} uint8 "
              f"steps, {float((d != 0).mean()):.3g} of {d.size} values differ (limit "
              f"1 step on {WARP_SHARE}); {ms:.4f} ms a call (CUDA events, 10 calls), "
              f"{n} device operations a call", flush=True)
        if d.max() > 1 or (d != 0).mean() > WARP_SHARE:
            raise RuntimeError(f"warp {label}: the card is off the CPU")
    out["void_ratios"] = measure_void_ratios(dev)
    return out


def measure_void_ratios(dev) -> dict:
    """`geo.pointcloud.compute_window_void_ratios` on a VOID_WINDOW of depth
    faces (262,144 points a frame; smooth surfaces with a hole, poses turning
    4 deg and stepping 0.1 m a frame, hfov 90 intrinsics) on the card
    against the CPU: the ratios within VOID_RATIO_PIXELS pixels of a frame
    (frame 0 into itself: its hole and edges, under 0.1);
    ms a call by CUDA events (inputs on the card) and device operations a
    call; raises off the tolerance or on a ratio outside [0, 1]."""
    from wiw_tpu_torch.geo import pointcloud as PC

    F, H, W = VOID_WINDOW
    yy, xx = np.mgrid[0:H, 0:W]
    depth = (2.0 + 1.5 * np.sin(xx / 60.0) + 0.8 * np.cos(yy / 45.0)).astype(np.float32)
    depths = np.repeat(depth[None], F, axis=0)
    depths[:, 200:260, 300:380] = 0.0  # no depth there
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for i in range(1, F):
        a = np.radians(4.0 * i)
        poses[i, 0, 0], poses[i, 0, 2], poses[i, 2, 0], poses[i, 2, 2] = (
            np.cos(a), np.sin(a), -np.sin(a), np.cos(a))
        poses[i, :3, 3] = (0.05 * i, 0.0, -0.1 * i)
    K = PC.habitat_intrinsics(W, H, 90.0)
    depths_d, poses_d = torch.from_numpy(depths).to(dev), torch.from_numpy(poses).to(dev)

    def card():
        return PC.compute_window_void_ratios(depths_d, poses_d, K)

    got = card().cpu().numpy()
    want = PC.compute_window_void_ratios(depths, poses, K).numpy()
    pixels = float(np.abs(got - want).max()) * H * W
    ms = cuda_ms(card, 10)
    n = device_launches(card)
    print(f"pointcloud compute_window_void_ratios {F}x{H}x{W} ({H * W} points a "
          f"frame) on {dev} against the CPU: ratios {np.round(got, 6).tolist()}, "
          f"largest difference {pixels:.1f} pixels of a frame (limit "
          f"{VOID_RATIO_PIXELS}); {ms:.4f} ms a call (CUDA events, 10 calls), {n} "
          f"device operations a call", flush=True)
    if pixels > VOID_RATIO_PIXELS or not (0 <= got.min() and got.max() <= 1) or got[0] > 0.1:
        raise RuntimeError(f"void ratios: the card is off the CPU ({pixels} pixels) "
                           f"or out of range: {got}")
    return {"window": [F, H, W], "ratios": got.tolist(), "max_pixels": pixels,
            "ms": ms, "launches": n}


def solver_args(root: str, task: str, port: int, dev, gd_port: int = 0) -> list:
    """`run_solver`'s arguments for `task` against the server at `port`, on
    a gzip'd episode file of SOLVER_EPISODES episodes written into `root`
    (as tests/test_integration.py writes one); AR's carry a target's 3D box
    1 m ahead of the camera, so every decision step projects it and crops
    the imagined clips around it; A-EQA's a question, and its run imagines
    each high-level direction and asks the gd_sam2 server at `gd_port`."""
    import gzip

    box = [[x, y, z] for x in (-0.2, 0.2) for y in (-0.2, 0.2) for z in (-1.2, -0.8)]
    extra = {"AR": lambda i: {"bbox_corners_world": box,
                              "cam_to_world": np.eye(4).tolist()},
             "AEQA": lambda i: {"question_id": f"smoke{i}", "answer": "red",
                                "question": "what color is the sofa?"}}
    eps = [{"episode_id": i, "scene_id": f"scene{i}", "target_category": "chair",
            **extra.get(task, lambda i: {})(i)} for i in range(SOLVER_EPISODES)]
    path = os.path.join(root, f"episodes_{task}.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"episodes": eps}, f)
    aeqa = (["--use_wm_imagination", "--use_detector", "--gd_sam2_port", str(gd_port)]
            if task == "AEQA" else [])
    return ["--task", task, "--dataset_path", path, "--exp_id", "smoke",
            "--simulator", "fake", "--use_heur", "--wm_type", "igenex",
            "--max_episodes", str(SOLVER_EPISODES), "--max_action_num",
            str(SOLVER_ACTIONS[task]), "--WM_port", str(port), "--states_root", root,
            "--worker_num", "1", "--device", torch.device(dev).type, *aeqa]


def gd_sam2_server():
    """A-EQA's detector as `python -m wiw_tpu_torch.serve.server_cli
    --server_type gd_sam2 --external_cmd GD_SAM2_CMD` builds it
    (`build_executors`: the port's grounding worker as a subprocess worker)
    behind a `ManagerServer` on a free port; returns (server, port)."""
    from wiw_tpu_torch.serve import server_cli
    from wiw_tpu_torch.serve.manager import ManagerServer

    args, extra = server_cli.build_parser().parse_known_args(
        ["--server_type", "gd_sam2", "--host", "127.0.0.1", "--port",
         str(free_port()), "--external_cmd", GD_SAM2_CMD])
    server = ManagerServer(server_cli.build_executors(args, extra), host=args.host,
                           port=args.port, server_type=args.server_type)
    return server, server.start()


def solvers_phase(port: int, server, dev) -> dict:
    """The closed loop's task solvers against the rollouts' server: first
    `warp_checks` (the full-size warps, A-EQA's surround views and
    `pointcloud`'s void ratios, in a process of its own), then
    `wiw_tpu_torch.agents.run_solver --task AR`, `--task IGNav` and `--task
    AEQA` (`main(argv)`, the CLI's own entry; --simulator fake --use_heur
    --wm_type igenex, so the world model type is the registry's 'action':
    every decision step asks the server for imagined panos and the solvers
    warp them on the card), IGNav's LPIPS reward from the random
    upstream-layout weights named by WIW_LPIPS_WEIGHTS; A-EQA with
    --use_wm_imagination --use_detector against `gd_sam2_server`, its fake
    simulator given a depth (`AEQA_DEPTH_M` at the pano's size), so every
    high-level round backprojects it (`depth_to_points`) on the card.
    `run_shard` catches an episode's exception as the reference's does, so
    the phase counts each episode's metrics.jsonl and records every
    exception itself. It raises on a missing metric file, an episode's
    exception, an error in the manager's stats, a WM request that is not the
    solvers', a gd_sam2 request not served (an error, no detections, or the
    server's count off the client's), K1, K7-dense, K7-conv or K8 not
    launched, an LPIPS call, a surround view or a `depth_to_points` off the
    card. Prints s an episode and a decision step (A-EQA: a high-level
    round), the WM and detector requests served, the shares of the wall time
    in warps (A-EQA: its backprojection and surround views), waiting on the
    server and on the detector, the frames the detector found, and the peak.
    Returns the launches of the episodes."""
    import glob
    import shutil
    import tempfile

    warps = warp_checks()
    tmp = tempfile.mkdtemp(prefix="wiw_solvers_")
    lpips_path = os.path.join(tmp, "lpips.pth")
    torch.save(upstream_weights("lpips", seed=3), lpips_path)
    os.environ["WIW_LPIPS_WEIGHTS"] = lpips_path
    from wiw_tpu_torch.agents import postprocess, run_solver, surround
    from wiw_tpu_torch.agents.solver import FakeSimulator, Solver
    from wiw_tpu_torch.agents.solver_ignav import IGNavSolver
    from wiw_tpu_torch.eval import lpips
    from wiw_tpu_torch.geo import equirect, pointcloud
    from wiw_tpu_torch.serve.manager import WMClient

    lpips._DEFAULT_WEIGHTS = lpips_path  # read once at import: name it in any case
    # host seconds and calls of the warps (A-EQA's: its depth backprojection
    # and surround views), of the WM requests (the server's answer
    # included), of the detector's requests, of IGNav's ranking (its init
    # frames and views, the LPIPS rewards) and of its rollout strips (PNGs);
    # the devices of the LPIPS calls, of the backprojected points and of the
    # surround views; the detector's answers and the frames it was handed
    clock = {"warp": [0.0, 0], "wm": [0.0, 0], "detector": [0.0, 0],
             "rank": [0.0, 0], "strips": [0.0, 0]}
    lpips_devices, errors, real = [], [], {}
    geo_devices = {"depth_to_points": [], "annotated_surround_views": []}
    detections = []

    def clocked(owner, name, key, probe=None):
        fn = real[(owner, name)] = getattr(owner, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                out = fn(*a, **k)
                if probe:
                    probe(out, *a, **k)
                return out
            finally:
                clock[key][0] += time.perf_counter() - t
                clock[key][1] += 1
        setattr(owner, name, wrapper)

    def points_probe(out, depth, K):
        geo_devices["depth_to_points"].append((depth.device.type, out[0].device.type))

    def views_probe(out, pano, *a, device="cuda", **k):
        geo_devices["annotated_surround_views"].append(torch.device(device).type)

    clocked(postprocess, "front_crop", "warp")
    clocked(postprocess, "front_crop_batch", "warp")
    clocked(equirect, "aligned_front_crops", "warp")
    clocked(pointcloud, "depth_to_points", "warp", points_probe)
    clocked(surround, "annotated_surround_views", "warp", views_probe)
    clocked(Solver, "send_batch_to_server", "wm")
    clocked(IGNavSolver, "pick_candidate", "rank")
    clocked(IGNavSolver, "persist_imagined_rollouts", "strips")
    real_lpips, real_episode = lpips.LPIPS.forward, run_solver.run_one_episode
    real_send, real_build = WMClient.send_batch, run_solver._build_sim

    class DepthSim(FakeSimulator):
        def get_depth(self):
            return np.full((self.H, self.W), AEQA_DEPTH_M, np.float32)

    def build_sim(datum, args):  # A-EQA's fake simulator with a depth
        sim = real_build(datum, args)
        return DepthSim(sim.H, sim.W, sim.seed) if args.task == "AEQA" else sim

    def send(self, input_dict):  # the detector's requests, timed
        if self.server_type != "gd_sam2":
            return real_send(self, input_dict)
        frames = sum(len(glob.glob(os.path.join(d, "*.png")))
                     for d in input_dict["save_dirs"])
        t = time.perf_counter()
        out = real_send(self, input_dict)
        clock["detector"][0] += time.perf_counter() - t
        clock["detector"][1] += 1
        detections.append((frames, out))
        return out

    def lpips_forward(self, img1, img2):
        lpips_devices.append(img1.device.type)
        return real_lpips(self, img1, img2)

    def episode(datum, args, shard_idx):
        try:
            return real_episode(datum, args, shard_idx)
        except Exception as e:  # recorded here: run_shard swallows it
            errors.append((args.task, datum.get("episode_id"), repr(e)))
            raise

    lpips.LPIPS.forward, run_solver.run_one_episode = lpips_forward, episode
    WMClient.send_batch, run_solver._build_sim = send, build_sim
    streams = sys.stdout, sys.stderr  # run_shard tees them into logs/
    out = {"warps": warps}
    gd = None
    try:
        for task in ("AR", "IGNav", "AEQA"):
            clock.update({k: [0.0, 0] for k in clock})
            root = os.path.join(tmp, task)
            os.makedirs(root)
            gd_port = 0
            if task == "AEQA":
                t = time.perf_counter()
                gd, gd_port = gd_sam2_server()
                print(f"solvers AEQA: gd_sam2 server (server_cli --server_type "
                      f"gd_sam2 --external_cmd \"{GD_SAM2_CMD}\") on :{gd_port} in "
                      f"{time.perf_counter() - t:.3f} s", flush=True)
            before = server.get_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t = time.perf_counter()
            run_solver.main(solver_args(root, task, port, dev, gd_port))
            wall = time.perf_counter() - t
            sys.stdout, sys.stderr = streams
            torch.cuda.synchronize()
            counts = launches()
            stats = server.get_stats()
            files = sorted(glob.glob(os.path.join(root, f"{task}_smoke", "*", "*",
                                                  "metrics.jsonl")))
            metrics = []
            for f in files:
                with open(f) as fh:
                    metrics.append(json.loads(fh.read().splitlines()[-1]))
            served = stats["requests"] - before["requests"]
            steps = clock["wm"][1]
            rounds = clock["detector"][1] if task == "AEQA" else steps
            info = {"episodes": len(files), "s_episode": wall / SOLVER_EPISODES,
                    "decision_steps": rounds, "s_decision_step": wall / max(rounds, 1),
                    "wm_requests": served, "items": stats["items"] - before["items"],
                    "errors": stats["errors"] - before["errors"], "wall_s": wall,
                    "warp_s": clock["warp"][0], "warp_calls": clock["warp"][1],
                    "warp_share": clock["warp"][0] / wall, "wm_s": clock["wm"][0],
                    "wm_share": clock["wm"][0] / wall, "rank_s": clock["rank"][0],
                    "strips_s": clock["strips"][0],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: v for k, v in counts.items() if v}}
            extra = ""
            if task == "AEQA":
                gd_stats = gd.get_stats()
                bad = [o for _, o in detections if "error" in o or "detections" not in o]
                info.update({
                    "detector_requests": clock["detector"][1],
                    "detector_served": gd_stats["requests"],
                    "detector_errors": gd_stats["errors"] + len(bad),
                    "detector_s": clock["detector"][0],
                    "detector_share": clock["detector"][0] / wall,
                    "detector_frames": sum(f for f, _ in detections),
                    "detections": sum(len(d) for _, o in detections
                                      for d in o.get("detections", [])),
                    "geo_devices": {k: sorted({"->".join(d) if isinstance(d, tuple)
                                               else d for d in v})
                                    for k, v in geo_devices.items()},
                    "geo_calls": {k: len(v) for k, v in geo_devices.items()}})
                extra = (f"; detector requests {info['detector_requests']} (served "
                         f"{info['detector_served']}, errors {info['detector_errors']}), "
                         f"{info['detector_frames']} frames handed to it, "
                         f"{info['detections']} detections, waiting on it "
                         f"{info['detector_s']:.3f} s ({info['detector_share']:.4f}); "
                         f"depth_to_points {info['geo_calls']['depth_to_points']} calls "
                         f"(input, output devices {info['geo_devices']['depth_to_points']}), "
                         f"surround views {info['geo_calls']['annotated_surround_views']} "
                         f"calls (devices "
                         f"{info['geo_devices']['annotated_surround_views']})")
            print(f"solvers {task}: {len(files)} of {SOLVER_EPISODES} episodes wrote "
                  f"metrics.jsonl {metrics}; {wall:.3f} s, {info['s_episode']:.3f} s an "
                  f"episode, {rounds} decision steps, {info['s_decision_step']:.3f} s a "
                  f"decision step; WM requests served {served} ({info['items']} "
                  f"candidates), manager errors {info['errors']}; wall time in warps "
                  f"{info['warp_s']:.3f} s ({info['warp_share']:.4f} of it, "
                  f"{info['warp_calls']} calls), waiting on the server "
                  f"{info['wm_s']:.3f} s ({info['wm_share']:.4f}); IGNav's ranking "
                  f"(init frames, views, LPIPS) {info['rank_s']:.3f} s and rollout "
                  f"strips (PNG) {info['strips_s']:.3f} s{extra}; peak "
                  f"{info['peak_gib']:.2f} GiB; launches {info['launches']}", flush=True)
            if (errors or len(files) != SOLVER_EPISODES or info["errors"] or served != steps
                    or not steps or any(not counts[k] for k in (
                        "K1", "K7-dense", "K7-conv", "K8"))):
                raise RuntimeError(f"solvers {task}: episode errors {errors}, info {info}")
            if task == "AEQA" and (
                    not rounds or info["detector_errors"]
                    or info["detector_served"] != rounds
                    or not geo_devices["depth_to_points"]
                    or any(d != ("cuda", "cuda") for d in geo_devices["depth_to_points"])
                    or any(d != "cuda" for d in geo_devices["annotated_surround_views"])):
                raise RuntimeError(f"solvers AEQA: the detector or the geometry: {info}")
            out[task] = info
        print(f"solvers: IGNav's LPIPS reward: {len(lpips_devices)} calls, on "
              f"{sorted(set(lpips_devices))}", flush=True)
        if not lpips_devices or set(lpips_devices) != {torch.device(dev).type}:
            raise RuntimeError(f"IGNav's LPIPS reward did not run on {dev}")
        out["lpips_calls"] = len(lpips_devices)
        print("solvers " + json.dumps(out), flush=True)
    finally:
        sys.stdout, sys.stderr = streams
        if gd is not None:
            gd.stop()
        os.environ.pop("WIW_LPIPS_WEIGHTS", None)
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)
        lpips.LPIPS.forward, run_solver.run_one_episode = real_lpips, real_episode
        WMClient.send_batch, run_solver._build_sim = real_send, real_build
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: sum(out[t]["launches"].get(k, 0) for t in ("AR", "IGNav", "AEQA"))
            for k in _counters()}


@functools.lru_cache(maxsize=1)
def habitat_double():
    """tests/habitat_sim_double.py: the numpy double of habitat-sim's
    surface that the collection and solver adapters call, imported by path
    (the tests directory is no package). `installed()` puts it into
    sys.modules as `habitat_sim` for a block."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), HABITAT_DOUBLE)
    spec = importlib.util.spec_from_file_location("habitat_sim_double", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    print(f"habitat-sim: the double {HABITAT_DOUBLE} (a square room rendered by "
          f"ray casting on the host; no real scene)", flush=True)
    return mod


def collect_phase(dev) -> dict:
    """Data collection as `python -m wiw_tpu_torch.data.collect_cli` runs it
    (`main(argv)`: the CLI's 512^2 faces to a 1000x2000 pano, the warp on
    the card) on one scene of the habitat-sim double: COLLECT_POINTS points,
    one trajectory, one process, into a temp dir. Every pano's warp must
    run on the card (CUDA events by call); the saver threads are joined
    before the tree is read. Then one pano of the same faces on the card
    against `--device cpu` (at most COLLECT_STEP uint8 steps apart), its ms
    by CUDA events (the faces up, the pano home as uint8) and its device
    operations, and the port's `data/dataset_utils` must read the tree
    (`glob_all_imgleaf_folders`, `get_actions`). Prints s a step with its
    PNG writes, the double's render share, the steps and files written.
    Returns the launches of the CLI's run (no kernel of the table)."""
    import glob
    import shutil
    import tempfile

    from wiw_tpu_torch.data import collect_cli, dataset_utils

    double = habitat_double()
    tmp = tempfile.mkdtemp(prefix="wiw_collect_")
    panos, render = [], [0.0, 0]
    real_warp, real_obs = collect_cli.cube_to_equirect, double.Simulator.get_sensor_observations

    def warp(faces, *a, **k):  # each pano's device and event time
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_warp(faces, *a, **k)
        end.record()
        panos.append((out.device.type, start, end))
        return out

    def observe(self):  # the double's host render, timed
        t = time.perf_counter()
        try:
            return real_obs(self)
        finally:
            render[0] += time.perf_counter() - t
            render[1] += 1

    scene = "smoke_room.glb"
    collect_cli.cube_to_equirect, double.Simulator.get_sensor_observations = warp, observe
    try:
        with double.installed():
            threads = set(threading.enumerate())
            reset_launches()
            t0 = time.perf_counter()
            collect_cli.main(["--scenes", scene, "--out_root", tmp, "--num_points",
                              str(COLLECT_POINTS), "--num_trajs", "1",
                              "--num_processes", "1"])
            for t in set(threading.enumerate()) - threads:
                t.join(timeout=120)  # the savers (collect_trajectory waits 10 s)
                if t.is_alive():
                    raise RuntimeError(f"collect: thread {t.name} still runs")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = launches()
            sim = double.SIMULATORS[0]
            steps, obs = list(sim.steps), sim.get_sensor_observations()
            collect_cli.cube_to_equirect = real_warp
            card, cpu = (collect_cli.HabitatNavEnv(scene, 1000, 2000, device=d)
                         for d in ("cuda", "cpu"))
            pano_card, pano_cpu = card._pano_from_faces(obs), cpu._pano_from_faces(obs)
            card._pano_from_faces(obs)
            ms = cuda_ms(lambda: card._pano_from_faces(obs), 5)
            ops = device_launches(lambda: card._pano_from_faces(obs))
        files = glob.glob(os.path.join(tmp, "**", "*"), recursive=True)
        kinds = {ext: sum(f.endswith(ext) for f in files)
                 for ext in (".png", ".npy", "metadata.json")}
        metas = dataset_utils.glob_all_imgleaf_folders(tmp)
        ids = []
        for meta in metas:
            folder = os.path.dirname(meta)
            frames = dataset_utils.get_sorted_frame_paths(folder)
            ids += dataset_utils.get_actions(
                scene.split(".")[0], "0", folder.split("-")[-1], folder,
                [int(os.path.basename(f).split("-")[1].split("_")[0]) for f in frames])
    finally:
        collect_cli.cube_to_equirect, double.Simulator.get_sensor_observations = (
            real_warp, real_obs)
        shutil.rmtree(tmp, ignore_errors=True)
    d = np.abs(pano_card.astype(np.int16) - pano_cpu.astype(np.int16))
    run_ms = [s.elapsed_time(e) for _, s, e in panos]
    info = {"steps": len(steps), "observations": render[1], "panos": len(panos),
            "files": kinds, "wall_s": wall, "s_step": wall / max(len(steps), 1),
            "render_s": render[0], "render_share": render[0] / wall,
            "warp_ms_in_run": float(np.median(run_ms)) if run_ms else None,
            "pano_ms": ms, "pano_device_ops": ops, "max_step": int(d.max()),
            "differing_values": int(np.count_nonzero(d)), "frames_read": len(ids),
            "pano_devices": sorted({p[0] for p in panos})}
    print(f"collect (collect_cli.main, 1 scene of the double, {COLLECT_POINTS} points, "
          f"1 trajectory, 512^2 faces to 1000x2000 on the card): {wall:.3f} s, "
          f"{len(steps)} steps ({info['s_step']:.4f} s a step with its PNG writes), "
          f"{render[1]} sensor reads of the double (its host render) in {render[0]:.3f} s "
          f"({info['render_share']:.4f} of the wall time, host), {len(panos)} panos "
          f"warped on {info['pano_devices']} at median {info['warp_ms_in_run']} ms "
          f"(events, the warp alone); files written {kinds}; a pano of the same faces "
          f"{ms:.3f} ms by CUDA events (faces up as uint8, pano home as uint8), "
          f"{ops} device operations; card against CPU: max {info['max_step']} uint8 "
          f"steps, {info['differing_values']} of {d.size} values differ; "
          f"dataset_utils read {len(metas)} waypoint folders, {len(ids)} frames' "
          f"actions; launches {({k: v for k, v in counts.items() if v})}", flush=True)
    # each waypoint's first frame is a stop, then one frame an action taken
    stop, named = dataset_utils.ACTION_STOP, dataset_utils.ACTION_NAME_TO_ID
    if (info["max_step"] > COLLECT_STEP or not steps or info["pano_devices"] != ["cuda"]
            or kinds[".png"] != len(steps) + len(metas) or not metas
            or len(ids) != kinds[".png"] or ids.count(stop) != len(metas)
            or [i for i in ids if i != stop] != [named[a] for a in steps]):
        raise RuntimeError(f"collect: {info}")
    return counts


def habitat_phase(port: int, server, dev) -> dict:
    """`run_solver --task AR --simulator habitat` (the CLI's `main`) under
    the habitat-sim double: one episode, --use_heur --max_action_num 1,
    against the rollouts' server; the panos 576x1024 from 512^2 faces, each
    warped on the card (recorded by call). Raises if a pano is not on the
    card, the episode raises or writes no metrics.jsonl, no WM request is
    served, or K1, K7-dense, K7-conv or K8 is not launched. Returns the
    launches."""
    import glob
    import shutil
    import tempfile

    from wiw_tpu_torch.agents import habitat_sim_api, run_solver
    from wiw_tpu_torch.data import collect_cli

    double = habitat_double()
    tmp = tempfile.mkdtemp(prefix="wiw_habitat_")
    devices, errors = [], []
    real_warp, real_episode = collect_cli.cube_to_equirect, run_solver.run_one_episode

    def warp(faces, *a, **k):
        out = real_warp(faces, *a, **k)
        devices.append(out.device.type)
        return out

    def episode(datum, args, shard_idx):
        try:
            return real_episode(datum, args, shard_idx)
        except Exception as e:  # recorded here: run_shard swallows it
            errors.append(repr(e))
            raise

    argv = solver_args(tmp, "AR", port, dev)
    argv[argv.index("--simulator") + 1] = "habitat"
    argv[argv.index("--max_episodes") + 1] = "1"
    streams = sys.stdout, sys.stderr  # run_shard tees them into logs/
    collect_cli.cube_to_equirect, run_solver.run_one_episode = warp, episode
    try:
        with double.installed():
            before = server.get_stats()
            torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            run_solver.main(argv)
            wall = time.perf_counter() - t
            sys.stdout, sys.stderr = streams
            torch.cuda.synchronize()
            counts = launches()
            stats = server.get_stats()
            sims = list(double.SIMULATORS)
        files = glob.glob(os.path.join(tmp, "AR_smoke", "*", "*", "metrics.jsonl"))
        metrics = []
        for f in files:
            with open(f) as fh:
                metrics.append(json.loads(fh.read().splitlines()[-1]))
    finally:
        sys.stdout, sys.stderr = streams
        collect_cli.cube_to_equirect, run_solver.run_one_episode = real_warp, real_episode
        for sim in habitat_sim_api._SIM_CACHE.values():
            sim.close()
        habitat_sim_api._SIM_CACHE.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    served = stats["requests"] - before["requests"]
    print(f"habitat AR (run_solver --simulator habitat under the double, 1 episode, "
          f"--use_heur --max_action_num 1): {wall:.3f} s; {len(files)} metrics.jsonl "
          f"{metrics}; {len(devices)} panos warped on {sorted(set(devices))}; "
          f"simulator actions {[s.steps for s in sims]}; WM requests served {served}, "
          f"errors {stats['errors'] - before['errors']}; episode exceptions {errors}; "
          f"launches {({k: v for k, v in counts.items() if v})}", flush=True)
    if (errors or len(files) != 1 or not devices or set(devices) != {"cuda"} or not served
            or stats["errors"] != before["errors"]
            or any(not counts[k] for k in ("K1", "K7-dense", "K7-conv", "K8"))):
        raise RuntimeError(f"habitat AR: errors {errors}, files {files}, panos on "
                           f"{devices}, served {served}, launches {counts}")
    return counts


def manip_phase(worker) -> dict:
    """The manipulation benchmark's igenex arms as `python -m
    wiw_tpu_torch.manip.run_manip` runs them (`main(argv)`, --env fake): a
    continuous 4-slot engine (`server_cli.make_continuous_executor`) around
    world_phase's igenex_manip worker (448x448, int8, WORLD_STEPS steps,
    out 480x480) behind a `ManagerServer`, and a policy server whose
    subprocess worker is DIFF_POLICY_CMD (`server_cli --external_cmd`);
    then one episode of MANIP_TASK with --solver_env vlm-igenex (3
    candidates a request) and one with diff-igenex --max_plan_rounds 1.
    Each tick's launches against the hooks' counts (as the serve phase);
    raises on an exception, a missing result file, a WM answer with an
    error or without [B, 14, 3, 480, 480] uint8 pred_frames, a policy answer
    without proposals, or K1, K7-dense, K7-conv or K8 not launched. Success
    is not required (the fake environment's target follows PYTHONHASHSEED).
    Prints s an episode and a planning round, the requests, the shares of
    the wall time waiting on the WM server, on the policy server and on the
    host, the launches and the peak. Returns the launches of both arms."""
    import glob
    import shutil
    import tempfile

    from wiw_tpu_torch.manip import run_manip
    from wiw_tpu_torch.manip.evaluator import ManipEvaluator
    from wiw_tpu_torch.serve import server_cli
    from wiw_tpu_torch.serve.manager import ManagerServer, WMClient

    t0 = time.perf_counter()
    ex = server_cli.make_continuous_executor(worker, 4)
    eng, pipe = ex.engine, ex.engine.pipe
    wm_server = ManagerServer([ex], host="127.0.0.1", port=free_port())
    wm_port = wm_server.start()
    args, extra = server_cli.build_parser().parse_known_args(
        ["--host", "127.0.0.1", "--port", str(free_port()), "--external_cmd",
         DIFF_POLICY_CMD])
    policy = ManagerServer(server_cli.build_executors(args, extra), host=args.host,
                           port=args.port)
    policy_port = policy.start()
    print(f"manip: igenex_manip engine ({eng.S} slots, {eng.num_steps} steps, "
          f"{eng.gen.height}x{eng.gen.width}, out {eng.out_hw}) on :{wm_port}, policy "
          f"server (server_cli --external_cmd \"{DIFF_POLICY_CMD}\") on :{policy_port}, "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    ticks, _, _, restore = watch_ticks(eng, pipe)
    clock = {"wm": [0.0, 0], "policy": [0.0, 0], "round": [0.0, 0]}
    answers = {"wm": [], "policy": []}
    real_send, real_plan = WMClient.send_batch, ManipEvaluator._plan_trajectory

    def send(self, d):
        key = "policy" if self.addr[1] == policy_port else "wm"
        t = time.perf_counter()
        out = real_send(self, d)
        clock[key][0] += time.perf_counter() - t
        clock[key][1] += 1
        answers[key].append((len(d["save_dirs"]), out))
        return out

    def plan(self, *a, **k):
        t = time.perf_counter()
        try:
            return real_plan(self, *a, **k)
        finally:
            clock["round"][0] += time.perf_counter() - t
            clock["round"][1] += 1

    WMClient.send_batch, ManipEvaluator._plan_trajectory = send, plan
    tmp = tempfile.mkdtemp(prefix="wiw_manip_")
    total = dict.fromkeys(_counters(), 0)
    out = {}
    try:
        for arm, more in (("vlm-igenex", []), ("diff-igenex", ["--max_plan_rounds", "1"])):
            for v in clock.values():
                v[:] = [0.0, 0]
            for v in answers.values():
                v.clear()
            root = os.path.join(tmp, arm)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t = time.perf_counter()
            run_manip.main(["--env", "fake", "--solver_env", arm, "--tasks", MANIP_TASK,
                            "--episodes", "1", "--out_dir", root, "--WM_port",
                            str(wm_port), "--policy_port", str(policy_port), *more])
            wall = time.perf_counter() - t
            torch.cuda.synchronize()
            counts = launches()
            total = {k: total[k] + counts[k] for k in total}
            files = glob.glob(os.path.join(root, MANIP_TASK, "*.json"))
            result = None
            if files:
                with open(files[0]) as fh:
                    result = json.load(fh)
            bad_wm = [(n, o.get("error"), None if o.get("pred_frames") is None else
                       (o["pred_frames"].shape, str(o["pred_frames"].dtype)))
                      for n, o in answers["wm"] if "error" in o
                      or o.get("pred_frames") is None
                      or o["pred_frames"].shape != (n, FRAMES, 3, 480, 480)
                      or o["pred_frames"].dtype != np.uint8]
            bad_policy = [o.get("error") for _, o in answers["policy"]
                          if "proposals" not in o or not len(o["proposals"])]
            rounds = clock["round"][1]
            info = {"wall_s": wall, "s_episode": wall, "rounds": rounds,
                    "s_round": clock["round"][0] / max(rounds, 1),
                    "wm_requests": clock["wm"][1],
                    "wm_candidates": sum(n for n, _ in answers["wm"]),
                    "policy_requests": clock["policy"][1], "wm_s": clock["wm"][0],
                    "wm_share": clock["wm"][0] / wall, "policy_s": clock["policy"][0],
                    "policy_share": clock["policy"][0] / wall,
                    "host_share": 1 - (clock["wm"][0] + clock["policy"][0]) / wall,
                    "result": result,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: v for k, v in counts.items() if v}}
            print(f"manip {arm} (run_manip --env fake, 1 episode of {MANIP_TASK}"
                  f"{' ' + ' '.join(more) if more else ''}): {wall:.3f} s an episode, "
                  f"{rounds} planning rounds at {info['s_round']:.3f} s; WM requests "
                  f"{info['wm_requests']} ({info['wm_candidates']} candidates), policy "
                  f"requests {info['policy_requests']}; wall time waiting on the WM "
                  f"server {info['wm_s']:.3f} s ({info['wm_share']:.4f}), on the policy "
                  f"server {info['policy_s']:.3f} s ({info['policy_share']:.4f}), host "
                  f"{info['host_share']:.4f}; result {result}; peak "
                  f"{info['peak_gib']:.2f} GiB; launches {info['launches']}", flush=True)
            if (not files or bad_wm or bad_policy or not answers["wm"]
                    or (arm.startswith("diff") and not answers["policy"])
                    or any(not counts[k] for k in ("K1", "K7-dense", "K7-conv", "K8"))):
                raise RuntimeError(f"manip {arm}: files {files}, bad WM answers "
                                   f"{bad_wm}, bad policy answers {bad_policy}, {info}")
            out[arm] = info
        info = tick_summary("manip", ticks, eng.S)
        print(f"manip: {info['ticks']} ticks, {info['full_ticks']} full at median "
              f"{info['full_tick_ms']:.2f} ms, {info['cond_ticks']} cond-only at median "
              f"{info['cond_tick_ms']} ms; active slots by tick {info['active']}; "
              f"idle-slot share {info['idle_slot_share']:.4f}; phase_s "
              f"{dict(ex.phase_s)}", flush=True)
        print("manip " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "result"}
                                     for k, v in out.items()}), flush=True)
    finally:
        WMClient.send_batch, ManipEvaluator._plan_trajectory = real_send, real_plan
        restore()
        wm_server.stop()
        policy.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def engine_vs_generate(dev):
    """The engine held to the pipeline in bf16: one request alone in the
    4-slot pool (8 UNet rows a full tick, its CFG pair beside 3 idle
    slots), and `SVDPipeline.denoise` (2 rows) from the same initial
    latents, noise_aug_strength 0 so that no draw enters; the denoised
    latents before the decode within the small-input phase's bounds taken
    relative to the latents' scale (max |ref|, mean |ref|)."""
    from wiw_tpu_torch.serve.continuous import ContinuousEngine
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    worker = SVDActionWorker(
        width=1024, height=576, num_frames=FRAMES, num_inference_steps=CHECK_STEPS,
        out_width=480, out_height=480, quantize="bf16", cfg_schedule="serving",
        device="cuda", seed=0, fused_ff=False, temporal_attention="batched")
    gen = dataclasses.replace(worker.gen, noise_aug_strength=0.0)
    eng = ContinuousEngine(worker.pipe, gen, num_slots=4, out_hw=(480, 480),
                           out_uint8=True)
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (gen.height, gen.width, 3)).astype(np.float32)
    actions = np.array([4, 1, 1, 2, 2, 1, 3, 3, 1, 1, 2, 1, 3, 1])
    rid = eng.admit(image, actions, torch.Generator(device=dev).manual_seed(5))
    init = eng._state["latents"][0].clone()
    scale = worker.pipe.vae_config.scaling_factor
    denoised = {}
    dispatch = eng._dispatch_decode

    def capture(request_id, i):
        denoised[request_id] = eng._state["latents"][i] / scale
        return dispatch(request_id, i)

    eng._dispatch_decode = capture
    t = time.perf_counter()
    video = {}
    while eng.busy:
        video.update(eng.step())
    engine_s = time.perf_counter() - t
    s0 = eng.sigmas[0]
    t = time.perf_counter()
    ref = worker.pipe.denoise(
        torch.from_numpy(image)[None], gen, torch.from_numpy(actions)[None],
        init_latents=(init / torch.sqrt(s0 ** 2 + 1.0))[None])[0]
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t
    out = denoised[rid]
    diff = (out - ref).abs()
    max_rel = (diff.max() / ref.abs().max()).item()
    mean_rel = (diff.mean() / ref.abs().mean()).item()
    print(f"engine vs generate (bf16, {CHECK_STEPS} steps, one request in the "
          f"4-slot pool vs the pipeline's 2 rows, same init latents): denoised "
          f"latents max|diff| {diff.max().item():.6g} (max|ref| "
          f"{ref.abs().max().item():.6g}: {max_rel:.6g}, tol {SMALL_ATOL}), mean|diff| "
          f"{diff.mean().item():.6g} (mean|ref| {ref.abs().mean().item():.6g}: "
          f"{mean_rel:.6g}, tol {SMALL_MEAN_ATOL}); engine {engine_s:.3f} s with its "
          f"whole-clip decode, pipeline denoise {pipe_s:.3f} s; decoded "
          f"{video[rid].shape} {video[rid].dtype}", flush=True)
    if not (torch.isfinite(out).all() and max_rel <= SMALL_ATOL
            and mean_rel <= SMALL_MEAN_ATOL):
        raise RuntimeError("the engine's denoised latents disagree with generate's")
    if video[rid].shape != (FRAMES, 480, 480, 3) or video[rid].dtype != np.uint8:
        raise RuntimeError(f"bad engine video {video[rid].shape}")
    del worker, eng
    gc.collect()
    torch.cuda.empty_cache()


def world_phase(dev, label: str, k1_per_forward: int, int8_weights: int,
                keep: bool = False, **config):
    """One full-width request of another world through the worker (int8,
    WORLD_STEPS steps): `action_block` (nav ids as one-hot tokens; K1 32 a
    forward: the action branches add one self-attention a transformer) or
    the manipulation world (`igenex_manip`: 448x448, micro_cond on the
    10-channel pose codec, [1, 14, 8] poses). The int8 weights must number
    `int8_weights` (the reference policy's count: tests/test_torch_actions.py
    for action_block); launches are checked as the slices' are; returns
    them, and with `keep` the worker too (the manip phase serves it)."""
    from wiw_tpu_torch.ops import quant as TQ
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    kw = dict(width=1024, height=576, num_frames=FRAMES, out_width=480,
              out_height=480, quantize="int8", cfg_schedule="serving",
              device="cuda", seed=0, fused_ff=False, temporal_attention="batched")
    worker = SVDActionWorker(num_inference_steps=WORLD_STEPS, **{**kw, **config})
    n_int8 = TQ.count_quantized(worker.pipe.unet)
    rng = np.random.default_rng(11)
    if worker.task_type == "manipulation":
        xyz = rng.uniform(-0.2, 0.6, (1, FRAMES, 3))
        quat = rng.standard_normal((1, FRAMES, 4))
        actions = np.concatenate([xyz, quat, rng.uniform(0, 1, (1, FRAMES, 1))], -1)
    else:
        actions = rng.integers(1, 4, (1, FRAMES))
    h, w = worker.gen.height, worker.gen.width
    request = {"b_action": actions,
               "b_image": rng.integers(0, 256, (1, 3, h, w), dtype=np.uint8),
               "save_dirs": ["unused"], "request_model_name": label,
               "return_objects": [True]}
    norms, norm_hooks = count_group_norms(worker.pipe.unet, worker.pipe.vae)
    int8_calls, int8_hooks = count_int8_calls(worker.pipe.unet, worker.pipe.vae)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    out = worker(request)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = launches()
    for hk in norm_hooks + int8_hooks:
        hk.remove()
    want = expected({"K1": k1_per_forward * WORLD_STEPS}, sum(norms.values()),
                    int8_calls)
    frames = out["pred_frames"]
    print(f"{label} request ({h}x{w}, {WORLD_STEPS} steps, "
          f"{worker.pipe.unet_config.action_strategy}, action_input_channel "
          f"{worker.pipe.unet_config.action_input_channel}, b_action "
          f"{actions.shape}, {n_int8} int8 weights): {secs:.3f} s, pred_frames "
          f"{frames.shape} {frames.dtype} std {frames.std():.3f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts} "
          f"(K1 expected {want['K1']})", flush=True)
    if frames.shape != (1, FRAMES, 3, 480, 480) or frames.dtype != np.uint8 or (
            frames.min() == frames.max()):
        raise RuntimeError(f"{label}: bad pred_frames {frames.shape}")
    if counts != want or n_int8 != int8_weights:
        raise RuntimeError(f"{label}: launches {counts}, expected {want}; "
                           f"{n_int8} int8 weights, expected {int8_weights}")
    if keep:
        return counts, worker
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def count_k1_and_norms():
    """A global forward pre-hook: the K1 launches each attention call must
    make (a `CrossAttention` proper: self-attention, or a multi-token
    context, positions folded into the batch on 4-D inputs, one launch a
    range of `batch_splits`; a one-token context takes no kernel) and the
    GroupNorm calls (K8 one each). Returns (the counts, the handle)."""
    from wiw_tpu_torch.models.layers import CrossAttention, GroupNorm
    from wiw_tpu_torch.ops.flash_attention import batch_splits

    n = {"K1": 0, "K8": 0}

    def pre(m, args):
        if type(m) is CrossAttention:
            x, ctx = args[0], args[1] if len(args) > 1 else None
            if ctx is None or ctx.shape[-2] > 1:
                rows = x.shape[0] * (x.shape[2] if x.ndim == 4 else 1)
                n["K1"] += len(batch_splits(rows, m.heads))
        elif isinstance(m, GroupNorm):
            n["K8"] += 1

    return n, torch.nn.modules.module.register_module_forward_pre_hook(pre)


def upstream_weights(tower: str, seed: int) -> dict:
    """Random weights in the upstream key layouts (eval/manifest.py): the
    lpips heads with torchvision's AlexNet trunk, or pytorch-i3d's
    i3d_pretrained_400 (convs scaled so 22 ReLU layers keep their scale,
    BatchNorm statistics away from the identity)."""
    from wiw_tpu_torch.eval import manifest

    g = torch.Generator().manual_seed(seed)
    if tower == "lpips":
        return {k: (torch.rand(sh, generator=g) * 0.1 if k.startswith("lin")
                    else torch.randn(sh, generator=g) / np.sqrt(np.prod(sh[1:])))
                for k, sh in manifest.expected_lpips_keys().items()}
    sd = {}
    for k, sh in manifest.expected_i3d_keys().items():
        if k.endswith(("running_var", "bn.weight")):
            sd[k] = torch.rand(sh, generator=g) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(sh, generator=g) * 0.3
        elif k.endswith("bias"):
            sd[k] = torch.randn(sh, generator=g) * 0.05
        else:
            sd[k] = torch.randn(sh, generator=g) * (1.2 / np.sqrt(np.prod(sh[1:])))
    return sd


def write_trajectories(root: str, clips: int, frames: int, h: int, w: int, seed: int):
    """A trajectory tree in the layout the datasets read
    (<scene>/traj-<i>/waypoint-0/step-<k>_type-rgb.png + metadata.json with
    each step's action): `clips` trajectories of `frames` smooth frames
    moving across the image, actions from a seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = ["stop", "move_forward", "turn_left", "turn_right"]
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    for c in range(clips):
        d = os.path.join(root, "sceneA", f"traj-{c}", "waypoint-0")
        os.makedirs(d)
        phase = rng.uniform(0, 6.28, 3).astype(np.float32)
        steps = {}
        for k in range(frames):
            img = 127.5 + 100 * np.sin(xx[..., None] / (40 + 10 * c) + yy[..., None] / 55
                                       + phase + 0.3 * k)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f"step-{k}_type-rgb.png"))
            steps[f"step-{k}"] = {"action": names[0] if k == 0 else
                                  names[int(rng.integers(1, 4))], "coord": [0, 0, 0]}
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump({"steps": {"waypoint-0": steps}}, f)


def eval_phase(dev) -> dict:
    """The offline evaluation path at full width: a trajectory tree of
    EVAL_CLIPS clips of 14 frames at 576x1024, random upstream-layout LPIPS
    and I3D checkpoints named by WIW_LPIPS_WEIGHTS / WIW_I3D_WEIGHTS (set
    before the towers' modules are first imported: they read them once),
    `inference_cli.main` (SVD-dagger with random weights, EVAL_STEPS steps)
    whose metrics.json must hold psnr, ssim, lpips and fvd, then
    `video_metrics_cli --fvd` on PNG directories of the same frames (the
    same numbers), then the towers on the card held to the same modules on
    the CPU (fp32, TF32 off; the tolerances above). Random weights: the
    numbers check the route, not the quality. Returns the launches of the
    inference_cli run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="wiw_eval_")
    try:
        root, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        write_trajectories(root, EVAL_CLIPS, FRAMES, *EVAL_HW, seed=21)
        paths = {"lpips": os.path.join(tmp, "lpips.pth"),
                 "i3d": os.path.join(tmp, "i3d_pretrained_400.pt")}
        for tower, path in paths.items():
            torch.save(upstream_weights(tower, seed=3), path)
        os.environ["WIW_LPIPS_WEIGHTS"], os.environ["WIW_I3D_WEIGHTS"] = (
            paths["lpips"], paths["i3d"])
        from wiw_tpu_torch.agents import saver
        from wiw_tpu_torch.eval import fvd, inference_cli, lpips, video_metrics_cli
        from wiw_tpu_torch.eval.metrics import frechet_distance

        # the towers read the variables once, at import (the solvers phase
        # imported LPIPS first): name these weights in either case
        lpips._DEFAULT_WEIGHTS, fvd._DEFAULT_I3D = paths["lpips"], paths["i3d"]

        stitched, real_save = [], saver.save_video

        def capture(path, frames, fps=7):  # the gen | gt clips inference_cli saves
            stitched.append(frames.copy())
            return real_save(path, frames, fps)

        saver.save_video = capture
        n, handle = count_k1_and_norms()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        try:
            metrics = inference_cli.main([
                "--data_root", root, "--out_dir", out, "--num_clips", str(EVAL_CLIPS),
                "--num_inference_steps", str(EVAL_STEPS)])
        finally:
            saver.save_video = real_save
            handle.remove()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = launches()
        want = expected({"K1": n["K1"]}, n["K8"])
        with open(os.path.join(out, "metrics.json")) as f:
            saved = json.load(f)
        print(f"eval: inference_cli at {EVAL_HW[0]}x{EVAL_HW[1]}, {EVAL_CLIPS} clips of {FRAMES} frames, "
              f"{EVAL_STEPS} steps (a cut depth), random weights (the numbers check "
              f"the route, not quality): {secs:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; metrics.json "
              f"{json.dumps(saved)}; files {sorted(os.listdir(out))}; launches "
              f"{counts} (K1 expected {want['K1']}, K8 {want['K8']})", flush=True)
        if set(saved) != {"psnr", "ssim", "lpips", "fvd"} or not all(
                np.isfinite(v) for v in saved.values()) or saved != metrics:
            raise RuntimeError(f"eval: metrics.json {saved}")
        if counts != want or not counts["K1"] or not counts["K8"]:
            raise RuntimeError(f"eval: launches {counts}, expected {want}")

        gen_dirs, gt_dirs = [], []
        w = EVAL_HW[1]
        for i, clip in enumerate(stitched):  # [T, H, W + 4 + W, 3]: gen | gt
            for name, part, dirs in (("gen", clip[:, :, :w], gen_dirs),
                                     ("gt", clip[:, :, w + 4:], gt_dirs)):
                d = os.path.join(tmp, f"{name}{i}")
                for k, frame in enumerate(part):
                    saver.save_image(os.path.join(d, f"{k:03d}.png"), frame)
                dirs.append(d)
        vm = video_metrics_cli.main(["--gen", *gen_dirs, "--gt", *gt_dirs, "--fvd"])
        same = {k: abs(vm[k] - saved[k]) <= 1e-6 * max(1.0, abs(saved[k])) for k in saved}
        print(f"eval: video_metrics_cli --fvd on PNG directories of the same frames: "
              f"{json.dumps(vm)}; the same as metrics.json (1e-6 relative): {same}",
              flush=True)
        if set(vm) != set(saved) or not all(same.values()):
            raise RuntimeError("video_metrics_cli disagrees with inference_cli")

        # the towers on the card against the same modules on the CPU
        clips = torch.stack([torch.from_numpy(video_metrics_cli.load_clip(d))
                             for d in gen_dirs + gt_dirs]).to(dev).float() / 255.0
        card_ev = fvd.FVDEvaluator()
        cpu_ev = fvd.FVDEvaluator(model=fvd.load_i3d_weights(paths["i3d"]))
        feats = {"card": card_ev.features(clips)}
        feats["cpu"] = cpu_ev.features(clips.cpu())
        _, line = tower_check("I3D features (FVDEvaluator.features)", feats["card"],
                              feats["cpu"])
        print(f"eval: {line}", flush=True)
        lp_card = lpips.default_lpips()
        lp_cpu = lpips.load_lpips_weights(paths["lpips"])
        a, b = clips[0, :LPIPS_FRAMES], clips[EVAL_CLIPS, :LPIPS_FRAMES]
        d_card = lp_card(a, b)
        with torch.no_grad():
            d_cpu = lp_cpu(a.cpu(), b.cpu())
        _, line = tower_check(f"LPIPS distances ({LPIPS_FRAMES} frame pairs at "
                              f"{EVAL_HW[0]}x{EVAL_HW[1]})", d_card, d_cpu)
        print(f"eval: {line}", flush=True)
        half = EVAL_CLIPS
        fd = {k: frechet_distance(f[:half], f[half:]).item() for k, f in feats.items()}
        f64 = feats["cpu"].double()
        traces = float(torch.cov(f64[:half].T).trace() + torch.cov(f64[half:].T).trace())
        g = torch.Generator().manual_seed(5)
        w1, w2 = torch.randn(256, 64, generator=g), torch.randn(256, 64, generator=g) * 1.3
        well = {"card": frechet_distance(w1.to(dev), w2.to(dev)).item(),
                "cpu": frechet_distance(w1, w2).item()}
        ok_fd = abs(fd["card"] - fd["cpu"]) <= FD_TRACE_REL * traces
        ok_well = abs(well["card"] - well["cpu"]) <= FD_REL * abs(well["cpu"])
        # why frechet_distance runs on the host: fp32 eigh of one of those
        # 64 x 64 covariances on the card (cuSOLVER) and on the CPU (LAPACK)
        cov = torch.cov(w1.T)
        errs = {}
        for where, m in (("card", cov.to(dev)), ("cpu", cov)):
            lam, vec = torch.linalg.eigh(m)
            lam64, _ = torch.linalg.eigh(cov.double())
            errs[where] = ((lam.cpu().double() - lam64).abs().max().item(),
                           (vec.T @ vec - torch.eye(64, device=vec.device)).abs().max().item())
        print(f"eval: fp32 eigh of a 64 x 64 covariance (max eigenvalue "
              f"{lam64.max().item():.4g}): eigenvalues' max|err| against float64 "
              f"and orthogonality max|V^T V - I|, card (cuSOLVER) {errs['card'][0]:.3g} / "
              f"{errs['card'][1]:.3g}, CPU (LAPACK) {errs['cpu'][0]:.3g} / "
              f"{errs['cpu'][1]:.3g}", flush=True)
        print(f"eval: frechet_distance (on the host) of this run's card and CPU "
              f"features {fd['card']:.6g} / {fd['cpu']:.6g} (tol {FD_TRACE_REL} x the "
              f"covariances' traces {traces:.6g}: {ok_fd}); of 256 x 64 normal "
              f"features on the card and the CPU {well['card']:.6g} / "
              f"{well['cpu']:.6g} (tol {FD_REL} relative: {ok_well})", flush=True)
        if not (ok_fd and ok_well):
            raise RuntimeError("frechet_distance on the card disagrees with the CPU")
    finally:
        for k in ("WIW_LPIPS_WEIGHTS", "WIW_I3D_WEIGHTS"):
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def tower_check(name: str, out, ref) -> tuple[float, str]:
    """An eval tower's output on the card against the CPU's: within
    TOWER_REL of max |ref| at every element and in relative Frobenius
    error; raises beyond."""
    out, ref = out.float().cpu(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_fro = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
    line = (f"{name}, card vs CPU (fp32, TF32 off): max|err| {err:.6g} (max|ref| "
            f"{scale:.6g}), rel_fro {rel_fro:.6g}; tol {TOWER_REL} of max|ref| and "
            f"rel_fro {TOWER_REL}")
    if not torch.isfinite(out).all() or err > TOWER_REL * scale or rel_fro > TOWER_REL:
        raise RuntimeError(f"{line}: disagrees")
    return err, line


def past_alt_phase(dev, g) -> dict:
    """One full-width request through `SVDPipeline.generate` with
    past_images (Np = 2: every cross-attention takes 3 context tokens, so
    K1 runs the spatial ones at Skv 3 and the temporal ones on positions
    folded into the batch, split by `batch_splits` where B*H passes 65535)
    and the 'alt' CFG tail (an odd tail: stale, full, stale), PAST_STEPS
    steps; its seconds, peak and launches (K1's must equal the count
    hooks make). Then K1 held to its plain version at Skv 3 and at the
    split fold of level 0. Returns the request's launches."""
    from wiw_tpu_torch.core.schedule import CFGSchedule
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.ops import flash_attention as TFA
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

    gen = GenerationConfig(num_inference_steps=PAST_STEPS, cfg=CFGSchedule(
        tail_sigma=PAST_TAIL_SIGMA, tail_policy="alt"))
    segs = segments_of(gen)
    if segs[-1][0] != "alt" or (segs[-1][2] - segs[-1][1]) % 2 == 0:
        raise RuntimeError(f"past+alt: the tail is not an odd alt segment: {segs}")
    t0 = time.perf_counter()
    pipe = SVDPipeline(UNetConfig(action_strategy="micro_cond", dtype="bfloat16"),
                       device=dev)
    pipe.init_params(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(13)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 576, 1024, 3)).astype(np.float32))
    past = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 576, 1024, 3)).astype(np.float32))
    actions = torch.tensor([[4, 1, 1, 2, 2, 1, 3, 3, 1, 1, 2, 1, 3, 1]])
    built = time.perf_counter() - t0
    n, handle = count_k1_and_norms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    try:
        video = pipe.generate(image, gen, actions, past, out_uint8_hw=(480, 480),
                              generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
    finally:
        handle.remove()
    secs = time.perf_counter() - t
    counts = launches()
    want = expected({"K1": n["K1"]}, n["K8"])
    video = video.cpu().numpy()
    print(f"past_images + alt (576x1024, Np 2, {PAST_STEPS} steps, segments {segs}; "
          f"pipeline built in {built:.1f} s): {secs:.3f} s, video {video.shape} "
          f"{video.dtype} std {video.std():.3f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
          f"{counts['K1']} (hooks: {n['K1']}), launches {counts}", flush=True)
    if video.shape != (1, FRAMES, 480, 480, 3) or video.dtype != np.uint8 or (
            video.min() == video.max()):
        raise RuntimeError(f"past+alt: bad video {video.shape}")
    if counts != want or not counts["K1"]:
        raise RuntimeError(f"past+alt: launches {counts}, expected {want}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    def heads(rows, S, H):
        x = torch.randn(rows, S, H * 64, generator=g, device=dev).to(torch.bfloat16)
        return x.view(rows, S, H, 64).transpose(1, 2)

    for label, (rows, H, Sq) in (("spatial, Skv 3 (level 0)", (28, 5, 9216)),
                                 ("temporal fold of level 0", (2 * 9216, 5, FRAMES))):
        q, k, v = heads(rows, Sq, H), heads(rows, 3, H), heads(rows, 3, H)
        before = TFA.flash_attention.launches
        out = TFA.flash_attention(q, k, v)
        made = TFA.flash_attention.launches - before
        splits = TFA.batch_splits(rows, H)
        _, line = compare(f"K1 {label}", out, TFA.flash_attention_plain(q, k, v))
        print(f"  past+alt K1 {label}: q [{rows}, {H}, {Sq}, 64], kv 3 tokens: "
              f"{made} launches (batch_splits: {splits}); {line}", flush=True)
        if made != len(splits):
            raise RuntimeError(f"K1 {label}: {made} launches, expected {len(splits)}")
        del q, k, v, out
    torch.cuda.empty_cache()
    return counts


# the NWM world model (CDiT-XL/2 at 224x224, context 4, bf16, random weights
# from a seed): a request is NWM_CANDIDATES rows x NWM_FRAMES actions, each
# frame after the first one DDIM rollout of NWM_STEPS CDiT forwards
NWM_CANDIDATES, NWM_FRAMES, NWM_STEPS = 2, 14, 20
# K1 at head_dim 72 in a CDiT-XL/2 forward at B = 2 (196 tokens; context 4 x
# 196 + the bias_kv row): (B, heads, Sq, Skv, calls a forward)
K1_D72_SHAPES = [(2, 16, 196, 196, 28), (2, 16, 196, 785, 28)]
# the full-width bf16 CDiT forward against an fp32 forward of the same
# weights with the plain attention, on the card: relative Frobenius error
# of the output, set before the first run: bf16 rounding carried through 28
# residual blocks of random weights stays at a few 1e-2; a wrong kernel,
# layout or modulation is off by O(1)
CDIT_REL_FRO = 0.1
NWM_CMD = "python -m wiw_tpu_torch.workers.nwm_worker"


def nwm_request(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"b_action": rng.integers(1, 4, (n, NWM_FRAMES)),
            "b_image": rng.integers(0, 256, (n, 3, 256, 256), dtype=np.uint8),
            "save_dirs": [f"nwm{seed}_{i}" for i in range(n)],
            "request_model_name": "nwm", "return_objects": [True] * n}


def check_nwm_answer(label: str, out: dict, n: int):
    pred = out.get("pred_frames")
    if pred is None or pred.shape != (n, NWM_FRAMES, 3, 480, 480) or (
            pred.dtype != np.uint8) or pred[:, 1:].std() < 1:
        raise RuntimeError(f"{label}: bad answer "
                           f"{None if pred is None else (pred.shape, pred.dtype)}"
                           f" error {out.get('error')}")


def k1_d72_phase(row: Row, dev, g):
    """K1's head_dim 72 instance at the CDiT's shapes, on head views of its
    projections (the self-attention's fused qkv; the cross-attention's q
    and its k, v with the bias row), against its plain version; kernel,
    plain and SDPA ms by events in turns, the kernel's device time by
    torch.profiler (a call is a few microseconds of device work, so the
    event loop measures the host's dispatch), the bound."""
    import torch.nn.functional as F

    from wiw_tpu_torch.ops import flash_attention as TFA

    row.d["device_ms"] = row.d["library_device_ms"] = 0.0
    for B, H, Sq, Skv, calls in K1_D72_SHAPES:
        def heads(S, parts):
            x = torch.randn(B, S, parts * H * 72, generator=g, device=dev,
                            dtype=torch.bfloat16)
            return [t.view(B, S, H, 72).transpose(1, 2) for t in x.chunk(parts, -1)]

        q, k, v = heads(Sq, 3) if Sq == Skv else (*heads(Sq, 1), *heads(Skv, 2))
        max_err, err_line = compare(f"K1-D72 Sq={Sq} Skv={Skv}",
                                    TFA.flash_attention(q, k, v),
                                    TFA.flash_attention_plain(q, k, v))
        flops = 4 * B * H * Sq * Skv * 72
        nbytes = 2 * B * H * 72 * (2 * Sq + 2 * Skv)
        bound = bound_ms(nbytes, flops, BF16_FLOPS_S)
        by = "bytes" if nbytes / HBM_BYTES_S > flops / BF16_FLOPS_S else "operations"
        ms, plain_ms, lib = timed(
            f"K1-D72 B*H={B * H} Sq={Sq} Skv={Skv} D=72 ({calls} a CDiT forward) "
            f"{err_line}", lambda: TFA.flash_attention_plain(q, k, v),
            lambda: TFA.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), 200, 50, bound,
            lambda ms: f"{flops / ms / 1e9:.2f} TFLOP/s by events")
        dev_ms = device_ms(lambda: TFA.flash_attention(q, k, v), ("flash_attn_fwd",),
                           50)
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                            ("sdpa", "fmha", "flash_fwd", "attention"), 50)
        print(f"  device time (torch.profiler): kernel {dev_ms:.5f} ms a call, "
              f"{flops / dev_ms / 1e9:.2f} TFLOP/s, {nbytes / dev_ms / 1e6:.0f} "
              f"GB/s; SDPA {lib_dev:.5f} ms in "
              + kernel_names(lambda: F.scaled_dot_product_attention(q, k, v)),
              flush=True)
        row.add(calls, max_err, ms, plain_ms, bound, by, lib)
        row.d["device_ms"] += calls * dev_ms
        row.d["library_device_ms"] += calls * lib_dev
    # one long shape, B*H 32, S 2304: the checks only
    q, k, v = (torch.randn(2, 2304, 16 * 72, generator=g, device=dev,
                           dtype=torch.bfloat16).view(2, 2304, 16, 72).transpose(1, 2)
               for _ in range(3))
    compare("K1-D72 S=2304", TFA.flash_attention(q, k, v),
            TFA.flash_attention_plain(q, k, v))


def cdit_forward_flops(cfg, B: int) -> float:
    """A CDiT forward's products: per block the qkv, proj, cross q / out,
    the context's k and v, the MLP, the adaLN, both attentions; the patch
    embedding of x and the context, the final layer."""
    C, N = cfg.hidden_size, cfg.num_patches
    T = cfg.context_size * N
    block = (2 * B * N * C * (3 * C + C + C + C + 2 * 4 * C)
             + 2 * B * T * C * 2 * C + 2 * B * C * 11 * C
             + 4 * B * N * N * C + 4 * B * N * (T + 1) * C)
    P = cfg.patch_size
    edges = (2 * B * (cfg.context_size + 1) * N * P * P * cfg.in_channels * C
             + 2 * B * C * 2 * C + 2 * B * N * C * P * P * cfg.out_channels)
    return cfg.depth * block + edges


def nwm_phase(rows: dict, dev, g) -> dict:
    """The NWM world model: K1-D72 at its shapes; one full-width request
    (NWM_CANDIDATES x NWM_FRAMES, 224x224, NWM_STEPS DDIM steps) through
    `NWMWorker` in-process, its launches against the attention and
    GroupNorm calls counted by hooks; a CDiT forward's ms, one profiled
    DDIM step (device busy and idle share, top kernels); the bf16 forward
    against an fp32 forward of the same weights with the plain attention;
    K8 at every GroupNorm shape of the request (the VAE at 224x224); then
    `server_cli --wm_type nwm` (it must refuse to run without
    --external_cmd) serving two requests through the subprocess worker.
    Returns the in-process request's launches."""
    import collections

    from wiw_tpu_torch.models import cdit as TC
    from wiw_tpu_torch.ops.flash_attention import flash_attention_plain
    from wiw_tpu_torch.workers.nwm_worker import NWMWorker

    with torch.inference_mode():
        k1_d72_phase(rows["K1-D72"], dev, g)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    worker = NWMWorker(num_steps=NWM_STEPS)
    torch.cuda.synchronize()
    cfg = worker.cfg
    n_params = sum(p.numel() for p in worker.model.parameters())
    print(f"nwm: NWMWorker built in {time.perf_counter() - t0:.1f} s: CDiT "
          f"{n_params / 1e9:.4f} B parameters (hidden {cfg.hidden_size}, depth "
          f"{cfg.depth}, {cfg.num_heads} heads of {cfg.hidden_size // cfg.num_heads}, "
          f"latent {cfg.input_size}, context {cfg.context_size}, {cfg.dtype}), "
          f"VAE bf16, {NWM_STEPS} DDIM steps", flush=True)
    norms, hooks = count_group_norms(worker.vae)
    attn = collections.Counter()
    hooks += [m.register_forward_pre_hook(
        lambda m, a: attn.update([type(m).__name__])) for m in worker.model.modules()
        if isinstance(m, (TC.Attention, TC.CrossAttention))]
    req = nwm_request(NWM_CANDIDATES, 11)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = worker(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_nwm_answer("nwm request", out, NWM_CANDIDATES)
    rollouts = NWM_FRAMES - 1
    want = expected({"K1-D72": sum(attn.values())}, sum(norms.values()))
    print(f"nwm request ({NWM_CANDIDATES} candidates x {NWM_FRAMES} actions, "
          f"{rollouts} rollouts of {NWM_STEPS} steps): {secs:.3f} s, "
          f"{NWM_CANDIDATES * rollouts / secs:.4f} generated frames/s, peak "
          f"{peak:.2f} GiB; attention calls by hooks {dict(attn)}, GroupNorm "
          f"calls {sum(norms.values())}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != want or want["K1-D72"] != 2 * cfg.depth * NWM_STEPS * rollouts:
        raise RuntimeError(f"nwm launches {counts} != {want}")

    # a CDiT forward at B = 2, one DDIM step profiled
    gx = torch.Generator(device=dev).manual_seed(12)
    n = cfg.input_size
    args = (torch.randn(NWM_CANDIDATES, n, n, 4, generator=gx, device=dev),
            torch.full((NWM_CANDIDATES,), 500.0, device=dev),
            torch.zeros(NWM_CANDIDATES, 3, device=dev),
            torch.randn(NWM_CANDIDATES, cfg.context_size, n, n, 4, generator=gx,
                        device=dev),
            torch.full((NWM_CANDIDATES,), 0.5, device=dev))
    flops = cdit_forward_flops(cfg, NWM_CANDIDATES)
    wbytes = sum(p.numel() * p.element_size() for p in worker.model.parameters())
    with torch.inference_mode():
        worker.model(*args)
        fwd_ms = cuda_ms(lambda: worker.model(*args), 10)

        def step():
            return TC.ddim_sample(worker.model, args[0].shape, args[3], args[2],
                                  args[4], num_steps=1, noise=args[0])

        step()
        step_ms = cuda_ms(step, 10)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step()
            torch.cuda.synchronize()
    busy = busy_ms(prof)
    launches_step = sum(e.count for e in prof.key_averages()
                        if "CUDA" in str(e.device_type))
    print(f"nwm CDiT forward (B = {NWM_CANDIDATES}): {fwd_ms:.3f} ms by CUDA events "
          f"(mean of 10); {flops / 1e12:.4f} TFLOP ({flops / fwd_ms / 1e9:.1f} "
          f"TFLOP/s), weights {wbytes / 1e9:.3f} GB (bound "
          f"{bound_ms(wbytes, flops, BF16_FLOPS_S):.3f} ms); a DDIM step "
          f"{step_ms:.3f} ms by events; in the profiled step device busy "
          f"{busy:.3f} ms, idle share {1 - busy / step_ms:.4f} of the event "
          f"time, {launches_step} kernels", flush=True)
    print_top(prof)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    print("  top ops by self host time (under the profiler, which adds its "
          "own): " + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} "
                               f"ms {e.count}x" for e in host[:10]), flush=True)

    # the bf16 forward against an fp32 one of the same weights, plain attention
    def plain_bsd(q, k, v, heads):
        B, Sq, HD = q.shape
        hv = [t.reshape(B, -1, heads, HD // heads).transpose(1, 2) for t in (q, k, v)]
        return flash_attention_plain(*hv).transpose(1, 2).reshape(B, Sq, HD)

    with torch.device("meta"):
        ref_model = TC.CDiT(dataclasses.replace(cfg, dtype="float32"))
    ref_model.to_empty(device=dev).load_state_dict(worker.model.state_dict())
    outs = {}

    def grab(tag, i):
        return lambda m, a, o: outs.__setitem__((tag, i), o.float())

    hooks = [blk.register_forward_hook(grab(tag, i))
             for tag, model in (("bf16", worker.model), ("fp32", ref_model))
             for i, blk in enumerate(model.blocks)]
    kernel_bsd, TC.attention_bsd = TC.attention_bsd, plain_bsd
    try:
        with torch.inference_mode():
            ref = ref_model(*args)
    finally:
        TC.attention_bsd = kernel_bsd
    with torch.inference_mode():
        got = worker.model(*args)
    for h in hooks:
        h.remove()

    def rel(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    per_block = [rel(outs["bf16", i], outs["fp32", i]) for i in range(cfg.depth)]
    err = rel(got, ref)
    print(f"nwm bf16 CDiT forward against fp32 (the same weights, plain "
          f"attention), relative Frobenius: output {err:.5f} (tol {CDIT_REL_FRO}); "
          f"by block " + ", ".join(f"{e:.4f}" for e in per_block), flush=True)
    if not torch.isfinite(got).all() or err > CDIT_REL_FRO:
        raise RuntimeError(f"the bf16 CDiT forward is {err} from fp32's")
    del ref_model, ref, got, outs, worker, prof
    gc.collect()
    torch.cuda.empty_cache()

    # K8 at the VAE's GroupNorm shapes at 224x224 (encode B = 2, decode 1 frame)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vae = dict.fromkeys(("request_ms", "request_device_ms", "request_plain_ms",
                         "request_bound_ms", "request_library_ms"), 0.0)
    for key in sorted(norms, key=lambda k: -int(np.prod(k[0]))):
        r = k8_shape(key, f"{norms[key]} an NWM request", dev, g, sms)
        for name, val in (("ms", r["ms"]), ("device_ms", r["device_ms"]),
                          ("plain_ms", r["plain_ms"]), ("bound_ms", r["bound"]),
                          ("library_ms", r["library_ms"])):
            vae[f"request_{name}"] += norms[key] * val
        rows["K8"].d["max_abs_err"] = max(rows["K8"].d["max_abs_err"], r["max_err"])
    vae["calls"] = sum(norms.values())
    vae["shapes"] = len(norms)
    rows["K8"].d["nwm_vae224"] = vae
    print(f"K8 in an NWM request ({vae['calls']} calls at {len(norms)} shapes): "
          f"kernel {vae['request_ms']:.4f} ms (device "
          f"{vae['request_device_ms']:.4f} ms), plain {vae['request_plain_ms']:.4f} "
          f"ms, bound {vae['request_bound_ms']:.4f} ms, library "
          f"{vae['request_library_ms']:.4f} ms", flush=True)
    d = rows["K1-D72"].d
    d.update(request_ms=d["ms"] * NWM_STEPS * rollouts,
             request_device_ms=d["device_ms"] * NWM_STEPS * rollouts,
             nwm={"s": secs, "frames_s": NWM_CANDIDATES * rollouts / secs,
                  "forward_ms": fwd_ms, "step_ms": step_ms, "step_busy_ms": busy,
                  "idle_share": 1 - busy / step_ms, "peak_gib": peak,
                  "bf16_vs_fp32_rel_fro": err})
    d["nwm"]["server"] = nwm_server_phase()
    return counts


def nwm_server_phase() -> dict:
    """`server_cli --wm_type nwm`: without --external_cmd it raises and names
    the command; with it, a `ManagerServer` on a free port hands two
    concurrent requests (two `WMClient` threads) to the subprocess worker
    (built and initialised after the server starts: the first answer pays
    for it); then the server and the worker stop."""
    from wiw_tpu_torch.serve import server_cli
    from wiw_tpu_torch.serve.manager import ManagerServer, WMClient

    base = ["--host", "127.0.0.1", "--port", str(free_port()), "--wm_type", "nwm"]
    args, extra = server_cli.build_parser().parse_known_args(base)
    try:
        server_cli.build_executors(args, extra)
    except SystemExit as e:
        if NWM_CMD not in str(e):
            raise RuntimeError(f"server_cli --wm_type nwm refused without naming "
                               f"its worker: {e}")
        print(f"server_cli --wm_type nwm without --external_cmd: {e}", flush=True)
    else:
        raise RuntimeError("server_cli --wm_type nwm built a worker without "
                           "--external_cmd")
    args, extra = server_cli.build_parser().parse_known_args(
        base + ["--external_cmd", NWM_CMD])
    execs = server_cli.build_executors(args, extra)
    server = ManagerServer(execs, host="127.0.0.1", port=args.port)
    port = server.start()
    results, errors = {}, []

    def client(name, seed):
        try:
            c = WMClient(port=port)
            t = time.perf_counter()
            out = c.send_batch(nwm_request(NWM_CANDIDATES, seed))
            results[name] = (time.perf_counter() - t, out)
            c.close()
        except Exception as e:  # reported below: the phase fails
            errors.append(f"client {name}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(name, i + 20))
               for i, name in enumerate("AB")]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    procs = [e.proc for e in execs]
    if errors or len(results) != 2 or any(p.poll() is None for p in procs):
        raise RuntimeError(f"nwm server: {errors}, answers {len(results)}, worker "
                           f"exit codes {[p.poll() for p in procs]}")
    for name, (secs, res) in sorted(results.items()):
        check_nwm_answer(f"nwm server client {name}", res, NWM_CANDIDATES)
        print(f"nwm server client {name}: pred_frames "
              f"{res['pred_frames'].shape} {res['pred_frames'].dtype} in "
              f"{secs:.3f} s", flush=True)
    print(f"nwm server: 2 requests in {wall:.3f} s from start (the subprocess "
          f"worker's start and random init included); server and worker "
          f"stopped", flush=True)
    return {"wall_s": wall, "request_s": {n: r[0] for n, r in results.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from wiw_tpu_torch.ops import native

    os.environ.pop("WIW_FUSED_FF_GATE", None)  # the fp32 gate but where set below
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sdp = torch.backends.cuda
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; SDPA (the library "
          f"yardstick of K1, K4): flash built {sdp.is_flash_attention_available()}"
          f", enabled flash {sdp.flash_sdp_enabled()} mem_efficient "
          f"{sdp.mem_efficient_sdp_enabled()} cudnn {sdp.cudnn_sdp_enabled()}",
          flush=True)

    libs = native.LIBRARIES
    t0 = time.perf_counter()
    native.load_libraries(*libs)
    print(f"build (sm_90a, one nvcc per source in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in libs:
        secs, log = native.build_info[name]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: {secs:.2f} s; " + "; ".join(ptxas), flush=True)
    # K7, K5/K6, K10 and K1 (with K2's and K9's modes) run their products
    # on wgmma: ptxas must not serialise them (C7510-C7520) nor spill
    for name in ("w8a8", "geglu_ffn", "flash_attn_i8", "flash_attn_fwd"):
        log = native.build_info[name][1].splitlines()
        wgmma = [ln.strip() for ln in log if "serialized" in ln or "C751" in ln
                 or "C7520" in ln]
        print(f"  {name} ptxas wgmma lines: " + ("; ".join(wgmma) if wgmma else
                                                 "none (no wgmma serialized)"),
              flush=True)
        if wgmma:
            raise RuntimeError(f"ptxas serialised {name}'s wgmma")
    for name in ("geglu_ffn", "group_norm", "temporal_attn", "flash_attn_i8",
                 "flash_attn_fwd"):
        spills = [ln.strip() for ln in native.build_info[name][1].splitlines()
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spills:
            raise RuntimeError(f"ptxas spilled in {name}: " + "; ".join(spills))

    rows = {
        "K1": Row("flash_attn_fwd_d64", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                  "wiw_tpu/ops/pallas_attention.py:121",
                  "one 2-row UNet forward: 16 calls", library=True),
        "K1-D72": Row("flash_attn_fwd_d72", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                      "wiw_tpu/ops/pallas_attention.py:121",
                      "one CDiT-XL/2 forward at B = 2, 224x224: 28 self-"
                      "attentions (Sq = Skv = 196) and 28 cross-attentions (Sq "
                      "196, Skv 785); request_*: one NWM request (13 rollouts of "
                      "20 forwards); device_ms by torch.profiler", library=True),
        "K2": Row("flash_attn_fwd_d64_v1", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                  "wiw_tpu/ops/pallas_attention.py:40",
                  "one call at S = 9216 (B*H = 140) and one at S = 144 (B*H = "
                  "560); no model caller", library=True),
        "K2-unroll2": Row("flash_attn_fwd_d64_v1_unroll2",
                          "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                          "wiw_tpu/ops/pallas_attention.py:77",
                          "as K2, K1's kernel too; at S = 144 (not a multiple of "
                          "128) counted as v1, where the reference takes its "
                          "one-block loop; no model caller", library=True),
        "K3": Row("flash_attn_bwd_d64", "wiw_tpu_torch/csrc/flash_attn_bwd.cu",
                  "wiw_tpu/ops/attention.py:60",
                  "one 1-row training micro-batch: 16 calls", library=True),
        "K4": Row("temporal_attn_d64", "wiw_tpu_torch/csrc/temporal_attn.cu",
                  "wiw_tpu/ops/temporal_attention.py:26",
                  "one 2-row UNet forward: 15 calls", library=True),
        "K5": Row("geglu_ffn", "wiw_tpu_torch/csrc/geglu_ffn.cu",
                  "wiw_tpu/ops/fused_mlp.py:43",
                  "K6's 30 shapes of one 2-row UNet forward; no model caller, "
                  "no single PyTorch call", library=False),
        "K6": Row("ln_geglu_ffn_residual", "wiw_tpu_torch/csrc/geglu_ffn.cu",
                  "wiw_tpu/ops/fused_mlp.py:169",
                  "one 2-row UNet forward: 30 calls; no single PyTorch call",
                  library=False),
        "K6-bf16": Row("ln_geglu_ffn_residual_bf16_gate",
                       "wiw_tpu_torch/csrc/geglu_ffn.cu", "wiw_tpu/ops/fused_mlp.py:192",
                       "one 2-row UNet forward with WIW_FUSED_FF_GATE=bf16: 30 "
                       "calls; no single PyTorch call", library=False),
        "K8": Row("group_norm_silu", "wiw_tpu_torch/csrc/group_norm.cu",
                  "scripts/tune_temporal3.py:74",
                  "one 2-row UNet forward (request_*: one default request, all "
                  "towers); library: F.group_norm (+ F.silu) on the [N, C, L] view",
                  library=True),
        "K7-dense": Row("w8a8_dense", "wiw_tpu_torch/csrc/w8a8.cu",
                        "wiw_tpu/ops/quant.py:97",
                        "one 2-row int8 UNet forward: its GEGLU in-projections "
                        "(request_*: one int8 request); library: torch._int_mm "
                        "on the same int8 operands, the product alone",
                        library=True),
        "K7-conv": Row("w8a8_conv", "wiw_tpu_torch/csrc/w8a8.cu",
                       "wiw_tpu/ops/quant.py:115",
                       "one 2-row int8 UNet forward: its 3x3 convs (request_*: "
                       "one int8 request; vae_conv: the VAE decoder's largest "
                       "int8 conv); no int8 conv in PyTorch", library=False),
        "K9-floor": Row("flash_attn_fwd_d64_floor", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                        "scripts/tune_attention2.py:78",
                        "one call at B*H = 140, S = 9216; no model caller",
                        library=False),
        "K9-noexp": Row("flash_attn_fwd_d64_noexp", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                        "scripts/tune_attention2.py:95",
                        "one call at B*H = 140, S = 9216; no model caller",
                        library=False),
        "K9-v2": Row("flash_attn_fwd_d64_v2", "wiw_tpu_torch/csrc/flash_attn_fwd.cu",
                     "scripts/tune_attention2.py:122",
                     "one call at B*H = 140, S = 9216 (K1's code on the "
                     "pre-scaled q); no model caller", library=True),
        "K10": Row("flash_attn_i8qk", "wiw_tpu_torch/csrc/flash_attn_i8.cu",
                   "scripts/probe_int8_attention.py:48",
                   "one call at B*H = 140, S = 9216, bf16 PV; no model caller",
                   library=False),
        "K10-i8pv": Row("flash_attn_i8qk_i8pv", "wiw_tpu_torch/csrc/flash_attn_i8.cu",
                        "scripts/probe_int8_attention.py:48",
                        "one call at B*H = 140, S = 9216, int8 PV; no model "
                        "caller", library=False),
        "K8-stats": Row("group_norm_stats", "wiw_tpu_torch/csrc/group_norm.cu",
                        "scripts/tune_temporal3.py:74",
                        "shard_clip: one call on each GroupNorm shape of SPLIT_GN_SHAPES, "
                        "the largest shard of a rank at fsdp 4; library: torch.var_mean",
                        library=True),
        "K8-combine": Row("combine_stats", "wiw_tpu_torch/csrc/group_norm.cu",
                          "scripts/tune_temporal3.py:74",
                          "shard_clip: one call on each GroupNorm shape of SPLIT_GN_SHAPES, "
                          "the parts of fsdp 4's shards; no single PyTorch call",
                          library=False),
        "K8-apply": Row("group_norm_apply", "wiw_tpu_torch/csrc/group_norm.cu",
                        "scripts/tune_temporal3.py:80",
                        "shard_clip: as K8-stats; no single PyTorch call", library=False),
        "K7-amax": Row("conv_amax", "wiw_tpu_torch/csrc/w8a8.cu", "wiw_tpu/ops/quant.py:115",
                       "shard_clip: one call on a rank's largest shard of a level-0 "
                       "conv input at fsdp 4; library: torch.linalg.vector_norm(ord=inf)",
                       library=True),
        "K7-conv-given": Row("w8a8_conv_amax_given", "wiw_tpu_torch/csrc/w8a8.cu",
                             "wiw_tpu/ops/quant.py:115",
                             "shard_clip: one level-0 3x3 conv on a rank's largest halo'd "
                             "shard at fsdp 4; no int8 conv in PyTorch", library=False),
    }
    g = torch.Generator(device=dev).manual_seed(0)
    k1_phase(rows["K1"], dev, g)
    k2_phase(rows, dev, g)
    k4_phase(rows["K4"], dev, g)
    gate_floors = ffn_phase(rows["K5"], rows["K6"], rows["K6-bf16"], dev, g)
    k3_phase(rows["K1"], rows["K3"], dev, g)
    k6_backward_check(dev, g)
    k8_checks(dev, g)
    attention_probe_phase(rows, dev, g)
    torch.cuda.empty_cache()

    small_reference_phase(dev)
    by_path = {}
    by_path["default"], info = slice_phase(dev, "default", 1)
    k8_phase(rows["K8"], info["forward"], info["request"], dev, g)
    by_path["int8"], info8 = slice_phase(dev, "int8", 1, **INT8)
    mse = np.mean((info8["frames"].astype(np.float64)
                   - info["frames"].astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
    print(f"int8 against default, same seed and weights: {info8['int8_weights']} "
          f"int8 weights; {info8['s']:.3f} vs {info['s']:.3f} s/request, "
          f"{info8['frames_s']:.4f} vs {info['frames_s']:.4f} denoise frames/s, "
          f"2-row forward {info8['forward_ms']:.2f} vs {info['forward_ms']:.2f} ms, "
          f"peak {info8['peak_gib']:.2f} vs {info['peak_gib']:.2f} GiB; decoded "
          f"frames PSNR {psnr:.2f} dB (random weights: no quality figure); K6 "
          f"steps aside at {info8['k6_bypass']} feed-forwards a forward", flush=True)
    if not np.isfinite(mse) or psnr < 10:
        raise RuntimeError(f"int8 frames far from bf16's: PSNR {psnr:.2f} dB")
    k7_phase(rows["K7-dense"], rows["K7-conv"], info8["int8_forward"],
             info8["int8_request"], vae_int8_calls(dev), dev, g)
    for key in ("int8_weights", "s", "frames_s", "forward_ms", "peak_gib",
                "k6_bypass"):
        rows["K7-dense"].d[f"int8_{key}"] = info8[key]
    rows["K7-dense"].d["int8_psnr_db_vs_bf16"] = psnr
    del info, info8
    by_path["fused"], _ = slice_phase(dev, "fused", 1, FUSED_STEPS, **FUSED)
    os.environ["WIW_FUSED_FF_GATE"] = "bf16"  # read by the worker, as the reference's
    try:
        by_path["fused-bf16"], _ = slice_phase(dev, "fused-bf16", 1, FUSED_STEPS,
                                               **FUSED)
    finally:
        del os.environ["WIW_FUSED_FF_GATE"]
    by_path["serve"] = serve_phase(rows, dev, g)
    engine_vs_generate(dev)
    by_path["action_block"] = world_phase(
        dev, "action_block", 32, 98 + 16, action_strategy="action_block")
    by_path["manipulation"], manip_worker = world_phase(
        dev, "manipulation", 16, 98, keep=True, width=448, height=448,
        task_type="manipulation", action_input_channel=10)
    by_path["manip"] = manip_phase(manip_worker)
    del manip_worker
    gc.collect()
    torch.cuda.empty_cache()
    by_path["rollouts"], by_path["solvers"], by_path["habitat"] = rollouts_phase(rows)
    by_path["collect"] = collect_phase(dev)
    by_path["eval"] = eval_phase(dev)
    by_path["past_alt"] = past_alt_phase(dev, g)
    by_path["nwm"] = nwm_phase(rows, dev, g)
    by_path["train"], train = train_phase(dev)
    by_path["optim"] = optim_phase(train, dev)
    del train
    gc.collect()
    torch.cuda.empty_cache()
    by_path["dist"] = dist_phase(dev)
    by_path["shard_clip"] = shard_clip_phase(rows, dev, g)
    for key, row in rows.items():
        d = row.d
        floor = (f", gate floor {gate_floors[key]:.4f} ms (estimated)"
                 if key in gate_floors else "")
        print(f"{key} per UNet forward ({d['per']}): kernel {d['ms']:.4f} ms "
              f"(before: {PREV_MS[key]} ms), plain "
              f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']}){floor}, library {d['library_ms']}", flush=True)
        d["launches"] = sum(p.get(key, 0) for p in by_path.values())
        d["launches_by_path"] = {p: c.get(key, 0) for p, c in by_path.items()}
        d["on_main_path"] = key not in ("K2", "K2-unroll2", "K5", "K9-floor",
                                        "K9-noexp", "K9-v2", "K10", "K10-i8pv")
        if d["on_main_path"] and not d["launches"]:
            raise RuntimeError(f"{key} was not launched on any path")
    rows["K1"].d["lse_per"] = ("one 1-row training forward: 16 calls at "
                               "batch 14, with (lse_ms) and without (lse_off_ms)"
                               " the LSE output")

    print(json.dumps({"prev_kernels": {k: PREV_MS[k] for k in rows},
                      "from": PREV_FROM}))
    print(json.dumps({"kernels": [r.d for r in rows.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warps"]:  # warp_checks' own process
        with open(sys.argv[2], "w") as f:
            json.dump(measure_warps(torch.device("cuda")), f)
        sys.exit(0)
    sys.exit(main())
