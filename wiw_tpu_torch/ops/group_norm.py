"""GroupNorm (+ SiLU) over the channel axis: kernel K8 and its plain version.

The function is the reference's `GroupNorm` (wiw_tpu/models/layers.py),
followed by `silu` where the model applies one to the norm's output: fp32
statistics per (batch row, group of C/G contiguous channels) over every
position, y = (x - mean) * rstd * weight + bias rounded to x's dtype, then
SiLU of that rounded value (in fp32, rounded again). The reference leaves
this to XLA, which fuses it into a few passes; PyTorch runs it eagerly op
by op (~10 fp32 passes), so the port carries it on a kernel.

- `group_norm_plain` is the plain version: an exact two-pass variance in
  fp32, each batch row on its own.
- K8 (`wiw_tpu_torch/csrc/group_norm.cu`) replaces the TPU probe kernels
  `_stats_kernel` and `_affine_silu_kernel` of scripts/tune_temporal3.py
  and the glue between them; its header says what bounds it on the H100.
  One call is one launch, counted in `group_norm.launches`. `k8_plan` is
  the one place that picks its work: the slab (a channel range of whole
  groups and whole 16-byte vectors), path R (the slab resident in the
  shared memory of a cluster of CTAs) or path S (one cooperative grid that
  walks whole rows, a batch of them between grid barriers), the cluster
  size and the positions a block holds. The C entry refuses any other
  plan.
- The split entries, for a GroupNorm whose positions are split over ranks
  (shard_clip, `parallel/clip_sharding.group_norm`): `group_norm_stats`
  (K8-stats: per (row, group) count, mean and M2 of the positions given,
  its tiles' partials combined on the card in the same launch; the TPU
  probe's `_stats_kernel` and the glue that merges its partials;
  `stats_plan` picks its tiles) and `group_norm_apply` (K8-apply: the
  ranks' all-gathered parts combined by Chan's rule in each block's
  prologue, then affine + SiLU; `_affine_silu_kernel`; `apply_plan`
  picks its tiles), each with its plain version (the ranks' combination:
  `combine_stats_plain`). The one-launch K8 stays what runs without a row
  split.
- `copy_plus_one` (the probe's `_copy_kernel`, x + 1 in bf16) measures the
  card's copy ceiling beside K8; its plain version is `x + 1`.
- The gradient: `GroupNormFunction` runs K8 forward and saves only x and
  the parameters; its backward recomputes through `group_norm_plain` and
  differentiates that, as K6's backward does (the reference has no
  GroupNorm backward kernel either).

`group_norm` takes CPU tensors to the plain version and launches K8 on CUDA
tensors (bf16 or fp32 x; C a multiple of 8 and of the groups; a group of at
most 4 KB a position, 2048 bf16 or 1024 fp32 channels; at most 65535 batch
rows; anything else raises: no fallback). A non-contiguous x is made
contiguous first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from wiw_tpu_torch.ops import native

C_STEP = 8  # the kernel reads 8 channels a thread
MAX_ROWS = 65535  # batch rows: a grid dimension of the kernel
_LIB = "group_norm"

# K8's plan (csrc/group_norm.cu keeps the same numbers)
K8_THREADS_R = 256           # path R's CTAs; a thread owns one 16-byte column
K8_BLOCKS_S = 2              # path S's blocks an SM, all resident
K8_SMEM = 232448             # dynamic shared memory a block may use
K8_SHARD = 92 * 1024         # path R: a CTA's positions, two CTAs an SM
K8_CLUSTER_PORTABLE = 8      # cluster sizes every card runs
K8_CLUSTER_MAX = 16          # with the non-portable attribute
K8_L2_BATCH = 20 * 2 ** 20   # path S: a row this small is read back from L2
K8_S_BATCH = 80 * 2 ** 20    # path S: bytes of x a batch of whole rows
H100_SMS = 132


class K8Plan(NamedTuple):
    """K8's work for one [N, L, C] shape. path "R": the slab of `slab`
    channels is resident in a cluster of `cluster` CTAs, each holding
    `rows` positions; `blocks` CTAs in all. path "S": a cooperative grid of
    `blocks` blocks walks whole rows, `slabs_per_batch` slabs (of whole
    rows) between grid barriers, each block streaming `rows` positions of
    one slab of each row; `resident` says whether a row fits K8_L2_BATCH,
    so that the apply reads it back from L2 (else x is read twice from
    HBM, less what of it the L2 still holds)."""
    path: str
    slab: int
    cluster: int
    rows: int
    blocks: int
    slabs_per_batch: int
    resident: bool


def _k8_smem_extra(w: int, gs: int, rs: int) -> int:
    """Bytes of fp32 scratch a path-R CTA needs beside its shard (the C
    side's `smem_extra`): its threads' channel sums twice, the sums of row
    segments twice, the slab's scale and offset, and five values a group."""
    return 4 * (2 * rs * w + 2 * max(w, K8_THREADS_R) + 2 * w + 5 * gs)


def k8_smem_extra(w: int, C: int, groups: int, dtype: torch.dtype) -> int:
    """`_k8_smem_extra` of a path-R slab of w channels."""
    return _k8_smem_extra(w, w // (C // groups), K8_THREADS_R // (w * dtype.itemsize // 16))


@functools.lru_cache(maxsize=None)
def k8_plan(N: int, L: int, C: int, groups: int, dtype: torch.dtype,
            sms: int = H100_SMS) -> K8Plan:
    """K8's plan for x [N, L, C] with `groups` groups on a card of `sms`
    multiprocessors. The slab is a multiple of lcm(C/G, 8) channels (whole
    groups of whole 16-byte vectors) dividing C, at least 16 channels where
    C allows. Path R where a slab of at least 64 bytes a position fits a
    cluster of at most 16 CTAs of K8_SHARD bytes (two an SM), or one of at
    least 128 bytes fits 16 CTAs one an SM, preferring a portable cluster
    (8 at most), then whole 32-byte sectors a position, then the narrowest;
    path S where none does, on half-row slabs, as many
    whole rows a batch as K8_S_BATCH holds. Nothing in the plan that sets
    the arithmetic depends on N (path S's rows a batch do, and only say
    which rows share a barrier), so a row's bits do not depend on the rows
    beside it. Raises for what the kernel does not take."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm kernel takes bf16 or fp32 x, got {dtype}")
    if C <= 0 or C % C_STEP or groups <= 0 or C % groups:
        raise ValueError(f"group_norm kernel takes C a multiple of {C_STEP} and "
                         f"of the groups, got C={C}, groups={groups}")
    if not 0 < N <= MAX_ROWS or L <= 0:
        raise ValueError(f"group_norm kernel takes 1..{MAX_ROWS} rows of at least "
                         f"one position, got N={N}, L={L}")
    isz = dtype.itemsize
    cg = C // groups
    unit = math.lcm(cg, C_STEP)
    widths = [w for w in range(unit, C + 1, unit)
              if C % w == 0 and w * isz <= 16 * K8_THREADS_R]
    if not widths:
        raise ValueError(f"group_norm kernel takes groups of at most "
                         f"{16 * K8_THREADS_R // isz} channels, got C/G={cg}")
    widths = [w for w in widths if w >= 16] or widths

    def cluster(w, shard):
        """(CTAs, positions a CTA) of the smallest cluster whose CTAs of
        `shard` bytes hold a slab of w channels, or None."""
        k = -(-(L * w * isz) // shard)
        if k > K8_CLUSTER_MAX:
            return None
        rows = -(-L // k)
        return -(-L // rows), rows

    # path R where a slab of at least 64 bytes a position fits a cluster
    # of CTAs two an SM (one loads while the other computes), or one of at
    # least 128 bytes fits CTAs one an SM; else path S (measured on an
    # H100: one CTA an SM on narrower slabs, and 32-byte slabs, ran slower)
    big = K8_SMEM - max(k8_smem_extra(w, C, groups, dtype) for w in widths)
    for shard, least in ((K8_SHARD, 64), (big, 128)):
        fits = {w: cluster(w, shard) for w in widths
                if w * isz >= least and cluster(w, shard)}
        if fits:
            # a portable cluster first, then whole 32-byte sectors a
            # position, then the narrowest
            w = min(fits, key=lambda w: (fits[w][0] > K8_CLUSTER_PORTABLE,
                                         w * isz % 32 != 0, w))
            k, rows = fits[w]
            return K8Plan("R", w, k, rows, N * (C // w) * k, 0, True)
    # path S: half-row slabs (contiguous reads; two a row ran faster than
    # one), Q = blocks / slabs-a-row blocks on each, as many whole rows a
    # batch as K8_S_BATCH holds (the batch sets only which rows share a
    # grid barrier, not the bits)
    w = max((v for v in widths if v <= C // 2), default=widths[-1])
    blocks = sms * K8_BLOCKS_S
    row_bytes = L * C * isz
    rb = max(1, min(N, K8_S_BATCH // row_bytes))
    return K8Plan("S", w, 1, -(-L // (blocks // (C // w))), blocks, rb * (C // w),
                  row_bytes <= K8_L2_BATCH)


def k8_work_bytes(plan: K8Plan, C: int, groups: int) -> int:
    """Scratch of a path-S call: each block's (mean, M2) per group for each
    slab of a batch (float64 pairs), the batch's (mean, 1/std) per group
    twice (by batch parity, fp32 pairs), and an arrival counter a slab."""
    if plan.path == "R":
        return 0
    gs = plan.slab // (C // groups)
    slots, Q = plan.slabs_per_batch, plan.blocks // (C // plan.slab)
    return slots * Q * gs * 16 + 2 * slots * gs * 8 + slots * 4


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last (channel) axis in fp32, exact two-pass
    statistics per batch row; returns x's dtype, then SiLU if asked."""
    N, C = x.shape[0], x.shape[-1]
    g = x.float().reshape(N, -1, groups, C // groups)
    d = g - g.mean(dim=(1, 3), keepdim=True)
    var = (d * d).mean(dim=(1, 3), keepdim=True)
    out = (d * torch.rsqrt(var + eps)).reshape(x.shape)
    out = (out * weight + bias).to(x.dtype)
    return F.silu(out) if silu else out


def _bind(lib: ctypes.CDLL):
    fn = lib.wiw_group_norm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn



def _check(x, weight, bias) -> None:
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"group_norm: {name} on {t.device}, x on {x.device}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"group_norm kernel takes a non-empty [N, ..., C] x, "
                         f"got {tuple(x.shape)}")
    C = x.shape[-1]
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"group_norm: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{C}]")


def _group_norm(x, weight, bias, groups, eps, silu):
    """The plain version on CPU tensors, K8 on CUDA tensors."""
    if native.on_cpu(x, weight, bias):
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    _check(x, weight, bias)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel takes a 16-byte aligned x")
    fn = _bind(native.load_library(_LIB))
    N, C = x.shape[0], x.shape[-1]
    L = x.numel() // (N * C)
    plan = k8_plan(N, L, C, groups, x.dtype,
                   torch.cuda.get_device_properties(x.device).multi_processor_count)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    work = torch.empty(k8_work_bytes(plan, C, groups), dtype=torch.uint8,
                       device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 work.data_ptr() if work.numel() else None, N, L, C, groups,
                 float(eps), int(x.dtype == torch.bfloat16), int(silu),
                 int(plan.path == "S"), plan.slab, plan.cluster, plan.rows,
                 plan.blocks, plan.slabs_per_batch,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_LIB} launch failed: cudaError {err}")
    group_norm.launches += 1
    return y


class GroupNormFunction(torch.autograd.Function):
    """K8 forward (the plain version on the CPU); backward recomputed
    through `group_norm_plain`."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        ctx.save_for_backward(x, weight, bias)
        return _group_norm(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        return (*native.recompute_backward(ctx, group_norm_plain, grad, ctx.groups,
                                           ctx.eps, ctx.silu), None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) of x [N, ..., C] over its last axis. CPU tensors
    take `group_norm_plain`; CUDA tensors launch K8 (see the module
    docstring for what it takes; anything else raises) and count one launch
    in `group_norm.launches`. With gradients wanted it goes through
    `GroupNormFunction` (backward by recomputation); under `no_grad` or
    `inference_mode` nothing is saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return GroupNormFunction.apply(x, weight, bias, groups, eps, silu)
    return _group_norm(x, weight, bias, groups, eps, silu)


group_norm.launches = 0


# ------------------------------------------------- split entries (shard_clip)
STATS_THREADS = 256       # K8-stats: a block's threads, two blocks an SM
STATS_MAX_THREADS = 512   # csrc/group_norm.cu kStatMaxThreads; one block an SM
STATS_CHUNK = 4           # 16-byte loads a chunk (kStatChunk)
STATS_MIN_CHUNKS = 4      # chunks a thread loads at least, against a block's fold
STATS_TILE_LOADS = 4      # partials a thread of a row's last block reads a pass


class StatsPlan(NamedTuple):
    """K8-stats' work for one [N, L, C] shape: blocks of `threads`, each
    taking `tile` positions of one row (every channel), `tiles` a row."""
    threads: int
    tile: int
    tiles: int


@functools.lru_cache(maxsize=None)
def stats_plan(N: int, L: int, C: int, groups: int, dtype: torch.dtype,
               sms: int = H100_SMS) -> StatsPlan:
    """K8-stats' plan. A thread owns one 16-byte column of the nv = C *
    itemsize / 16 of a position at every rs-th position of its tile. One
    wave of blocks: two of STATS_THREADS threads an SM (rs = threads // nv
    row threads, at least one), or one of up to STATS_MAX_THREADS where a
    position is wider or the rows are too few for that (a position wider
    than the block is taken in turns). Tiles of at least STATS_MIN_CHUNKS
    chunks a thread, and at most STATS_TILE_LOADS tiles for each of a row's
    last block's threads on a group (that block combines them)."""
    nv = C * dtype.itemsize // 16

    def plan(width: int) -> StatsPlan:
        rs = max(1, width // nv)
        threads = min(STATS_MAX_THREADS, max(width, -(-rs * nv // 32) * 32))
        rs = max(1, threads // nv)
        per_sm = 2 if threads <= STATS_THREADS else 1
        most = min(STATS_TILE_LOADS * max(1, threads // groups),
                   -(-L // (rs * STATS_CHUNK * STATS_MIN_CHUNKS)))
        tiles = max(1, min(most, per_sm * sms // N))
        tile = -(-L // tiles)
        return StatsPlan(threads, tile, -(-L // tile))

    two = plan(STATS_THREADS)
    if N * two.tiles >= sms:
        return two
    one = plan(STATS_MAX_THREADS)
    return one if one.tiles * one.threads > two.tiles * two.threads else two


def stats_work_bytes(plan: StatsPlan, N: int, groups: int) -> int:
    """K8-stats' workspace: each (row, tile, group)'s (mean, M2) as float64
    pairs, then an arrival counter a row."""
    return N * plan.tiles * groups * 16 + 4 * N


def _rows_view(x: torch.Tensor, groups: int):
    """x as fp32 [N, L, G, C/G] (L = 0 for an x without positions)."""
    N, C = x.shape[0], x.shape[-1]
    L = x.numel() // (N * C) if N * C else 0
    return x.float().reshape(N, L, groups, C // groups)


def group_norm_stats_plain(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(count, mean, M2) of each (batch row, group) of x [N, ..., C] over
    its positions, an exact two-pass in fp32: float64 [N, G, 3] (zeros for
    an x without positions)."""
    g = _rows_view(x, groups)
    N = g.shape[0]
    out = torch.zeros(N, groups, 3, dtype=torch.float64, device=x.device)
    count = g.shape[1] * g.shape[3]
    if count:
        mean = g.mean(dim=(1, 3))
        d = g - mean[:, None, :, None]
        out[..., 0] = count
        out[..., 1] = mean.double()
        out[..., 2] = (d * d).sum(dim=(1, 3)).double()
    return out


def group_norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The statistics half of a GroupNorm whose positions are split over
    ranks: float64 [N, G, 3] of (count, mean, M2) per (batch row, group) of
    x [N, ..., C]. CPU tensors take `group_norm_stats_plain`. CUDA tensors
    launch K8-stats (bf16/fp32, C a multiple of 8 and of the groups; a
    non-contiguous x is copied first), whose last block of each row
    combines the row's tiles, so its output is the result; counted in
    `group_norm_stats.launches`. An x without positions gives zeros with no
    launch."""
    if native.on_cpu(x) or x.numel() == 0:
        return group_norm_stats_plain(x, groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_stats: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_stats takes bf16 or fp32 x, got {x.dtype}")
    x = x.contiguous()
    N, C = x.shape[0], x.shape[-1]
    if C % C_STEP or C % groups or not 0 < N <= MAX_ROWS or x.data_ptr() % 16:
        raise ValueError(f"group_norm_stats takes C a multiple of {C_STEP} and of the "
                         f"groups, 1..{MAX_ROWS} rows, 16-byte aligned; got "
                         f"{tuple(x.shape)}, groups={groups}")
    L = x.numel() // (N * C)
    plan = stats_plan(N, L, C, groups, x.dtype, native.sm_count(x.device))
    work = torch.empty(stats_work_bytes(plan, N, groups), dtype=torch.uint8,
                       device=x.device)
    out = torch.empty(N, groups, 3, dtype=torch.float64, device=x.device)
    fn = native.load_library(_LIB).wiw_group_norm_stats
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with native.device_of(x):
        err = fn(x.data_ptr(), work.data_ptr(), out.data_ptr(), N, L, C, groups,
                 plan.threads, plan.tile, int(x.dtype == torch.bfloat16),
                 native.raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"group_norm_stats launch failed: cudaError {err}")
    group_norm_stats.launches += 1
    return out


group_norm_stats.launches = 0


def combine_stats_plain(every: torch.Tensor, eps: float):
    """(mean, rstd), fp32 [N, G], of the (count, mean, M2) statistics
    `every` [R, N, G, 3] of R parts of the same rows (ranks, or row shards),
    combined by Chan's rule in double in the parts' order: mean = sum(n_i
    mean_i) / n, M2 = sum(M2_i + n_i (mean_i - mean)^2), parts of count 0
    adding nothing; rstd = rsqrt(M2 / count + eps) in fp32, as
    `group_norm_plain` takes it."""
    count, mean = every[..., 0], every[..., 1]
    n = count.sum(0)
    mu = (count * mean).sum(0) / n.clamp_min(1)
    m2 = (every[..., 2] + count * (mean - mu) ** 2).sum(0)
    var = (m2 / n).float()
    return mu.float(), torch.rsqrt(var + eps)


APPLY_THREADS = 256      # K8-apply: a block's threads at most (csrc kApplyThreads)
APPLY_THREADS_SM = 1024  # K8-apply: resident threads an SM at <= 64 registers a thread
APPLY_MIN_ROWS = 4       # positions a thread takes at least: two chunks of two loads


class ApplyPlan(NamedTuple):
    """K8-apply's work for one [N, L, C] shape: blocks of `threads`, each
    taking `tile` positions of one row (every channel), `tiles` a row."""
    threads: int
    tile: int
    tiles: int


@functools.lru_cache(maxsize=None)
def apply_plan(N: int, L: int, C: int, dtype: torch.dtype,
               sms: int = H100_SMS) -> ApplyPlan:
    """K8-apply's plan. A thread owns one 16-byte column of the nv = C *
    itemsize / 16 of a position at every rs-th position of its tile, rs =
    256 // nv row threads (one, taking its columns in turn, where a
    position is wider than 256 vectors), so a block has rs * nv threads.
    One wave of blocks: as many tiles a row as SMs x resident blocks
    (APPLY_THREADS_SM) give for N rows, but no tile under APPLY_MIN_ROWS
    positions a thread (each block pays its prologue once)."""
    nv = C * dtype.itemsize // 16
    rs = max(1, APPLY_THREADS // nv)
    threads = min(APPLY_THREADS, rs * nv)
    tiles = max(1, min(sms * (APPLY_THREADS_SM // threads) // N,
                       -(-L // (rs * APPLY_MIN_ROWS))))
    tile = -(-L // tiles)
    return ApplyPlan(threads, tile, -(-L // tile))


def normalise_plain(x, mean, rstd, weight, bias, silu: bool = False):
    """((x - mean) * rstd) * weight + bias in fp32 per (batch row, group)
    from the given fp32 mean and rstd [N, G], rounded to x's dtype, then
    SiLU if asked (`group_norm_plain`'s arithmetic from given statistics)."""
    G = mean.shape[1]
    g = _rows_view(x, G)
    out = ((g - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape)
    out = (out * weight + bias).to(x.dtype)
    return F.silu(out) if silu else out


def group_norm_apply_plain(x, every, weight, bias, eps: float, silu: bool = False):
    """The apply half from the ranks' parts `every` [R, N, G, 3]: their
    combination (`combine_stats_plain`), then `normalise_plain` with the
    parameters in fp32."""
    mean, rstd = combine_stats_plain(every, eps)
    return normalise_plain(x, mean, rstd, weight.float(), bias.float(), silu)


def group_norm_apply(x: torch.Tensor, every: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = False) -> torch.Tensor:
    """The apply half of a split GroupNorm: x [N, ..., C] normalised with
    the statistics of the ranks' parts `every` [R, N, G, 3] (float64
    (count, mean, M2), all-gathered in rank order) (+ SiLU). CPU tensors
    take `group_norm_apply_plain`. CUDA tensors launch K8-apply (each
    block combines its row's parts as `combine_stats_plain` does, then the
    one-launch kernel's arithmetic: y = x * sc + of, sc = rstd * weight, of
    = bias - mean * sc; bf16/fp32 x, weight and bias of one dtype, bf16 or
    fp32, read as they are), counted in `group_norm_apply.launches`."""
    if native.on_cpu(x, every, weight, bias):
        return group_norm_apply_plain(x, every, weight, bias, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_apply: unsupported device {x.device}")
    _check(x, weight, bias)
    x = x.contiguous()
    N, C = x.shape[0], x.shape[-1]
    if (every.device != x.device or every.dtype != torch.float64 or every.ndim != 4
            or every.shape[1] != N or every.shape[-1] != 3):
        raise ValueError(f"group_norm_apply takes every, float64 [R, {N}, G, 3] on "
                         f"{x.device}; got {tuple(every.shape)} {every.dtype} on "
                         f"{every.device}")
    R, _, G, _ = every.shape
    if (x.dtype not in (torch.bfloat16, torch.float32) or C % C_STEP or C % G
            or not 0 < N <= MAX_ROWS or x.data_ptr() % 16):
        raise ValueError(f"group_norm_apply takes bf16/fp32 x with C a multiple of "
                         f"{C_STEP} and of the groups, 1..{MAX_ROWS} rows, 16-byte "
                         f"aligned; got x {tuple(x.shape)} {x.dtype}, {G} groups")
    if weight.dtype != bias.dtype or weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_apply takes bf16 or fp32 weight and bias of one "
                        f"dtype, got {weight.dtype} and {bias.dtype}")
    L = x.numel() // (N * C)
    plan = apply_plan(N, L, C, x.dtype, native.sm_count(x.device))
    every, weight, bias = every.contiguous(), weight.contiguous(), bias.contiguous()
    fn = native.load_library(_LIB).wiw_group_norm_apply
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    with native.device_of(x):
        err = fn(x.data_ptr(), every.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), R, N, L, C, G, float(eps), plan.threads, plan.tile,
                 int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16),
                 int(silu), native.raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"group_norm_apply launch failed: cudaError {err}")
    group_norm_apply.launches += 1
    return y


group_norm_apply.launches = 0


def copy_plus_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def copy_plus_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 in bf16: one read and one write of x (the card's copy ceiling).
    CPU tensors take `copy_plus_one_plain`; CUDA tensors launch the kernel
    (contiguous, 16-byte aligned bf16 with a multiple of 8 elements;
    anything else raises) and count one launch in `copy_plus_one.launches`."""
    if native.on_cpu(x):
        return copy_plus_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy_plus_one: unsupported device {x.device}")
    if (x.dtype != torch.bfloat16 or not x.is_contiguous() or x.numel() % 8
            or x.numel() == 0 or x.data_ptr() % 16):
        raise ValueError("copy_plus_one kernel takes contiguous, 16-byte aligned "
                         "bf16 with a multiple of 8 elements")
    fn = native.load_library(_LIB).wiw_copy_plus_one_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy_plus_one launch failed: cudaError {err}")
    copy_plus_one.launches += 1
    return y


copy_plus_one.launches = 0
