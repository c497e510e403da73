"""Explicit SPMD for the single-clip denoise (`generate(shard_clip=True)`).

Port of `wiw_tpu/parallel/clip_sharding.py`. Under shard_clip the latent's
rows (the height of every UNet level) are split over the mesh's 'fsdp'
axis and, on full CFG steps, the fold's two UNet rows over 'dp'. The
reference states the layout and GSPMD inserts the collectives; here each
one is explicit code, called by the layers that need it while a
`ClipSharding` is active (`activate`, around each UNet call):

  * spatial self-attention (`spatial_attention`): the Ulysses reshard
    (arXiv 2309.14509, DeepSpeed-Ulysses; the pattern, no code). q/k/v
    arrive sequence-sharded from the projections; the heads are padded with
    zeros up to a multiple of the 'fsdp' size (SVD's 5, 10 and 20 heads
    over fsdp 4 become 8, 12 and 20; a pad head sees zero logits over zero
    values and returns zeros); one all-to-all makes them head-sharded over
    the full sequence, kernel K1 runs on this rank's heads, a second
    all-to-all brings the output back to this rank's positions, and the
    pad heads are sliced off. `WIW_SHARD_ATTN=gather` takes the
    reference's other arm instead: K and V all-gathered over the sequence
    and K1 run on this rank's queries against them.
  * 3x3 convs (`halo`): one row from each neighbouring rank, zero rows at
    the level's edges and a zero column each side, then the conv with
    padding 0. A stride-2 conv (`downsample`) and nearest x2 + conv
    (`upsample`) do the same on their windows; their output is re-split
    to the level rule by one uneven all-to-all (`resplit`).
  * GroupNorm (`group_norm`): K8's statistics entry on this rank's
    positions (count, mean, M2 per (row, group)), one all-gather of the
    small [N, G, 3] tensor over 'fsdp', Chan's combination in rank order
    on every rank (K8's combine entry), then K8's apply entry.
  * int8 convs (`global_amax`): the activation scale of a W8A8 conv spans
    the whole call, as the reference's does, so this rank's amax(|x|) is
    all-reduced (MAX) over every rank that holds rows of the call (the
    'fsdp' group; the whole mesh when 'dp' splits the CFG rows) and the
    conv runs with that amax given.

The split rule (`split_rows`): a level of height H over n ranks gives the
first H mod n ranks ceil(H / n) rows and the others floor(H / n), in the
order of the ranks' 'fsdp' coordinates. A rank may hold no row of a level
(H < n): it skips the kernels there but joins every collective (count 0
statistics, amax 0, zero-sized all-to-all splits), since a rank that skips
a collective hangs its group.

`ClipSharding.height` and `.width` are the global size of the level now
flowing through the UNet (a rank without rows cannot see it); the pipeline
sets them at `activate` and the resamplers update them.
The frame-parallel decode activates a `ClipSharding` with `row_split`
False: rows whole, and only the int8 convs' amax reduced over the mesh.
The rank's place in the 'fsdp' group (`group`, `n`, `pos`, `peers`) is read
from the mesh once, when the context is made.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from wiw_tpu_torch.ops import group_norm as G
from wiw_tpu_torch.ops.flash_attention import flash_attention
from wiw_tpu_torch.ops.quant import conv_amax

AXIS = "fsdp"  # the mesh axis the rows are split over
ATTENTION_ARMS = ("ulysses", "gather")


def split_rows(height: int, n: int) -> list[range]:
    """The rows [start, stop) of a level of `height` that each of n ranks
    holds, by 'fsdp' coordinate: the first height mod n ranks take one row
    more."""
    base, extra = divmod(height, n)
    out, start = [], 0
    for p in range(n):
        stop = start + base + (p < extra)
        out.append(range(start, stop))
        start = stop
    return out


@dataclasses.dataclass
class ClipSharding:
    """The active shard_clip layout. `batch_axis` is 'dp' when the CFG
    fold's two rows are split over it; `row_split` False means rows whole
    (the frame-parallel decode); `height` is the global height of the level
    now running and `width` its width; `attention` is the spatial
    attention's arm. `group` is the process group of this rank's 'fsdp' row
    of the mesh, `n` its size, `pos` this rank's coordinate in it and
    `peers` the global rank at each coordinate."""

    mesh: object  # a torch DeviceMesh with axes ('dp', 'fsdp')
    batch_axis: Optional[str]
    row_split: bool = True
    height: int = 0
    width: int = 0
    attention: str = "ulysses"
    group: object = dataclasses.field(init=False)
    n: int = dataclasses.field(init=False)
    pos: int = dataclasses.field(init=False)
    peers: list[int] = dataclasses.field(init=False)

    def __post_init__(self):
        if self.attention not in ATTENTION_ARMS:
            raise ValueError(f"WIW_SHARD_ATTN {self.attention!r} not in {ATTENTION_ARMS}")
        self.group = self.mesh.get_group(AXIS)
        self.n = self.mesh[AXIS].size()
        self.pos = self.mesh.get_local_rank(AXIS)
        self.peers = [dist.get_global_rank(self.group, p) for p in range(self.n)]

    def splits(self, height: Optional[int] = None) -> list[range]:
        return split_rows(self.height if height is None else height, self.n)

    def rows(self, height: Optional[int] = None) -> range:
        """This rank's rows of a level (the current one by default)."""
        return self.splits(height)[self.pos]

    def amax_group(self):
        """The ranks that hold rows of one UNet (or decode) call: the
        'fsdp' group, or every rank (the mesh spans the world) when 'dp'
        splits the call's rows or the call is the frame-parallel decode."""
        if not self.row_split or self.batch_axis is not None:
            return None
        return self.group


_ctx: contextvars.ContextVar[Optional[ClipSharding]] = contextvars.ContextVar(
    "wiw_clip_sharding", default=None)


@contextlib.contextmanager
def activate(mesh, batch_axis: Optional[str], height: int = 0, width: int = 0,
             row_split: bool = True):
    """Make the layers run row-sharded (and the attention head-sharded)
    while a UNet call (or, with `row_split` False, a decode) runs. The
    attention arm is read from WIW_SHARD_ATTN here, at each activation."""
    cs = ClipSharding(mesh, batch_axis, row_split, height, width,
                      os.environ.get("WIW_SHARD_ATTN", "ulysses"))
    token = _ctx.set(cs)
    try:
        yield cs
    finally:
        _ctx.reset(token)


def current() -> Optional[ClipSharding]:
    """The active ClipSharding, or None (every path but shard_clip's)."""
    return _ctx.get()


def row_sharded() -> Optional[ClipSharding]:
    """The active ClipSharding when it splits rows, else None."""
    cs = _ctx.get()
    return cs if cs is not None and cs.row_split else None


# ------------------------------------------------------------ attention
def spatial_attention(cs: ClipSharding, q4: torch.Tensor, k4: torch.Tensor,
                      v4: torch.Tensor) -> torch.Tensor:
    """Head-sharded (or, with the gather arm, K/V-gathered) self-attention
    over [B, H, S_local, D] tensors whose positions are this rank's rows of
    the current level, row-major, with K1 on the whole sequences. Returns
    [B, H, S_local, D]."""
    sizes = [len(r) * cs.width for r in cs.splits()]
    if cs.attention == "gather":
        return _gather_attention(cs, q4, k4, v4, sizes)
    n, group = cs.n, cs.group
    B, H, S_l, D = q4.shape
    hs = -(-H // n)  # heads a rank after padding to n * hs
    S = sum(sizes)

    def to_heads(t):
        buf = t.new_zeros(B, S_l, n * hs, D)
        buf[:, :, :H] = t.transpose(1, 2)
        send = (buf.view(B, S_l, n, hs, D).permute(2, 1, 0, 3, 4).contiguous()
                .view(n * S_l, B, hs, D))
        recv = t.new_empty(S, B, hs, D)
        dist.all_to_all_single(recv, send, sizes, [S_l] * n, group=group)
        return recv.permute(1, 2, 0, 3)  # [B, hs, S, D], strided

    out = flash_attention(to_heads(q4), to_heads(k4), to_heads(v4))  # [B, hs, S, D]
    send = out.permute(2, 0, 1, 3).contiguous()  # [S, B, hs, D]
    recv = out.new_empty(n * S_l, B, hs, D)
    dist.all_to_all_single(recv, send, [S_l] * n, sizes, group=group)
    full = recv.view(n, S_l, B, hs, D).permute(2, 1, 0, 3, 4).reshape(B, S_l, n * hs, D)
    return full[:, :, :H].transpose(1, 2)


def _gather_attention(cs, q4, k4, v4, sizes):
    """The gather arm: K and V all-gathered over the sequence, K1 on this
    rank's queries."""
    k, v = (_all_gather(cs, t.permute(2, 0, 1, 3), sizes).permute(1, 2, 0, 3)
            for t in (k4, v4))  # [B, H, S, D], strided
    if q4.shape[2] == 0:
        return q4.new_empty(q4.shape)
    return flash_attention(q4, k, v)


def _all_gather(cs: ClipSharding, t: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """Every 'fsdp' rank's t along dim 0, of `sizes` rows each, in
    coordinate order (each padded to the largest, all-gathered, the pads
    dropped)."""
    big = max(sizes)
    buf = t.new_zeros(big, *t.shape[1:])
    buf[:t.shape[0]] = t
    parts = t.new_empty(cs.n * big, *t.shape[1:])
    dist.all_gather_into_tensor(parts, buf, group=cs.group)
    return torch.cat([parts[p * big:p * big + s] for p, s in enumerate(sizes)])


# ---------------------------------------------------------------- convs
def halo(cs: ClipSharding, x: torch.Tensor, pad_width: int = 1) -> torch.Tensor:
    """This rank's rows [a, b) of NHWC x with the rows a-1 and b from the
    neighbouring ranks (zeros at the level's edges) and `pad_width` zero
    columns each side: [N, b - a + 2, W + 2 * pad_width, C]. The neighbours
    are exchanged by point-to-point sends within the 'fsdp' group; a rank
    without rows sends and receives nothing."""
    N, h, W, C = x.shape
    out = x.new_zeros(N, h + 2, W + 2 * pad_width, C)
    out[:, 1:h + 1, pad_width:pad_width + W] = x
    if h == 0 or cs.n == 1:
        return out
    splits, p = cs.splits(), cs.pos
    ops, recvs = [], []
    for q, mine, theirs in ((p - 1, 0, 0), (p + 1, h - 1, h + 1)):
        if 0 <= q < cs.n and len(splits[q]):
            peer = cs.peers[q]
            buf = x.new_empty(N, 1, W, C)
            ops.append(dist.P2POp(dist.isend, x[:, mine:mine + 1].contiguous(), peer))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            recvs.append((theirs, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for row, buf in recvs:
        out[:, row:row + 1, pad_width:pad_width + W] = buf
    return out


def resplit(cs: ClipSharding, x: torch.Tensor, have: list[range],
            want: list[range]) -> torch.Tensor:
    """Move NHWC rows held as `have` (every rank's range, by 'fsdp'
    coordinate) to the split `want`, by one uneven all-to-all over the
    'fsdp' group (none where the two agree)."""
    if have == want:
        return x
    p = cs.pos

    def overlap(a: range, b: range) -> int:
        return max(0, min(a.stop, b.stop) - max(a.start, b.start))

    send = [overlap(have[p], w) for w in want]
    recv = [overlap(h, want[p]) for h in have]
    N, _, W, C = x.shape
    out = x.new_empty(sum(recv), N, W, C)
    dist.all_to_all_single(out, x.transpose(0, 1).contiguous(), recv, send, group=cs.group)
    return out.transpose(0, 1).contiguous()


def downsample(cs: ClipSharding, x: torch.Tensor,
               conv_valid: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A stride-2 3x3 conv (SAME) of this rank's rows: output row i reads
    input rows 2i-1..2i+1, so this rank computes the outputs whose centre
    row it holds, from its halo'd rows, then re-splits them to the rule of
    the output level (whose height the context then takes)."""
    H, r = cs.height, cs.rows()
    e = halo(cs, x)
    i0, i1 = -(-r.start // 2), -(-r.stop // 2)
    out = conv_valid(e[:, 2 * i0 - r.start:2 * i1 - r.start + 1])
    have = [range(-(-s.start // 2), -(-s.stop // 2)) for s in cs.splits()]
    cs.height, cs.width = -(-H // 2), -(-cs.width // 2)
    return resplit(cs, out, have, cs.splits())


def upsample(cs: ClipSharding, x: torch.Tensor,
             conv_valid: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Nearest x2 then a 3x3 conv (SAME) of this rank's rows: the halo rows
    of the input become the upsampled rows just outside 2a..2b-1; the
    output is re-split to the rule of the level of twice the height."""
    e = halo(cs, x, pad_width=0)
    u = e.repeat_interleave(2, dim=1)[:, 1:-1].repeat_interleave(2, dim=2)
    out = conv_valid(F.pad(u, (0, 0, 1, 1)))
    have = [range(2 * s.start, 2 * s.stop) for s in cs.splits()]
    cs.height, cs.width = 2 * cs.height, 2 * cs.width
    return resplit(cs, out, have, cs.splits())


def global_amax(cs: ClipSharding, x: torch.Tensor) -> torch.Tensor:
    """amax(|x|) of the whole call: this rank's (K7's amax entry; 0 without
    rows) all-reduced with MAX over `cs.amax_group()`. fp32, one element."""
    amax = conv_amax(x)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=cs.amax_group())
    return amax


# ------------------------------------------------------------ GroupNorm
def group_norm(cs: ClipSharding, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, groups: int, eps: float,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) of x [N, ..., C] whose positions are split over
    the 'fsdp' group: K8's statistics of this rank's positions, one
    all-gather, Chan's combination (K8's combine entry), K8's apply. The
    parameters are cast to fp32 first, so that nothing but the combination
    runs between the all-gather and the apply."""
    weight, bias = weight.float(), bias.float()
    stats = G.group_norm_stats(x, groups)  # [N, G, 3] float64
    every = stats.new_empty(cs.n * stats.shape[0], *stats.shape[1:])
    dist.all_gather_into_tensor(every, stats.contiguous(), group=cs.group)
    mean, rstd = G.combine_stats(every.view(cs.n, *stats.shape), eps)
    if x.numel() == 0:
        return x
    return G.group_norm_apply(x, mean, rstd, weight, bias, silu)


# ------------------------------------------------------------ latent rows
def gather_level(cs: ClipSharding, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole level from every 'fsdp' rank's rows of x along `dim`."""
    sizes = [len(r) for r in cs.splits()]
    return _all_gather(cs, x.movedim(dim, 0), sizes).movedim(0, dim).contiguous()
