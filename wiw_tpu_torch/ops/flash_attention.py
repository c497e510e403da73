"""Kernels K1 (flash-attention forward), K2 (the reference's v1 forward)
and K3 (K1's backward), with their plain PyTorch versions and the autograd
Function that joins K1 and K3.

K1 replaces the TPU kernel `_attn_kernel_v2` (wiw_tpu/ops/pallas_attention.py,
called through `flash_attention_bhsd(kernel="v2")`); its CUDA source is
`wiw_tpu_torch/csrc/flash_attn_fwd.cu`. K3 replaces the backward of the
stock Pallas TPU flash attention that the reference's custom VJP calls
(`_flash_attention_fn` in wiw_tpu/ops/attention.py); its CUDA source is
`wiw_tpu_torch/csrc/flash_attn_bwd.cu`. Both run on wgmma, fed by TMA
through an mbarrier ring (helpers in `csrc/sm90.cuh`); each header says
what bounds the kernel on the H100 and how the design answers that. K3 sums
dQ over kv tiles by reductions in L2 (TMA reduce-add), in the order the
CTAs reach them, so dq's last bits change from run to run.
K2 replaces the TPU kernels `_attn_kernel` and `_attn_kernel_unroll2`
(`flash_attention_bhsd(kernel="v1", unroll2=...)`): both run K1's kernel.
v1 is K1's function; unroll2's pair of kv blocks under one running max is
one 128-row stage of K1, so the two differ only in the order of the fp32
sums, and on the card unroll2's output is v1's, bit for bit.
`flash_attention(kernel="v1")` reaches both through `flash_attention_v1`.
No model caller uses K2, as none uses v1 in the reference.

K9, the reference's attention ablations (`_kern_floor`, `_kern_noexp`,
`_kern_v2` in scripts/tune_attention2.py), all run K1's kernel:
`attention_floor` (no softmax: sum of bf16(q k^T) v) and `attention_noexp`
(K1's loop with exp replaced by the identity, out = acc / (denominator + 1))
as its template modes, which change only the step between its two
products, and `attention_v2` (K1's function with q pre-scaled by the
caller) as K1 itself with a unit scale. Their plain versions take the kv
block width `bkv`, because noexp's (and v2's bf16 P's) values depend on the
running max at each block; the kernel's is KV_TILE, a stage of K1's ring
(the reference's probe runs at 512). floor and noexp take Skv a multiple of
KV_TILE. No model caller, as in the reference.

`flash_attention(q, k, v)` takes [B, H, S, D] tensors (any strides with a
unit stride on D, e.g. head views of [B, S, H*D] projections), D = 64; K1
also has an instance for D = 72 (the CDiT's heads, 1152 / 16), a serving
forward with no LSE and no backward, so there it takes no gradient. On CPU
tensors it computes the plain versions; on CUDA tensors it launches the
kernels or raises: there is no fallback.
- Under `no_grad`/`inference_mode`, or when no input needs a gradient
  (serving), it runs K1 alone: no LSE is written and nothing is saved.
- Otherwise it goes through `FlashAttention`, an autograd Function: the
  forward runs K1 with its LSE output (`flash_attention_lse_plain` on the
  CPU) and saves q, k, v, the output and the LSE; the backward runs K3
  (`flash_attention_bwd_plain` on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from wiw_tpu_torch.ops import native

HEAD_DIM = 64  # the head width of every kernel here (K1 also takes D72_HEAD_DIM)
D72_HEAD_DIM = 72  # K1's second instance: the CDiT's heads (1152 / 16), serving only
KV_TILE = 128  # k/v rows a stage of K1's kernel (K1, K2, K9): two of the
# reference's unroll2 blocks of 64
Q_TILE = 64  # q rows a stage of K3
GRID_Y = 65535  # the forward kernel's grid puts B*H on y, which takes at most this
KERNELS = ("v2", "v1")
_LIB = "flash_attn_fwd"
_BWD_LIB = "flash_attn_bwd"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Reference attention: QK^T in fp32, softmax, weights cast to v's
    dtype, then PV ([B, H, S, D] -> [B, H, Sq, D])."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def flash_attention_v1_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """K2's arithmetic, the reference's v1 kernels (`_attn_kernel`, and
    `_attn_kernel_unroll2`, which differs only in the order of its fp32
    sums): logits in fp32 scaled in fp32, P = exp(logits - row max)
    rounded to v's dtype for the PV product, the denominator the fp32 sum of
    the unrounded P, out = (P v) / denominator rounded once. The kernels
    take the max block by block and rescale; this takes it once per row,
    which moves only where P's rounding falls."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp K1 writes with its LSE flag: fp32 [B, H, Sq],
    logsumexp_j(q . k_j / sqrt(D))."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout):
    """K3's arithmetic in plain PyTorch, all in fp32: P = exp(scale q k^T -
    LSE), dV = P^T dO (P rounded to v's dtype, where the forward rounds the
    weights), dP = dO v^T, dS = P o (dP - rowsum(dO o O)), dQ = scale dS k,
    dK = scale dS^T q. Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                  - lse.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _takes(t: torch.Tensor) -> bool:
    """Whether the kernels read `t` in place: unit stride on D, the other
    strides multiples of 8 elements, 16-byte aligned."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dims: tuple = (HEAD_DIM,)) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, {name} is {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if t.shape[-1] not in dims:
            raise ValueError(
                f"flash_attention kernel is built for head_dim in {dims}, "
                f"{name} has {t.shape[-1]}")
        if not _takes(t):
            raise ValueError(
                f"{name} strides {t.stride()} not taken: D must be unit-stride, "
                "the other strides multiples of 8 elements, 16-byte aligned")
    B, H, Sq, _ = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    if H > GRID_Y:
        raise ValueError(f"H = {H} exceeds the kernel's grid limit {GRID_Y}")


def _bind(lib: ctypes.CDLL, D: int = HEAD_DIM):
    fn = getattr(lib, f"wiw_flash_attn_fwd_d{D}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.wiw_flash_attn_bwd_d64
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# the forward kernel's modes (csrc/flash_attn_fwd.cu)
_SOFTMAX, _FLOOR, _NOEXP = 0, 1, 2


def batch_splits(B: int, H: int) -> list[tuple[int, int]]:
    """The batch ranges [b0, b1) of the forward kernel's launches over a
    [B, H, S, D] call: one launch unless B*H exceeds GRID_Y (the temporal
    cross-attention's fold of positions into the batch gives 2 x 9216 x 5 =
    92160 at level 0 of a full-width request), else as few as keep each
    launch's (b1 - b0) * H within it."""
    per = max(1, GRID_Y // H)
    return [(b, min(b + per, B)) for b in range(0, B, per)]


def _launch_fwd(q, k, v, with_lse: bool, mode: int = _SOFTMAX,
                sm_scale: float | None = None):
    """The forward kernel on CUDA tensors: (out, lse or None, launches),
    one launch a range of `batch_splits`; `mode` K1's softmax or a K9
    ablation; `sm_scale` D^-0.5 unless given. D is 64, or 72 for K1's
    softmax without LSE (the D = 72 instance has no LSE and no backward)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, (HEAD_DIM, D72_HEAD_DIM)
           if mode == _SOFTMAX and not with_lse else (HEAD_DIM,))
    B, H, Sq, D = q.shape
    fn = _bind(native.load_library(_LIB), D)
    # [B, H, Sq, D] view of a contiguous [B, Sq, H, D]: merging heads is free
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    splits = batch_splits(B, H)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for b0, b1 in splits:  # slices of the batch: the same strides
            part = [t[b0:b1] for t in (q, k, v, out)]
            err = fn(*(t.data_ptr() for t in part),
                     None if lse is None else lse[b0:b1].data_ptr(), b1 - b0, H,
                     Sq, k.shape[2], *(s for t in part for s in t.stride()[:3]),
                     D ** -0.5 if sm_scale is None else sm_scale, mode, stream)
            if err != 0:
                raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    return out, lse, len(splits)


def _forward(q, k, v, with_lse: bool):
    """(out, lse or None): the plain versions on CPU tensors, K1 on CUDA
    tensors (counted in `flash_attention.launches`, or at D = 72 in
    `flash_attention.launches_d72`)."""
    if native.on_cpu(q, k, v):
        out = flash_attention_plain(q, k, v)
        return out, flash_attention_lse_plain(q, k) if with_lse else None
    out, lse, n = _launch_fwd(q, k, v, with_lse)
    if q.shape[-1] == D72_HEAD_DIM:
        flash_attention.launches_d72 += n
    else:
        flash_attention.launches += n
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout):
    """(dq, dk, dv) of attention, from the forward's inputs, output and LSE.
    CPU tensors take `flash_attention_bwd_plain`. CUDA tensors launch K3
    (bf16, D = 64, the layouts K1 takes; a dO the kernel cannot read in
    place is made contiguous first; anything else raises) and count one
    launch in `flash_attention_bwd.launches`. dq, dk and dv are [B, H, S, D]
    views of contiguous [B, S, H, D] tensors, as K1 writes its output."""
    if native.on_cpu(q, k, v, out, lse, dout):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if not _takes(dout):
        dout = dout.contiguous()
    _check(q, k, v)
    _check(out, dout, dout)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(dout.shape)} "
                         f"must be shaped like q {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be K1's contiguous fp32 [B, H, Sq] output")
    fn = _bind_bwd(native.load_library(_BWD_LIB))

    def grad_like(S):
        return torch.empty(B, S, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(Sq), grad_like(Skv), grad_like(Skv)
    # the kernel's scratch: L * log2(e) and Delta per q row, and dQ's fp32
    # sum over kv tiles (reduce-adds into zeros), Sq padded to Q_TILE rows;
    # the kernel refuses a padding other than its own q tile's
    sq_pad = -(-Sq // Q_TILE) * Q_TILE
    rows = torch.empty(2, B * H, sq_pad, dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros(B * H, sq_pad, D, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, out, dout, dq, dk, dv)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                 dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, H, Sq, Skv, sq_pad, ctypes.cast(strides, ctypes.c_void_p),
                 D ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 with its LSE forward, K3 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return flash_attention_bwd(*ctx.saved_tensors, dout)


def flash_attention_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       unroll2: bool = False) -> torch.Tensor:
    """K2, the reference's v1 forward, over [B, H, S, D] tensors. CPU tensors
    take `flash_attention_v1_plain`. CUDA tensors launch K1's kernel (what
    K1 takes; no gradient, as the reference's v1 has none: an input that
    needs one raises) in every case, and count its launches (one a range
    of `batch_splits`) in `flash_attention_v1.launches`, or, with `unroll2` and Skv a multiple of
    128 (the reference's Skv % (2 * bkv): where it takes its pair loop), in
    `flash_attention_v1.launches_unroll2`."""
    if native.on_cpu(q, k, v):
        return flash_attention_v1_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention(kernel='v1') has no gradient; use kernel='v2'")
    pair = unroll2 and k.shape[2] % KV_TILE == 0
    out, _, n = _launch_fwd(q, k, v, with_lse=False)
    if pair:
        flash_attention_v1.launches_unroll2 += n
    else:
        flash_attention_v1.launches += n
    return out


flash_attention_v1.launches = 0
flash_attention_v1.launches_unroll2 = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernel: str = "v2", unroll2: bool = False) -> torch.Tensor:
    """Non-causal softmax(q k^T / sqrt(D)) v over [B, H, S, D] tensors;
    `kernel` and `unroll2` as the reference's `flash_attention_bhsd`
    ("v1" takes `flash_attention_v1`, K2; unroll2 with "v2" raises, as
    there).

    With "v2", CPU tensors take the plain versions. CUDA tensors launch K1
    (bf16, D = 64, or D = 72 where no gradient is wanted: the CDiT's heads;
    anything else raises) once a range of `batch_splits`
    (once, unless B*H exceeds GRID_Y) and count each launch in
    `flash_attention.launches` (D = 64) or `flash_attention.launches_d72`;
    with gradients wanted, the backward launches K3. The output is a
    [B, H, Sq, D] view of a contiguous [B, Sq, H, D] tensor, so merging
    heads back is free.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    if kernel == "v1":
        return flash_attention_v1(q, k, v, unroll2)
    if unroll2:
        raise ValueError("unroll2 only applies to kernel='v1' (the v2 kernel "
                         "has no unrolled variant)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.launches_d72 = 0


# ---------------------------------------------------------------- K9
NEG_INIT = -1e30  # the ablations' initial running max (tune_attention2.py)


def _blocks(k, v, bkv):
    Skv = k.shape[-2]
    if Skv % bkv:
        raise ValueError(f"Skv {Skv} not a multiple of the block width {bkv}")
    return ((k[..., i:i + bkv, :].float(), v[..., i:i + bkv, :])
            for i in range(0, Skv, bkv))


def attention_floor_plain(q, k, v, bkv: int = KV_TILE):
    """`_kern_floor`'s arithmetic: acc += bf16(q k^T) v block by block (the
    logits unscaled and in fp32, rounded to v's dtype for the product)."""
    qf = q.float()
    acc = torch.zeros(*q.shape[:-1], v.shape[-1], dtype=torch.float32,
                      device=q.device)
    for kb, vb in _blocks(k, v, bkv):
        s = torch.einsum("...qd,...kd->...qk", qf, kb)
        acc = acc + torch.einsum("...qk,...kd->...qd", s.to(v.dtype).float(),
                                 vb.float())
    return acc.to(q.dtype)


def attention_noexp_plain(q, k, v, bkv: int = KV_TILE,
                          with_denominator: bool = False,
                          dtype: torch.dtype = torch.float32):
    """`_kern_noexp`'s arithmetic: the running max m from -1e30, P = S - m
    (the identity for exp) on unscaled fp32 logits, acc and the
    denominator scaled by (m_old - m_new); out = acc / (denominator + 1).
    `with_denominator`: (out, denominator + 1), the latter [..., Sq, 1]
    (out has a pole where it nears 0). `dtype`: the logits' and sums' type,
    the reference's fp32; float64 gives the same arithmetic (P still
    rounded to v's dtype for the product) with near-exact sums, which the
    card's check holds the kernel to: rows with |denominator + 1| of a few
    units, where thousands cancel, are off by up to ~1% in fp32 on either
    side."""
    qf = q.to(dtype)
    shape = q.shape[:-1]
    acc = torch.zeros(*shape, v.shape[-1], dtype=dtype, device=q.device)
    m = torch.full((*shape, 1), NEG_INIT, dtype=dtype, device=q.device)
    denom = torch.zeros_like(m)
    for kb, vb in _blocks(k, v, bkv):
        s = torch.einsum("...qd,...kd->...qk", qf, kb.to(dtype))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = s - m_new
        scale = m - m_new
        acc = acc * scale + torch.einsum("...qk,...kd->...qd",
                                         p.to(v.dtype).to(dtype), vb.to(dtype))
        denom = denom * scale + p.sum(dim=-1, keepdim=True)
        m = m_new
    out = (acc / (denom + 1.0)).to(q.dtype)
    return (out, denom + 1.0) if with_denominator else out


def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """`v2`'s caller-side pre-scale: q * D^-0.5 in fp32, rounded to q's
    dtype (as `_attn_kernel_v2` rounds it in-kernel)."""
    return (q.float() * q.shape[-1] ** -0.5).to(q.dtype)


def attention_v2_plain(q, k, v, bkv: int = KV_TILE):
    """`_kern_v2`'s arithmetic with its caller's pre-scale: S = q_s k^T in
    fp32, P = exp(S - m) rounded to v's dtype, the denominator the sum of
    that rounded P (the ones column appended to V), out = acc / acc[D]."""
    qs = prescale_q(q).float()
    D = v.shape[-1]
    ones = torch.ones(*v.shape[:-1], 1, dtype=v.dtype, device=v.device)
    vp = torch.cat([v, ones], dim=-1)
    shape = q.shape[:-1]
    acc = torch.zeros(*shape, D + 1, dtype=torch.float32, device=q.device)
    m = torch.full((*shape, 1), NEG_INIT, dtype=torch.float32, device=q.device)
    for kb, vb in _blocks(k, vp, bkv):
        s = torch.einsum("...qd,...kd->...qk", qs, kb)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        scale = torch.exp(m - m_new)
        acc = acc * scale + torch.einsum("...qk,...kd->...qd",
                                         p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / acc[..., D:D + 1]).to(q.dtype)[..., :D]


def _ablation(q, k, v, mode):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the K9 ablations have no gradient")
    if k.shape[2] % KV_TILE:
        raise ValueError(f"K9 takes Skv a multiple of {KV_TILE}, got {k.shape[2]}")
    out, _, n = _launch_fwd(q, k, v, with_lse=False, mode=mode)
    return out, n


def attention_floor(q, k, v):
    """K9 floor over [B, H, S, D] (what K1 takes, Skv a multiple of
    KV_TILE, no gradient). CPU tensors take `attention_floor_plain`; CUDA
    tensors launch K1's kernel in its floor mode (`attention_floor.launches`)
    or raise."""
    if native.on_cpu(q, k, v):
        return attention_floor_plain(q, k, v)
    out, n = _ablation(q, k, v, _FLOOR)
    attention_floor.launches += n
    return out


def attention_noexp(q, k, v):
    """K9 noexp over [B, H, S, D], as `attention_floor` takes them; counted
    in `attention_noexp.launches`."""
    if native.on_cpu(q, k, v):
        return attention_noexp_plain(q, k, v)
    out, n = _ablation(q, k, v, _NOEXP)
    attention_noexp.launches += n
    return out


def attention_v2(q, k, v):
    """K9 v2 over [B, H, S, D]: softmax(prescale_q(q) k^T) v, K1's kernel
    with a unit scale on the pre-scaled q (what K1 takes; no gradient);
    counted in `attention_v2.launches`."""
    if native.on_cpu(q, k, v):
        return attention_v2_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the K9 ablations have no gradient")
    out, _, n = _launch_fwd(prescale_q(q), k, v, with_lse=False, sm_scale=1.0)
    attention_v2.launches += n
    return out


attention_floor.launches = 0
attention_noexp.launches = 0
attention_v2.launches = 0
