"""Kernels K1 (flash-attention forward), K2 (the reference's v1 forward)
and K3 (K1's backward), with their plain PyTorch versions and the autograd
Function that joins K1 and K3.

K1 replaces the TPU kernel `_attn_kernel_v2` (wiw_tpu/ops/pallas_attention.py,
called through `flash_attention_bhsd(kernel="v2")`); its CUDA source is
`wiw_tpu_torch/csrc/flash_attn_fwd.cu`. K3 replaces the backward of the
stock Pallas TPU flash attention that the reference's custom VJP calls
(`_flash_attention_fn` in wiw_tpu/ops/attention.py); its CUDA source is
`wiw_tpu_torch/csrc/flash_attn_bwd.cu`. Each header says what bounds the
kernel on the H100 and how the design answers that. K2 replaces the TPU
kernels `_attn_kernel` and `_attn_kernel_unroll2` (`flash_attention_bhsd(
kernel="v1", unroll2=...)`): the same source as K1, whose arithmetic is
already v1's, with `unroll2` a template parameter (two k/v tiles an
iteration, one running max over both); `flash_attention(kernel="v1")`
reaches it through `flash_attention_v1`. No model caller uses K2, as none
uses v1 in the reference.

`flash_attention(q, k, v)` takes [B, H, S, D] tensors (any strides with a
unit stride on D, e.g. head views of [B, S, H*D] projections). On CPU
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

HEAD_DIM = 64  # the kernels' template constant
KV_TILE = 64  # k/v rows a kernel tile; unroll2 takes two an iteration
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
    `_attn_kernel_unroll2`, which differs only in the order it takes the k/v
    blocks): logits in fp32 scaled in fp32, P = exp(logits - row max)
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, {name} is {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if t.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"flash_attention kernel is built for head_dim {HEAD_DIM}, "
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
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")


def _bind(lib: ctypes.CDLL):
    fn = lib.wiw_flash_attn_fwd_d64
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.wiw_flash_attn_bwd_d64
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, with_lse: bool, tiles: int):
    """The forward kernel on CUDA tensors: (out, lse or None); `tiles` k/v
    tiles an iteration (2: unroll2)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    fn = _bind(native.load_library(_LIB))
    B, H, Sq, D = q.shape
    # [B, H, Sq, D] view of a contiguous [B, Sq, H, D]: merging heads is free
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, H, Sq, k.shape[2],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], D ** -0.5, tiles, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    return out, lse


def _forward(q, k, v, with_lse: bool):
    """(out, lse or None): the plain versions on CPU tensors, K1 on CUDA
    tensors (counted in `flash_attention.launches`)."""
    if native.on_cpu(q, k, v):
        out = flash_attention_plain(q, k, v)
        return out, flash_attention_lse_plain(q, k) if with_lse else None
    out, lse = _launch_fwd(q, k, v, with_lse, tiles=1)
    flash_attention.launches += 1
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
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, out, dout, dq, dk, dv)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, H, Sq, Skv,
                 ctypes.cast(strides, ctypes.c_void_p), D ** -0.5, stream)
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
    take `flash_attention_v1_plain`. CUDA tensors launch K2 (what K1 takes;
    no gradient, as the reference's v1 has none: an input that needs one
    raises) and count one launch in `flash_attention_v1.launches`, or, with
    `unroll2` and Skv a multiple of 128 (the reference's Skv % (2 * bkv)),
    the two-tile loop in `flash_attention_v1.launches_unroll2`; with
    `unroll2` and another Skv, the one-tile loop, as the reference does."""
    if native.on_cpu(q, k, v):
        return flash_attention_v1_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention(kernel='v1') has no gradient; use kernel='v2'")
    pair = unroll2 and k.shape[2] % (2 * KV_TILE) == 0
    out = _launch_fwd(q, k, v, with_lse=False, tiles=2 if pair else 1)[0]
    if pair:
        flash_attention_v1.launches_unroll2 += 1
    else:
        flash_attention_v1.launches += 1
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
    (bf16, D = 64; anything else raises) and count one launch in
    `flash_attention.launches`; with gradients wanted, the backward
    launches K3. The output is a [B, H, Sq, D] view of a contiguous
    [B, Sq, H, D] tensor, so merging heads back is free.
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
