"""Kernel K1: flash-attention forward, and its plain PyTorch version.

Replaces the TPU kernel `_attn_kernel_v2` (wiw_tpu/ops/pallas_attention.py,
called through `flash_attention_bhsd(kernel="v2")`). The CUDA source is
`wiw_tpu_torch/csrc/flash_attn_fwd.cu`; its header says what bounds it on
the H100 and how the design answers that.

`flash_attention(q, k, v)` takes [B, H, S, D] tensors (any strides with a
unit stride on D, e.g. head views of [B, S, H*D] projections). On CPU
tensors it computes `flash_attention_plain`; on CUDA tensors it launches the
kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from wiw_tpu_torch.ops import native

HEAD_DIM = 64  # the kernel's template constant
_LIB = "flash_attn_fwd"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Reference attention: QK^T in fp32, softmax, weights cast to v's
    dtype, then PV ([B, H, S, D] -> [B, H, Sq, D])."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


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
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name} strides {t.stride()} not taken: D must be unit-stride "
                "and the other strides multiples of 8 elements")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal softmax(q k^T / sqrt(D)) v over [B, H, S, D] tensors.

    CPU tensors take the plain version. CUDA tensors launch K1 (bf16,
    D = 64; anything else raises) and count one launch in
    `flash_attention.launches`. The output is a [B, H, Sq, D] view of a
    contiguous [B, Sq, H, D] tensor, so merging heads back is free.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    fn = _bind(native.load_library(_LIB))
    B, H, Sq, D = q.shape
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Sq, k.shape[2],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
