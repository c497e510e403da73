"""Temporal self-attention over frames on [B, F, S, H*D].

Port of `wiw_tpu/ops/temporal_attention.py`: three formulations of the
same function and the dispatcher that picks one.

- `temporal_self_attention_batched`: (batch, position, head) fold into one
  batch axis and the F x F attention runs as batched matmuls; softmax
  weights rounded to v's dtype. The default.
- `temporal_self_attention_xla`: the reference's einsum oracle.
- kernel K4, `frame_attention` (plain version `frame_attention_plain`):
  replaces the TPU kernel `_kernel` (reached from
  `temporal_self_attention_pallas`). fp32 logits and fp32 softmax weights
  that are NOT rounded before the weighted sum; the output is rounded once.
  The CUDA source is `wiw_tpu_torch/csrc/temporal_attn.cu`; its header says
  what bounds it on the H100 and how the design answers that.
"""

from __future__ import annotations

import ctypes

import torch

from wiw_tpu_torch.ops import native

MODES = ("batched", "xla", "pallas")
HEAD_DIM = 64    # the kernel's head dim
MAX_FRAMES = 16  # the kernel keeps every frame's k and v in registers
_LIB = "temporal_attn"


def temporal_self_attention_batched(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, heads: int) -> torch.Tensor:
    """q, k, v: [B, F, S, H*D] -> [B, F, S, H*D]; attention over F for each
    (position, head). Logits and softmax in fp32, weights cast to v's dtype."""
    B, F, S, HD = q.shape
    D = HD // heads

    def fold(x):
        return (x.reshape(B, F, S, heads, D).permute(0, 2, 3, 1, 4)
                .reshape(B * S * heads, F, D))

    qf, kf, vf = fold(q), fold(k), fold(v)
    logits = torch.bmm(qf.float(), kf.float().transpose(1, 2))  # [N, F, G]
    w = torch.softmax(logits * D ** -0.5, dim=-1).to(v.dtype)
    out = torch.bmm(w, vf)
    return (out.reshape(B, S, heads, F, D).permute(0, 3, 1, 2, 4)
            .reshape(B, F, S, HD))


def temporal_self_attention_xla(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int) -> torch.Tensor:
    """The reference's einsum oracle: fp32 [B, S, H, F, G] logits, weights
    cast to v's dtype before the weighted sum."""
    B, F, S, HD = q.shape
    D = HD // heads
    qh, kh, vh = (t.reshape(B, F, S, heads, D) for t in (q, k, v))
    logits = torch.einsum("bfshd,bgshd->bshfg", qh.float(), kh.float())
    w = torch.softmax(logits * D ** -0.5, dim=-1)
    out = torch.einsum("bshfg,bgshd->bfshd", w.to(v.dtype), vh)
    return out.reshape(B, F, S, HD)


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch: q scaled in fp32, fp32 logits and
    softmax, fp32 weighted sum of v, output rounded once to q's dtype."""
    B, F, S, HD = q.shape
    D = HD // heads
    qh, kh, vh = (t.float().reshape(B, F, S, heads, D) for t in (q, k, v))
    logits = torch.einsum("bfshd,bgshd->bshfg", qh * D ** -0.5, kh)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshfg,bgshd->bfshd", w, vh)
    return out.reshape(B, F, S, HD).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"frame_attention kernel takes bf16, {name} is {t.dtype}")
        if t.shape != q.shape or t.ndim != 4:
            raise ValueError(f"{name} must be [B, F, S, H*D] like q, got "
                             f"{tuple(t.shape)} vs {tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"frame_attention kernel takes contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    B, F, S, HD = q.shape
    if HD != heads * HEAD_DIM:
        raise ValueError(f"frame_attention kernel is built for head_dim "
                         f"{HEAD_DIM}; got H*D = {HD} with {heads} heads")
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"frame_attention kernel takes 1..{MAX_FRAMES} frames, got {F}")
    if B * S == 0:
        raise ValueError("empty input")


def _bind(lib: ctypes.CDLL):
    fn = lib.wiw_temporal_attn_d64
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Attention over the F frames of [B, F, S, H*D] for each (position,
    head). CPU tensors take `frame_attention_plain`. CUDA tensors launch K4
    (bf16, contiguous, head_dim 64, F <= 16; anything else raises) and
    count one launch in `frame_attention.launches`. K4 has no gradient, as
    the reference's bare `pallas_call` has none: off the CPU, asking for
    one raises NotImplementedError (train with the batched or xla form)."""
    if native.on_cpu(q, k, v):
        return frame_attention_plain(q, k, v, heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "frame attention kernel K4 has no gradient (the reference's "
            "pallas_call defines none): train with temporal_attention "
            "'batched' or 'xla'")
    if q.device.type != "cuda":
        raise ValueError(f"frame_attention: unsupported device {q.device}")
    _check(q, k, v, heads)
    fn = _bind(native.load_library(_LIB))
    B, F, S, HD = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, F, S, heads, HEAD_DIM ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"temporal_attn launch failed: cudaError {err}")
    frame_attention.launches += 1
    return out


frame_attention.launches = 0


def temporal_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int, mode: str = "batched") -> torch.Tensor:
    """[B, F, S, H*D] frame attention in the formulation `mode` selects, by
    the reference's rule: 'pallas' takes K4 when S % 64 == 0 and the
    batched form otherwise; 'xla' the einsum oracle; 'batched' the batched
    form."""
    if mode not in MODES:
        raise ValueError(f"temporal attention mode {mode!r} not in {MODES}")
    if mode == "pallas" and q.shape[2] % 64 == 0:
        return frame_attention(q, k, v, heads)
    if mode == "xla":
        return temporal_self_attention_xla(q, k, v, heads)
    return temporal_self_attention_batched(q, k, v, heads)
