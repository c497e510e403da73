"""Kernel K10: attention with an int8 q k^T, and its plain version.

K10 replaces the TPU kernel `_kernel_i8qk` of
scripts/probe_int8_attention.py (the reference's probe of SageAttention-style
int8 attention, a clone of its v2 flash kernel); its CUDA source is
`wiw_tpu_torch/csrc/flash_attn_i8.cu`, whose header says what bounds it on
the H100 and how the design answers that. No model caller, as in the
reference.

`int8_qk_attention(q8, k8, v, qk_scale, i8pv)` takes the reference's
layouts: q8, k8 int8 [B*H, S, 64] (quantised by the caller); v [B*H, S, 65]
with the ones column at index 64 (bf16, or int8 with `i8pv`); it returns
bf16 [B*H, S, 65] = acc / acc[:, 64]. CPU tensors take
`int8_qk_attention_plain`; CUDA tensors launch K10 or raise.
"""

from __future__ import annotations

import ctypes

import torch

from wiw_tpu_torch.ops import native

HEAD_DIM = 64
KV_TILE = 64  # the kernel's kv block width
NEG_INIT = -1e30
_LIB = "flash_attn_i8"


def int8_qk_attention_plain(q8, k8, v, qk_scale: float, i8pv: bool = False,
                            bkv: int = KV_TILE):
    """`_kernel_i8qk`'s arithmetic block by block (the int32 sums are exact
    in fp32: |q8 . k8| <= 64 * 127^2 and |p8 . v8| <= 64 * 127^2 per block
    of 64, both below 2^24): S = (q8 k8^T) * qk_scale; m from -1e30;
    P = exp(S - m_new); acc = acc * exp(m - m_new) + PV, where PV is
    bf16(P) v in fp32, or with `i8pv` p8 = trunc(P * 127 + 0.5) against
    int8 v, times 1/127; out = acc / acc[:, 64] in bf16."""
    BH, S, D = q8.shape
    if S % bkv:
        raise ValueError(f"S {S} not a multiple of the block width {bkv}")
    qf = q8.float()
    acc = torch.zeros(BH, S, v.shape[-1], dtype=torch.float32, device=q8.device)
    m = torch.full((BH, S, 1), NEG_INIT, dtype=torch.float32, device=q8.device)
    for i in range(0, k8.shape[1], bkv):
        kb, vb = k8[:, i:i + bkv].float(), v[:, i:i + bkv]
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * qk_scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        scale = torch.exp(m - m_new)
        if i8pv:
            p8 = torch.trunc(p * 127.0 + 0.5)
            pv = torch.einsum("bqk,bkd->bqd", p8, vb.float()) * (1.0 / 127.0)
        else:
            pv = torch.einsum("bqk,bkd->bqd", p.to(vb.dtype).float(), vb.float())
        acc = acc * scale + pv
        m = m_new
    return (acc / acc[..., D:D + 1]).to(torch.bfloat16)


def _bind(lib: ctypes.CDLL):
    fn = lib.wiw_flash_attn_i8qk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def int8_qk_attention(q8, k8, v, qk_scale: float, i8pv: bool = False):
    """K10 over the reference's layouts (module docstring). CUDA tensors:
    contiguous int8 q8, k8 [BH, S, 64], contiguous v [BH, S, 65] (bf16, or
    int8 with `i8pv`), S a multiple of 64; anything else raises. Counts one
    launch in `int8_qk_attention.launches` (bf16 PV) or
    `int8_qk_attention.launches_i8pv`."""
    if native.on_cpu(q8, k8, v):
        return int8_qk_attention_plain(q8, k8, v, qk_scale, i8pv)
    if q8.device.type != "cuda":
        raise ValueError(f"int8_qk_attention: unsupported device {q8.device}")
    BH, S, D = q8.shape
    want_v = torch.int8 if i8pv else torch.bfloat16
    for name, t, dt, shape in (("q8", q8, torch.int8, (BH, S, HEAD_DIM)),
                               ("k8", k8, torch.int8, (BH, S, HEAD_DIM)),
                               ("v", v, want_v, (BH, S, HEAD_DIM + 1))):
        if t.device != q8.device:
            raise ValueError(f"{name} on {t.device}, q8 on {q8.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"int8_qk_attention: {name} must be contiguous {dt} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if S % KV_TILE or BH > 65535:
        raise ValueError(f"int8_qk_attention: S {S} not a multiple of {KV_TILE} "
                         f"or B*H {BH} > 65535")
    out = torch.empty(BH, S, HEAD_DIM + 1, dtype=torch.bfloat16, device=q8.device)
    fn = _bind(native.load_library(_LIB))
    with torch.cuda.device(q8.device):
        err = fn(q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                 S, qk_scale, int(i8pv),
                 torch.cuda.current_stream(q8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_i8 launch failed: cudaError {err}")
    if i8pv:
        int8_qk_attention.launches_i8pv += 1
    else:
        int8_qk_attention.launches += 1
    return out


int8_qk_attention.launches = 0
int8_qk_attention.launches_i8pv = 0
