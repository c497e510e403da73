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
`int8_qk_attention_plain`; CUDA tensors launch K10 or raise. On the card a
call is two steps: `repack_v` lays v out as the kernel reads it (rows of
65 elements are read by neither TMA nor 16-byte copies), then
`int8_qk_attention_packed` launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wiw_tpu_torch.ops import native

HEAD_DIM = 64
KV_TILE = 128  # the kernel's kv block width (a stage of its TMA ring)
NEG_INIT = -1e30
_LIB = "flash_attn_i8"
# int8 PV: the kv index that logical k holds within each 32-wide chunk of
# the kernel's s8 A fragments (k 4t..4t+3 is kv 2t, 2t+1, 8+2t, 9+2t, and
# 16 + the same for k 16+4t..), where the softmax accumulator leaves a
# thread kv 2t, 2t+1 of each 8-wide block; v8 is permuted alike. With
# k = 16h + 4t + 2a + b it is kv = 16h + 8a + 2t + b: the digits (a, t)
# swap, so `repack_v` permutes axes of a strided view and copies once
KV_PERM = tuple(16 * (k // 16) + 8 * (k % 4 // 2) + 2 * (k % 16 // 4) + k % 2
                for k in range(32))


def int8_qk_attention_plain(q8, k8, v, qk_scale: float, i8pv: bool = False,
                            bkv: int = KV_TILE):
    """`_kernel_i8qk`'s arithmetic block by block (the int32 sums are exact
    in fp32: |q8 . k8| <= 64 * 128^2 and |p8 . v8| <= 128 * 127 * 128 per
    block of 128, both below 2^24): S = (q8 k8^T) * qk_scale; m from -1e30;
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


def repack_v(v: torch.Tensor, i8pv: bool):
    """v [BH, S, 65] as K10 reads it: (values, column 64). bf16: [BH, S, 64]
    and [BH, S, 8] (the column, then 7 zeros: the B operand of an 8-wide
    product); int8: [BH, 64, S] (kv along the rows, as 8-bit wgmma takes B)
    and [BH, S], kv permuted by `KV_PERM` within each 32 in both. All
    contiguous. A layout step, not the kernel's arithmetic: plain torch."""
    BH, S, _ = v.shape
    if not i8pv:
        return v[..., :HEAD_DIM].contiguous(), F.pad(v[..., HEAD_DIM:], (0, 7))
    # kv = 32c + 16h + 8a + 2t + b as digits (c, h, a, t, b); logical k
    # takes them in the order (c, h, t, a, b)
    digits = v.reshape(BH, S // 32, 2, 2, 4, 2, HEAD_DIM + 1)
    main = digits[..., :HEAD_DIM].permute(0, 6, 1, 2, 4, 3, 5)
    col = digits[..., HEAD_DIM].permute(0, 1, 2, 4, 3, 5)
    return main.reshape(BH, HEAD_DIM, S), col.reshape(BH, S)


def _bind(lib: ctypes.CDLL):
    fn = lib.wiw_flash_attn_i8qk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q8 on {device}")
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"int8_qk_attention: {name} must be contiguous, 16-byte "
                         f"aligned {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")


def _check_qk(q8, k8):
    if q8.device.type != "cuda":
        raise ValueError(f"int8_qk_attention: unsupported device {q8.device}")
    BH, S, _ = q8.shape
    for name, t in (("q8", q8), ("k8", k8)):
        _check(name, t, torch.int8, (BH, S, HEAD_DIM), q8.device)
    if S % KV_TILE or BH > 65535:
        raise ValueError(f"int8_qk_attention: S {S} not a multiple of {KV_TILE} "
                         f"or B*H {BH} > 65535")
    return BH, S


def int8_qk_attention_packed(q8, k8, v_main, v_col, qk_scale: float,
                             i8pv: bool = False):
    """K10's launch on CUDA tensors, v as `repack_v` lays it out (anything
    else raises). Counts one launch in `int8_qk_attention.launches` (bf16
    PV) or `int8_qk_attention.launches_i8pv`."""
    BH, S = _check_qk(q8, k8)
    if i8pv:
        _check("v", v_main, torch.int8, (BH, HEAD_DIM, S), q8.device)
        _check("v's column", v_col, torch.int8, (BH, S), q8.device)
    else:
        _check("v", v_main, torch.bfloat16, (BH, S, HEAD_DIM), q8.device)
        _check("v's column", v_col, torch.bfloat16, (BH, S, 8), q8.device)
    out = torch.empty(BH, S, HEAD_DIM + 1, dtype=torch.bfloat16, device=q8.device)
    fn = _bind(native.load_library(_LIB))
    with torch.cuda.device(q8.device):
        err = fn(q8.data_ptr(), k8.data_ptr(), v_main.data_ptr(), v_col.data_ptr(),
                 out.data_ptr(), BH, S, qk_scale, int(i8pv),
                 torch.cuda.current_stream(q8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_i8 launch failed: cudaError {err}")
    if i8pv:
        int8_qk_attention.launches_i8pv += 1
    else:
        int8_qk_attention.launches += 1
    return out


def int8_qk_attention(q8, k8, v, qk_scale: float, i8pv: bool = False):
    """K10 over the reference's layouts (module docstring). CUDA tensors:
    contiguous int8 q8, k8 [BH, S, 64], v [BH, S, 65] (bf16, or int8 with
    `i8pv`), S a multiple of 128; anything else raises. v is repacked
    (`repack_v`), then the kernel launches (`int8_qk_attention_packed`)."""
    if native.on_cpu(q8, k8, v):
        return int8_qk_attention_plain(q8, k8, v, qk_scale, i8pv)
    BH, S = _check_qk(q8, k8)
    want_v = torch.int8 if i8pv else torch.bfloat16
    if v.device != q8.device or v.dtype != want_v or tuple(v.shape) != (
            BH, S, HEAD_DIM + 1):
        raise ValueError(f"int8_qk_attention: v must be {want_v} "
                         f"{(BH, S, HEAD_DIM + 1)} on {q8.device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return int8_qk_attention_packed(q8, k8, *repack_v(v, i8pv), qk_scale, i8pv)


int8_qk_attention.launches = 0
int8_qk_attention.launches_i8pv = 0
