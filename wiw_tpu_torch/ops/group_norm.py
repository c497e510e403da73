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
  One call is three launches (tile statistics, merge into per-channel
  scale and offset, apply), counted as one in `group_norm.launches`.
- `copy_plus_one` (the probe's `_copy_kernel`, x + 1 in bf16) measures the
  card's copy ceiling beside K8; its plain version is `x + 1`.
- The gradient: `GroupNormFunction` runs K8 forward and saves only x and
  the parameters; its backward recomputes through `group_norm_plain` and
  differentiates that, as K6's backward does (the reference has no
  GroupNorm backward kernel either).

`group_norm` takes CPU tensors to the plain version and launches K8 on CUDA
tensors (bf16 or fp32 x; C a multiple of 8 and of the groups; at most 65535
batch rows; anything else raises: no fallback). A non-contiguous x is made
contiguous first.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wiw_tpu_torch.ops import native

C_STEP = 8  # the kernel reads 8 channels a thread
MAX_ROWS = 65535  # batch rows: a grid dimension of the kernel
_LIB = "group_norm"


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
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        work = lib.wiw_group_norm_work_floats
        work.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        work.restype = ctypes.c_int64
    return fn


def _check(x, weight, bias, groups) -> None:
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"group_norm: {name} on {t.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm kernel takes bf16 or fp32 x, got {x.dtype}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"group_norm kernel takes a non-empty [N, ..., C] x, "
                         f"got {tuple(x.shape)}")
    N, C = x.shape[0], x.shape[-1]
    if C % C_STEP or C % groups:
        raise ValueError(f"group_norm kernel takes C a multiple of {C_STEP} and "
                         f"of the groups, got C={C}, groups={groups}")
    if N > MAX_ROWS:
        raise ValueError(f"group_norm kernel takes at most {MAX_ROWS} rows, got {N}")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"group_norm: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{C}]")


def _group_norm(x, weight, bias, groups, eps, silu):
    """The plain version on CPU tensors, K8 on CUDA tensors."""
    if native.on_cpu(x, weight, bias):
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    _check(x, weight, bias, groups)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel takes a 16-byte aligned x")
    lib = native.load_library(_LIB)
    fn = _bind(lib)
    N, C = x.shape[0], x.shape[-1]
    L = x.numel() // (N * C)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    work = torch.empty(lib.wiw_group_norm_work_floats(N, L, C),
                       dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 work.data_ptr(), N, L, C, groups, float(eps),
                 int(x.dtype == torch.bfloat16), int(silu),
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
