"""W8A8 int8 serving: kernel K7 (`w8a8_dense`, `w8a8_conv`), its plain
versions, and the quantisation policy of the UNet trunk and VAE decoder.

Port of `wiw_tpu/ops/quant.py`, whose int8 product and conv are XLA on the
TPU. Here they are hand-written Hopper kernels (`wiw_tpu_torch/csrc/w8a8.cu`,
whose header says what bounds them), because the activation's dynamic
quantisation has to be fused into the int8 product to pay:
  * `w8a8_dense`: per-row dynamic int8 quantisation of x (one pass), then an
    int8 x int8 -> int32 product whose epilogue dequantises,
    ((acc * s_a[row]) * s_w[col]) + bias, in fp32, rounded once to `dtype`;
  * `w8a8_conv`: one dynamic scale for the whole call (per-position scales
    do not factor out of a conv's window sum): a pass takes amax(|x|), a
    pass writes x8 = rint(x / s_a), the implicit-GEMM int8 conv reads its
    tiles from x8, and the epilogue is acc * (s_a * s_w[col]) + bias.
    The scale spans every row of the call (both CFG rows and all frames),
    as the reference's does, so a row's output depends on the rows batched
    with it.
Both products run on one wgmma core; `k7_plan` picks its tile width and,
for a conv, how its A operand is loaded (the header of w8a8.cu says why).
Under shard_clip a conv's rows are split over ranks, while its scale must
span the whole call: `conv_amax` is K7-conv's amax pass as an entry of its
own, the ranks reduce it with MAX (`parallel/clip_sharding.global_amax`),
and `w8a8_conv(..., amax=)` runs the conv with that amax given, skipping
its own pass; each has its plain version beside it.
Dispatch is by device, as in every kernel wrapper of the port: CPU tensors
take the plain versions (exact int32 sums, in float64), CUDA tensors launch
K7 or raise; there is no fallback.

Weights are in torch's layouts with the output channel FIRST (the
reference's flax kernels keep it last): a Linear's int8 weight is [N, K]
(K-contiguous, the product's `col` operand); a conv's is laid out once, at
quantisation, as [O, kh, kw, I], i.e. [O, kh*kw*I] for the implicit GEMM.
Each sits beside an fp32 `weight_scale` [N]. `quantize_params` walks a torch
module by name: each Linear/Conv2d name is translated to the reference's
flax path (`models/convert.translate_key`) and judged by the reference's
policy (`QUANT_SUBTREES`, `QUANT_DENYLIST`, the module sets), so the set of
quantised modules is the reference's. Inference only: the int8 weights
carry no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.ops import native

_EPS = 1e-8
_LIB = "w8a8"
K_STEP = 16  # K (dense) and input channels (conv) come in multiples of this

# module names whose weight is eligible for int8: the reference's measured
# set (wiw_tpu/ops/quant.py: spatial 3x3 convs and the GEGLU in-projection)
QUANT_KERNEL_MODULES = frozenset({
    "conv1", "conv2", "conv",
    "net_0_proj",
})

# the full candidate set, for sensitivity/throughput ablations
QUANT_KERNEL_MODULES_AGGRESSIVE = frozenset({
    "conv1", "conv2", "conv_shortcut", "conv",
    "to_q", "to_k", "to_v", "to_out_0",
    "net_0_proj", "net_2",
    "proj_in", "proj_out",
})

# top-level subtrees within which quantization applies
QUANT_SUBTREES = ("down_blocks", "mid_block", "up_blocks")

# module names never quantized even inside an eligible subtree (the
# reference's XLA int8 (3,1,1) conv lost on the TPU)
QUANT_DENYLIST = frozenset({"time_emb_proj", "temporal_res_block"})


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division. PyTorch on CUDA divides by a Python (or
    CPU) scalar as a product with its reciprocal, which differs from the
    quotient by an ulp for some t; the reference and K7 divide."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_kernel(w: torch.Tensor):
    """Symmetric per-out-channel int8 quantisation of a weight whose output
    channel is its FIRST axis (torch's Linear [N, K], conv [O, ...]).
    Returns (int8 weight of the same layout, fp32 scale [N]) with
    w ~= w8 * scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
    scale = _div127(torch.clamp_min(amax, _EPS))
    shape = (-1,) + (1,) * (wf.ndim - 1)
    w8 = torch.clamp(torch.round(wf / scale.view(shape)), -127, 127)
    return w8.to(torch.int8), scale


def _quant_rows(x: torch.Tensor):
    """Per-row (last-axis) dynamic int8 quantisation. Returns (x8, scale)
    with scale shaped like x minus the last axis (keepdim)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div127(torch.clamp_min(amax, _EPS))
    return torch.round(xf / scale).to(torch.int8), scale


def _quant_tensor(x: torch.Tensor, amax=None):
    """One dynamic scale for all of x (the conv's): (x8, fp32 scalar); with
    `amax` given (that of a larger call, as under a row split) the scale is
    taken from it."""
    xf = x.float()
    amax = xf.abs().amax() if amax is None else amax.float().reshape(())
    scale = _div127(torch.clamp_min(amax, _EPS))
    return torch.round(xf / scale).to(torch.int8), scale


def w8a8_dense_plain(x, w8, w_scale, bias=None, dtype=torch.bfloat16):
    """K7-dense's arithmetic: x [..., K] in the dtype it arrives in, w8
    [N, K] int8, w_scale [N] fp32; the int32 sums exact (float64)."""
    x8, sa = _quant_rows(x)
    acc = torch.matmul(x8.double(), w8.double().t())
    out = acc.float() * sa * w_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def w8a8_conv_plain(x, w8, w_scale, bias=None, *, stride=1, padding=0,
                    dtype=torch.bfloat16, amax=None):
    """K7-conv's arithmetic: x NHWC [N, H, W, I], w8 [O, kh, kw, I] int8,
    symmetric `padding`, the activation's amax taken from x or `amax`; the
    int32 sums exact (float64)."""
    x8, sa = _quant_tensor(x, amax)
    acc = F.conv2d(x8.double().permute(0, 3, 1, 2),
                   w8.double().permute(0, 3, 1, 2), stride=stride,
                   padding=padding).permute(0, 2, 3, 1)
    out = acc.float() * (sa * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


K7_TILE_M = 128  # output rows (conv: pixels) of one tile of the product


def k7_plan(N: int, C: int | None = None, stride: int = 1, OW: int = 1):
    """K7's tiling: (bn, bw). `bn` is the tile's width in output channels,
    one that divides N where one does, so that no width of the UNet or the
    VAE decoder pads: a dense product and a gathered conv take 160, a conv
    with TMA boxes 256 (the least L2 traffic an operation), then 160, else
    128 (the widths that measured fastest: the header of w8a8.cu). For a
    conv (`C` input channels, `stride`, output width `OW`), `bw` > 0 loads
    the A operand by TMA boxes shifted per tap, in output rectangles of bw x
    (128 / bw) pixels, with bw the power of two >= OW up to 128 (stride 1
    and C a multiple of 64, a 64-byte K chunk inside one tap); `bw` 0
    gathers A with cp.async (a dense product takes TMA and ignores it)."""
    bw = 0
    if C is not None and stride == 1 and C % 64 == 0:
        bw = min(K7_TILE_M, 1 << max(OW - 1, 0).bit_length())
    widths = (256, 160) if bw else (160,)
    return next((w for w in widths if N % w == 0), 128), bw


def _bind(lib: ctypes.CDLL):
    dense, conv = lib.wiw_w8a8_dense, lib.wiw_w8a8_conv
    if dense.argtypes is None:
        dense.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
        dense.restype = ctypes.c_int
        conv.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                         + [ctypes.c_void_p])
        conv.restype = ctypes.c_int
    return dense, conv


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check_common(x, w8, w_scale, bias, dtype, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    for name, t in (("w8", w8), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16/fp32 x and output, got {x.dtype} "
                        f"-> {dtype}")
    if w8.dtype != torch.int8 or not w8.is_contiguous():
        raise TypeError(f"{what}: w8 must be contiguous int8, got {w8.dtype}")
    N = w8.shape[0]
    if (w_scale.dtype != torch.float32 or w_scale.shape != (N,)
            or not w_scale.is_contiguous()):
        raise ValueError(f"{what}: w_scale must be contiguous fp32 [{N}]")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be contiguous fp32 [{N}]")
    if N % 8:
        raise ValueError(f"{what}: output channels {N} not a multiple of 8")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    if any(t is not None and t.data_ptr() % 8 for t in (w_scale, bias)):
        raise ValueError(f"{what}: w_scale and bias must be 8-byte aligned")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def w8a8_dense(x, w8, w_scale, bias=None, dtype=torch.bfloat16):
    """x @ dequant(w8)^T + bias with the int8 product. x [..., K] float (in
    the dtype it arrives in: never promoted first), w8 [N, K] int8, w_scale
    [N] fp32, bias [N] or None. CPU tensors take `w8a8_dense_plain`. CUDA
    tensors launch K7-dense (a per-row quantisation pass, then the int8
    product; counted as one launch in `w8a8_dense.launches`): bf16/fp32 x
    and output, K a multiple of 16, N of 8, fp32 bias; anything else
    raises. `k7_plan(N)` picks the tile width."""
    if native.on_cpu(*(t for t in (x, w8, w_scale, bias) if t is not None)):
        return w8a8_dense_plain(x, w8, w_scale, bias, dtype)
    _check_common(x, w8, w_scale, bias, dtype, "w8a8_dense")
    N, K = w8.shape
    if x.shape[-1] != K or K % K_STEP:
        raise ValueError(f"w8a8_dense: x {tuple(x.shape)} against w8 "
                         f"{tuple(w8.shape)} (K a multiple of {K_STEP})")
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    M = x2.shape[0]
    if M == 0:
        raise ValueError("w8a8_dense: empty input")
    x8 = torch.empty(M, K, dtype=torch.int8, device=x.device)
    sa = torch.empty(M, dtype=torch.float32, device=x.device)
    out = torch.empty(M, N, dtype=dtype, device=x.device)
    dense, _ = _bind(native.load_library(_LIB))
    with torch.cuda.device(x.device):
        err = dense(x2.data_ptr(), x8.data_ptr(), sa.data_ptr(), w8.data_ptr(),
                    w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, N, K, k7_plan(N)[0],
                    _DTYPES[x.dtype], _DTYPES[dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"w8a8_dense launch failed: cudaError {err}")
    w8a8_dense.launches += 1
    return out.view(*x.shape[:-1], N)


w8a8_dense.launches = 0


def w8a8_conv(x, w8, w_scale, bias=None, *, stride=1, padding=0,
              dtype=torch.bfloat16, amax=None):
    """conv(x, dequant(w8)) + bias with the int8 product, channels-last.
    x [N, H, W, I] float, w8 [O, kh, kw, I] int8, symmetric integer
    `stride` and `padding`. CPU tensors take `w8a8_conv_plain`. CUDA tensors
    launch K7-conv (an amax pass, a pass that writes x8, then the
    implicit-GEMM int8 conv, tiled by `k7_plan`; counted as one launch in
    `w8a8_conv.launches`):
    contiguous bf16/fp32 x, I a multiple of 16, O of 8; anything else
    raises. With `amax` (a one-element fp32 tensor on x's device: amax(|x|)
    of a larger call, as `conv_amax` and a MAX reduction over ranks give it
    under a row split) K7-conv skips its amax pass and quantises with it;
    such a launch counts in `w8a8_conv.launches_given`."""
    if native.on_cpu(*(t for t in (x, w8, w_scale, bias, amax) if t is not None)):
        return w8a8_conv_plain(x, w8, w_scale, bias, stride=stride,
                               padding=padding, dtype=dtype, amax=amax)
    _check_common(x, w8, w_scale, bias, dtype, "w8a8_conv")
    if x.ndim != 4 or w8.ndim != 4 or x.shape[-1] != w8.shape[-1]:
        raise ValueError(f"w8a8_conv: x {tuple(x.shape)} (NHWC) against w8 "
                         f"{tuple(w8.shape)} ([O, kh, kw, I])")
    if not x.is_contiguous():
        raise ValueError("w8a8_conv: x must be contiguous NHWC")
    Nb, H, W, C = x.shape
    O, kh, kw, _ = w8.shape
    if C % K_STEP:
        raise ValueError(f"w8a8_conv: {C} input channels, not a multiple of "
                         f"{K_STEP}")
    if stride < 1 or padding < 0:
        raise ValueError(f"w8a8_conv: stride {stride}, padding {padding}")
    OH = (H + 2 * padding - kh) // stride + 1
    OW = (W + 2 * padding - kw) // stride + 1
    if Nb == 0 or OH <= 0 or OW <= 0:
        raise ValueError(f"w8a8_conv: empty output for x {tuple(x.shape)}")
    given = amax is not None
    if given:
        if (amax.device != x.device or amax.dtype != torch.float32
                or amax.numel() != 1):
            raise ValueError("w8a8_conv: amax must be one fp32 on x's device")
        amax = amax.reshape(1).contiguous()
    else:
        amax = torch.empty(1, dtype=torch.float32, device=x.device)
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty(Nb, OH, OW, O, dtype=dtype, device=x.device)
    bn, bw = k7_plan(O, C, stride, OW)
    _, conv = _bind(native.load_library(_LIB))
    with torch.cuda.device(x.device):
        err = conv(x.data_ptr(), x8.data_ptr(), amax.data_ptr(), w8.data_ptr(),
                   w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
                   out.data_ptr(), Nb, H, W, C, O, kh, kw, stride, padding,
                   OH, OW, bn, bw,
                   _DTYPES[x.dtype] | (_DTYPES[dtype] << 1) | (int(given) << 2),
                   _stream(x))
    if err != 0:
        raise RuntimeError(f"w8a8_conv launch failed: cudaError {err}")
    if given:
        w8a8_conv.launches_given += 1
    else:
        w8a8_conv.launches += 1
    return out


w8a8_conv.launches = 0
w8a8_conv.launches_given = 0


def conv_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """amax(|x|) in fp32 as a one-element tensor; 0 for an empty x."""
    if x.numel() == 0:
        return torch.zeros(1, dtype=torch.float32, device=x.device)
    return x.float().abs().amax().reshape(1)


def conv_amax(x: torch.Tensor) -> torch.Tensor:
    """amax(|x|) of a conv's input, the pass K7-conv runs first, as an entry
    of its own (a one-element fp32 tensor; 0 for an empty x, with no
    launch). CPU tensors take `conv_amax_plain`; CUDA tensors launch K7's
    amax pass (bf16/fp32, 16-byte aligned, a multiple of 8 elements; a
    non-contiguous x is copied first), which zeroes its output itself,
    counted in `conv_amax.launches`."""
    if x.device.type != "cuda":
        if native.on_cpu(x):
            return conv_amax_plain(x)
        raise ValueError(f"conv_amax: unsupported device {x.device}")
    if x.numel() == 0:
        return torch.zeros(1, dtype=torch.float32, device=x.device)
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_amax takes bf16/fp32 x, got {x.dtype}")
    x = x.contiguous()
    if x.numel() % 8 or x.data_ptr() % 16:
        raise ValueError("conv_amax takes a 16-byte aligned x of a multiple of 8 "
                         "elements")
    fn = native.load_library(_LIB).wiw_amax_abs
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    with native.device_of(x):
        err = fn(x.data_ptr(), x.numel(), out.data_ptr(), _DTYPES[x.dtype],
                 native.raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"conv_amax launch failed: cudaError {err}")
    conv_amax.launches += 1
    return out


conv_amax.launches = 0


def _eligible(path: Sequence[str], modules=QUANT_KERNEL_MODULES) -> bool:
    if not path or not path[0].startswith(QUANT_SUBTREES):
        return False
    if any(p in QUANT_DENYLIST for p in path):
        return False
    return path[-1] in modules


def eligible_modules(module: nn.Module, extra_deny: Sequence[str] = (),
                     modules=QUANT_KERNEL_MODULES, prefix: str = ""):
    """[(name, submodule)] of the Linear/Conv layers of `module` whose
    weight the reference's policy quantises. Names are judged as the
    reference's flax paths (`translate_key` of `prefix + name + ".weight"`
    with the prefix's own path parts dropped), so `prefix="decoder."`
    judges a VAE decoder as the reference judges its decoder tree."""
    from wiw_tpu_torch.models.convert import translate_key

    deny = QUANT_DENYLIST | set(extra_deny)
    skip = len(translate_key(prefix + "x")) - 1 if prefix else 0
    found = []
    for name, m in module.named_modules():
        if not isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)) or not name:
            continue
        path = translate_key(f"{prefix}{name}.weight")[skip:-1]
        if _eligible(path, modules) and not (deny & set(path)):
            if isinstance(m, nn.Conv3d) or getattr(m, "pad", None) is not None:
                raise NotImplementedError(
                    f"{prefix}{name}: K7 takes Linear and symmetric-padding "
                    f"Conv2d layers, not {m}")
            found.append((name, m))
    return found


def make_int8_(m: nn.Module, w8: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> None:
    """Make a Linear/Conv2d int8: `w8` its weight (a conv's [O, kh, kw, I]),
    `scale` an fp32 `weight_scale` buffer, the bias fp32 (the reference adds
    it in fp32), its output dtype `dtype`. The float weight is dropped."""
    m.weight = nn.Parameter(w8, requires_grad=False)
    m.register_buffer("weight_scale", scale.float())
    if m.bias is not None:
        m.bias = nn.Parameter(m.bias.detach().float(), requires_grad=False)
    m._compute_dtype = dtype


@torch.no_grad()
def quantize_module_(m: nn.Module, dtype: torch.dtype) -> None:
    """Quantise a Linear/Conv2d's weight from its current values
    (`quantize_kernel`; a conv's laid out [O, kh, kw, I]) and make the layer
    int8 (`make_int8_`)."""
    w = m.weight.detach()
    if w.ndim == 4:
        w = w.permute(0, 2, 3, 1)
    w8, scale = quantize_kernel(w)
    make_int8_(m, w8.contiguous(), scale, dtype)


def quantize_params(module: nn.Module, extra_deny: Sequence[str] = (),
                    modules=QUANT_KERNEL_MODULES,
                    prefix: str = "") -> nn.Module:
    """Quantise, in place, every weight of `module` that the reference's
    policy makes int8 (`eligible_modules`); the layers then take K7. Each
    keeps the compute dtype it had as its output dtype; a layer that is int8
    already stays as it is. Returns the module."""
    for _, m in eligible_modules(module, extra_deny, modules, prefix):
        if m.weight.dtype != torch.int8:
            quantize_module_(m, m.compute_dtype)
    return module


def quantize_vae_decoder(vae: nn.Module) -> nn.Module:
    """W8A8 the VAE decoder's spatial 3x3 convs (mid/up res blocks,
    upsamplers) by the same policy; the encoder is untouched. Returns the
    VAE."""
    quantize_params(vae.decoder, prefix="decoder.")
    return vae


def count_quantized(module: nn.Module) -> int:
    """Number of int8 weights in `module`."""
    return sum(t.dtype == torch.int8 for t in module.state_dict().values())
