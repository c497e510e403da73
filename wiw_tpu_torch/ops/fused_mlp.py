"""Fused GEGLU feed-forward: kernels K5 and K6 and their plain versions.

Port of `wiw_tpu/ops/fused_mlp.py`. Weights are in torch's Linear layout:
w1 [2*inner, C] (rows: the hidden half, then the gate half, as diffusers'
GEGLU `proj`), w2 [C_out, inner]; the reference's are the transposes.

- K5 `geglu_ffn` (plain `geglu_ffn_plain`) replaces the TPU kernel `_kernel`
  (`geglu_ffn_pallas`): x @ W1 + b1 in fp32, rounded to the model dtype;
  hidden * gelu(gate) in fp32, rounded; @ W2 accumulated in fp32, + b2 in
  fp32, rounded once. No model caller, as in the reference.
- K6 `ln_geglu_ffn_residual` (plain `ln_geglu_ffn_residual_plain`) replaces
  `_lnff_kernel` (`ln_geglu_ffn_residual_pallas`): x + W2 GEGLU(LN(x)),
  with the unfused pair of Linear layers' roundings: fp32 two-pass LN
  rounded; each dot rounded, then a model-dtype bias add; the gate in fp32,
  rounded; h = rounded acc + b2 in the model dtype; x + h.
- K6-bf16, the same entry with `gate="bf16"` (the reference's
  WIW_FUSED_FF_GATE=bf16, read there inside `_lnff_kernel`): the gate in
  the model dtype's arithmetic (bf16 wherever the kernel runs), the
  reference's Abramowitz-Stegun erf with every constant, product and sum
  rounded to that dtype (`_gate_bf16`); counted in
  `ln_geglu_ffn_residual.launches_bf16_gate`. The ops read no environment:
  the worker resolves the switch into `UNetConfig.fused_ff_gate`.
- `lnff_eligible` is the reference's rule for taking K6; where it says no
  (C > 640, rows not a multiple of 128, ...) the model runs its unfused
  LayerNorm and FeedForward modules, the function of the reference's
  unfused oracle. K6 takes C in multiples of `C_STEP` (16: TMA reads the
  columns past C as zeros and the kernel normalises over the true C); the
  reference's Pallas kernel takes any C <= 640, so the model's dispatch
  (`models/layers.py`, `_ln_ff_residual`) also asks for C % C_STEP == 0
  and sends any other C to the unfused modules: a route by shape, as the
  reference sends C > 640 to XLA, to the same function. Under the
  reference's rule (inner = 4 C a multiple of 128) every C it takes is a
  multiple of 32, so a FeedForward of the usual width never takes that
  route. K5 keeps its first kernel, which takes C and C_out in multiples
  of `K5_STEP` (64).
- `k6_plan(C, C_out)` is the one place that picks K6's tile, split and
  stage counts; the C entry refuses any other plan.
- K6's gradient, as the reference's custom VJP does it: the autograd
  Function `LnGegluFfnResidual` runs K6 forward and saves only its inputs;
  its backward recomputes through the unfused differentiable formulation
  `ln_geglu_ffn_residual_unfused` (the reference's
  `ln_geglu_ffn_residual_xla`) and returns all seven gradients. There is no
  backward kernel, as the reference has none. The recomputation takes the
  exact GELU whatever the forward's gate, as the reference's VJP does: with
  the bf16 gate the gradient is the fp32 gate's.

Both kernels are one CUDA source, `wiw_tpu_torch/csrc/geglu_ffn.cu`, whose
header says what bounds them on the H100 and how K6 is laid out (wgmma,
TMA through an mbarrier ring, clusters that multicast the weights; K5 on
the first version's mma.sync template). The wrappers take CPU tensors to
the plain versions; on CUDA tensors they launch or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wiw_tpu_torch.ops import native

MAX_C = 640       # K5 and K6 keep the output row's fp32 sums in registers
C_STEP = 16       # K6 takes C in multiples of this
K5_STEP = 64      # K5 takes C and C_out in multiples of this
INNER_STEP = 32   # K6 walks the inner dimension 32 columns at a time (K5: 64)
ROW_BLOCK = 128   # rows must come in multiples of this (the reference's rule)
_LIB = "geglu_ffn"
_SQRT1_2 = 0.7071067811865476
GATES = ("f32", "bf16")
# `_erf`'s Abramowitz-Stegun 7.1.26 constants a1..a5, p
_AS_ERF = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429,
           0.3275911)


def _consts(dtype: torch.dtype, *cs: float):
    """Python constants as the reference's arithmetic in `dtype` sees them
    (weak-typed scalars there: rounded to the array's dtype)."""
    return (torch.tensor(c, dtype=dtype) for c in cs)


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """The reference's `_erf` in x's dtype, one op at a time: the sign taken
    in fp32, each constant, product, sum, quotient and exp rounded."""
    a1, a2, a3, a4, a5, p = _consts(x.dtype, *_AS_ERF)
    s = torch.sign(x.float()).to(x.dtype)
    ax = x * s
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gate_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6-bf16's gate: a * (b * 0.5 * (1 + erf(b / sqrt 2))) in the model
    dtype's ops (a's and b's: bf16 wherever the kernel runs), as
    `_lnff_kernel` computes it under WIW_FUSED_FF_GATE=bf16."""
    half, one, r2 = _consts(b.dtype, 0.5, 1.0, _SQRT1_2)
    return a * (b * half * (one + _erf_as(b * r2)))


# K6's build (csrc/geglu_ffn.cu `Layout`, whose static_assert holds its
# shared memory to an H100 block's): each warpgroup's output accumulator is
# 64 rows x K6_NW columns; the W1 and W2 rings' stage counts by split
K6_NW = 320
K6_CLUSTER = 2   # CTAs that multicast each weight box (4 ran slower, PERF.md)
_K6_STAGES = {False: (2, 3), True: (2, 1)}  # split -> (W1, W2) stages


class K6Plan(NamedTuple):
    split: bool      # two column halves of 64-row tiles (C > 320), else two
                     # 64-row halves of 128-row tiles
    tile_rows: int
    w1_stages: int
    w2_stages: int


def k6_plan(C: int, C_out: int) -> K6Plan:
    """K6's plan for C input and C_out output columns (C_out == C for K6):
    at C_out <= 320 the two warpgroups split 128-row tiles by rows, above
    it 64-row tiles by columns, so that each keeps a 64 x 320 fp32
    accumulator (160 registers a thread) at both of the UNet's widths.
    Raises for what the kernel does not take: C not a positive multiple of
    C_STEP up to MAX_C, C_out != C."""
    if C % C_STEP or not 0 < C <= MAX_C:
        raise ValueError(f"K6 takes C a multiple of {C_STEP} up to {MAX_C}, got {C}")
    if C_out != C:
        raise ValueError(f"K6 takes C_out == C (the residual), got {C_out} and {C}")
    split = C_out > K6_NW
    return K6Plan(split, 64 if split else 128, *_K6_STAGES[split])


def _check_gate(gate: str) -> None:
    if gate not in GATES:
        raise ValueError(f"gate {gate!r} not in {GATES}")


def lnff_eligible(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """The reference's rule for taking the fused kernel (`_lnff_dispatch`):
    C <= 640, flattened rows a positive multiple of 128, inner a multiple
    of 128, weights not int8. It does not ask for C % C_STEP == 0, which
    the CUDA kernel needs; the model's dispatch adds that (see the module
    docstring)."""
    C = x.shape[-1]
    M = x.numel() // C if C else 0
    return (C <= MAX_C and M >= ROW_BLOCK and M % ROW_BLOCK == 0
            and w2.shape[1] % 128 == 0 and w1.dtype != torch.int8)


def _ln_rows(x, scale, bias, eps):
    """Row LayerNorm in fp32 with a two-pass variance (the reference's
    `_ln_rows`)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def geglu_ffn_plain(x, w1, b1, w2, b2):
    """K5's arithmetic in plain PyTorch (model dtype = x's dtype)."""
    dt = x.dtype
    inner, c_out = w2.shape[1], w2.shape[0]
    xf = x.reshape(-1, x.shape[-1]).float()
    h = (xf @ w1.float().t() + b1.float()).to(dt).float()
    a, b = h[:, :inner], h[:, inner:]
    g = a * (b * 0.5 * (1.0 + torch.erf(b * _SQRT1_2)))
    out = g.to(dt).float() @ w2.float().t() + b2.float()
    return out.to(dt).reshape(*x.shape[:-1], c_out)


def ln_geglu_ffn_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                eps: float = 1e-5, gate: str = "f32"):
    """K6's arithmetic in plain PyTorch (model dtype = x's dtype); with
    `gate="bf16"`, K6-bf16's."""
    _check_gate(gate)
    dt = x.dtype
    inner = w2.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    xn = _ln_rows(x2, ln_w, ln_b, eps).to(dt)
    h = (xn.float() @ w1.float().t()).to(dt) + b1.to(dt)
    if gate == "bf16":
        g = _gate_bf16(h[:, :inner], h[:, inner:]).to(dt)
    else:
        a, b = h[:, :inner].float(), h[:, inner:].float()
        g = (a * (b * 0.5 * (1.0 + torch.erf(b * _SQRT1_2)))).to(dt)
    out = (g.float() @ w2.float().t()).to(dt) + b2.to(dt)
    return (x2 + out).reshape(x.shape)


def ln_geglu_ffn_residual_unfused(x, ln_w, ln_b, w1, b1, w2, b2,
                                  eps: float = 1e-5):
    """The reference's unfused oracle `ln_geglu_ffn_residual_xla`, with its
    dtype rules: LN in fp32 rounded to x's dtype, each product in x's dtype,
    + bias (a wider bias widens the sum, as in JAX), rounded; exact gelu.
    Differentiable: K6's backward recomputes through it, for either gate."""
    dt = x.dtype
    inner = w2.shape[1]
    ln = _ln_rows(x, ln_w, ln_b, eps).to(dt)
    h = (ln @ w1.to(dt).t() + b1).to(dt)
    g = h[..., :inner] * torch.nn.functional.gelu(h[..., inner:])
    return x + (g.to(dt) @ w2.to(dt).t() + b2).to(dt)


def _check(x, w1, b1, w2, b2, residual: bool, ln=()) -> tuple[int, int, int, int]:
    name = "ln_geglu_ffn_residual" if residual else "geglu_ffn"
    for t in (w1, b1, w2, b2, *ln):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
    for t in (x, w1, w2):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16 x and weights, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned "
                             "x and weights")
    C = x.shape[-1]
    M = x.numel() // C if C else 0
    c_out, inner = w2.shape
    if (w1.shape != (2 * inner, C) or b1.shape != (2 * inner,)
            or b2.shape != (c_out,)):
        raise ValueError(f"{name}: shapes w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
                         f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} do not fit C={C}")
    if residual and (c_out != C or any(t.shape != (C,) for t in ln)):
        raise ValueError(f"{name}: the residual needs C_out == C and [C] norm params")
    step, inner_step = (C_STEP, INNER_STEP) if residual else (K5_STEP, 64)
    for what, n in (("C", C), ("C_out", c_out)):
        if n % step or not 0 < n <= MAX_C:
            raise ValueError(f"{name} kernel takes {what} a multiple of {step} up to "
                             f"{MAX_C}, got {n}")
    if inner % inner_step or inner == 0:
        raise ValueError(f"{name} kernel takes inner a multiple of {inner_step}, "
                         f"got {inner}")
    if M == 0 or M % ROW_BLOCK:
        raise ValueError(f"{name} kernel takes a positive multiple of {ROW_BLOCK} "
                         f"rows, got {M}")
    return M, C, inner, c_out


def _f32(t: torch.Tensor) -> torch.Tensor:
    """An fp32 vector for the kernels: contiguous, 16-byte aligned (they
    read bias pairs as 8-byte words)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bind(lib: ctypes.CDLL, residual: bool):
    fn = lib.wiw_ln_geglu_ffn_residual if residual else lib.wiw_geglu_ffn
    if fn.argtypes is None:
        if residual:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                           + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        else:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(residual: bool, x, args: tuple) -> None:
    fn = _bind(native.load_library(_LIB), residual)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_LIB} launch failed: cudaError {err}")


def geglu_ffn(x, w1, b1, w2, b2):
    """GEGLU feed-forward x [..., C] -> [..., C_out]. CPU tensors take
    `geglu_ffn_plain`; CUDA tensors launch K5 (bf16; C and C_out multiples
    of K5_STEP up to 640, inner a multiple of 64, rows a multiple of 128;
    anything else raises) and count one launch in `geglu_ffn.launches`."""
    if native.on_cpu(x, w1, b1, w2, b2):
        return geglu_ffn_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ffn: unsupported device {x.device}")
    M, C, inner, c_out = _check(x, w1, b1, w2, b2, residual=False)
    # biases go in fp32: K5 adds them in fp32, as the reference does
    b1f, b2f = _f32(b1), _f32(b2)
    out = torch.empty(*x.shape[:-1], c_out, dtype=x.dtype, device=x.device)
    _launch(False, x, (x.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(),
                       b2f.data_ptr(), out.data_ptr(), M, C, inner, c_out))
    geglu_ffn.launches += 1
    return out


geglu_ffn.launches = 0


def _ln_geglu_ffn_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps, gate):
    _check_gate(gate)
    if native.on_cpu(x, ln_w, ln_b, w1, b1, w2, b2):
        return ln_geglu_ffn_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps,
                                           gate)
    if x.device.type != "cuda":
        raise ValueError(f"ln_geglu_ffn_residual: unsupported device {x.device}")
    M, C, inner, _ = _check(x, w1, b1, w2, b2, residual=True, ln=(ln_w, ln_b))
    plan = k6_plan(C, C)
    # norm params and biases go in fp32; K6 rounds the biases to bf16 itself
    lw, lb, b1f, b2f = (_f32(t) for t in (ln_w, ln_b, b1, b2))
    out = torch.empty_like(x)
    _launch(True, x, (x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(),
                      b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(), out.data_ptr(),
                      M, C, inner, float(eps), int(gate == "bf16"), int(plan.split),
                      plan.w1_stages, plan.w2_stages))
    if gate == "bf16":
        ln_geglu_ffn_residual.launches_bf16_gate += 1
    else:
        ln_geglu_ffn_residual.launches += 1
    return out


class LnGegluFfnResidual(torch.autograd.Function):
    """K6 or K6-bf16 forward; backward recomputed through the unfused
    formulation (exact GELU, as the reference's VJP)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, gate):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        return _ln_geglu_ffn_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps, gate)

    @staticmethod
    def backward(ctx, grad):
        return (*native.recompute_backward(ctx, ln_geglu_ffn_residual_unfused,
                                           grad, ctx.eps), None, None)


def ln_geglu_ffn_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                          gate: str = "f32"):
    """x + GEGLU_FF(LayerNorm(x)) over x [..., C], the gate in fp32 (K6) or,
    with `gate="bf16"`, in bf16 arithmetic (K6-bf16). CPU tensors take
    `ln_geglu_ffn_residual_plain`; CUDA tensors launch the kernel (bf16; C a
    multiple of C_STEP up to 640, inner a multiple of 32, rows a multiple
    of 128; anything else raises; tiled by `k6_plan`) and count one launch in
    `ln_geglu_ffn_residual.launches` (K6) or `.launches_bf16_gate`
    (K6-bf16). With gradients wanted it goes through `LnGegluFfnResidual`
    (backward by recomputation with the exact gate, as the reference's)."""
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LnGegluFfnResidual.apply(*args, eps, gate)
    return _ln_geglu_ffn_residual(*args, eps, gate)


ln_geglu_ffn_residual.launches = 0
ln_geglu_ffn_residual.launches_bf16_gate = 0
