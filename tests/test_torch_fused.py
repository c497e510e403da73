"""Port parity for kernels K4, K5, K6 and K6-bf16: their plain versions
against the reference's Pallas kernels run in interpret mode on the CPU, and
the port's dispatch rules against the reference's.

Inputs are made with numpy; the FF inputs are those of the reference's
tests/test_models.py::TestFusedGEGLU (C = 64, inner = 256). Weights go to
the port in torch's Linear layout (the transposes of the reference's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiw_tpu.ops import fused_mlp as JF
from wiw_tpu.ops.temporal_attention import temporal_self_attention_pallas
from wiw_tpu.ops.temporal_attention import temporal_self_attention_xla as J_xla
from wiw_tpu_torch.models.unet import UNetConfig
from wiw_tpu_torch.ops import fused_mlp as TF
from wiw_tpu_torch.ops import temporal_attention as TT

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(a, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if bf16 else t


def _j(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16) if bf16 else jnp.asarray(a)


# ---------------------------------------------------------------- K4
@pytest.mark.parametrize("bf16", [False, True])
def test_frame_attention_plain_matches_pallas_kernel(bf16):
    q, k, v = (_rand((2, 5, 128, 2 * 16), s) for s in (1, 2, 3))  # S % 64 == 0
    ref = np.asarray(temporal_self_attention_pallas(
        *(_j(a, bf16) for a in (q, k, v)), heads=2, interpret=True), np.float32)
    out = TT.frame_attention(*(_t(a, bf16) for a in (q, k, v)), heads=2)
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if bf16:
        # both round the fp32 result once; a sum in another order can move
        # it across one rounding boundary: one bf16 ulp of outputs up to ~3
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)
    else:
        # fp32 throughout; only the summation order differs
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_xla_formulation_matches_reference(bf16):
    """The einsum oracle, which WIW_TEMPORAL_ATTN=xla selects."""
    q, k, v = (_rand((2, 5, 24, 2 * 16), s) for s in (7, 8, 9))
    ref = np.asarray(J_xla(*(_j(a, bf16) for a in (q, k, v)), heads=2), np.float32)
    out = TT.temporal_self_attention_xla(*(_t(a, bf16) for a in (q, k, v)), heads=2)
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if bf16:
        # the same bf16 weights; the weighted sum is rounded once, in
        # another order: one bf16 ulp of outputs up to ~3
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_frame_attention_keeps_softmax_weights_unrounded():
    """In bf16, K4 rounds only its output; the batched form rounds the
    weights too, so on the same inputs it is the further from fp32."""
    q, k, v = (_rand((1, 14, 64, 64), s) for s in (4, 5, 6))
    tb = [_t(a, True) for a in (q, k, v)]
    ref32 = TT.frame_attention_plain(*(t.float() for t in tb), heads=1)
    err_k4 = (TT.frame_attention(*tb, heads=1).float() - ref32).abs().mean()
    err_batched = (TT.temporal_self_attention_batched(*tb, heads=1).float()
                   - ref32).abs().mean()
    assert err_k4 < err_batched


# ---------------------------------------------------------------- K5, K6
C, INNER = 64, 256


def _ffn_weights(c=C, inner=INNER, c_out=C):
    return dict(w1=_rand((c, 2 * inner), 11, 0.05), b1=_rand((2 * inner,), 12, 0.05),
                w2=_rand((inner, c_out), 13, 0.05), b2=_rand((c_out,), 14, 0.05))


def test_fp32_gate_is_the_reference_erf_gate_bit_for_bit():
    """K5's and K6's fp32 gate is the reference kernels' (`_kernel`,
    `_lnff_kernel`): a * (b * 0.5 * (1 + _erf(b / sqrt 2))) with the
    Abramowitz-Stegun `_erf` in fp32, not the exact erf (which puts 0.3% of
    the rounded gates one bf16 step or more apart). Held bit for bit after
    the bf16 rounding on 2^21 seeded bf16 pairs of std 2, the reference
    evaluated one jnp op at a time (as `_lnff_op_by_op` runs the kernel
    body: compiled, XLA rewrites the chain and moves a few gates an ulp)."""
    import jax

    rng = np.random.default_rng(50)
    a, b = (torch.from_numpy(rng.standard_normal(1 << 21).astype(np.float32) * 2)
            .bfloat16() for _ in range(2))
    ja, jb = (jnp.asarray(t.float().numpy()) for t in (a, b))
    with jax.disable_jit():
        ref = ja * (jb * 0.5 * (1.0 + JF._erf(jb * jnp.float32(0.7071067811865476))))
        ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    got = TF._gate_f32(a, b).bfloat16().float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_geglu_ffn_plain_matches_pallas_kernel(bf16):
    x = _rand((256, C), 10)
    p = _ffn_weights()
    ref = np.asarray(JF.geglu_ffn_pallas(
        _j(x, bf16), _j(p["w1"], bf16), p["b1"], _j(p["w2"], bf16), p["b2"],
        interpret=True), np.float32)
    out = TF.geglu_ffn(_t(x, bf16), _t(p["w1"].T, bf16), _t(p["b1"]),
                       _t(p["w2"].T, bf16), _t(p["b2"])).float().numpy()
    if bf16:
        # one rounding of outputs up to ~1.2 may land one bf16 ulp apart
        # (2^-8 relative; 0.0078 at 1.2): the fp32 sums run in another order
        np.testing.assert_allclose(out, ref, atol=8e-3, rtol=8e-3)
    else:
        # the reference test's own fp32 bound (the same erf; the fp32 sums
        # run in another order)
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c_in,c_out", [(96, 160), (160, 96)])
def test_geglu_ffn_plain_matches_pallas_kernel_at_other_widths(bf16, c_in, c_out):
    """K5 at C and C_out off 64 and C_out != C both ways (the kernel's step
    is 16), inner 128: the bounds of the test above."""
    x = _rand((256, c_in), 15)
    p = _ffn_weights(c_in, 128, c_out)
    ref = np.asarray(JF.geglu_ffn_pallas(
        _j(x, bf16), _j(p["w1"], bf16), p["b1"], _j(p["w2"], bf16), p["b2"],
        interpret=True), np.float32)
    out = TF.geglu_ffn(_t(x, bf16), _t(p["w1"].T, bf16), _t(p["b1"]),
                       _t(p["w2"].T, bf16), _t(p["b2"])).float().numpy()
    assert out.shape == (256, c_out)
    if bf16:
        np.testing.assert_allclose(out, ref, atol=8e-3, rtol=8e-3)
    else:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_ln_geglu_ffn_residual_plain_matches_pallas_kernel(bf16):
    x = _rand((384, C), 20, 1.7, 0.3)
    s, c = _rand((C,), 21, 0.2, 1.0), _rand((C,), 22, 0.1)
    p = _ffn_weights()
    ref = np.asarray(JF.ln_geglu_ffn_residual_pallas(
        _j(x, bf16), s, c, _j(p["w1"], bf16), p["b1"], _j(p["w2"], bf16),
        p["b2"], interpret=True), np.float32)
    args = (_t(x, bf16), _t(s), _t(c), _t(p["w1"].T, bf16), _t(p["b1"]),
            _t(p["w2"].T, bf16), _t(p["b2"]))
    out = TF.ln_geglu_ffn_residual(*args).float().numpy()
    if bf16:
        # the CPU compiler of the reference rewrites the gate and some bf16
        # round trips (the next test holds the roundings to the kernel's
        # source), so an output may land one bf16 ulp apart: at most
        # 2^-7 |out|, and 2^-7 (a tenth of the mean |h|) below |out| = 1
        np.testing.assert_array_less(
            np.abs(out - ref), 2.0 ** -7 * np.maximum(np.abs(ref), 1.0) + 1e-6)
    else:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


class _Ref:
    """A VMEM ref of the reference's kernel body, held as an eager array."""

    def __init__(self, a):
        self.a = a

    @property
    def dtype(self):
        return self.a.dtype

    def __jax_array__(self):  # jnp.zeros_like(ref)
        return self.a

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)


def _lnff_op_by_op(monkeypatch, gate="f32"):
    """K6 (K6-bf16 with `gate="bf16"`) in bf16 with weights at 0.15: (the
    port's output, the output of the reference's `_lnff_kernel` itself run
    eagerly one jnp op at a time under the matching WIW_FUSED_FF_GATE, x).
    One row block and one inner tile (inner = its block size)."""
    if gate == "bf16":
        monkeypatch.setenv("WIW_FUSED_FF_GATE", "bf16")
    else:
        monkeypatch.delenv("WIW_FUSED_FF_GATE", raising=False)
    monkeypatch.setattr(JF.pl, "program_id", lambda axis: 0)
    monkeypatch.setattr(JF.pl, "num_programs", lambda axis: 1)
    monkeypatch.setattr(JF.pl, "when", lambda c: (lambda f: f() if c else None))
    x = _rand((384, C), 20, 1.7, 0.3)
    s, c = _rand((C,), 21, 0.2, 1.0), _rand((C,), 22, 0.1)
    w1, b1 = _rand((C, 2 * INNER), 11, 0.15), _rand((2 * INNER,), 12, 0.15)
    w2, b2 = _rand((INNER, C), 13, 0.15), _rand((C,), 14, 0.15)
    xj, w1j = _j(x, True), _j(w1, True)
    o_ref = _Ref(jnp.zeros_like(xj))
    JF._lnff_kernel(1e-5, _Ref(xj), _Ref(_j(s[None])), _Ref(_j(c[None])),
                    _Ref(w1j[:, :INNER]), _Ref(w1j[:, INNER:]),
                    _Ref(_j(b1[None, :INNER])), _Ref(_j(b1[None, INNER:])),
                    _Ref(_j(w2, True)), _Ref(_j(b2[None])), o_ref,
                    _Ref(jnp.zeros_like(xj)), _Ref(jnp.zeros(x.shape, jnp.float32)))
    out = TF.ln_geglu_ffn_residual(
        _t(x, True), _t(s), _t(c), _t(w1.T, True), _t(b1), _t(w2.T, True),
        _t(b2), gate=gate).float().numpy()
    return out, np.asarray(o_ref.a, np.float32), _t(x, True).float().numpy()


def test_ln_geglu_ffn_residual_plain_rounds_where_the_kernel_does(monkeypatch):
    """K6's bf16 roundings (LN rounded; each dot rounded, then a bf16 bias
    add; the gate rounded; h = rounded acc + b2 in bf16; x + h) against the
    reference's `_lnff_kernel` run op by op, so that each rounding happens
    where its source puts it. (Compiled for the CPU, as interpret mode
    compiles it, XLA rewrites the fp32 gate and the round trips around it,
    so many rounded gates move one ulp, and the outputs of the test above
    agree only to one ulp.) Weights at 0.15, so that h is O(1) (mean
    |h| ~2 beside |x| ~1.7), where a wrong rounding of h or of an
    intermediate moves a share of the outputs by an ulp."""
    out, ref, x = _lnff_op_by_op(monkeypatch)
    assert np.abs(ref - x).mean() > 1.0
    diff = np.abs(out - ref)
    # only the fp32 sums' order differs, so a rounding lands one ulp apart
    # at a few elements (0.008% measured; the next test plants the faults)
    assert (diff > 0).mean() < K6_MOVED
    np.testing.assert_array_less(diff, 2.0 ** -7 * np.maximum(np.abs(ref), 1.0) + 1e-6)


K6_MOVED = 5e-3  # share of outputs that may move an ulp in the test above


def _k6_plain_without(drop):
    """K6's plain version with the bf16 rounding `drop` left out (None: the
    plain version itself)."""
    def plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5, gate="f32"):
        assert gate == "f32"

        def rnd(t):
            return t.to(x.dtype).float()

        def r(step, t):
            return t if step == drop else rnd(t)

        inner, x2 = w2.shape[1], x.reshape(-1, x.shape[-1])
        xn = r("ln", TF._ln_rows(x2, ln_w, ln_b, eps))
        hb = r("bias1", r("dot1", xn @ w1.float().t()) + rnd(b1))
        a, b = hb[:, :inner], hb[:, inner:]
        g = r("gate", TF._gate_f32(a, b))
        h = r("h", r("dot2", g @ w2.float().t()) + rnd(b2))
        return (x2.float() + h).to(x.dtype).reshape(x.shape)

    return plain


@pytest.mark.parametrize("drop", [None, "ln", "dot1", "bias1", "gate", "dot2", "h"])
def test_rounding_check_catches_a_dropped_rounding(monkeypatch, drop):
    """The test above fails for a plain version that leaves out any one of
    K6's roundings, and passes for one that keeps them all."""
    monkeypatch.setattr(TF, "ln_geglu_ffn_residual_plain", _k6_plain_without(drop))
    out, ref, _ = _lnff_op_by_op(monkeypatch)
    moved = (np.abs(out - ref) > 0).mean()
    assert (moved < K6_MOVED) == (drop is None), moved


# ---------------------------------------------------------------- K6-bf16
def test_bf16_gate_plain_rounds_where_the_kernel_does(monkeypatch):
    """K6-bf16's plain version against the reference's `_lnff_kernel` run op
    by op under WIW_FUSED_FF_GATE=bf16, so that every bf16 rounding of the
    gate's erf polynomial happens where its source puts it: the same bound
    as K6's test above (a rounding may land one ulp apart at a few outputs,
    from the fp32 sums' order)."""
    out, ref, _ = _lnff_op_by_op(monkeypatch, gate="bf16")
    diff = np.abs(out - ref)
    assert (diff > 0).mean() < K6_MOVED
    np.testing.assert_array_less(diff, 2.0 ** -7 * np.maximum(np.abs(ref), 1.0) + 1e-6)
    # and the switch matters: the fp32 gate moves many more outputs
    monkeypatch.undo()
    f32, _, _ = _lnff_op_by_op(monkeypatch, gate="f32")
    assert (np.abs(f32 - ref) > 0).mean() > 10 * K6_MOVED


def test_bf16_gate_plain_matches_pallas_kernel_interpret(monkeypatch):
    """K6-bf16's plain version against `ln_geglu_ffn_residual_pallas` in
    interpret mode under WIW_FUSED_FF_GATE=bf16. The kernel reads the switch
    when it is traced, so the jit cache is cleared before and after. The
    CPU compiler may evaluate bf16 chains with excess precision, so an
    output may land one bf16 ulp apart (the bound of the fp32-gate test)."""
    x = _rand((384, C), 20, 1.7, 0.3)
    s, c = _rand((C,), 21, 0.2, 1.0), _rand((C,), 22, 0.1)
    p = _ffn_weights()
    monkeypatch.setenv("WIW_FUSED_FF_GATE", "bf16")
    JF.ln_geglu_ffn_residual_pallas.clear_cache()
    try:
        ref = np.asarray(JF.ln_geglu_ffn_residual_pallas(
            _j(x, True), s, c, _j(p["w1"], True), p["b1"], _j(p["w2"], True),
            p["b2"], interpret=True), np.float32)
    finally:
        JF.ln_geglu_ffn_residual_pallas.clear_cache()
    out = TF.ln_geglu_ffn_residual(
        _t(x, True), _t(s), _t(c), _t(p["w1"].T, True), _t(p["b1"]),
        _t(p["w2"].T, True), _t(p["b2"]), gate="bf16").float().numpy()
    np.testing.assert_array_less(
        np.abs(out - ref), 2.0 ** -7 * np.maximum(np.abs(ref), 1.0) + 1e-6)


def test_bf16_gate_matches_the_gelu_gate_to_its_resolution():
    """The bf16 erf polynomial is a coarser GELU (the reference: phi error
    ~5e-3); held against the exact gate in fp32 on the same bf16 inputs."""
    rng = np.random.default_rng(40)
    a, b = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 2)
            .bfloat16() for _ in range(2))
    got = TF._gate_bf16(a, b).float()
    exact = a.float() * torch.nn.functional.gelu(b.float())
    assert (got - exact).abs().max() <= 0.03 * exact.abs().max()
    assert not torch.equal(got, exact)


def test_bf16_gate_function_backward_takes_the_exact_gate():
    """The autograd Function with gate="bf16": its forward is the bf16-gate
    plain version on the CPU, and its backward recomputes through the
    unfused formulation with the exact GELU, as the reference's VJP does
    whatever the forward's gate, so its gradients are the fp32 gate's bit
    for bit (fp32 params, bf16 activations)."""
    x = torch.from_numpy(_rand((128, C), 41)).bfloat16()
    s, c = (torch.from_numpy(a) for a in (_rand((C,), 42, 0.2, 1.0), _rand((C,), 43, 0.1)))
    p = {k: torch.from_numpy(v) for k, v in _ffn_weights().items()}
    args = (x, s, c, p["w1"].T.contiguous().bfloat16(), p["b1"].bfloat16(),
            p["w2"].T.contiguous().bfloat16(), p["b2"].bfloat16())
    g = torch.from_numpy(_rand((128, C), 44)).bfloat16()

    def grads(fn, **kw):
        leaves = [t.detach().requires_grad_() for t in args]
        out = fn(*leaves, **kw)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]

    out, got = grads(TF.ln_geglu_ffn_residual, gate="bf16")
    out_f32, f32 = grads(TF.ln_geglu_ffn_residual)
    _, unfused = grads(TF.ln_geglu_ffn_residual_unfused)
    assert torch.equal(out, TF.ln_geglu_ffn_residual_plain(*args, gate="bf16"))
    assert not torch.equal(out, out_f32)
    for a, b, u in zip(got, f32, unfused):
        assert torch.equal(a, b) and torch.equal(a, u)


def test_bf16_gate_function_gradients_match_reference(monkeypatch):
    """K6-bf16's autograd Function against jax.vjp of the reference's
    custom-VJP `ln_geglu_ffn_residual` under WIW_FUSED_FF_GATE=bf16, all
    seven gradients, fp32: relative Frobenius error 1e-5 (summation order
    only). The switch is set as the reference reads it, with the fused
    kernel's jit cache cleared before and after."""
    import jax

    x = _rand((384, C), 45, 1.7, 0.3)
    s, c = _rand((C,), 46, 0.2, 1.0), _rand((C,), 47, 0.1)
    p = _ffn_weights()
    g = _rand((384, C), 48)
    jargs = (x, s, c, p["w1"], p["b1"], p["w2"], p["b2"])
    monkeypatch.setenv("WIW_FUSED_FF_GATE", "bf16")
    JF.ln_geglu_ffn_residual_pallas.clear_cache()
    try:
        _, vjp = jax.vjp(lambda *a: JF.ln_geglu_ffn_residual(*a), *map(_j, jargs))
        ref = vjp(_j(g))
    finally:
        JF.ln_geglu_ffn_residual_pallas.clear_cache()
    leaves = [_t(a).requires_grad_() for a in
              (x, s, c, p["w1"].T, p["b1"], p["w2"].T, p["b2"])]
    TF.ln_geglu_ffn_residual(*leaves, gate="bf16").backward(_t(g))
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        got = leaf.grad.numpy()
        r = np.asarray(r, np.float64)
        if i in (3, 5):  # the port's weights are the transposes
            got = got.T
        assert np.linalg.norm(got - r) <= 1e-5 * np.linalg.norm(r), i


def test_transformer_blocks_pass_the_gate_to_k6(monkeypatch):
    """`fused_ff_gate` reaches K6's wrapper from the UNet config's blocks;
    an unknown gate raises."""
    from wiw_tpu_torch.models import layers as TL
    from wiw_tpu_torch.models.unet import UNetConfig

    seen = []

    def record(x, *a):
        seen.append(a[-1])
        return x

    monkeypatch.setattr(TL, "ln_geglu_ffn_residual", record)
    block = TL.TemporalBasicTransformerBlock(64, 1, 64, 16, fused_ff=True,
                                             fused_ff_gate="bf16")
    with torch.no_grad():
        block(torch.zeros(1, 2, 64, 64), None)
    assert seen == ["bf16", "bf16"]
    with pytest.raises(ValueError):
        UNetConfig(fused_ff_gate="fp16")
    with pytest.raises(ValueError):
        TF.ln_geglu_ffn_residual_plain(*(torch.zeros(1),) * 7, gate="fp16")


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("M,C_,inner,int8", [
    (258048, 320, 1280, False), (64512, 640, 2560, False),
    (16128, 1280, 5120, False), (4032, 1280, 5120, False),  # C > 640
    (129024, 320, 1280, False), (384, 32, 128, False), (96, 64, 256, False),
    (200, 64, 256, False), (128, 64, 192, False), (128, 640, 2560, True),
    (0, 64, 256, False), (640, 641, 2560, False),
])
def test_lnff_eligibility_matches_reference_rule(M, C_, inner, int8):
    dt = torch.int8 if int8 else torch.bfloat16
    x = torch.empty(M, C_, device="meta")
    w1 = torch.empty(2 * inner, C_, dtype=dt, device="meta")
    w2 = torch.empty(C_, inner, dtype=dt, device="meta")
    # wiw_tpu/ops/fused_mlp.py _lnff_dispatch, with on_tpu = True
    ref = bool(C_ <= 640 and not int8 and JF._pick_bm(M, C_)
               and inner % 128 == 0)
    assert TF.lnff_eligible(x, w1, w2) == ref


@pytest.mark.parametrize("mode", TT.MODES)
@pytest.mark.parametrize("S", [9216, 2304, 576, 144, 64, 16, 100])
def test_temporal_dispatch_matches_reference_rule(monkeypatch, mode, S):
    calls = []
    for name in ("frame_attention", "temporal_self_attention_batched",
                 "temporal_self_attention_xla"):
        monkeypatch.setattr(TT, name, lambda *a, _n=name: calls.append(_n))
    q = torch.empty(1, 3, S, 64, device="meta")
    TT.temporal_self_attention(q, q, q, 1, mode)
    # wiw_tpu/ops/temporal_attention.py temporal_self_attention, on_tpu = True
    if mode == "pallas" and S % 64 == 0:
        expect = "frame_attention"
    elif mode == "xla":
        expect = "temporal_self_attention_xla"
    else:
        expect = "temporal_self_attention_batched"
    assert calls == [expect]


def test_temporal_dispatch_refuses_unknown_mode():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError):
        TT.temporal_self_attention(q, q, q, 1, "flash")


def test_xla_formulation_gradients_match_reference():
    """The batched and xla forms train through autograd (K4 has no
    gradient): the xla form's vjp against the reference's, fp32."""
    import jax

    q, k, v, g = (_rand((2, 3, 10, 2 * 16), s) for s in (11, 12, 13, 14))
    _, vjp = jax.vjp(lambda a, b, c: J_xla(a, b, c, heads=2), *map(_j, (q, k, v)))
    ref = vjp(_j(g))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    TT.temporal_self_attention_xla(*leaves, heads=2).backward(_t(g))
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-5)


def test_frame_attention_refuses_a_gradient_off_the_cpu():
    m = torch.zeros(1, 14, 64, 128, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        TT.frame_attention(m, m, m, 2)


def test_fused_ff_routes_c_off_the_kernel_step_to_the_unfused_modules(monkeypatch):
    """C = 40 with a 16-fold inner width (640) passes the reference's rule
    (C <= 640, 384 rows, inner a multiple of 128) but not the CUDA kernel's
    C % C_STEP (16): the block takes the unfused modules, whose result is
    the fused path's function, and never calls K6's wrapper."""
    from wiw_tpu_torch.models import layers as TL

    torch.manual_seed(0)
    fused = TL.BasicTransformerBlock(40, 2, 20, 16, fused_ff=True)
    plain = TL.BasicTransformerBlock(40, 2, 20, 16, fused_ff=False)
    for block in (fused, plain):
        block.ff = TL.FeedForward(40, mult=16)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_rand((3, 128, 40), 5))
    ctx = torch.from_numpy(_rand((3, 1, 16), 6))
    w1 = fused.ff.net[0].proj.weight
    assert 40 % TF.C_STEP and TF.lnff_eligible(x, w1, fused.ff.net[2].weight)

    def refuse(*a, **k):
        raise AssertionError("K6's wrapper called at C = 40")

    monkeypatch.setattr(TL, "ln_geglu_ffn_residual", refuse)
    with torch.no_grad():
        torch.testing.assert_close(fused(x, ctx), plain(x, ctx), rtol=0, atol=0)


def test_fused_ff_takes_k6_at_a_c_of_the_kernel_step(monkeypatch):
    """C = 96, a multiple of C_STEP but not of 64, which the kernel takes
    since its C-tail is read as zeros: the block calls K6's wrapper once (the
    plain version on the CPU) and agrees with the unfused modules (fp32:
    summation order only)."""
    from wiw_tpu_torch.models import layers as TL

    torch.manual_seed(0)
    fused = TL.BasicTransformerBlock(96, 2, 48, 16, fused_ff=True)
    plain = TL.BasicTransformerBlock(96, 2, 48, 16, fused_ff=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_rand((3, 128, 96), 5))
    ctx = torch.from_numpy(_rand((3, 1, 16), 6))
    calls = []

    def record(*a, **k):
        calls.append(a[0].shape)
        return TF.ln_geglu_ffn_residual(*a, **k)

    monkeypatch.setattr(TL, "ln_geglu_ffn_residual", record)
    with torch.no_grad():
        torch.testing.assert_close(fused(x, ctx), plain(x, ctx), rtol=1e-5, atol=1e-5)
    assert calls == [(3, 128, 96)]


# the feed-forward widths of the UNet (C <= MAX_C) and of the card tests
K6_WIDTHS = sorted({c for c in UNetConfig().block_out_channels if c <= TF.MAX_C}
                   | {16, 64, 96, 128, 336, 624})


@pytest.mark.parametrize("C_", K6_WIDTHS)
def test_k6_plan_fits_the_card(C_):
    """Every width K6 runs at gets a plan of the stage counts built for its
    split (the C entry refuses any other; the build's static_assert holds
    that split's shared memory to an H100 block's): row halves of 128-row
    tiles up to C_out = 320, column halves of 64-row tiles above, so that
    each warpgroup's accumulator stays 64 x 320 (160 registers a thread)."""
    plan = TF.ffn_plan(C_, C_)
    assert plan.split == (C_ > TF.FFN_NW)
    assert plan.tile_rows == (64 if plan.split else 128)
    assert (plan.w1_stages, plan.w2_stages) == ((2, 1) if plan.split else (2, 3))


@pytest.mark.parametrize("C_,C_out", [
    (0, 0), (100, 100), (8, 8), (656, 656), (1280, 1280), (320, 640), (640, 320),
])
def test_k6_plan_refuses_what_the_kernel_does_not_take(C_, C_out):
    with pytest.raises(ValueError):
        TF.ffn_plan(C_, C_out)


@pytest.mark.parametrize("C_,C_out,split", [
    (96, 160, False), (160, 96, False), (320, 320, False), (48, 48, False),
    (16, 320, False), (640, 640, True), (96, 336, True), (336, 96, True),
    (640, 16, True),
])
def test_ffn_plan_gives_k5_its_plan(C_, C_out, split):
    """K5's plan: C_out may differ from C; the split follows the larger of
    the two (a 128-row tile's accumulator holds 320 output columns, and
    its x tile 320 input columns beside the weight rings), with the stage
    counts built for that split."""
    plan = TF.ffn_plan(C_, C_out, residual=False)
    assert plan.split == split
    assert plan.tile_rows == (64 if split else 128)
    assert (plan.w1_stages, plan.w2_stages) == ((2, 1) if split else (2, 3))


@pytest.mark.parametrize("C_,C_out", [
    (0, 96), (96, 0), (100, 96), (96, 100), (8, 96), (96, 40), (656, 96), (96, 656),
    (1280, 640),
])
def test_ffn_plan_refuses_what_k5_does_not_take(C_, C_out):
    with pytest.raises(ValueError):
        TF.ffn_plan(C_, C_out, residual=False)


def test_k6_wrapper_refuses_shapes_before_any_launch():
    """The wrapper's shape rules on meta tensors (no device needed): C off
    the step, inner off K6's 32, rows off 128."""
    def args(M, C_, inner):
        m = torch.empty(M, C_, dtype=torch.bfloat16, device="meta")
        return (m, torch.empty(C_, device="meta"), torch.empty(C_, device="meta"),
                torch.empty(2 * inner, C_, dtype=torch.bfloat16, device="meta"),
                torch.empty(2 * inner, device="meta"),
                torch.empty(C_, inner, dtype=torch.bfloat16, device="meta"),
                torch.empty(C_, device="meta"))

    for M, C_, inner in ((128, 100, 400), (128, 96, 48), (200, 96, 384)):
        a = args(M, C_, inner)
        with pytest.raises(ValueError):
            TF._check(*a[:1], *a[3:], residual=True, ln=a[1:3])
    a = args(128, 96, 384)
    assert TF._check(*a[:1], *a[3:], residual=True, ln=a[1:3]) == (
        128, 96, 384, 96, TF.ffn_plan(96, 96))


def test_k5_wrapper_refuses_shapes_before_any_launch():
    """K5's shape rules on meta tensors: C or C_out off the step of 16 or
    above 640, inner off 32, rows off 128; C_out != C is taken."""
    def args(M, C_, inner, c_out):
        return (torch.empty(M, C_, dtype=torch.bfloat16, device="meta"),
                torch.empty(2 * inner, C_, dtype=torch.bfloat16, device="meta"),
                torch.empty(2 * inner, device="meta"),
                torch.empty(c_out, inner, dtype=torch.bfloat16, device="meta"),
                torch.empty(c_out, device="meta"))

    for case in ((128, 100, 128, 96), (128, 96, 128, 100), (128, 656, 128, 96),
                 (128, 96, 128, 656), (128, 96, 48, 160), (200, 96, 128, 160)):
        with pytest.raises(ValueError):
            TF._check(*args(*case), residual=False)
    for C_, c_out in ((96, 160), (336, 96)):
        assert TF._check(*args(256, C_, 128, c_out), residual=False) == (
            256, C_, 128, c_out, TF.ffn_plan(C_, c_out, residual=False))


def test_ln_geglu_ffn_residual_function_gradients_match_reference():
    """K6's autograd Function (the plain forward here; the backward
    recomputed through the unfused formulation) against jax.vjp of the
    reference's custom-VJP `ln_geglu_ffn_residual`, all seven gradients,
    fp32: relative Frobenius error 1e-5 (summation order only)."""
    import jax

    x = _rand((384, C), 30, 1.7, 0.3)
    s, c = _rand((C,), 31, 0.2, 1.0), _rand((C,), 32, 0.1)
    p = _ffn_weights()
    g = _rand((384, C), 33)
    jargs = (x, s, c, p["w1"], p["b1"], p["w2"], p["b2"])
    out, vjp = jax.vjp(lambda *a: JF.ln_geglu_ffn_residual(*a), *map(_j, jargs))
    ref = vjp(_j(g))
    leaves = [_t(a).requires_grad_() for a in
              (x, s, c, p["w1"].T, p["b1"], p["w2"].T, p["b2"])]
    before = TF.ln_geglu_ffn_residual.launches
    tout = TF.ln_geglu_ffn_residual(*leaves)
    assert tout.grad_fn is not None and "LnGegluFfnResidual" in type(tout.grad_fn).__name__
    tout.backward(_t(g))
    assert TF.ln_geglu_ffn_residual.launches == before  # plain on the CPU
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=2e-5, rtol=2e-5)
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        got = leaf.grad.numpy()
        r = np.asarray(r, np.float64)
        if i in (3, 5):  # the port's weights are the transposes
            got = got.T
        assert np.linalg.norm(got - r) <= 1e-5 * np.linalg.norm(r), i
