"""Kernel K8 (GroupNorm + SiLU): its plain version and autograd Function
against the reference's `GroupNorm` (+ `silu`), on the CPU.

Inputs are made with numpy; the norm's scale and bias are perturbed away
from their init. fp32: both sides compute the statistics in fp32 in another
order (the reference sums raw moments, the port an exact two-pass), so
outputs of magnitude ~1-3 agree to 1e-4. The kernel itself only runs on the
card: tests/test_torch_cuda.py holds it against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiw_tpu.models import layers as JL
from wiw_tpu_torch.models import layers as TL
from wiw_tpu_torch.models.convert import load_flax_params
from wiw_tpu_torch.ops import group_norm as TG

torch.set_num_threads(1)

ATOL = 1e-4
# bf16: the port and the reference each round the norm's output to bf16 and
# SiLU's output again, from fp32 values computed in another order (and XLA
# evaluates SiLU in its own way), so each rounding may land one bf16 ulp
# (2^-7 relative at worst) apart
BF16_TOL = 2.0 ** -7


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _affine(C, seed):
    return _rand((C,), seed, 0.2, 1.0), _rand((C,), seed + 1, 0.3)


def _reference(x, scale, bias, groups, eps, silu):
    """The reference's GroupNorm (+ silu) on a jnp array."""
    mod = JL.GroupNorm(num_groups=groups, eps=eps)
    out = mod.apply({"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}}, x)
    return JL.silu(out) if silu else out


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [
    ((2, 6, 5, 64), 32),      # 4-D [N, H, W, C], the spatial resnet's layout
    ((2, 3, 4, 4, 32), 32),   # 5-D [B, F, H, W, C], the temporal resnet's
    ((3, 7, 16), 4),          # [N, S, C]
    ((2, 5, 5, 24), 32),      # C < 32: one group per channel
])
def test_plain_matches_reference_fp32(shape, groups, silu):
    C = shape[-1]
    x = _rand(shape, 1, 1.5, 0.5)
    s, b = _affine(C, 2)
    ref = np.asarray(_reference(jnp.asarray(x), s, b, groups, 1e-5, silu))
    g = groups if C % groups == 0 and C >= groups else C
    out = TG.group_norm_plain(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(b), g, 1e-5, silu)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("silu", [False, True])
def test_plain_matches_reference_bf16(silu):
    x = _rand((2, 3, 6, 6, 64), 3, 2.0, -0.5)
    s, b = _affine(64, 4)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(_reference(xb, s, b, 32, 1e-6, silu), np.float32)
    out = TG.group_norm_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(s),
                              torch.from_numpy(b), 32, 1e-6, silu)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_module_takes_the_flag_and_matches_reference():
    """`GroupNorm(silu=True)` is the reference's `silu(GroupNorm()(x))`, with
    the same parameter names as before (`weight`, `bias`)."""
    x = _rand((2, 4, 4, 64), 5)
    s, b = _affine(64, 6)
    ref = np.asarray(_reference(jnp.asarray(x), s, b, 32, 1e-6, True))
    mod = TL.GroupNorm(64, eps=1e-6, silu=True)
    assert sorted(n for n, _ in mod.named_parameters()) == ["bias", "weight"]
    load_flax_params(torch.nn.ModuleDict({"norm": mod}),
                     {"norm": {"scale": s, "bias": b}})
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def _block_params(jmod, *args, seed=0):
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_resnet_blocks_norms_carry_the_silu(kind):
    """ResnetBlock2D and TemporalResnetBlock with their norms' SiLU folded in
    (no `F.silu` left at the call sites) against the reference blocks."""
    if kind == "spatial":
        jmod, tmod = JL.ResnetBlock2D(32, eps=1e-6), TL.ResnetBlock2D(16, 32, 1e-6, 20)
        args = (_rand((2, 6, 6, 16), 7), _rand((2, 20), 8))
    else:
        jmod, tmod = JL.TemporalResnetBlock(32, eps=1e-5), TL.TemporalResnetBlock(32, 1e-5, 20)
        args = (_rand((2, 3, 4, 4, 32), 9), _rand((2, 3, 20), 10))
    assert tmod.norm1.silu and tmod.norm2.silu
    p = _block_params(jmod, *args)
    ref = np.asarray(jmod.apply({"params": p}, *args))
    load_flax_params(tmod, p)
    with torch.no_grad():
        out = tmod(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_norms_without_silu_stay_without():
    """The transformer's input norm and the VAE attention's norm take no
    SiLU, as in the reference."""
    from wiw_tpu_torch.models.vae import VAEAttention

    assert not TL.TransformerSpatioTemporal(32, 2, 16, 24).norm.silu
    assert not VAEAttention(32).group_norm.silu


@pytest.mark.parametrize("silu", [False, True])
def test_function_gradients_match_plain_autograd_and_reference_vjp(silu):
    """`GroupNormFunction` (the plain forward on the CPU, backward recomputed
    through `group_norm_plain`) against autograd through the plain version
    and against jax.vjp of the reference, all three gradients (x, weight,
    bias), fp32 at 1e-4."""
    x = _rand((2, 3, 5, 5, 32), 11, 1.3, 0.4)
    s, b = _affine(32, 12)
    gy = _rand(x.shape, 13)
    groups, eps = 8, 1e-5

    _, vjp = jax.vjp(lambda xx, ss, bb: _reference(xx, ss, bb, groups, eps, silu),
                     jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(gy))]

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
        out = fn(*leaves, groups, eps, silu)
        out.backward(torch.from_numpy(gy))
        return out, [t.grad.numpy() for t in leaves]

    before = TG.group_norm.launches
    out, got = grads(TG.group_norm)
    assert "GroupNormFunction" in type(out.grad_fn).__name__
    assert TG.group_norm.launches == before  # plain on the CPU
    _, plain = grads(TG.group_norm_plain)
    for g_, p_, r_ in zip(got, plain, ref):
        np.testing.assert_allclose(g_, p_, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g_, r_, atol=ATOL, rtol=ATOL)


def test_function_passes_only_the_gradients_asked_for():
    x = torch.from_numpy(_rand((2, 4, 16), 14)).requires_grad_()
    w, b = torch.ones(16), torch.zeros(16)
    TG.group_norm(x, w, b, 4, 1e-5, True).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    x = torch.from_numpy(_rand((2, 9, 32), 15))
    w, b = (torch.from_numpy(a) for a in _affine(32, 16))
    before = TG.group_norm.launches, TG.copy_plus_one.launches
    with torch.no_grad():
        for silu in (False, True):
            assert torch.equal(TG.group_norm(x, w, b, 8, 1e-6, silu),
                               TG.group_norm_plain(x, w, b, 8, 1e-6, silu))
        assert torch.equal(TG.copy_plus_one(x.bfloat16()), x.bfloat16() + 1)
    assert (TG.group_norm.launches, TG.copy_plus_one.launches) == before


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    m = torch.zeros(2, 4, 16, device="meta")
    p = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TG.group_norm(m, p, p, 4, 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        TG.copy_plus_one(m.bfloat16())


def test_combine_of_row_shards_with_an_empty_one_equals_the_whole():
    """Chan's rule over the row shards' statistics (one shard without rows,
    as a rank without rows of a level gives) gives the whole's mean and
    rstd within 1e-6."""
    x = torch.from_numpy(_rand((3, 10, 6, 64), 20, 2.0, 0.3))
    parts = [x[:, :4], x[:, 4:4], x[:, 4:]]
    every = torch.stack([TG.group_norm_stats_plain(p, 32) for p in parts])
    assert torch.equal(every[1], torch.zeros(3, 32, 3, dtype=torch.float64))
    mean, rstd = TG.combine_stats_plain(every, 1e-5)
    whole = TG.group_norm_stats_plain(x, 32)
    assert torch.equal(every[..., 0].sum(0), whole[..., 0])
    np.testing.assert_allclose(mean.numpy(), whole[..., 1].numpy(), atol=1e-6, rtol=1e-6)
    want = torch.rsqrt((whole[..., 2] / whole[..., 0]).float() + 1e-5)
    np.testing.assert_allclose(rstd.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("silu", [False, True])
def test_apply_from_the_ranks_parts_equals_combine_then_apply(x_dtype, param_dtype, R,
                                                              silu):
    """K8-apply from the parts `every` [R, N, G, 3] of R row shards (at R 2
    and 4 one shard holds no rows: a part of count 0), with bf16 or fp32
    weight and bias: its plain version, and the wrapper on CPU tensors (no
    launch counted), equal bit for bit the chain it replaces,
    `combine_stats_plain` then `normalise_plain` with the parameters cast
    to fp32; the shards together within 1e-5 (fp32) of the whole
    GroupNorm."""
    x = torch.from_numpy(_rand((3, 8, 5, 64), 22, 1.7, 0.4)).to(x_dtype)
    w, b = (torch.from_numpy(a).to(param_dtype) for a in _affine(64, 23))
    cuts = {1: [0, 8], 2: [0, 0, 8], 4: [0, 3, 3, 6, 8]}[R]
    parts = [x[:, lo:hi] for lo, hi in zip(cuts, cuts[1:])]
    every = torch.stack([TG.group_norm_stats_plain(p, 16) for p in parts])
    assert R == 1 or not every[..., 0].all()
    mean, rstd = TG.combine_stats_plain(every, 1e-5)
    before = TG.group_norm_apply.launches
    got = []
    for p in (p for p in parts if p.shape[1]):
        want = TG.normalise_plain(p, mean, rstd, w.float(), b.float(), silu)
        out = TG.group_norm_apply_plain(p, every, w, b, 1e-5, silu)
        assert torch.equal(out, want)
        assert torch.equal(TG.group_norm_apply(p, every, w, b, 1e-5, silu), want)
        got.append(out)
    assert TG.group_norm_apply.launches == before
    if x_dtype == torch.float32:
        whole = TG.group_norm_plain(x, w.float(), b.float(), 16, 1e-5, silu)
        torch.testing.assert_close(torch.cat(got, 1), whole, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N,L,C,dtype", [
    (28, 2304, 320, torch.bfloat16),      # the level-0 shard at fsdp 4
    (2, 32256, 320, torch.bfloat16),      # its temporal rows
    (28, 48, 1280, torch.bfloat16),       # the level-3 shard
    (4, 120, 64, torch.float32),          # 16 vectors a position
    (3, 35, 2560, torch.float32),         # a position wider than the block
    (1, 5, 640, torch.bfloat16)])         # fewer positions than one tile's least
def test_apply_plan_covers_each_row_in_one_wave(N, L, C, dtype):
    """K8-apply's plan: blocks of whole positions (rs * nv threads, or 256
    taking their columns in turn), tiles that cover each row with no empty
    one, one wave of blocks (at most SMs x APPLY_THREADS_SM threads), and no
    more tiles than give each row thread APPLY_MIN_ROWS positions."""
    plan = TG.apply_plan(N, L, C, dtype, 132)
    nv = C * dtype.itemsize // 16
    rs = max(1, 256 // nv)
    assert plan.threads == (256 if nv > 256 else rs * nv)
    assert plan.tiles * plan.tile >= L > (plan.tiles - 1) * plan.tile
    assert plan.tiles == 1 or N * plan.tiles <= 132 * (TG.APPLY_THREADS_SM // plan.threads)
    assert plan.tiles == 1 or plan.tile >= rs * TG.APPLY_MIN_ROWS - rs


def test_split_wrappers_on_cpu_take_the_plain_versions_and_count_no_launch():
    from wiw_tpu_torch.ops import quant as TQ

    x = torch.from_numpy(_rand((2, 9, 4, 32), 21, 1.5, -0.2))
    w, b = (torch.from_numpy(a) for a in _affine(32, 24))
    before = (TG.group_norm_stats.launches, TG.group_norm_apply.launches,
              TQ.conv_amax.launches)
    st = TG.group_norm_stats(x, 8)
    assert torch.equal(st, TG.group_norm_stats_plain(x, 8))
    every = torch.stack([st, TG.group_norm_stats(x[:, :0], 8)])
    assert torch.equal(TG.group_norm_apply(x, every, w, b, 1e-6),
                       TG.group_norm_apply_plain(x, every, w, b, 1e-6))
    assert torch.equal(TQ.conv_amax(x.bfloat16()), TQ.conv_amax_plain(x.bfloat16()))
    assert (TG.group_norm_stats.launches, TG.group_norm_apply.launches,
            TQ.conv_amax.launches) == before


def test_split_wrappers_refuse_devices_other_than_cpu_and_cuda():
    from wiw_tpu_torch.ops import quant as TQ

    m = torch.zeros(2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TG.group_norm_stats(m, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        TG.group_norm_apply(m, torch.zeros(2, 2, 4, 3, dtype=torch.float64, device="meta"),
                            torch.ones(16, device="meta"), torch.ones(16, device="meta"), 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        TQ.conv_amax(m.bfloat16())
