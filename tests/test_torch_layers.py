"""Port parity: wiw_tpu_torch.models.layers and ops against the reference.

Each block is initialised by the reference (flax), its parameters are
perturbed with numpy noise (so biases, norm scales and mix factors are not
at their trivial init) and carried into the port by `load_flax_params`; the
same numpy inputs then go through both. All fp32 on the CPU, with JAX
matmuls pinned to fp32 (tests/conftest.py): only summation order differs,
so blocks agree to 1e-4 absolute on outputs of magnitude ~1 (sums of a few
hundred products per conv/matmul, each ~1e-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiw_tpu.models import layers as JL
from wiw_tpu.ops.temporal_attention import (
    temporal_self_attention_batched as jax_temporal_batched,
)
from wiw_tpu_torch.models import layers as TL
from wiw_tpu_torch.models.convert import load_flax_params
from wiw_tpu_torch.ops.resize import resize_cubic
from wiw_tpu_torch.ops.temporal_attention import temporal_self_attention_batched

torch.set_num_threads(1)

ATOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _params(jmod, *args, seed=0):
    """Reference init + seeded numpy perturbation of every leaf."""
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


def _check(jmod, tmod, *args, atol=ATOL, wrap=None):
    """`wrap` names the parent a lone norm or feed-forward has in a real
    tree (the key grammar keys on it)."""
    p = _params(jmod, *args)
    ref = np.asarray(jmod.apply({"params": p}, *args))
    if wrap is None:
        load_flax_params(tmod, p)
    else:
        load_flax_params(torch.nn.ModuleDict({wrap: tmod}), {wrap: p})
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    with torch.no_grad():
        out = tmod(*targs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=ATOL)


# ---------------------------------------------------------------- norms
class TestGroupNorm:
    """Exact two-pass fp32 statistics, per row."""

    def _ref64(self, x, groups, eps=1e-5):
        N, C = x.shape[0], x.shape[-1]
        g = np.asarray(x, np.float64).reshape(N, -1, groups, C // groups)
        out = (g - g.mean(axis=(1, 3), keepdims=True)) / np.sqrt(
            g.var(axis=(1, 3), keepdims=True) + eps)
        return out.reshape(x.shape)

    def _port(self, x, groups):
        gn = TL.GroupNorm(x.shape[-1], num_groups=groups)
        with torch.no_grad():
            return gn(torch.from_numpy(x)).numpy()

    def test_typical_stats_match_float64_and_reference(self):
        x = _rand((2, 8, 8, 16), 1)
        np.testing.assert_allclose(self._port(x, 4), self._ref64(x, 4),
                                   atol=2e-5, rtol=2e-5)
        _check(JL.GroupNorm(num_groups=4), TL.GroupNorm(16, num_groups=4), x,
               wrap="norm")

    @pytest.mark.parametrize("offset,atol", [(1200.0, 2e-3), (500.0, 1e-3)])
    def test_ill_conditioned_groups(self, offset, atol):
        # |mean|/std ~ 1e3: a raw E[x^2]-E[x]^2 variance is wrong here; the
        # same bounds as the reference's tests/test_models.py::TestGroupNorm
        x = _rand((1, 64, 16), 2)
        x[..., :4] += offset
        np.testing.assert_allclose(self._port(x, 4), self._ref64(x, 4),
                                   atol=atol, rtol=atol)

    def test_rows_are_independent(self):
        # a degenerate co-batched row must not change another row's output
        good = _rand((1, 6, 6, 32), 3)
        bad = _rand((1, 6, 6, 32), 4) + 1e4
        alone = self._port(good, 8)
        batched = self._port(np.concatenate([bad, good, bad]), 8)
        np.testing.assert_array_equal(batched[1], alone[0])

    def test_few_channels_use_one_group_per_channel(self):
        x = _rand((2, 5, 5, 8), 5)
        _check(JL.GroupNorm(), TL.GroupNorm(8), x, wrap="norm")


def test_layernorm():
    _check(JL.LayerNorm(), TL.LayerNorm(24), _rand((2, 7, 24), 6, 3.0) + 1.0,
           wrap="norm")


def test_cast_matmul_weights_keeps_norms_fp32():
    blk = TL.cast_matmul_weights(TL.BasicTransformerBlock(32, 2, 16, 24),
                                 torch.bfloat16)
    assert blk.attn1.to_q.weight.dtype == torch.bfloat16
    assert blk.ff.net[0].proj.bias.dtype == torch.bfloat16
    assert blk.norm1.weight.dtype == torch.float32
    res = TL.cast_matmul_weights(TL.SpatioTemporalResBlock(8, 8, temb_ch=16),
                                 torch.bfloat16)
    assert res.spatial_res_block.norm1.weight.dtype == torch.float32
    assert res.time_mixer.mix_factor.dtype == torch.float32
    assert res.temporal_res_block.conv1.weight.dtype == torch.bfloat16


# ---------------------------------------------------------------- small blocks
def test_timestep_embedding_and_feedforward():
    _check(JL.TimestepEmbedding(64, out_dim=16), TL.TimestepEmbedding(16, 64, 16),
           _rand((3, 16), 7))
    _check(JL.FeedForward(), TL.FeedForward(16), _rand((2, 5, 16), 8),
           wrap="ff")


def test_alpha_blender_switch():
    a, b = _rand((2, 4, 8), 9), _rand((2, 4, 8), 10)
    for switch, alpha in [(False, 0.5), (True, 0.0)]:
        _check(JL.AlphaBlender(alpha_init=alpha, switch=switch),
               TL.AlphaBlender(alpha, switch), a, b)


@pytest.mark.parametrize("asym", [False, True])
def test_down_and_upsample(asym):
    x = _rand((2, 8, 6, 8), 11)
    _check(JL.Downsample2D(8, asymmetric_pad=asym),
           TL.Downsample2D(8, asymmetric_pad=asym), x)
    _check(JL.Upsample2D(8), TL.Upsample2D(8), x)


@pytest.mark.parametrize("cin,cout,temb", [(16, 16, True), (8, 16, True),
                                           (16, 8, False)])
def test_resnet_block_2d(cin, cout, temb):
    args = [_rand((2, 6, 6, cin), 12)]
    if temb:
        args.append(_rand((2, 20), 13))
    _check(JL.ResnetBlock2D(cout, eps=1e-6, use_temb=temb),
           TL.ResnetBlock2D(cin, cout, 1e-6, 20 if temb else None), *args)


def test_temporal_resnet_block():
    _check(JL.TemporalResnetBlock(16, eps=1e-5),
           TL.TemporalResnetBlock(16, 1e-5, 20),
           _rand((2, 3, 4, 4, 16), 14), _rand((2, 3, 20), 15))


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_spatio_temporal_res_block(kind):
    x = _rand((6, 4, 4, 8), 16)
    if kind == "unet":
        _check(JL.SpatioTemporalResBlock(16, eps=1e-5),
               TL.SpatioTemporalResBlock(8, 16, eps=1e-5, temb_ch=20),
               x, 3, _rand((6, 20), 17))
    else:
        _check(JL.SpatioTemporalResBlock(16, eps=1e-6, temporal_eps=1e-5,
                                         merge_factor=0.0, switch=True,
                                         use_temb=False),
               TL.SpatioTemporalResBlock(8, 16, eps=1e-6, temporal_eps=1e-5,
                                         merge_factor=0.0, switch=True),
               x, 3)


# ---------------------------------------------------------------- attention
def test_self_attention_and_single_token_cross_shortcut():
    x = _rand((2, 20, 32), 18)
    _check(JL.CrossAttention(2, 16), TL.CrossAttention(32, 2, 16), x)
    ctx = _rand((2, 1, 24), 19)
    _check(JL.CrossAttention(2, 16), TL.CrossAttention(32, 2, 16, 24), x, ctx)
    # temporal layout [B, F, S, C] with per-batch context
    _check(JL.CrossAttention(2, 16), TL.CrossAttention(32, 2, 16, 24),
           _rand((2, 3, 5, 32), 20), ctx)


def test_temporal_attention_batched_and_module():
    q, k, v = (_rand((2, 5, 12, 3 * 8), s) for s in (21, 22, 23))
    ref = np.asarray(jax_temporal_batched(q, k, v, heads=3))
    out = temporal_self_attention_batched(
        *(torch.from_numpy(a) for a in (q, k, v)), heads=3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    _check(JL.TemporalSelfAttention(2, 16), TL.TemporalSelfAttention(32, 2, 16),
           _rand((2, 3, 5, 32), 24))


def test_transformer_blocks():
    ctx = _rand((6, 1, 24), 25)
    _check(JL.BasicTransformerBlock(2, 16), TL.BasicTransformerBlock(32, 2, 16, 24),
           _rand((6, 16, 32), 26), ctx)
    _check(JL.TemporalBasicTransformerBlock(2, 16),
           TL.TemporalBasicTransformerBlock(32, 2, 16, 24),
           _rand((2, 3, 16, 32), 27), _rand((2, 1, 24), 28))


def test_transformer_spatio_temporal():
    _check(JL.TransformerSpatioTemporal(2, 16),
           TL.TransformerSpatioTemporal(32, 2, 16, 24),
           _rand((6, 4, 4, 32), 29), 3, _rand((2, 1, 24), 30))


def test_bf16_block_tracks_reference_bf16():
    """bf16 weights/activations with fp32 norms in both packages. Tolerance
    5e-2 on outputs of magnitude ~1: bf16 has an 8-bit mantissa and the two
    libraries round matmul outputs and bias adds at different places."""
    x = _rand((6, 16, 32), 31)
    ctx = _rand((6, 1, 24), 32)
    jmod = JL.BasicTransformerBlock(2, 16, dtype=jnp.bfloat16)
    p = _params(jmod, x, ctx)
    ref = np.asarray(jmod.apply({"params": p}, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(ctx, jnp.bfloat16)), np.float32)
    tmod = load_flax_params(TL.BasicTransformerBlock(32, 2, 16, 24), p)
    TL.cast_matmul_weights(tmod, torch.bfloat16)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(ctx).bfloat16()).float().numpy()
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("shape,out,dims", [
    ((2, 40, 56, 3), (16, 24), (1, 2)),     # downscale (antialiased)
    ((2, 40, 56, 3), (64, 100), (1, 2)),    # upscale
    ((1, 36, 64, 3), (224, 224), (1, 2)),   # CLIP preprocessing shape
    ((1, 2, 24, 40, 3), (20, 20), (2, 3)),  # decoded video -> output size
])
def test_cubic_resize_matches_jax(shape, out, dims):
    x = np.random.default_rng(33).uniform(-1, 1, shape).astype(np.float32)
    full = list(shape)
    for d, s in zip(dims, out):
        full[d] = s
    ref = np.asarray(jax.image.resize(jnp.asarray(x), tuple(full), "cubic",
                                      antialias=True))
    got = resize_cubic(torch.from_numpy(x), out, dims).numpy()
    # the resampling matrices agree with JAX's to one ulp; the two
    # contractions run in another order (JAX's is one einsum): 1e-5 on
    # values in [-1, 1]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
