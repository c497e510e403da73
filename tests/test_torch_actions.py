"""Port parity: the action codecs, the action_block UNet and pose actions.

Every codec of `wiw_tpu_torch/core/actions.py` takes the same seeded numpy
inputs as `wiw_tpu/core/actions.py`: the integer codecs must be equal, the
float ones agree to fp32 rounding (5e-6 absolute on values of magnitude
<= 2 pi: ten ulps there). The action_block pieces (ActionEmbedderBlock, the transformer's
action branch, the whole UNet, the W8A8 policy and a `generate`) get the
same weights on both sides (a reference init carried across by
`load_flax_params`, or a port init carried to the reference by the
reference's own converter) and run on the same inputs in fp32 on the CPU,
with JAX matmuls pinned to fp32 (tests/conftest.py): only the summation
order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_models import TINY_CLIP, TINY_UNET, TINY_VAE
from wiw_tpu.core import actions as JA
from wiw_tpu.core.schedule import SERVING_CFG as J_SERVING_CFG
from wiw_tpu.models import convert as JCV
from wiw_tpu.models import layers as JL
from wiw_tpu.models import unet as JU
from wiw_tpu.ops import quant as JQ
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.sampling.pipeline import SVDPipeline as JPipe
from wiw_tpu_torch.core import actions as TA
from wiw_tpu_torch.core import schedule as TS
from wiw_tpu_torch.models import convert as TCV
from wiw_tpu_torch.models import layers as TL
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.vae import VAEConfig
from wiw_tpu_torch.ops import quant as TQ
from wiw_tpu_torch.sampling.pipeline import (
    GenerationConfig,
    SVDPipeline,
    init_weights_,
)

torch.set_num_threads(1)

# fp32 codecs: rotation products in another order, divided by the scene
# span and scaled by up to 4 pi, on outputs of magnitude <= 2 pi, where one
# ulp is 4.8e-7: ten ulps (measured six, relative poses)
CODEC_ATOL = 5e-6
STRATEGIES = ("action_block", "action_block_nocfg")


def port_cfg(cls, jcfg, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    return cls(**dict(kw, **over))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _nav(shape, seed, low=0, high=5):
    return np.random.default_rng(seed).integers(low, high, shape)


def _poses(T, seed):
    """[T, 8] poses: xyz inside and outside the scene bounds, unnormalised
    quaternions, grippers outside [0, 1] too."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 2.0, (T, 3))
    quat = rng.standard_normal((T, 4)) * rng.uniform(0.5, 2.0, (T, 1))
    grip = rng.uniform(-0.5, 1.5, (T, 1))
    return np.concatenate([xyz, quat, grip], -1).astype(np.float32)


# ---------------------------------------------------------------- codecs
@pytest.mark.parametrize("shape,low,high", [((3, 14), 0, 5), ((2, 3), -2, 8),
                                            ((1, 1), 1, 4)])
def test_encode_onehot_equals_reference(shape, low, high):
    acts = _nav(shape, 1, low, high)
    ref = np.asarray(JA.encode_onehot(jnp.asarray(acts)))
    out = TA.encode_onehot(torch.from_numpy(acts))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(3, 14), (2, 3), (1, 1)])
def test_encode_and_decode_idx_equal_reference(shape):
    acts = _nav(shape, 2)
    enc = TA.encode_idx(torch.from_numpy(acts))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(JA.encode_idx(jnp.asarray(acts))))
    np.testing.assert_array_equal(
        TA.decode_idx(enc).numpy(), np.asarray(JA.decode_idx(JA.encode_idx(jnp.asarray(acts)))))


@pytest.mark.parametrize("shape", [(2, 5, 3), (1, 14, 10), (3, 1, 4)])
def test_encode_positional_equals_reference(shape):
    acts = _rand(shape, 3)
    np.testing.assert_array_equal(
        TA.encode_positional(torch.from_numpy(acts)).numpy(),
        np.asarray(JA.encode_positional(jnp.asarray(acts))))


def test_quat_to_rotmat_matches_reference():
    q = _rand((4, 7, 4), 4, 3.0)
    np.testing.assert_allclose(TA.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(JA.quat_to_rotmat(jnp.asarray(q))),
                               atol=CODEC_ATOL, rtol=0)


def test_normalize_action_pieces_match_reference():
    xyz, r6, g = _rand((9, 3), 5, 2.0), _rand((9, 6), 6, 2.0), _rand((9,), 7, 2.0)
    for rescale in (False, True):
        np.testing.assert_allclose(
            TA._to_range(torch.from_numpy(g), rescale).numpy(),
            np.asarray(JA._to_range(jnp.asarray(g), rescale)), atol=CODEC_ATOL, rtol=0)
    np.testing.assert_allclose(
        TA.normalize_action(*map(torch.from_numpy, (xyz, r6, g))).numpy(),
        np.asarray(JA.normalize_action(*map(jnp.asarray, (xyz, r6, g)))),
        atol=CODEC_ATOL, rtol=0)
    m = _rand((5, 3, 3), 8)
    np.testing.assert_array_equal(TA._rot6d(torch.from_numpy(m)).numpy(),
                                  np.asarray(JA._rot6d(jnp.asarray(m))))


@pytest.mark.parametrize("encode", ["encode_pose_absolute", "encode_pose_relative"])
@pytest.mark.parametrize("T", [14, 2])
def test_pose_codecs_match_reference(encode, T):
    poses = _poses(T, 9)
    out = getattr(TA, encode)(torch.from_numpy(poses))
    ref = np.asarray(getattr(JA, encode)(jnp.asarray(poses)))
    assert out.shape == (T, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=CODEC_ATOL, rtol=0)


@pytest.mark.parametrize("strategy,kind,absolute", [
    ("action_block", "nav", True), ("action_block_nocfg", "nav", True),
    ("micro_cond", "nav", True), ("micro_cond", "pose", True),
    ("micro_cond", "pose", False), (None, "nav", True)])
def test_get_action_ids_matches_reference(strategy, kind, absolute):
    acts = (_nav((3, 14), 10) if kind == "nav"
            else np.stack([_poses(14, s) for s in (11, 12, 13)]))
    ref = np.asarray(JA.get_action_ids(jnp.asarray(acts), strategy, absolute))
    out = TA.get_action_ids(torch.from_numpy(acts), strategy, absolute)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=CODEC_ATOL, rtol=0)


def test_actions_to_prompt_equals_reference():
    acts = _nav((14,), 14, 0, 7)
    assert TA.actions_to_prompt(acts) == JA.actions_to_prompt(acts)
    assert TA.actions_to_prompt(torch.from_numpy(acts)) == JA.actions_to_prompt(acts)


# ---------------------------------------------------------------- modules
def _init(jmod, *args, seed=0):
    """Reference init + seeded numpy perturbation of every leaf (so biases,
    norms and mix factors are off their trivial init)."""
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


def test_action_embedder_block_matches_reference_and_drops_the_sentinel():
    x = np.eye(4, dtype=np.float32)[_nav((3, 5), 15, 0, 4)]
    x[1] = JU.ACTION_DROPPED  # a CFG-dropped sample
    x[2, 0] = JU.ACTION_DROPPED  # one dropped frame alone drops nothing
    jmod = JU.ActionEmbedderBlock(out_dim=24, num_frames=5)
    p = _init(jmod, x)
    ref = np.asarray(jmod.apply({"params": p}, x))
    tmod = TU.ActionEmbedderBlock(24, 5)
    TCV.load_flax_params(torch.nn.ModuleDict({"action_proj": tmod}), {"action_proj": p})
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    # three Dense layers of width <= 512, fp32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert not out[1].any() and np.abs(out[[0, 2]]).min() > 0
    assert TU.ACTION_DROPPED == JU.ACTION_DROPPED == -1.0


def test_action_branch_transformer_matches_reference():
    """TransformerSpatioTemporal with the action branch (a BasicTransformer
    block cross-attending the single action token, merged by
    time_mixer_action): 3 frames of 4x4, two heads of 16, tokens of 20."""
    x, ctx, act = _rand((6, 4, 4, 32), 16), _rand((2, 1, 24), 17), _rand((6, 1, 20), 18)
    jmod = JL.TransformerSpatioTemporal(2, 16, use_action=True)
    p = _init(jmod, x, 3, ctx, act)
    assert "temporal_transformer_blocks_action_0" in p and "time_mixer_action" in p
    ref = np.asarray(jmod.apply({"params": p}, x, 3, ctx, act))
    tmod = TL.TransformerSpatioTemporal(32, 2, 16, 24, action_dim=20)
    TCV.load_flax_params(tmod, p)
    with torch.no_grad():
        out = tmod(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in (x, 3, ctx, act))).numpy()
    # the bound of the layer tests (tests/test_torch_layers.py): 1e-4
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _ab_inputs(B=2, F=3, H=8, W=8):
    x = np.eye(4, dtype=np.float32)[_nav((B, F), 19, 0, 4)]
    x[1] = JU.ACTION_DROPPED
    return dict(
        sample=_rand((B, F, H, W, 8), 20),
        timestep=np.asarray([0.9, -1.2], np.float32)[:B],
        context=_rand((B, 1, TINY_UNET.cross_attention_dim), 21, 0.3),
        added_time_ids=np.tile(np.asarray([[6.0, 127.0, 0.02]], np.float32), (B, 1)),
        action_ids=x)


def reference_tree(module: torch.nn.Module) -> dict:
    """The reference's parameter tree of a port module, by the reference's
    own converter (`wiw_tpu/models/convert.convert_state_dict`)."""
    return _np(JCV.convert_state_dict(
        {k: v.detach().numpy() for k, v in module.state_dict().items()}))


def _port_init(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """flax's initialiser families (the pipeline's `init_weights_`), then
    seeded noise on every parameter so that no bias, norm or mix factor
    sits at its trivial value."""
    init_weights_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return module


@pytest.fixture(scope="module")
def ab_unet():
    """{strategy: (reference config, port module, its reference tree,
    the reference's output)}. The weights are made on the port's side and
    carried to the reference by the reference's converter, which spares a
    reference init."""
    inputs, out = _ab_inputs(), {}
    for strategy in STRATEGIES:
        jcfg = dataclasses.replace(TINY_UNET, action_strategy=strategy)
        tmod = _port_init(TU.UNetSpatioTemporal(port_cfg(TU.UNetConfig, jcfg)), 0)
        params = reference_tree(tmod)
        jmod = JU.UNetSpatioTemporal(jcfg)
        out[strategy] = (jcfg, tmod, params,
                         np.asarray(jax.jit(jmod.apply)({"params": params}, **inputs)))
    return inputs, out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tiny_action_block_unet_matches_reference(ab_unet, strategy):
    inputs, runs = ab_unet
    jcfg, tmod, _, ref = runs[strategy]
    assert tmod.config.uses_action_block
    assert tmod.config.action_attention_dim == jcfg.action_attention_dim
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = tmod(**targs)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # ~40 stacked fp32 convs/matmuls at random weights (test_torch_models)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)
    # the action tokens are live: another action moves only its own row
    acts = inputs["action_ids"].copy()
    acts[0, 2] = np.roll(acts[0, 2], 1)
    with torch.no_grad():
        out2 = tmod(**dict(targs, action_ids=torch.from_numpy(acts)))
    assert not torch.allclose(out[0], out2[0])
    torch.testing.assert_close(out[1], out2[1], rtol=0, atol=0)


def test_action_block_converter_covers_the_tree_both_ways(ab_unet):
    """The port's action_block state dict, converted by the reference,
    covers the reference UNet's parameter tree exactly (names and shapes:
    `validate_converted` against an abstract init); the port's inverse
    grammar gives every key back (`torch_key` checks the round trip) and
    `load_flax_params` loads the tree with full coverage, action_proj's
    pos_embedding, the action branch and its mixer included."""
    inputs, runs = ab_unet
    jcfg, tmod, params, _ = runs["action_block"]
    jmod = JU.UNetSpatioTemporal(jcfg)
    abstract = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), **inputs))
    JCV.validate_converted(params, abstract["params"])
    state = TCV.flax_to_torch(params)
    assert set(state) == set(tmod.state_dict())
    for key in ("action_proj.pos_embedding", "action_proj.layers.4.weight",
                "down_blocks.0.attentions.0.temporal_transformer_blocks_action.0"
                ".attn2.to_v.weight",
                "mid_block.attentions.0.time_mixer_action.mix_factor"):
        assert torch.equal(state[key], tmod.state_dict()[key]), key
    fresh = TCV.load_flax_params(TU.UNetSpatioTemporal(tmod.config), params)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, tmod.state_dict()[key]), key


def _int8_paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _int8_paths(v, prefix + (k,))
        elif np.asarray(v).dtype == np.int8:
            out.add(prefix)
    return out


@pytest.mark.parametrize("modules", ["default", "aggressive"])
def test_action_block_int8_set_equals_reference(ab_unet, modules):
    mods = (JQ.QUANT_KERNEL_MODULES if modules == "default"
            else JQ.QUANT_KERNEL_MODULES_AGGRESSIVE)
    _, runs = ab_unet
    jcfg, _, params, _ = runs["action_block"]
    want = _int8_paths(JQ.quantize_params(params, modules=mods))
    port = TU.UNetSpatioTemporal(port_cfg(TU.UNetConfig, jcfg))
    found = TQ.eligible_modules(port, modules=mods)
    assert {TCV.translate_key(f"{n}.weight")[:-1] for n, _ in found} == want
    # the action branch's feed-forward is in the set, as in the reference
    assert any("temporal_transformer_blocks_action" in n for n, _ in found)


def test_full_width_action_block_int8_count_equals_reference():
    """At SVD† widths the action_block UNet's int8 count equals the
    reference policy's (traced abstractly: no weights are made): 98 of
    micro_cond plus the 16 action branches' GEGLU in-projections."""
    jcfg = JU.UNetConfig(action_strategy="action_block")
    jmod, F = JU.UNetSpatioTemporal(jcfg), jcfg.num_frames

    def quantized_tree():
        params = jmod.init(
            jax.random.PRNGKey(0), sample=jnp.zeros((1, F, 8, 16, jcfg.in_channels)),
            timestep=jnp.zeros((1,)), context=jnp.zeros((1, 1, jcfg.cross_attention_dim)),
            added_time_ids=jnp.zeros((1, 3)), action_ids=jnp.zeros((1, F, 4)))["params"]
        return JQ.quantize_params(params)

    want = JQ.count_quantized(jax.eval_shape(quantized_tree))
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, jcfg), device="cpu")
    assert pipe.quantize_unet() == want == 98 + 16


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("strategy,acts", [
    ("action_block", "nav"), ("action_block_nocfg", "nav"),
    ("micro_cond", "nav"), ("micro_cond", "pose")])
def test_prepare_action_ids_matches_reference(strategy, acts):
    """The CFG-doubled action ids: action_block's uncond half is the
    dropped sentinel, the others repeat the cond half; poses go through the
    absolute pose codec under micro_cond."""
    a = _nav((2, 3), 22) if acts == "nav" else np.stack([_poses(3, 23), _poses(3, 24)])
    jcfg = dataclasses.replace(TINY_UNET, action_strategy=strategy,
                               action_input_channel=10 if acts == "pose" else 3)
    ref = np.asarray(JPipe(jcfg, TINY_VAE, TINY_CLIP)._prepare_action_ids(
        jnp.asarray(a), 2, None))
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, jcfg), port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    out = pipe._prepare_action_ids(torch.from_numpy(a))
    np.testing.assert_allclose(out.numpy(), ref, atol=CODEC_ATOL, rtol=0)


@pytest.mark.parametrize("strategy,acts", [("action_block", "nav"),
                                           ("micro_cond", "pose")])
def test_generate_matches_reference(strategy, acts):
    """A tiny generate with SERVING_CFG at 4 steps (segments full 0-3,
    stale 3-4): action_block with nav ids (the sentinel uncond half), and
    the manipulation world (micro_cond, 10 channels, absolute pose codec,
    task_type manipulation). The same init latents injected and
    noise_aug_strength 0, so no random draw of either side enters."""
    jcfg = dataclasses.replace(
        TINY_UNET, action_strategy=strategy,
        action_input_channel=10 if acts == "pose" else 3,
        cross_attention_dim=TINY_CLIP.projection_dim)
    task = "manipulation" if acts == "pose" else "navigation"
    jgen = JGen(height=32, width=32, num_frames=3, num_inference_steps=4,
                noise_aug_strength=0.0, cfg=J_SERVING_CFG, task_type=task)
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, jcfg), port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    jpipe = JPipe(jcfg, TINY_VAE, TINY_CLIP,
                  params={k: reference_tree(t) for k, t in
                          (("unet", pipe.unet), ("vae", pipe.vae), ("clip", pipe.clip))})
    rng = np.random.default_rng(25)
    image = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    a = np.asarray([[4, 2, 3]]) if acts == "nav" else _poses(3, 26)[None]
    noise = rng.standard_normal((1, 3, 16, 16, 4)).astype(np.float32)
    ref = np.asarray(jpipe.generate(jax.random.PRNGKey(1), image, jgen,
                                    actions=jnp.asarray(a), init_latents=noise))
    gen = GenerationConfig(height=32, width=32, num_frames=3, num_inference_steps=4,
                           noise_aug_strength=0.0, cfg=TS.SERVING_CFG, task_type=task)
    out = pipe.generate(torch.from_numpy(image), gen, actions=torch.from_numpy(a),
                        init_latents=torch.from_numpy(noise)).numpy()
    assert out.shape == ref.shape == (1, 3, 32, 32, 3)
    # the slice test's bound (tests/test_torch_pipeline.py): 1e-4 on [0, 1]
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
