"""Port parity: the UNet, VAE and CLIP towers, and the weight converter.

The reference initialises each tiny tower (TINY_UNET / TINY_VAE / TINY_CLIP
of tests/test_models.py), `flax_to_torch` carries the weights into the
port, and the same numpy inputs go through both, fp32 on the CPU with JAX
matmuls pinned to fp32. Tolerances are stated per test from the depth of
the tower: each conv/matmul adds ~1e-7 relative reordering error, and the
random-weight towers amplify it layer over layer.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_models import TINY_CLIP, TINY_UNET, TINY_VAE
from wiw_tpu.models import convert as JCV
from wiw_tpu.models.clip import CLIPVisionModel as JCLIP
from wiw_tpu.models.clip import preprocess_for_clip as jax_preprocess
from wiw_tpu.models.unet import UNetConfig as JUNetConfig
from wiw_tpu.models.unet import UNetSpatioTemporal as JUNet
from wiw_tpu.models.vae import AutoencoderKLTemporal as JVAE
from wiw_tpu.models.vae import VAEConfig as JVAEConfig
from wiw_tpu_torch.models import clip as TC
from wiw_tpu_torch.models import convert as TCV
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.models import vae as TV

torch.set_num_threads(1)


def port_cfg(cls, jcfg, **over):
    """The port's config with the reference config's shared fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    kw.update(over)
    return cls(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


MICRO_UNET = dataclasses.replace(TINY_UNET, action_strategy="micro_cond",
                                 action_input_channel=3)


def _unet_inputs(B=2, H=8, W=8):
    F = MICRO_UNET.num_frames
    acts = np.asarray([[[4, 0, 0], [4, 2, 0], [4, 2, 1]],
                       [[4, 0, 0], [4, 3, 0], [4, 3, 3]]], np.float32)[:B]
    return dict(
        sample=_rand((B, F, H, W, MICRO_UNET.in_channels), 1),
        timestep=np.asarray([0.9, -1.2], np.float32)[:B],
        context=_rand((B, 1, MICRO_UNET.cross_attention_dim), 2, 0.3),
        added_time_ids=np.tile(np.asarray([[6.0, 127.0, 0.02]], np.float32), (B, 1)),
        action_ids=acts,
    )


def _unet_parity(jcfg, inputs):
    jmod = JUNet(jcfg)
    params = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), **inputs)["params"])
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, **inputs))
    tmod = TCV.load_flax_params(
        TU.UNetSpatioTemporal(port_cfg(TU.UNetConfig, jcfg)), params)
    with torch.no_grad():
        out = tmod(**{k: None if v is None else torch.from_numpy(v)
                      for k, v in inputs.items()})
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # ~40 stacked fp32 convs/matmuls at random weights: 2e-4 absolute on
    # outputs of magnitude ~1
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)
    return tmod, out


class TestUNet:
    def test_tiny_unet_without_actions_matches_reference(self):
        _unet_parity(TINY_UNET, dict(_unet_inputs(), action_ids=None))

    def test_tiny_unet_micro_cond_matches_reference(self):
        inputs = _unet_inputs()
        tmod, out = _unet_parity(MICRO_UNET, inputs)
        # the action conditioning is live in the port too
        acts2 = inputs["action_ids"].copy()
        acts2[0, 2, 2] = 3.0
        with torch.no_grad():
            out2 = tmod(**{k: torch.from_numpy(v) for k, v in
                           dict(inputs, action_ids=acts2).items()})
        assert not torch.allclose(out[0], out2[0])
        torch.testing.assert_close(out[1], out2[1], rtol=0, atol=0)

    def test_port_config_refuses_unported_strategies(self):
        with pytest.raises(NotImplementedError):
            TU.UNetConfig(action_strategy="action_block")


class TestVAE:
    def test_encode_and_decode_match_reference(self):
        frames = np.random.default_rng(3).uniform(-1, 1, (6, 16, 16, 3)).astype(
            np.float32)  # B=2, F=3
        jmod = JVAE(TINY_VAE)
        params = _np(jax.jit(jmod.init, static_argnums=2)(
            jax.random.PRNGKey(0), frames, 3)["params"])
        tmod = TCV.load_flax_params(TV.AutoencoderKLTemporal(
            port_cfg(TV.VAEConfig, TINY_VAE)), params)

        ref_z = np.asarray(jmod.apply({"params": params}, frames,
                                      method=jmod.encode))
        with torch.no_grad():
            z = tmod.encode(torch.from_numpy(frames))
        # encoder: ~12 convs + one attention, fp32: 1e-4
        np.testing.assert_allclose(z.numpy(), ref_z, atol=1e-4, rtol=1e-4)

        lat = _rand((6, 8, 8, 4), 4)
        ref_v = np.asarray(jmod.apply({"params": params}, lat, 3,
                                      method=jmod.decode))
        with torch.no_grad():
            video = tmod.decode(torch.from_numpy(lat), 3)
        assert video.shape == (2, 3, 16, 16, 3) and video.dtype == torch.float32
        # decoder: ~30 convs incl. temporal, fp32: 2e-4
        np.testing.assert_allclose(video.numpy(), ref_v, atol=2e-4, rtol=2e-4)

    def test_decode_chunks_are_temporal_units(self):
        """Decoding 3 frames as one chunk differs from 1+2: the chunk size
        is part of the output (why resolved_decode_chunk is kept exactly)."""
        tmod = TV.AutoencoderKLTemporal(port_cfg(TV.VAEConfig, TINY_VAE))
        from wiw_tpu_torch.sampling.pipeline import init_weights_

        init_weights_(tmod, torch.Generator().manual_seed(0))
        lat = torch.from_numpy(_rand((3, 8, 8, 4), 5))
        with torch.no_grad():
            whole = tmod.decode(lat, 3)
            split = torch.cat([tmod.decode(lat[:1], 1), tmod.decode(lat[1:], 2)], 1)
        assert not torch.allclose(whole, split)


class TestCLIP:
    def test_clip_matches_reference(self):
        images = np.random.default_rng(6).uniform(-1, 1, (2, 40, 72, 3)).astype(
            np.float32)
        ref_pix = np.asarray(jax_preprocess(jnp.asarray(images)))
        pix = TC.preprocess_for_clip(torch.from_numpy(images))
        # resize + normalise: 1e-5 relative on values ~2
        np.testing.assert_allclose(pix.numpy(), ref_pix, atol=3e-5, rtol=1e-5)

        jmod = JCLIP(TINY_CLIP)
        params = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), ref_pix)["params"])
        ref = np.asarray(jmod.apply({"params": params}, ref_pix))
        tmod = TCV.load_flax_params(
            TC.CLIPVisionModel(port_cfg(TC.CLIPVisionConfig, TINY_CLIP)), params)
        with torch.no_grad():
            out = tmod(torch.from_numpy(np.array(ref_pix)))
        assert out.shape == (2, TINY_CLIP.projection_dim)
        # 2 layers; flax LayerNorm uses E[x^2]-E[x]^2, the port two-pass: 1e-4
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- weights
def _full_width_towers():
    with torch.device("meta"):
        return {
            "unet": TU.UNetSpatioTemporal(TU.UNetConfig(action_strategy="micro_cond")),
            "vae": TV.AutoencoderKLTemporal(TV.VAEConfig()),
            "clip": TC.CLIPVisionModel(TC.CLIPVisionConfig()),
        }


@pytest.mark.parametrize("tower", ["unet", "vae", "clip"])
def test_translate_key_matches_reference_on_full_width_keys(tower):
    keys = list(_full_width_towers()[tower].state_dict())
    assert len(keys) > 300
    for k in keys:
        assert TCV.translate_key(k) == JCV.translate_key(k), k
        assert TCV.torch_key(TCV.translate_key(k)) == k


def test_full_width_unet_keys_cover_reference_tree():
    """Every leaf of the reference's full-width micro_cond UNet has exactly
    one port parameter of the converted shape, and nothing is left over
    (shapes from jax.eval_shape: nothing is allocated)."""
    jcfg = JUNetConfig(action_strategy="micro_cond")
    shapes = jax.eval_shape(lambda k: JUNet(jcfg).init(
        k, sample=jnp.zeros((1, 14, 8, 8, 8)), timestep=jnp.zeros((1,)),
        context=jnp.zeros((1, 1, 1024)), added_time_ids=jnp.zeros((1, 3)),
        action_ids=jnp.zeros((1, 14, 14))), jax.random.PRNGKey(0))["params"]
    ref = {p: tuple(v.shape) for p, v in
           TCV._flatten(jax.tree_util.tree_map(lambda s: s, shapes))}
    port = {}
    for k, v in _full_width_towers()["unet"].state_dict().items():
        path = TCV.translate_key(k)
        port[path] = tuple(TCV.convert_tensor(path, np.empty(v.shape, np.bool_)).shape)
    assert port == ref


def test_convert_tensor_layouts_roundtrip():
    rng = np.random.default_rng(7)
    for shape, leaf in [((5, 4, 3, 3), "kernel"), ((5, 4, 3, 1, 1), "kernel"),
                        ((5, 4), "kernel"), ((5,), "bias"), ((5,), "scale")]:
        a = rng.standard_normal(shape).astype(np.float32)
        path = ("m", leaf)
        np.testing.assert_array_equal(
            TCV.convert_tensor(path, a), JCV.convert_tensor(path, a))
        np.testing.assert_array_equal(
            TCV.unconvert_tensor(path, TCV.convert_tensor(path, a)), a)


def test_load_flax_params_requires_full_coverage():
    mod = TV.VAEAttention(8)
    tree = {"group_norm": {"scale": np.ones(8), "bias": np.zeros(8)},
            "to_q": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)},
            "to_k": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)},
            "to_v": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)},
            "to_out_0": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)}}
    TCV.load_flax_params(mod, tree)
    missing = {k: v for k, v in tree.items() if k != "to_v"}
    with pytest.raises(ValueError, match="missing"):
        TCV.load_flax_params(mod, missing)
    extra = dict(tree, to_w={"kernel": np.zeros((8, 8))})
    with pytest.raises(ValueError, match="unexpected"):
        TCV.load_flax_params(mod, extra)
    with pytest.raises(ValueError, match=re.escape("no torch key")):
        TCV.flax_to_torch({"weird": {"kernel": np.zeros(2)}, "kernel": np.zeros(1)})
