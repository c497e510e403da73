"""The NWM world model on PyTorch (`wiw_tpu_torch.models.cdit`,
`models/convert.cdit_flax_to_torch`, `workers/nwm_worker`) against the
reference (`wiw_tpu.models.cdit`, `convert_cdit_state_dict`,
`wiw_tpu.workers.nwm_worker`) on the CPU.

The tiny CDiT has hidden 144 over 2 heads, so head_dim 72, the XL model's
(1152 / 16): on the CPU the attention is K1's plain version, which the card
holds the D = 72 kernel against. Weights are the reference's flax init,
carried to the port by `load_cdit_flax_params`; inputs come from numpy
seeds. Tolerances:
  * fp32 forward: relative Frobenius 1e-5 (JAX's matmuls pinned to fp32 by
    tests/conftest.py; the two differ only in the order of their sums);
  * bf16 forward: 2e-2 (both round at the same places, to bf16, from sums
    taken in another order; a wrong layout or modulation is off by O(1));
  * DDIM at 5 steps, fp32: 2e-4. The forwards agree within ~1e-6, but the
    first step divides eps's error by sqrt(alphas_bar[999]) = 0.0064 (x 157)
    before the clip, and XLA rewrites the step's divisions where the port
    divides; its tables (timesteps, alphas_bar) equal to the bit;
  * the worker's uint8 frames, fp32: within 1 LSB on >= 99% of the values
    (the reference truncates to uint8, so a value near an integer may fall
    either side).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wiw_tpu.models import cdit as JC
from wiw_tpu.models.convert import convert_cdit_state_dict, validate_converted
from wiw_tpu_torch.models import cdit as TC
from wiw_tpu_torch.models.convert import cdit_flax_to_torch, load_cdit_flax_params

torch.set_num_threads(1)

TINY = dict(input_size=8, context_size=2, patch_size=2, in_channels=4,
            hidden_size=144, depth=2, num_heads=2)


def _inputs(B=2, seed=0):
    rng = np.random.default_rng(seed)
    n, c = TINY["input_size"], TINY["context_size"]
    return dict(
        x=rng.standard_normal((B, n, n, 4)).astype(np.float32),
        t=np.array([500.0, 17.0][:B], np.float32),
        action_xya=rng.standard_normal((B, 3)).astype(np.float32),
        x_cond=rng.standard_normal((B, c, n, n, 4)).astype(np.float32),
        rel_t=np.array([0.25, 0.75][:B], np.float32))


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_model():
    """The reference's tiny CDiT and its flax init (numpy leaves)."""
    model = JC.CDiT(JC.CDiTConfig(**TINY))
    inp = _inputs()
    params = model.init(jax.random.PRNGKey(0), *(jnp.asarray(inp[k]) for k in
                                                 ("x", "t", "action_xya",
                                                  "x_cond", "rel_t")))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params, dtype="float32"):
    model = TC.CDiT(TC.CDiTConfig(**TINY, dtype=dtype))
    return load_cdit_flax_params(model, params).eval()


def _jax_out(params, inp, dtype="float32"):
    model = JC.CDiT(JC.CDiTConfig(**TINY, dtype=dtype))
    return np.asarray(model.apply(params, *(jnp.asarray(inp[k]) for k in (
        "x", "t", "action_xya", "x_cond", "rel_t"))))


def _torch_out(model, inp):
    with torch.no_grad():
        return model(*(torch.from_numpy(inp[k]) for k in (
            "x", "t", "action_xya", "x_cond", "rel_t"))).numpy()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_forward_matches_reference(jax_model, dtype, tol):
    _, params = jax_model
    inp = _inputs(seed=1)
    ref = _jax_out(params, inp, dtype)
    out = _torch_out(_port(params, dtype), inp)
    assert out.shape == ref.shape == (2, 8, 8, 8) and out.dtype == np.float32
    assert _rel_fro(out, ref) <= tol


def test_action_and_context_change_the_output(jax_model):
    model = _port(jax_model[1])
    inp = _inputs(seed=2)
    base = _torch_out(model, inp)
    for key in ("action_xya", "x_cond"):
        moved = dict(inp, **{key: inp[key] + 1.0})
        assert _rel_fro(_torch_out(model, moved), base) > 1e-3, key


@pytest.mark.parametrize("n", [1, 5, 10, 20, 25, 30, 50, 100, 250])
def test_ddim_tables_are_the_references(n):
    ts, alphas_bar = TC.ddim_tables(n)
    ref_ts = np.asarray(jnp.linspace(999, 0, n).astype(jnp.int32))
    ref_ab = np.asarray(jnp.cumprod(1.0 - JC.linear_betas(1000)))
    assert ts.dtype == np.int32 and np.array_equal(ts, ref_ts)
    assert alphas_bar.dtype == np.float32
    assert np.array_equal(alphas_bar, ref_ab)
    assert np.array_equal(TC.linear_betas(), np.asarray(JC.linear_betas(1000)))


def test_cumprod_f32_is_xlas_order():
    """The blocked order at other lengths (one, two and three levels), on
    factors near 1 as the schedule's are (XLA flushes subnormal products to
    zero, numpy does not: products that small never occur here)."""
    rng = np.random.default_rng(3)
    for n in (1, 7, 16, 17, 300, 1000, 4096):
        x = rng.uniform(0.99, 1.01, n).astype(np.float32)
        assert np.array_equal(TC.cumprod_f32(x), np.asarray(jnp.cumprod(x))), n


def test_ddim_sample_matches_reference(jax_model):
    model, params = jax_model
    inp = _inputs(seed=4)
    shape = (2, 8, 8, 4)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JC.ddim_sample(
        lambda p, x, t, a, xc, rt: model.apply(p, x, t, a, xc, rt), params,
        key, shape, x_cond=jnp.asarray(inp["x_cond"]),
        action_xya=jnp.asarray(inp["action_xya"]),
        rel_t=jnp.asarray(inp["rel_t"]), num_steps=5))
    noise = torch.from_numpy(np.array(jax.random.normal(key, shape)))
    port = _port(params)
    with torch.no_grad():
        out = TC.ddim_sample(port, shape, torch.from_numpy(inp["x_cond"]),
                             torch.from_numpy(inp["action_xya"]),
                             torch.from_numpy(inp["rel_t"]), num_steps=5,
                             noise=noise).numpy()
    assert np.isfinite(out).all()
    assert _rel_fro(out, ref) <= 2e-4


def test_converter_round_trip(jax_model):
    """The reference's params -> `cdit_flax_to_torch` -> a strict load into
    the port; the port's state dict -> the reference's
    `convert_cdit_state_dict` -> the same params, bit for bit, covering
    the reference's tree exactly (`validate_converted`)."""
    params = jax_model[1]["params"]
    state = cdit_flax_to_torch(params)
    assert set(state) == set(cdit_flax_to_torch({"params": params}))
    model = TC.CDiT(TC.CDiTConfig(**TINY))
    model.load_state_dict(state, strict=True)
    assert state["blocks.0.cttn.in_proj_weight"].shape == (3 * 144, 144)
    assert state["blocks.1.cttn.bias_k"].shape == (1, 1, 144)
    assert state["x_embedder.proj.weight"].shape == (144, 4, 2, 2)
    back = convert_cdit_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    validate_converted(back, params)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_ref:
        assert np.array_equal(np.asarray(flat_back[path]), leaf), path
    with pytest.raises(ValueError, match="no NWM key"):
        cdit_flax_to_torch({**params, "stray": {"kernel": np.zeros(2)}})
    missing = {k: v for k, v in params.items() if k != "pos_embed"}
    with pytest.raises(ValueError, match="missing"):
        load_cdit_flax_params(TC.CDiT(TC.CDiTConfig(**TINY)), missing)


def test_worker_generate_matches_reference(jax_model):
    """The port's `NWMWorker.generate` against the reference's on the tiny
    CDiT and `TINY_VAE` (spatial scale 2: 16x16 images, 8x8 latents), fp32,
    3 frames of 2 DDIM steps, the same weights and, frame by frame, the
    reference's draws from its key splits. The reference worker is built
    with `object.__new__` and its attributes set (its own __init__ builds
    the full-size models)."""
    import dataclasses

    from test_models import TINY_VAE

    from wiw_tpu.models.convert import convert_state_dict
    from wiw_tpu.models.vae import AutoencoderKLTemporal as JVAE
    from wiw_tpu.workers.nwm_worker import NWMWorker as JNWM
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.workers import nwm_worker as TW

    model, params = jax_model
    size, B, F, steps = 16, 2, 3, 2
    jw = object.__new__(JNWM)
    jw.width = jw.height = size
    jw.cfg, jw.model, jw.num_steps = JC.CDiTConfig(**TINY), model, steps
    jw.vae = JVAE(TINY_VAE)
    jw.params = params
    jw._key = jax.random.PRNGKey(0)
    noise, key = [], jax.random.PRNGKey(0)
    for _ in range(F - 1):  # the reference's draws, as its generate splits
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (B, 8, 8, 4))))

    vae_cfg = VAEConfig(**{f.name: getattr(TINY_VAE, f.name)
                           for f in dataclasses.fields(VAEConfig)})
    tw = TW.NWMWorker(image_size=size, num_steps=steps, device="cpu",
                      cdit_config=TC.CDiTConfig(**TINY), vae_config=vae_cfg)
    load_cdit_flax_params(tw.model, params)
    # the VAE's random weights go the other way (the reference's init
    # would compile op by op)
    jw.vae_params = convert_state_dict(
        {k: v.numpy() for k, v in tw.vae.state_dict().items()})

    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    actions = rng.integers(0, 5, (B, F))
    ref = jw.generate(images, actions, None)
    out = tw.generate(images, actions, None, noise=np.stack(noise))
    assert out.shape == ref.shape == (B, F, size, size, 3)
    assert out.dtype == np.uint8
    assert np.array_equal(out[:, 0], images)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.99, np.bincount(diff.ravel())
    assert len(np.unique(out[:, 1:])) > 16  # not a constant or clipped frame
    assert np.allclose(TW.action_deltas([1, 2, 3, 4, 0, 9])[:, [0, 2]],
                       [[0.2, 0], [0, np.pi / 8], [0, -np.pi / 8], [0, 0],
                        [0, 0], [0, 0]])


def test_worker_answers_the_serving_contract(capsys):
    """The port's worker on random weights (tiny models, the CPU) answers an
    input dict as the manager sends it: the image resized to its size, one
    frame an action, frames returned in-band at the output size."""
    import dataclasses

    from test_models import TINY_VAE

    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.workers.nwm_worker import NWMWorker

    vae_cfg = VAEConfig(**{f.name: getattr(TINY_VAE, f.name)
                           for f in dataclasses.fields(VAEConfig)})
    worker = NWMWorker(image_size=16, num_steps=2, device="cpu",
                       cdit_config=TC.CDiTConfig(**TINY), vae_config=vae_cfg)
    assert "random-init" in capsys.readouterr().out
    out = worker({"b_action": np.array([[1, 2, 3]]),
                  "b_image": np.zeros((1, 3, 20, 20), np.uint8),
                  "save_dirs": ["d0"], "return_objects": [True]})
    assert out["save_dirs"] == ["d0"]
    assert out["pred_frames"].shape == (1, 3, 3, 480, 480)
    assert out["pred_frames"].dtype == np.uint8
