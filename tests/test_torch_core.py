"""Port parity: wiw_tpu_torch.core against wiw_tpu.core on the CPU.

Inputs come from numpy seeds and go through both packages. Tolerances:
schedule math is elementwise fp32 in both, so 2e-6 relative (the two
libraries' fp32 pow/exp differ by up to two ulp); the Karras ladder gets
1e-5, since near sigma_min the base of the pow is a difference of close
numbers and rho = 7 multiplies its rounding. Codecs and noise rolls move
values without arithmetic, so they must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiw_tpu.core import actions as JA
from wiw_tpu.core import noise as JN
from wiw_tpu.core import schedule as JS
from wiw_tpu_torch.core import actions as TA
from wiw_tpu_torch.core import noise as TN
from wiw_tpu_torch.core import schedule as TS

torch.set_num_threads(1)

RTOL = 2e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("steps", [1, 4, 25, 30])
def test_karras_sigmas(steps):
    ref = np.asarray(JS.karras_sigmas(steps))
    out = TS.karras_sigmas(steps).numpy()
    assert out.dtype == np.float32 and out.shape == (steps + 1,)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(TS.karras_sigmas_np(steps),
                                  JS.karras_sigmas_np(steps))


@pytest.mark.parametrize("steps,cfg", [
    (25, JS.SERVING_CFG), (4, JS.SERVING_CFG), (30, JS.CFGSchedule()),
    (25, JS.CFGSchedule(tail_sigma=1.0, tail_policy="cond")),
    (25, JS.CFGSchedule(tail_sigma=6.4, tail_policy="alt", head_sigma=300.0)),
])
def test_cfg_row_segments(steps, cfg):
    port = TS.CFGSchedule(cfg.tail_sigma, cfg.tail_policy, cfg.head_sigma)
    assert TS.cfg_row_segments(steps, port) == JS.cfg_row_segments(steps, cfg)


def test_serving_cfg_segments_at_25_and_4_steps():
    assert TS.SERVING_CFG == TS.CFGSchedule(0.2, "stale")
    assert TS.cfg_row_segments(25, TS.SERVING_CFG) == (
        ("full", 0, 20), ("stale", 20, 25))
    assert TS.cfg_row_segments(4, TS.SERVING_CFG) == (
        ("full", 0, 3), ("stale", 3, 4))
    with pytest.raises(ValueError):
        TS.CFGSchedule(tail_policy="bogus")


def test_elementwise_schedule_functions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    den = rng.standard_normal(x.shape).astype(np.float32)
    sigma = np.float32(3.7)
    sigma_next = np.float32(1.2)
    pairs = [
        (JS.sigma_to_t(jnp.asarray(sigma)), TS.sigma_to_t(_t(sigma))),
        (JS.precondition_inputs(x, sigma), TS.precondition_inputs(_t(x), _t(sigma))),
        (JS.precondition_outputs(den, x, sigma),
         TS.precondition_outputs(_t(den), _t(x), _t(sigma))),
        (JS.euler_step(x, den, sigma, sigma_next),
         TS.euler_step(_t(x), _t(den), _t(sigma), _t(sigma_next))),
        (JS.guidance_scales(14), TS.guidance_scales(14)),
        (JS.guidance_scales(3, 1.5, 2.5), TS.guidance_scales(3, 1.5, 2.5)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("dim", [320, 256, 16])
def test_timestep_embedding(dim):
    t = np.random.default_rng(1).uniform(-2, 2, (3, 5)).astype(np.float32)
    ref = JS.timestep_embedding(jnp.asarray(t), dim)
    out = TS.timestep_embedding(_t(t), dim)
    assert out.shape == (3, 5, dim) and out.dtype == torch.float32
    # sin/cos of arguments up to ~2e0: fp32 libm differences stay ~1e-6
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-6)


def test_micro_cond_action_ids():
    acts = np.random.default_rng(2).integers(0, 5, (3, 14))
    ref = np.asarray(JA.get_action_ids(jnp.asarray(acts), "micro_cond"))
    out = TA.get_action_ids(_t(acts), "micro_cond")
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(TA.encode_idx(_t(acts)).numpy(),
                                  np.asarray(JA.encode_idx(jnp.asarray(acts))))
    with pytest.raises(NotImplementedError):
        TA.get_action_ids(_t(acts), "action_block")


@pytest.mark.parametrize("angle,width", [
    (22.5, 128), (-22.5, 128), (45.0, 64), (90.0, 16), (0.0, 7), (360.0, 9)])
def test_rotation_shift_and_rotate_pano(angle, width):
    assert TN.rotation_shift(angle, width) == JN.rotation_shift(angle, width)
    x = np.arange(2 * 3 * width, dtype=np.float32).reshape(2, 3, width)
    np.testing.assert_array_equal(TN.rotate_pano(_t(x), angle).numpy(),
                                  np.asarray(JN.rotate_pano(jnp.asarray(x), angle)))


def test_rotation_shift_rejects():
    for args in [(10.0, 128), (22.5, 100)]:
        with pytest.raises(ValueError):
            TN.rotation_shift(*args)


def _jax_noise_with_fresh(actions, fresh, monkeypatch):
    """Run the reference sample_latent_noise with its base draw replaced by
    `fresh` (the only random input)."""
    monkeypatch.setattr(JN.jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(fresh, dtype))
    return np.asarray(JN.sample_latent_noise(
        JN.jax.random.PRNGKey(0), jnp.asarray(actions), fresh.shape))


@pytest.mark.parametrize("width", [32, 12])
def test_sample_latent_noise_injected(width, monkeypatch):
    rng = np.random.default_rng(3)
    actions = np.array([[4, 2, 2, 1, 3, 3], [4, 1, 3, 2, 0, 2]])
    fresh = rng.standard_normal((2, 6, 4, 3, width)).astype(np.float32)
    ref = _jax_noise_with_fresh(actions, fresh, monkeypatch)
    out = TN.sample_latent_noise(_t(actions), fresh.shape, fresh=_t(fresh))
    np.testing.assert_array_equal(out.numpy(), ref)
    if width == 32:  # turns really roll the previous frame
        np.testing.assert_array_equal(out[0, 1].numpy(),
                                      np.roll(fresh[0, 0], 2, axis=-1))


def test_sample_latent_noise_generator_shape_and_seed():
    actions = torch.tensor([[4, 2, 1]])
    a = TN.sample_latent_noise(actions, (1, 3, 4, 2, 16),
                               generator=torch.Generator().manual_seed(5))
    b = TN.sample_latent_noise(actions, (1, 3, 4, 2, 16),
                               generator=torch.Generator().manual_seed(5))
    assert a.shape == (1, 3, 4, 2, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a[0, 1], torch.roll(a[0, 0], 1, dims=-1),
                               rtol=0, atol=0)
