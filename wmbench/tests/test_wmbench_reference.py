"""The plain reference against the system under test at a tiny size on the
CPU: the same weights by name, the same inputs; and the reference's W8A8
rule against the port's int8 layers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from wmbench.reference import svd as ref
from wmbench.tests import tiny


def port_pipe(cfg, quantize=False, dtype="float32"):
    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    def cast(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    u = dict(cast(cfg["unet"]), dtype=dtype)
    v = dict(cast(cfg["vae"]), dtype=dtype)
    pipe = SVDPipeline(UNetConfig(**u), VAEConfig(**v), CLIPVisionConfig(**cfg["clip"]),
                       device="cpu")
    if quantize:
        pipe.quantize_unet()
    spec = ref.param_spec(cfg)
    towers = {t: ref.make_tower(spec[t], t, 3, torch.float32, "cpu") for t in spec}
    pipe.load_state_dicts(towers["unet"], towers["vae"], towers["clip"])
    P = {k: v for t in towers.values() for k, v in t.items()}
    return pipe, P


@pytest.fixture(scope="module")
def cfg():
    return tiny.config("svd_dagger_int8")


def test_spec_matches_the_port_at_full_size():
    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline
    import json

    full = json.loads((tiny.HERE / "configs" / "svd_dagger_int8.json").read_text())
    cast = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa
    pipe = SVDPipeline(UNetConfig(**cast(full["unet"])), VAEConfig(**cast(full["vae"])),
                       CLIPVisionConfig(**full["clip"]), device="cpu")
    spec = ref.param_spec(full)
    for name, tower in (("unet", pipe.unet), ("vae", pipe.vae), ("clip", pipe.clip)):
        got = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
        assert got == {k: tuple(s) for k, (s, _) in spec[name].items()}
    assert sum(ref.Quant("int8").applies(n[:-len(".weight")])
               for n in spec["unet"] if n.endswith(".weight")) == pipe.quantize_unet() == 98


def test_towers_match_the_port(cfg):
    pipe, P = port_pipe(cfg)
    g = torch.Generator().manual_seed(0)
    u, F_ = cfg["unet"], cfg["unet"]["num_frames"]
    x = torch.randn(2, F_, 8, 16, 8, generator=g)
    t = torch.tensor([0.3, -0.5])
    ctxe = torch.randn(2, 1, 32, generator=g)
    aug = torch.tensor([0.02, 0.02])
    acts = torch.tensor([[1, 2, 3], [1, 1, 3]])
    codes = ref.encode_idx(acts)
    want = ref.unet(P, u, x, t, ctxe, aug, codes)
    atids = torch.stack([torch.full((2,), 6.0), torch.full((2,), 127.0), aug], dim=1)
    from wiw_tpu_torch.core.actions import get_action_ids

    got = pipe.unet(x, t, ctxe, atids, get_action_ids(acts, "micro_cond"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    img = torch.rand(2, 16, 32, 3, generator=g) * 2 - 1
    eps = torch.randn(2, 8, 16, 4, generator=g)
    torch.testing.assert_close(pipe.vae.encode(img, eps=eps), ref.vae_encode(P, cfg["vae"], img, eps),
                               rtol=1e-4, atol=1e-4)
    z = torch.randn(F_, 8, 16, 4, generator=g)
    torch.testing.assert_close(pipe.vae.decode(z, F_), ref.vae_decode(P, cfg["vae"], z, F_),
                               rtol=1e-4, atol=1e-4)
    from wiw_tpu_torch.models.clip import preprocess_for_clip

    torch.testing.assert_close(pipe.clip(preprocess_for_clip(img)), ref.clip_embed(P, cfg["clip"], img),
                               rtol=1e-4, atol=1e-4)


def test_int8_rule_matches_the_port(cfg):
    pipe, P = port_pipe(cfg, quantize=True)
    g = torch.Generator().manual_seed(1)
    F_ = cfg["unet"]["num_frames"]
    x = torch.randn(2, F_, 8, 16, 8, generator=g)
    t, aug = torch.tensor([0.3, -0.5]), torch.tensor([0.02, 0.02])
    ctxe = torch.randn(2, 1, 32, generator=g)
    acts = torch.tensor([[1, 2, 3], [1, 1, 3]])
    atids = torch.stack([torch.full((2,), 6.0), torch.full((2,), 127.0), aug], dim=1)
    from wiw_tpu_torch.core.actions import get_action_ids

    got = pipe.unet(x, t, ctxe, atids, get_action_ids(acts, "micro_cond"))
    want = ref.unet(P, cfg["unet"], x, t, ctxe, aug, ref.encode_idx(acts), ref.Quant("int8"))
    plain = ref.unet(P, cfg["unet"], x, t, ctxe, aug, ref.encode_idx(acts))
    int4 = ref.unet(P, cfg["unet"], x, t, ctxe, aug, ref.encode_idx(acts), ref.Quant("int4"))

    def rms(a, b):
        return ((a - b) ** 2).mean().sqrt().item()

    # int8 codes flip on rounding-level differences and the flips carry on,
    # so the rule agrees with the port well below int8's own error, and
    # the control's int4 lies an order of magnitude further out
    assert rms(got, want) < 0.8 * rms(want, plain)
    assert rms(int4, want) > 10 * rms(got, want)


def test_resize_matches_the_port():
    """The port builds JAX's matrix in float32 arithmetic, the reference in
    float64: they agree to float32's rounding of the sample positions."""
    from wiw_tpu_torch.ops.resize import weight_matrix

    for n_in, n_out in ((576, 224), (1024, 224), (576, 480), (1024, 480), (16, 8)):
        np.testing.assert_allclose(ref.resize_matrix(n_in, n_out),
                                   weight_matrix(n_in, n_out, "cubic"), atol=1e-4)


def test_weights_are_made_from_the_seed_in_few_draws(cfg):
    spec = ref.param_spec(cfg)["unet"]
    a = ref.make_tower(spec, "unet", 11, torch.float32, "cpu")
    b = ref.make_tower(spec, "unet", 11, torch.float32, "cpu")
    c = ref.make_tower(spec, "unet", 12, torch.float32, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if spec[k][1][0] == "normal")
    assert len(ref.chunk_plan(spec)) == 1
    big = ref.param_spec(tiny.json.loads((tiny.HERE / "configs" / "svd_dagger_int8.json").read_text()))
    assert len(ref.chunk_plan(big["unet"])) <= 8
