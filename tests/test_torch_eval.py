"""Port parity: the evaluation towers and CLIs, and the multi-token
cross-attention that `past_images` gives the UNet.

Random weights written in the upstream key layouts (the lpips heads with
torchvision's AlexNet trunk; pytorch-i3d's `i3d_pretrained_400.pt`) load
into both packages, as tests/test_eval_exactness.py does for the reference
alone; each test holds the port to `wiw_tpu` on the same inputs:
  * the manifest's verdicts on a full, a partial and a mis-shaped dict
  * LPIPS distances (1e-5 absolute, 1e-4 relative: fp32 convolutions)
  * I3D's pooled features and logits (2e-4, the reference's own bound
    against its torch golden), `FVDEvaluator.features` with JAX's
    antialiased bilinear resize to 224x224, and FVD
  * `frechet_distance` (1e-4 relative: fp32 eigendecompositions)
  * `evaluate_video_metrics` with LPIPS configured and not
  * `video_metrics_cli` on the same PNG clips (PSNR and SSIM 1e-5
    relative, LPIPS 1e-4, each with 1e-6 absolute; FVD 2e-3 absolute, see
    the test);
    `inference_cli` and `eval_cli` at
    tiny widths (keys, shapes, files)
  * `CrossAttention` with a multi-token context on 3-D (spatial) and 4-D
    (temporal) inputs against the flax module (1e-4), and K1's launches at
    the full-width shapes of the temporal fold (each under the grid's
    65535)
"""

import dataclasses
import functools
import json
import math
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from test_data import traj_root  # noqa: F401  (the synthetic trajectory tree)
from test_models import TINY_CLIP, TINY_VAE
from test_torch_layers import JL, TL, _check, _rand
from test_torch_models import port_cfg
from wiw_tpu.eval import fvd as JF
from wiw_tpu.eval import lpips as JLP
from wiw_tpu.eval import manifest as JMan
from wiw_tpu.eval import metrics as JM
from wiw_tpu.eval import video_metrics_cli as JCLI
from wiw_tpu_torch.eval import fvd as TF
from wiw_tpu_torch.eval import inference_cli
from wiw_tpu_torch.eval import lpips as TLP
from wiw_tpu_torch.eval import manifest as TMan
from wiw_tpu_torch.eval import metrics as TM
from wiw_tpu_torch.eval import video_metrics_cli as TCLI
from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.vae import VAEConfig
from wiw_tpu_torch.ops import flash_attention as TFA
from wiw_tpu_torch.sampling import eval_cli

torch.set_num_threads(1)


# ---------------------------------------------------- upstream checkpoints
def lpips_state_dict(seed: int = 0) -> dict:
    """Random weights in the merged lpips + torchvision layout."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(shape, generator=g) * 0.1 if k.startswith("lin")
                else torch.randn(shape, generator=g) / math.sqrt(math.prod(shape[1:])))
            for k, shape in TMan.expected_lpips_keys().items()}


def i3d_state_dict(seed: int = 0) -> dict:
    """Random weights in the i3d_pretrained_400 layout: convs scaled so 22
    ReLU layers keep their scale, BatchNorm statistics and affines away
    from the identity."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in TMan.expected_i3d_keys().items():
        if k.endswith(("running_var", "bn.weight")):
            sd[k] = torch.rand(shape, generator=g) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(shape, generator=g) * 0.3
        elif k.endswith("bias"):
            sd[k] = torch.randn(shape, generator=g) * 0.05
        else:
            sd[k] = torch.randn(shape, generator=g) * (1.2 / math.sqrt(math.prod(shape[1:])))
    return sd


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    paths = {"lpips": str(d / "lpips.pth"), "i3d": str(d / "i3d_pretrained_400.pt")}
    torch.save(lpips_state_dict(), paths["lpips"])
    torch.save(i3d_state_dict(), paths["i3d"])
    return paths


@pytest.fixture(scope="module")
def i3d(ckpts):
    return TF.load_i3d_weights(ckpts["i3d"]), JF.load_i3d_weights(ckpts["i3d"])


@pytest.fixture
def weights_configured(monkeypatch, ckpts):
    """WIW_LPIPS_WEIGHTS and WIW_I3D_WEIGHTS as both packages read them at
    import."""
    for mod, name, path in ((TLP, "_DEFAULT_WEIGHTS", ckpts["lpips"]),
                            (JLP, "_DEFAULT_WEIGHTS", ckpts["lpips"]),
                            (TF, "_DEFAULT_I3D", ckpts["i3d"]),
                            (JF, "_DEFAULT_I3D", ckpts["i3d"])):
        monkeypatch.setattr(mod, name, path)


@pytest.fixture
def no_weights(monkeypatch):
    for mod, name in ((TLP, "_DEFAULT_WEIGHTS"), (JLP, "_DEFAULT_WEIGHTS"),
                      (TF, "_DEFAULT_I3D"), (JF, "_DEFAULT_I3D")):
        monkeypatch.setattr(mod, name, "")


# ---------------------------------------------------------------- manifest
def _variants(sd: dict) -> dict:
    first = sorted(sd)[0]
    return {
        "full": dict(sd),
        "partial": {k: v for k, v in sd.items() if not k.startswith(("Mixed_4", "lin3"))},
        "misshaped": {**sd, first: torch.zeros(3, 2)},
        "extra": {**sd, "unknown.weight": torch.zeros(1)},
        "heads_only": {k: v for k, v in sd.items() if k.startswith("lin")},
    }


@pytest.mark.parametrize("tower", ["i3d", "lpips"])
def test_manifest_verdicts_match_reference(tower):
    sd = i3d_state_dict() if tower == "i3d" else lpips_state_dict()
    assert TMan.expected_i3d_keys() == JMan.expected_i3d_keys()
    assert TMan.expected_lpips_keys() == JMan.expected_lpips_keys()
    for name, d in _variants(sd).items():
        got = getattr(TMan, f"validate_{tower}_state_dict")(d)
        want = getattr(JMan, f"validate_{tower}_state_dict")(d)
        assert got == want, name
        assert got["ok"] == (name == "full" or (tower == "lpips" and name == "heads_only"))


def test_sha256_pinning_matches_reference(tmp_path, ckpts):
    lock_t, lock_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert (TMan.pin_or_verify_sha256(ckpts["lpips"], lock_t)
            == JMan.pin_or_verify_sha256(ckpts["lpips"], lock_j))
    assert TMan.pin_or_verify_sha256(ckpts["lpips"], lock_t)["status"] == "verified"
    with open(lock_t) as f, open(lock_j) as g:
        assert json.load(f) == json.load(g)


# ------------------------------------------------------------------- LPIPS
def test_lpips_matches_reference(ckpts):
    model = TLP.load_lpips_weights(ckpts["lpips"])
    params = JLP.load_lpips_weights(ckpts["lpips"])
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0, 1, (3, 64, 80, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JLP.LPIPS().apply({"params": params}, a, b))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    # the state dict loads straight into the module: the upstream names
    sd = torch.load(ckpts["lpips"], weights_only=True)
    assert set(TLP.LPIPS().state_dict()) == set(sd)
    fn = TLP.lpips_with_params(sd)
    np.testing.assert_allclose(fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               got, atol=1e-7)


def test_lpips_loader_validates_by_default(tmp_path):
    sd = lpips_state_dict()
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    bad = {**sd, "net.features.0.weight": torch.zeros(64, 3, 5, 5)}
    for name, d in (("heads", heads), ("bad", bad)):
        torch.save(d, tmp_path / f"{name}.pth")
    with pytest.raises(ValueError, match="heads only"):
        TLP.load_lpips_weights(str(tmp_path / "heads.pth"))
    with pytest.raises(ValueError, match="does not match the pinned lpips layout"):
        TLP.load_lpips_weights(str(tmp_path / "bad.pth"))
    # unvalidated, the heads load and the trunk keeps its initial values
    model = TLP.load_lpips_weights(str(tmp_path / "heads.pth"), validate=False)
    assert torch.equal(model.lin2.model[1].weight, heads["lin2.model.1.weight"])


def test_default_lpips_reads_the_environment(weights_configured, ckpts):
    fn = TLP.default_lpips()
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(JLP.default_lpips()(a, b))
    np.testing.assert_allclose(fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               want, atol=1e-5, rtol=1e-4)


def test_default_lpips_is_none_without_weights(no_weights):
    assert TLP.default_lpips() is None and JLP.default_lpips() is None


# --------------------------------------------------------------------- I3D
def test_i3d_matches_reference(i3d):
    """Pooled features and logits at a small input (the head's spatial mean
    takes any size; T = 10, the fewest FVD takes, leaves T' = 2)."""
    model, variables = i3d
    x = np.random.default_rng(1).uniform(-1, 1, (2, 10, 40, 56, 3)).astype(np.float32)
    with torch.no_grad():
        pooled, logits = model(torch.from_numpy(x))
    jp, jl = JF.InceptionI3d().apply(variables, x)
    assert pooled.shape == (2, 1024) and logits.shape == (2, 400)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)


def test_i3d_checkpoint_names_and_partial_dicts(tmp_path, ckpts):
    sd = torch.load(ckpts["i3d"], weights_only=True)
    assert set(TF.InceptionI3d().state_dict()) - set(sd) == {
        k for k in TF.InceptionI3d().state_dict() if k.endswith("num_batches_tracked")}
    partial = {k: v for k, v in sd.items() if not k.startswith("Mixed_5")}
    torch.save(partial, tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="i3d_pretrained_400"):
        TF.load_i3d_weights(str(tmp_path / "partial.pt"))
    with pytest.raises(ValueError, match="i3d_pretrained_400"):
        JF.load_i3d_weights(str(tmp_path / "partial.pt"))
    model = TF.load_i3d_weights(str(tmp_path / "partial.pt"), validate=False)
    assert torch.equal(model.Mixed_4b.b0.conv3d.weight, sd["Mixed_4b.b0.conv3d.weight"])


def test_fvd_features_and_distance_match_reference(i3d):
    """`features` resizes to 224x224 with JAX's antialiased bilinear (a
    downsample here: 256x320 -> 224x224), then I3D; FVD between two sets
    of 2 clips."""
    model, variables = i3d
    rng = np.random.default_rng(4)
    v1, v2 = (rng.uniform(0, 1, (2, 10, 256, 320, 3)).astype(np.float32)
              for _ in range(2))
    port, ref = TF.FVDEvaluator(model=model), JF.FVDEvaluator(variables=variables)
    got = port.features(torch.from_numpy(v1))
    want = np.asarray(ref.features(v1))
    assert got.shape == (2, 400)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    # plain bilinear (no antialias) is another function: the check would see it
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(v1[0]).permute(0, 3, 1, 2), (224, 224), mode="bilinear")
    anti = TF.resize_bilinear(torch.from_numpy(v1[0]), (224, 224), (1, 2))
    assert (plain.permute(0, 2, 3, 1) - anti).abs().max() > 1e-2
    f1, f2 = port.fvd(torch.from_numpy(v1), torch.from_numpy(v2)), ref.fvd(v1, v2)
    assert f1 == pytest.approx(f2, rel=1e-3)


@pytest.mark.parametrize("shape,out", [((2, 10, 256, 320, 3), (224, 224)),
                                       ((1, 3, 40, 56, 3), (224, 224)),
                                       ((1, 2, 48, 64, 3), (40, 56))])
def test_bilinear_resize_matches_jax(shape, out):
    """JAX's antialiased "bilinear" (FVD's input resize, video_metrics_cli
    --resize), down and up: test_cubic_resize_matches_jax's bound, 1e-5
    absolute and 1e-5 relative (JAX contracts both dims in one einsum)."""
    from wiw_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, shape[:2] + out + shape[-1:], "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), out, dims=(2, 3)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_frechet_distance_matches_reference():
    rng = np.random.default_rng(5)
    for n1, n2, d in ((5, 7, 16), (40, 30, 24), (2, 2, 400)):
        f1 = rng.standard_normal((n1, d)).astype(np.float32)
        f2 = (rng.standard_normal((n2, d)) * 1.3 + 0.2).astype(np.float32)
        got = float(TM.frechet_distance(torch.from_numpy(f1), torch.from_numpy(f2)))
        assert got == pytest.approx(float(JM.frechet_distance(f1, f2)), rel=1e-4)
    # a set against itself (well conditioned: 64 samples in 16 dimensions)
    f = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    assert abs(float(TM.frechet_distance(f, f))) < 1e-3


def test_evaluate_video_metrics_lpips_only_when_configured(weights_configured, no_weights):
    """The default metrics (ssim, psnr, lpips): LPIPS is left out only where
    no weights are configured, as in the reference."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (1, 2, 40, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = TM.evaluate_video_metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(JM.evaluate_video_metrics(a, b)) == {"psnr", "ssim"}


def test_evaluate_video_metrics_default_lpips(weights_configured):
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (1, 2, 40, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = TM.evaluate_video_metrics(torch.from_numpy(a), torch.from_numpy(b))
    want = JM.evaluate_video_metrics(a, b)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-4, abs=1e-6)


# -------------------------------------------------------------------- CLIs
def _png_clips(root, n_clips=2, frames=10, h=48, w=64, noise=0, seed=7):
    """Directories of frame PNGs: smooth seeded clips, plus uniform noise
    of +-`noise` levels from another seed."""
    from wiw_tpu_torch.agents.saver import save_image

    rng = np.random.default_rng(seed)
    jitter = np.random.default_rng(seed + noise)
    yy, xx = np.mgrid[:h, :w]
    dirs = []
    for c in range(n_clips):
        d = osp.join(root, f"clip{c}")
        for t in range(frames):
            phase = rng.uniform(0, 6.28, 3)
            img = 127.5 + 100 * np.sin(xx[..., None] / (5 + c) + yy[..., None] / 7
                                       + phase + t / 3)
            img = img + jitter.integers(-noise, noise + 1, img.shape)
            save_image(osp.join(d, f"{t:03d}.png"), np.clip(img, 0, 255).astype(np.uint8))
        dirs.append(d)
    return dirs


def test_video_metrics_cli_matches_reference(tmp_path, weights_configured):
    gen = _png_clips(str(tmp_path / "gen"), noise=40)
    gt = _png_clips(str(tmp_path / "gt"))
    argv = ["--gen", *gen, "--gt", *gt, "--resize", "40", "56", "--fvd"]
    got = TCLI.main(argv + ["--device", "cpu"])
    want = JCLI.main(argv)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips", "fvd"}
    for k, rel in (("psnr", 1e-5), ("ssim", 1e-5), ("lpips", 1e-4)):
        assert got[k] == pytest.approx(want[k], rel=rel, abs=1e-6), k
    # FVD of 2 clips a side: both packages take the fp32 eigendecomposition
    # of rank-1 400x400 covariances, each ~1% of the covariances' traces
    # (~0.18 here) off the float64 value; so 2e-3 absolute
    assert got["fvd"] == pytest.approx(want["fvd"], abs=2e-3)
    # under 10 frames there is no FVD, as in the reference
    short = TCLI.main(argv + ["--device", "cpu", "--max_frames", "6"])
    assert short["fvd"] is None and JCLI.main(argv + ["--max_frames", "6"])["fvd"] is None


def _tiny_towers(monkeypatch, mod):
    monkeypatch.setattr(mod, "VAE_CONFIG", port_cfg(VAEConfig, TINY_VAE))
    monkeypatch.setattr(mod, "CLIP_CONFIG", dataclasses.replace(
        port_cfg(CLIPVisionConfig, TINY_CLIP), projection_dim=1024))


def test_inference_cli_tiny(traj_root, tmp_path, monkeypatch,  # noqa: F811
                            weights_configured, capsys):
    """Tiny widths on the trajectory tree: the stitched clips and
    metrics.json with PSNR, SSIM and LPIPS (LPIPS weights configured; 64x64
    frames, about the least AlexNet's trunk takes; no FVD: 4-frame
    clips)."""
    _tiny_towers(monkeypatch, inference_cli)
    out = str(tmp_path / "out")
    metrics = inference_cli.main([
        "--data_root", traj_root, "--out_dir", out, "--width", "64", "--height",
        "64", "--sample_frames", "4", "--action_input_channel", "4",
        "--num_clips", "2", "--num_inference_steps", "2", "--unet_channels",
        "16", "32", "--unet_heads", "1", "2", "--save_gif", "--device", "cpu"])
    assert set(metrics) == {"psnr", "ssim", "lpips"}
    assert all(np.isfinite(v) for v in metrics.values())
    with open(osp.join(out, "metrics.json")) as f:
        assert json.load(f) == metrics
    files = sorted(os.listdir(out))
    assert {"clip0.gif", "clip1.gif", "metrics.json"} <= set(files)
    assert sum(f.startswith("clip0_stitch.") for f in files) == 1
    stitched = [f for f in files if f.startswith("clip1_stitch.")][0]
    from wiw_tpu_torch.agents.saver import load_video_frames

    assert load_video_frames(osp.join(out, stitched)).shape[1:] == (64, 2 * 64 + 4, 3)
    assert "[eval_inference] clip 1: (4, 64, 64, 3)" in capsys.readouterr().out


def _long_traj_tree(root, frames=10, h=16, w=32):
    """traj_root's layout with one trajectory of `frames` frames."""
    from PIL import Image

    d = osp.join(root, "sceneC", "traj-0", "waypoint-0")
    os.makedirs(d)
    steps = {}
    for k in range(frames):
        Image.fromarray(np.full((h, w, 3), 20 * k, np.uint8)).save(
            osp.join(d, f"step-{k}_type-rgb.png"))
        steps[f"step-{k}"] = {"action": "stop" if k == 0 else "move_forward",
                              "coord": [0, 0, 0]}
    with open(osp.join(d, "metadata.json"), "w") as f:
        json.dump({"steps": {"waypoint-0": steps}}, f)
    return root


def test_inference_cli_skips_fvd_only_without_i3d_weights(tmp_path, monkeypatch,
                                                          no_weights, ckpts, capsys):
    _tiny_towers(monkeypatch, inference_cli)
    root = _long_traj_tree(str(tmp_path / "data"))
    argv = ["--data_root", root, "--out_dir", str(tmp_path / "out"), "--width", "32",
            "--height", "16", "--sample_frames", "10", "--action_input_channel",
            "10", "--num_clips", "1", "--num_inference_steps", "1",
            "--unet_channels", "16", "32", "--unet_heads", "1", "2", "--device", "cpu"]
    metrics = inference_cli.main(argv)
    assert set(metrics) == {"psnr", "ssim"}
    assert "FVD skipped: no I3D weights" in capsys.readouterr().err
    # with weights, an error of the I3D tower raises (the reference swallows
    # it and leaves FVD out)
    monkeypatch.setattr(TF, "_DEFAULT_I3D", ckpts["i3d"])

    def broken(self, v1, v2):
        raise ZeroDivisionError("in the tower")

    monkeypatch.setattr(TF.FVDEvaluator, "fvd", broken)
    with pytest.raises(ZeroDivisionError, match="in the tower"):
        inference_cli.main(argv)


def test_eval_cli_tiny(tmp_path, monkeypatch, weights_configured):
    from wiw_tpu_torch.agents.saver import save_image, save_video

    _tiny_towers(monkeypatch, eval_cli)
    from wiw_tpu_torch.models import unet as TU

    monkeypatch.setattr(TU, "UNetConfig", functools.partial(
        TU.UNetConfig, block_out_channels=(16, 32), num_attention_heads=(1, 2)))
    rng = np.random.default_rng(9)
    conds = []
    for i in range(2):
        conds.append(str(tmp_path / f"cond{i}.png"))
        save_image(conds[-1], rng.integers(0, 256, (20, 30, 3)).astype(np.uint8))
    gts = [save_video(str(tmp_path / f"gt{i}.mp4"),
                      rng.integers(0, 256, (14, 64, 64, 3)).astype(np.uint8))
           for i in range(2)]
    out = str(tmp_path / "gen")
    # micro_cond takes one action channel a frame: 14 frames, as the default
    eval_cli.main(["--cond", *conds, "--gt", *gts, "--actions", "1,2", "--width",
                   "64", "--height", "64", "--num_frames", "14",
                   "--num_inference_steps", "2", "--out_dir", out, "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert [f.split(".")[0] for f in files] == ["gen_00", "gen_01", "metrics"]
    with open(osp.join(out, "metrics.json")) as f:
        assert set(json.load(f)) == {"psnr", "ssim", "lpips"}


# ------------------------------------------- past_images' cross-attention
def test_cross_attention_multi_token_context_matches_reference():
    """A context of Np + 1 = 3 tokens: on 3-D x (spatial, [B*F, S, C]) and
    on 4-D x (temporal, [B, F, S, C], positions folded into the batch),
    weights carried by flax_to_torch; tolerance 1e-4 (fp32)."""
    ctx = _rand((2, 3, 24), 19)
    _check(JL.CrossAttention(2, 16), TL.CrossAttention(32, 2, 16, 24),
           _rand((2, 20, 32), 21), ctx)
    _check(JL.CrossAttention(2, 16), TL.CrossAttention(32, 2, 16, 24),
           _rand((2, 3, 5, 32), 20), ctx)
    _check(JL.TransformerSpatioTemporal(2, 16),
           TL.TransformerSpatioTemporal(32, 2, 16, 24),
           _rand((6, 4, 4, 32), 29), 3, ctx)


def test_temporal_fold_launches_stay_under_the_grid_limit(monkeypatch):
    """At full width (576x1024 latents 72x128: S = 9216, 2304, 576, 144;
    heads 5, 10, 20, 20) the temporal cross-attention folds B*S rows into
    K1's batch; on meta tensors, the batch it gives K1 and the launches
    `batch_splits` makes of it: each within 65535 (batch, head) pairs,
    covering the batch in order, as few as that allows."""
    seen = []

    def record(q, k, v, heads):
        seen.append((q.shape[0], heads, k.shape[1]))
        return torch.empty_like(q)

    monkeypatch.setattr(TL, "attention_bsd", record)
    for S, C, heads in ((9216, 320, 5), (2304, 640, 10), (576, 1280, 20),
                        (144, 1280, 20)):
        attn = TL.CrossAttention(C, heads, 64, 1024).to("meta")
        for rows in (1, 2, 8):  # cond-only, CFG pair, the engine's 4 slots
            out = attn(torch.empty(rows, 14, S, C, device="meta"),
                       torch.empty(rows, 3, 1024, device="meta"))
            assert out.shape == (rows, 14, S, C)
            B, H, Skv = seen.pop()
            assert (B, H, Skv) == (rows * S, heads, 3)
            splits = TFA.batch_splits(B, H)
            assert splits[0][0] == 0 and splits[-1][1] == B
            assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
            assert all(0 < (b1 - b0) * H <= 65535 for b0, b1 in splits)
            assert len(splits) == math.ceil(B / (65535 // H))
    assert TFA.batch_splits(2 * 9216, 5) == [(0, 13107), (13107, 18432)]
    assert TFA.batch_splits(28, 5) == [(0, 28)]
