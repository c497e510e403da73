"""Port parity for the whole slice: SVDPipeline.generate with SERVING_CFG.

The reference builds and initialises the tiny towers (TINY_UNET with
micro_cond, TINY_VAE, TINY_CLIP), `load_flax_params` carries them into the
port, and both generate 3 frames at 64x64 with 4 Euler steps under the
serving CFG schedule (segments full 0-3 and stale 3-4). Randomness is
injected: the same numpy `init_latents`, and noise_aug_strength 0, so the
reference's own draws do not enter. Decoding runs in chunks of 2 frames
(2 + 1), so the chunk loop is exercised too.

Also here: the import guard and a static scan (no module of wiw_tpu_torch,
nor chip_smoke.py, imports jax, flax or wiw_tpu), one generate with the
fused-kernel configuration (K4, K6) on the same weights, one in W8A8
int8 (`quantize_unet()` on both sides), the 'alt' CFG tail at an even and
an odd length, and `past_images` (Np = 2), each against the reference.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_models import TINY_CLIP, TINY_UNET, TINY_VAE
from wiw_tpu.core.schedule import SERVING_CFG as J_SERVING_CFG
from wiw_tpu.core.schedule import CFGSchedule as J_CFGSchedule
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.sampling.pipeline import SVDPipeline as JPipe
from wiw_tpu_torch.core import schedule as TS
from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.unet import UNetConfig
from wiw_tpu_torch.models.vae import VAEConfig
from wiw_tpu_torch.ops import quant as Q
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

J_UNET = dataclasses.replace(
    TINY_UNET, action_strategy="micro_cond", action_input_channel=3,
    cross_attention_dim=TINY_CLIP.projection_dim)
STEPS = 4
OUT_HW = (48, 40)


def port_cfg(cls, jcfg, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    return cls(**dict(kw, **over))


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny pipeline, its weights (numpy) and the inputs."""
    jpipe = JPipe(J_UNET, TINY_VAE, TINY_CLIP)
    jgen = JGen(height=64, width=64, num_frames=3, num_inference_steps=STEPS,
                noise_aug_strength=0.0, decode_chunk_frames=2,
                cfg=J_SERVING_CFG)
    params = jpipe.init_params(jax.random.PRNGKey(0), jgen)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    actions = np.asarray([[4, 2, 1]])
    scale = 2 ** (len(TINY_VAE.block_out_channels) - 1)
    noise = rng.standard_normal((1, 3, 64 // scale, 64 // scale, 4)).astype(
        np.float32)
    return dict(jpipe=jpipe, jparams=params,
                params=jax.tree_util.tree_map(np.asarray, params),
                image=image, actions=actions, noise=noise)


def ref_generate(tiny, jgen, **kw) -> np.ndarray:
    """The reference's generate on its fp32 weights (`runs` quantises the
    pipeline's tree), from the shared init latents."""
    jpipe = tiny["jpipe"]
    jpipe.params = tiny["jparams"]
    return np.asarray(jpipe.generate(
        jax.random.PRNGKey(1), tiny["image"], jgen, actions=tiny["actions"],
        init_latents=tiny["noise"], **kw))


def port_pipe(tiny, **unet_over) -> SVDPipeline:
    pipe = SVDPipeline(port_cfg(UNetConfig, J_UNET, **unet_over),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    pipe.load_flax_params(tiny["params"])
    return pipe


@pytest.fixture(scope="module")
def runs(tiny):
    jgen = JGen(height=64, width=64, num_frames=3, num_inference_steps=STEPS,
                noise_aug_strength=0.0, decode_chunk_frames=2,
                cfg=J_SERVING_CFG)
    jpipe, params = tiny["jpipe"], tiny["params"]
    image, actions, noise = tiny["image"], tiny["actions"], tiny["noise"]
    key = jax.random.PRNGKey(1)
    ref = {
        "video": np.asarray(jpipe.generate(key, image, jgen, actions=actions,
                                           init_latents=noise)),
        "u8": np.asarray(jpipe.generate(key, image, jgen, actions=actions,
                                        init_latents=noise,
                                        out_uint8_hw=OUT_HW)),
    }

    gen = GenerationConfig(height=64, width=64, num_frames=3,
                           num_inference_steps=STEPS, noise_aug_strength=0.0,
                           decode_chunk_frames=2, cfg=TS.SERVING_CFG)
    pipe = port_pipe(tiny)
    args = (torch.from_numpy(image), gen)
    kw = dict(actions=torch.from_numpy(actions),
              init_latents=torch.from_numpy(noise))
    out = {
        "video": pipe.generate(*args, **kw).numpy(),
        "u8": pipe.generate(*args, out_uint8_hw=OUT_HW, **kw).numpy(),
    }
    # the fused-kernel configuration on the same weights: on the CPU K4's
    # and K6's plain versions where the reference's rules allow the kernels
    fused = port_pipe(tiny, fused_ff=True, temporal_attention="pallas")
    out["fused"] = fused.generate(*args, **kw).numpy()
    # W8A8: each side quantises the fp32 weights it holds (the reference
    # its tree, the port the values it loads)
    int8 = SVDPipeline(port_cfg(UNetConfig, J_UNET),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    out["int8_count"] = int8.quantize_unet()
    int8.load_flax_params(params)
    out["int8"] = int8.generate(*args, **kw).numpy()
    ref["int8_count"] = jpipe.quantize_unet()
    ref["int8"] = np.asarray(jpipe.generate(key, image, jgen, actions=actions,
                                            init_latents=noise))
    return gen, ref, out


def test_serving_segments_at_four_steps(runs):
    gen = runs[0]
    assert TS.cfg_row_segments(STEPS, gen.cfg) == (
        ("full", 0, 3), ("stale", 3, 4))


def test_generate_float_video_matches_reference(runs):
    _, ref, out = runs
    assert out["video"].shape == ref["video"].shape == (1, 3, 64, 64, 3)
    assert out["video"].dtype == np.float32
    # 4 steps x (2 rows through the UNet) + CLIP + VAE, all fp32 at random
    # weights: 1e-4 absolute on frames in [0, 1] (measured ~6e-6)
    np.testing.assert_allclose(out["video"], ref["video"], atol=1e-4, rtol=0)


def test_generate_fused_config_matches_reference(runs):
    """One tiny generate with fused_ff + temporal_attention='pallas' (the
    reference's XLA formulations on the CPU compute the same function)."""
    _, ref, out = runs
    assert out["fused"].shape == ref["video"].shape
    # the default configuration's bound: fp32 at random weights
    np.testing.assert_allclose(out["fused"], ref["video"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["fused"], out["video"], atol=1e-4, rtol=0)


def test_generate_int8_matches_reference_within_its_own_spread(runs):
    """W8A8 after `quantize_unet()` on both sides: the same 30 int8 weights,
    and frames within the spread of the reference's own int8 pipeline.
    Tolerance: the int8 UNet is chaotic at the level of activation codes (a
    ~1e-7 reordering moves a code by one step of amax/127, and later int8
    layers carry it on): the reference's int8 frames move by max 0.092 /
    mean 0.0089 when its init latents move by 1e-6 relative. So max 0.25,
    mean 0.02 (measured 0.106 / 0.0090); the int8 route moves the port's
    frames off its fp32 ones (by ~0.07, as the reference's)."""
    _, ref, out = runs
    assert out["int8_count"] == ref["int8_count"] == 30
    assert out["int8"].shape == ref["int8"].shape == (1, 3, 64, 64, 3)
    diff = np.abs(out["int8"] - ref["int8"])
    assert diff.max() <= 0.25 and diff.mean() <= 0.02, (diff.max(), diff.mean())
    assert np.abs(out["int8"] - out["video"]).max() > 1e-2


def test_generate_uint8_frames_within_one_level(runs):
    _, ref, out = runs
    assert out["u8"].dtype == np.uint8 and out["u8"].shape == (1, 3, 48, 40, 3)
    diff = np.abs(out["u8"].astype(np.int16) - ref["u8"].astype(np.int16))
    assert diff.max() <= 1


ALT_STEPS = 5  # sigmas 700, 134.9, 15.6, 0.678, 0.002


@pytest.mark.parametrize("tail_sigma,segments", [
    (1.0, (("full", 0, 3), ("alt", 3, 5))),    # an even tail: (stale, full)
    (20.0, (("full", 0, 2), ("alt", 2, 5))),   # odd: (stale, full), stale
])
def test_alt_tail_policy_matches_reference(tiny, tail_sigma, segments):
    """The 'alt' CFG tail (pairs of a stale and a full step, one stale step
    more when the tail is odd; the full step refreshes the carried uncond)
    against the reference's generate at 5 steps, from the same init latents
    with noise_aug_strength 0. Tolerance: the default configuration's, 1e-4
    absolute on frames in [0, 1] (fp32 at random weights)."""
    assert TS.cfg_row_segments(ALT_STEPS, TS.CFGSchedule(
        tail_sigma=tail_sigma, tail_policy="alt")) == segments
    kw = dict(height=64, width=64, num_frames=3, num_inference_steps=ALT_STEPS,
              noise_aug_strength=0.0, decode_chunk_frames=2)
    jgen = JGen(**kw, cfg=J_CFGSchedule(tail_sigma=tail_sigma, tail_policy="alt"))
    ref = ref_generate(tiny, jgen)
    gen = GenerationConfig(**kw, cfg=TS.CFGSchedule(tail_sigma=tail_sigma,
                                                    tail_policy="alt"))
    out = port_pipe(tiny).generate(
        torch.from_numpy(tiny["image"]), gen,
        actions=torch.from_numpy(tiny["actions"]),
        init_latents=torch.from_numpy(tiny["noise"])).numpy()
    assert out.shape == ref.shape == (1, 3, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_past_images_generate_matches_reference(tiny):
    """generate with past_images [B, Np=2, H, W, 3]: their CLIP tokens go
    before the image's in the context (uncond zeros), so every spatial and
    temporal cross-attention is multi-token. Against the reference's
    generate under the serving schedule, same init latents,
    noise_aug_strength 0. Tolerance: 1e-4 absolute on frames in [0, 1], the
    default configuration's."""
    past = np.random.default_rng(5).uniform(-1, 1, (1, 2, 64, 64, 3)).astype(
        np.float32)
    jgen = JGen(height=64, width=64, num_frames=3, num_inference_steps=STEPS,
                noise_aug_strength=0.0, decode_chunk_frames=2,
                cfg=J_SERVING_CFG)
    ref = ref_generate(tiny, jgen, past_images=past)
    gen = GenerationConfig(height=64, width=64, num_frames=3,
                           num_inference_steps=STEPS, noise_aug_strength=0.0,
                           decode_chunk_frames=2, cfg=TS.SERVING_CFG)
    pipe = port_pipe(tiny)
    args = (torch.from_numpy(tiny["image"]), gen, torch.from_numpy(tiny["actions"]))
    out = pipe.generate(*args, torch.from_numpy(past),
                        init_latents=torch.from_numpy(tiny["noise"])).numpy()
    assert out.shape == ref.shape == (1, 3, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    # the past tokens move the frames: the check is not vacuous
    alone = pipe.generate(*args, init_latents=torch.from_numpy(tiny["noise"]))
    assert np.abs(alone.numpy() - out).max() > 1e-3


def test_quantize_comes_before_the_weights():
    """quantize_unet/quantize_vae count the int8 weights to be and mark the
    towers; after the weights are placed they refuse (the weights as loaded
    are gone: quantising the cast ones would change codes)."""
    pipe = SVDPipeline(port_cfg(UNetConfig, J_UNET),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    n_unet, n_vae = pipe.quantize_unet(), pipe.quantize_vae()
    pipe.init_params(torch.Generator().manual_seed(0))
    assert n_unet == Q.count_quantized(pipe.unet) > 0
    assert n_vae == Q.count_quantized(pipe.vae) > 0
    assert Q.count_quantized(pipe.vae.encoder) == 0
    with pytest.raises(RuntimeError, match="before the weights"):
        pipe.quantize_unet()


def test_decode_chunk_resolution_matches_reference():
    for h, w, f, chunk in [(576, 1024, 14, None), (64, 64, 3, 2),
                           (288, 512, 14, None), (576, 1024, 14, 6)]:
        for nbytes in (2, 4):
            assert GenerationConfig(height=h, width=w, num_frames=f,
                                    decode_chunk_frames=chunk
                                    ).resolved_decode_chunk(nbytes) == JGen(
                height=h, width=w, num_frames=f,
                decode_chunk_frames=chunk).resolved_decode_chunk(nbytes)


BLOCKED = ("jax", "flax", "jaxlib", "wiw_tpu")


def test_import_guard_no_jax_in_port():
    """Import every wiw_tpu_torch module in a fresh interpreter with jax,
    flax and the reference package blocked (by exact top-level name, so
    wiw_tpu_torch itself still imports): any import of them fails."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = %r
for name in [m for m in sys.modules if m.split('.')[0] in BLOCKED]:
    del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import wiw_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(wiw_tpu_torch.__path__, 'wiw_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]
print(len(mods))
""" % (BLOCKED,)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # ops/quant, ops/int8_attention, eval/, serve/benchmarks, agents/solver,
    # workers/base, models/cdit and workers/nwm_worker too
    assert int(r.stdout.split()[-1]) >= 59


def _reference_imports(source: str) -> list:
    """(line, module) of every import of a BLOCKED package in `source`."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in BLOCKED]
    return found


def test_no_reference_import_anywhere_in_port_source():
    """Static scan: no `import` of jax, flax, jaxlib or wiw_tpu in any .py
    of wiw_tpu_torch or in chip_smoke.py, at any depth (imports inside
    functions, which the import guard never executes, included)."""
    assert _reference_imports(
        "import os\ndef f():\n    from wiw_tpu.serve import worker\n"
        "    import jax.numpy, wiw_tpu_torch\n") == [
            (3, "wiw_tpu.serve"), (4, "jax.numpy")]
    files = sorted((REPO / "wiw_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"wiw_tpu_torch/ops/quant.py",
            "wiw_tpu_torch/ops/int8_attention.py",
            "wiw_tpu_torch/serve/benchmarks.py",
            "wiw_tpu_torch/agents/solver.py",
            "wiw_tpu_torch/workers/base.py",
            "wiw_tpu_torch/eval/manifest.py",
            "wiw_tpu_torch/eval/lpips.py",
            "wiw_tpu_torch/eval/fvd.py",
            "wiw_tpu_torch/eval/metrics.py",
            "wiw_tpu_torch/eval/video_metrics_cli.py",
            "wiw_tpu_torch/eval/inference_cli.py",
            "wiw_tpu_torch/sampling/eval_cli.py",
            "wiw_tpu_torch/models/cdit.py",
            "wiw_tpu_torch/models/convert.py",
            "wiw_tpu_torch/workers/nwm_worker.py"} <= names
    bad = [(f.relative_to(REPO), hit) for f in files
           for hit in _reference_imports(f.read_text())]
    assert not bad, bad
