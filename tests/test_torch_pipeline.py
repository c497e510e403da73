"""Port parity for the whole slice: SVDPipeline.generate with SERVING_CFG.

The reference builds and initialises the tiny towers (TINY_UNET with
micro_cond, TINY_VAE, TINY_CLIP), `load_flax_params` carries them into the
port, and both generate 3 frames at 64x64 with 4 Euler steps under the
serving CFG schedule (segments full 0-3 and stale 3-4). Randomness is
injected: the same numpy `init_latents`, and noise_aug_strength 0, so the
reference's own draws do not enter. Decoding runs in chunks of 2 frames
(2 + 1), so the chunk loop is exercised too.

Also here: the import guard and a static scan (no module of wiw_tpu_torch,
nor chip_smoke.py, imports jax, flax or wiw_tpu), and one generate with the
fused-kernel configuration (K4, K6) on the same weights.
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
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.sampling.pipeline import SVDPipeline as JPipe
from wiw_tpu_torch.core import schedule as TS
from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.unet import UNetConfig
from wiw_tpu_torch.models.vae import VAEConfig
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
def runs():
    jgen = JGen(height=64, width=64, num_frames=3, num_inference_steps=STEPS,
                noise_aug_strength=0.0, decode_chunk_frames=2,
                cfg=J_SERVING_CFG)
    jpipe = JPipe(J_UNET, TINY_VAE, TINY_CLIP)
    params = jpipe.init_params(jax.random.PRNGKey(0), jgen)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    actions = np.asarray([[4, 2, 1]])
    scale = 2 ** (len(TINY_VAE.block_out_channels) - 1)
    noise = rng.standard_normal((1, 3, 64 // scale, 64 // scale, 4)).astype(
        np.float32)
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
    pipe = SVDPipeline(port_cfg(UNetConfig, J_UNET),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    pipe.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    args = (torch.from_numpy(image), gen)
    kw = dict(actions=torch.from_numpy(actions),
              init_latents=torch.from_numpy(noise))
    out = {
        "video": pipe.generate(*args, **kw).numpy(),
        "u8": pipe.generate(*args, out_uint8_hw=OUT_HW, **kw).numpy(),
    }
    # the fused-kernel configuration on the same weights: on the CPU K4's
    # and K6's plain versions where the reference's rules allow the kernels
    fused = SVDPipeline(port_cfg(UNetConfig, J_UNET, fused_ff=True,
                                 temporal_attention="pallas"),
                        port_cfg(VAEConfig, TINY_VAE),
                        port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    fused.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    out["fused"] = fused.generate(*args, **kw).numpy()
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


def test_generate_uint8_frames_within_one_level(runs):
    _, ref, out = runs
    assert out["u8"].dtype == np.uint8 and out["u8"].shape == (1, 3, 48, 40, 3)
    diff = np.abs(out["u8"].astype(np.int16) - ref["u8"].astype(np.int16))
    assert diff.max() <= 1


def test_alt_tail_policy_is_not_ported_yet():
    gen = GenerationConfig(height=16, width=16, num_frames=3,
                           num_inference_steps=4,
                           cfg=TS.CFGSchedule(tail_sigma=6.4, tail_policy="alt"))
    pipe = SVDPipeline(port_cfg(UNetConfig, J_UNET),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        pipe.generate(torch.zeros(1, 16, 16, 3), gen,
                      actions=torch.tensor([[4, 1, 1]]),
                      generator=torch.Generator().manual_seed(1))


def test_worker_refuses_int8_and_keeps_bf16_default():
    from wiw_tpu_torch.workers.svd_action import SVDActionWorker

    with pytest.raises(NotImplementedError, match="M6"):
        SVDActionWorker(quantize="int8", device="cpu")


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
    assert int(r.stdout.split()[-1]) >= 22


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
    bad = [(f.relative_to(REPO), hit) for f in files
           for hit in _reference_imports(f.read_text())]
    assert not bad, bad
