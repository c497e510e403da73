"""Port parity of `generate(shard_clip=True)` on the CPU: one clip split
within the denoise step over a ('dp', 'fsdp') mesh, with gloo.

One launch of four gloo ranks of `tests/torch_dist_ranks.py` (scenario
"clip") runs every case on the meshes (1, 4) and (2, 2), built from the same
group, while this process computes the reference's `shard_clip` generate on
four JAX CPU devices (`make_mesh(..., devices=jax.devices()[:4])`) and the
port's unsharded layers and generate. The pipeline is `test_torch_train`'s
tiny one with the reference's weights. Two image sizes:
  * 8 x 32 (SMALL): the latent is 4 x 16 and the UNet's levels have 4 and 2
    rows, so at fsdp 4 two ranks hold no row of level 1. Held to the
    port's unsharded generate, which equals the reference's unsharded one
    (`test_torch_pipeline`). The reference's own shard_clip does not serve
    as the oracle at this size: on four JAX CPU devices its frames depart
    from its unsharded generate's by 0.17 at meshes (1, 4) and (2, 2)
    (within 3e-6 at (1, 2), and at every mesh at 16 x 32), a fault of the
    reference that ROADMAP records.
  * 16 x 32 (REF): the latent is 8 x 16 (levels of 8 and 4 rows). The calls
    the reference runs (JAX_RUNS) are held to its shard_clip frames too.

Module level: Ulysses (and the gather arm's) spatial attention within 2e-5
of unsharded attention (the reference test's bound) for 2, 3, 5 and 20
heads; the split GroupNorm within 1e-5 of the plain one, with a rank
without rows at fsdp 4; the halo'd 3x3 conv, Downsample2D and Upsample2D
within 1e-5 in fp32, and in int8 with the global amax and codes equal to
the unsharded call's and outputs equal bit for bit.
Pipeline level: the frames within 1e-4 absolute of the reference's
shard_clip frames and of the port's unsharded generate, with the CFG tail
and decode chunks 1 and 2; int8 (`quantize_unet`) within the int8 bound
of `test_torch_pipeline` (max 0.25, mean 0.02) of the port's unsharded
int8 generate; every rank returns the whole clip.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_models import TINY_VAE
from test_torch_models import port_cfg
from test_torch_train import F, J_CLIP, J_UNET, port_pipeline, ref  # noqa: F401  (ref: fixture)
from torch_dist_ranks import CLIP_HEADS, clip_cases
from wiw_tpu.core.schedule import CFGSchedule as JCFG
from wiw_tpu.core.schedule import karras_sigmas_np
from wiw_tpu.parallel.mesh import make_mesh as jax_mesh
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu_torch.core.schedule import CFGSchedule
from wiw_tpu_torch.models import clip as TC
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.models import vae as TV
from wiw_tpu_torch.ops import quant as Q
from wiw_tpu_torch.ops.flash_attention import flash_attention_plain
from wiw_tpu_torch.parallel.clip_sharding import ATTENTION_ARMS, split_rows
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HELPER = str(REPO / "tests" / "torch_dist_ranks.py")
WORLD = 4
MESHES = [(1, 4), (2, 2)]
SMALL, REF = (8, 32), (16, 32)  # the images; latents 4 x 16 and 8 x 16
STEPS = 4
ATOL = 1e-4
INT8_MAX, INT8_MEAN = 0.25, 0.02
# the reference's shard_clip runs (at most four JAX traces): call -> mesh
JAX_RUNS = {"video": (1, 4), "tail": (2, 2), "chunk1": (2, 2), "chunk2": (1, 4)}


def inputs_of(size, seed: int = 11) -> dict:
    """The image, actions and init latents of one clip at `size`."""
    rng = np.random.default_rng(seed)
    h, w = size
    return {"image": torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)),
            "actions": torch.from_numpy(rng.integers(1, 4, (1, F)).astype(np.int32)),
            "init_latents": torch.from_numpy(
                rng.standard_normal((1, F, h // 2, w // 2, 4)).astype(np.float32))}


def calls() -> dict:
    """The generate calls every mesh runs: name -> (port kwargs, the
    GenerationConfig's overrides)."""
    tail = float(karras_sigmas_np(STEPS)[2])  # steps 0-1 full, 2-3 the tail
    small, ref_ = inputs_of(SMALL), inputs_of(REF)
    drawn = {k: small[k] for k in ("image", "actions")}
    out = {
        "video": (dict(small), {}),
        "tail": (dict(small), {"cfg": tail}),
        "chunk1": (dict(small), {"decode_chunk_frames": 1}),
        "chunk2": (dict(small), {"decode_chunk_frames": 2}),
        "int8": (dict(small, int8=True), {}),
        "gather": (dict(small, attention="gather"), {}),
        "drawn": (dict(drawn, seed=3), {"noise_aug_strength": 0.02}),
    }
    for name in JAX_RUNS:
        out[f"{name}_ref"] = (dict(ref_), out[name][1])
    return out


def decode_latents() -> torch.Tensor:
    """Latents [1, F, 4, 16, 4] for the frame-parallel decode cases."""
    rng = np.random.default_rng(12)
    return torch.from_numpy(rng.standard_normal((1, F, 4, 16, 4)).astype(np.float32))


def port_vae_int8(params) -> SVDPipeline:
    """`port_pipeline`'s pipeline with a W8A8 VAE decoder."""
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, J_UNET, param_dtype="float32"),
                       port_cfg(TV.VAEConfig, TINY_VAE),
                       port_cfg(TC.CLIPVisionConfig, J_CLIP), device="cpu")
    pipe.quantize_vae()
    pipe.load_flax_params(params)
    return pipe


def _gen(port: bool, size, over: dict):
    kw = dict(height=size[0], width=size[1], num_frames=F, num_inference_steps=STEPS,
              noise_aug_strength=0.0)
    kw.update(over)
    if "cfg" in kw:
        kw["cfg"] = (CFGSchedule if port else JCFG)(tail_sigma=kw["cfg"])
    return GenerationConfig(**kw) if port else JGen(**kw)


def port_int8(params) -> SVDPipeline:
    """`port_pipeline`'s pipeline with a W8A8 UNet (quantised as loaded)."""
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, J_UNET, param_dtype="float32"),
                       port_cfg(TV.VAEConfig, TINY_VAE),
                       port_cfg(TC.CLIPVisionConfig, J_CLIP), device="cpu")
    pipe.quantize_unet()
    pipe.load_flax_params(params)
    return pipe


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                PYTHONHASHSEED="0")


def launch(inputs: dict, tmp: Path) -> list:
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return [subprocess.Popen([sys.executable, HELPER, path, str(r), str(WORLD), str(tmp)],
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(WORLD)]


def join(procs: list, timeout: float = 300) -> None:
    """Wait for every rank; a rank that skipped a collective would hang its
    group, so the wait has a limit, after which every rank is killed."""
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    jpipe, params = ref
    tmp = tmp_path_factory.mktemp("clip")
    pipe = port_pipeline(params)
    todo = calls()

    def size(kw):
        return tuple(kw["image"].shape[1:3])

    spec_calls = {n: dict(kw, gen=_gen(True, size(kw), over)) for n, (kw, over) in todo.items()}
    inputs = {"cfgs": (pipe.unet_config, pipe.vae_config, pipe.clip_config),
              "weights": tuple(t.state_dict() for t in (pipe.unet, pipe.vae, pipe.clip)),
              "scenarios": {"clip": {"run": "clip", "meshes": MESHES, "calls": spec_calls,
                                     "decode": decode_latents(),
                                     "decode_gens": {c: _gen(True, SMALL, {
                                         "decode_chunk_frames": c}) for c in (1, 2)}}}}
    procs = launch(inputs, tmp)
    out = {"ref": {}, "port": {}}
    try:
        for name, mesh in JAX_RUNS.items():
            kw, over = todo[f"{name}_ref"]
            jmesh = jax_mesh(dp=mesh[0], fsdp=mesh[1], devices=jax.devices()[:WORLD])
            out["ref"][f"{name}_ref"] = np.asarray(jpipe.generate(
                jax.random.PRNGKey(1), kw["image"].numpy(), _gen(False, REF, over),
                actions=kw["actions"].numpy(), init_latents=kw["init_latents"].numpy(),
                mesh=jmesh, shard_clip=True))
        pipe8 = port_int8(params)
        for name, (kw, over) in todo.items():
            kw = dict(kw)
            p = pipe8 if kw.pop("int8", False) else pipe
            kw.pop("attention", None)
            if "seed" in kw:
                kw["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
            gen = _gen(True, size(kw), over)
            out["port"][name] = p.generate(kw.pop("image"), gen, **kw)
    finally:
        join(procs)
    out["ranks"] = torch.load(tmp / "clip.pt", weights_only=False)
    out["vae8"] = port_vae_int8(params)
    return out


def _row(every: list, mesh) -> list:
    """The results of the ranks of dp row 0 of `mesh`, by fsdp coordinate."""
    key = "x".join(map(str, mesh))
    mine = sorted((r[key] for r in every if r[key]["dp"] == 0), key=lambda r: r["fsdp"])
    assert [r["fsdp"] for r in mine] == list(range(mesh[1]))
    return mine


# ------------------------------------------------------------ module level
@pytest.mark.parametrize("arm", ATTENTION_ARMS)
@pytest.mark.parametrize("heads", CLIP_HEADS)
@pytest.mark.parametrize("mesh", MESHES)
def test_spatial_attention_matches_unsharded(runs, mesh, heads, arm):
    """Ulysses (heads padded to a multiple of the fsdp size where they do
    not divide it: 2, 3 and 5 at fsdp 4, 3 and 5 at fsdp 2) and the gather
    arm against unsharded attention on the same q/k/v."""
    q, k, v = clip_cases()["qkv"][heads]
    got = torch.cat([r["modules"][("attn", heads, arm)] for r in _row(runs["ranks"], mesh)], 2)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["gn", "gn_t"])
@pytest.mark.parametrize("mesh", MESHES)
def test_split_group_norm_matches_plain(runs, mesh, name):
    """The split GroupNorm (+ SiLU) over 3 rows (at fsdp 4 one rank holds
    none: count 0 statistics, no kernel, every collective joined), in the
    spatial and the temporal layout."""
    c = clip_cases()
    x, dim = c["norms"][name]
    parts = [r["modules"][name] for r in _row(runs["ranks"], mesh)]
    if mesh[1] == 4:
        assert parts[-1].shape[dim] == 0
    with torch.no_grad():
        want = c["gn"](x)
    torch.testing.assert_close(torch.cat(parts, dim), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("h", [6, 3])
@pytest.mark.parametrize("name", ["conv", "down", "up"])
@pytest.mark.parametrize("mesh", MESHES)
def test_halo_convs_match_unsharded(runs, mesh, name, h):
    """The 3x3 conv, Downsample2D and Upsample2D on halo'd rows (their
    output re-split to the next level's rule) against the unsharded layer:
    fp32 within 1e-5; int8 equal bit for bit, with the global amax and
    every code the unsharded call's."""
    c = clip_cases()
    x = c["xs"][h]
    ranks = _row(runs["ranks"], mesh)
    with torch.no_grad():
        for kind in ("convs", "int8"):
            want = c[kind][name](x)
            parts = [r["modules"][(kind, name, h)] for r in ranks]
            height = parts[0][1]
            assert height == want.shape[1]
            assert [p[0].shape[1] for p in parts] == [len(s) for s in split_rows(height,
                                                                                mesh[1])]
            got = torch.cat([p[0] for p in parts], 1)
            if kind == "convs":
                torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
            else:
                assert torch.equal(got, want), float((got - want).abs().max())
    x8, sa = Q._quant_tensor(x)
    for r in ranks:
        amax, codes = r["modules"][("codes", h)]
        assert torch.equal(amax.reshape(()), x.abs().amax())
    assert torch.equal(torch.cat([r["modules"][("codes", h)][1] for r in ranks], 1), x8)


# ---------------------------------------------------------- pipeline level
@pytest.mark.parametrize("call", ["video", "tail", "chunk1", "chunk2", "gather", "drawn",
                                  *(f"{n}_ref" for n in JAX_RUNS)])
@pytest.mark.parametrize("mesh", MESHES)
def test_generate_shard_clip_matches_reference_and_unsharded(runs, mesh, call):
    """generate(shard_clip=True) at world size 4 against the port's
    unsharded generate (the same init latents, or the same generator for
    "drawn"), and, for the REF calls on the mesh the reference ran them on,
    against the reference's shard_clip generate on four JAX devices; every
    rank returns the whole clip."""
    every = [r["x".join(map(str, mesh))]["generate"][call] for r in runs["ranks"]]
    got = every[0]
    assert got.shape == (1, F, *(REF if call.endswith("_ref") else SMALL), 3)
    for other in every[1:]:
        assert torch.equal(other, got)
    np.testing.assert_allclose(got.numpy(), runs["port"][call].numpy(), atol=ATOL, rtol=0)
    if JAX_RUNS.get(call.removesuffix("_ref")) == mesh and call.endswith("_ref"):
        np.testing.assert_allclose(got.numpy(), runs["ref"][call], atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
def test_frame_parallel_decode_is_one_program_over_the_groups(runs, mesh, chunk):
    """The frame-parallel decode with an int8 decoder: the complete chunks'
    temporal groups split over the four ranks (3 groups of 1 frame, padded
    with a copy; or 1 group of 2 and a tail of 1) equal one decode of all
    complete groups at once, as the reference's one program, whose int8
    convs take their amax over every group; the tail is decoded alone."""
    lat = decode_latents()
    pipe = runs["vae8"]
    main = F // chunk * chunk
    with torch.no_grad():
        groups = pipe._decode(lat[:, :main].reshape(main, 4, 16, 4), chunk)
        parts = [groups.reshape(1, main, *groups.shape[2:])]
        if F > main:
            parts.append(pipe._decode(lat[:, main:].reshape(F - main, 4, 16, 4), F - main))
    want = torch.cat(parts, dim=1)
    for r in runs["ranks"]:
        got = r["x".join(map(str, mesh))]["decode"][chunk]
        assert got.shape == want.shape == (1, F, *SMALL, 3)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_generate_shard_clip_int8_within_the_int8_bound(runs, mesh):
    """W8A8 (`quantize_unet`): every int8 conv takes the amax of the whole
    call over the ranks; the rest of the arithmetic differs in rounding,
    which int8 codes amplify, so the frames are held to the int8 bound."""
    got = runs["ranks"][0]["x".join(map(str, mesh))]["generate"]["int8"].numpy()
    d = np.abs(got - runs["port"]["int8"].numpy())
    assert d.max() <= INT8_MAX and d.mean() <= INT8_MEAN, (d.max(), d.mean())


def test_shard_clip_refusals(runs):
    """The reference's two ValueErrors (no 'fsdp' axis; dp not 1 or 2), and
    a UNet sharded by `shard_unet` (the port's departure: the UNet must be
    whole on every rank)."""
    got = runs["ranks"][0]["refusals"]
    assert got["no_fsdp"].startswith("ValueError: shard_clip shards latent spatial rows "
                                     "over an 'fsdp' mesh axis, absent from this mesh "
                                     "(axes: ('dp',))")
    assert got["dp4"].startswith("ValueError: shard_clip splits the CFG fold's 2 UNet rows "
                                 "over the 'dp' mesh axis") and "(got 4)" in got["dp4"]
    assert got["fsdp2"].startswith("ValueError: shard_clip runs the UNet whole")


def test_split_rows_rule():
    assert split_rows(9, 4) == [range(0, 3), range(3, 5), range(5, 7), range(7, 9)]
    assert split_rows(2, 4) == [range(0, 1), range(1, 2), range(2, 2), range(2, 2)]
    assert [len(r) for r in split_rows(72, 4)] == [18] * 4
    assert sum(map(len, split_rows(18, 4))) == 18
