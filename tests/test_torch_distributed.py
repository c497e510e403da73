"""Port parity of the multi-process paths on the CPU: the (dp, fsdp) mesh,
FSDP2-sharded training, checkpoints across world sizes, the train CLI under
`torch.distributed.run`, and `generate`'s batch-sharded mesh path.

Two gloo ranks run as subprocesses of `tests/torch_dist_ranks.py` (a
`file://` rendezvous in the test's temp dir, one torch thread a rank) on
the tiny pipeline of `test_torch_train` (the reference's weights), while
this process computes the reference's steps (at mesh (1, 2)) and generate
(at (2, 1)) on a 2-device JAX CPU mesh (`make_mesh(..., devices=
jax.devices()[:2])`) and the port's own unsharded ones. Every rank gets the global batch's draws (JAX's,
recomputed from its key) and trains on its rows, so a step at world size 2
computes what the reference computes on the global batch.

Tolerances: parameters and EMA within STEP_ATOL (1e-4, as the unsharded
step test) of the reference's and of the port's unsharded step (Adafactor:
but where rounding decides its update's sign, `test_torch_optimizers.
assert_steps_close`); the loss
within LOSS_REL; the frames within 1e-4 absolute and one uint8 level (the
generate tests' bounds).
"""

import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data import traj_root  # noqa: F401  (the synthetic trajectory tree)
from test_models import TINY_VAE
from test_torch_models import port_cfg
from test_torch_optimizers import assert_steps_close
from test_torch_train import (  # noqa: F401  (ref: the reference pipeline fixture)
    F, H, J_CLIP, LOSS_REL, STEP_ATOL, W, _batch, _flat, _t, jax_draws, port_pipeline,
    ref)
from wiw_tpu.parallel.mesh import _leaf_spec
from wiw_tpu.parallel.mesh import make_mesh as jax_mesh
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.train import trainer as JT
from wiw_tpu_torch.models import clip as TC
from wiw_tpu_torch.models import vae as TV
from wiw_tpu_torch.parallel import mesh as TM
from wiw_tpu_torch.parallel import multihost
from wiw_tpu_torch.sampling.pipeline import GenerationConfig
from wiw_tpu_torch.train import trainer as TT
from wiw_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HELPER = str(REPO / "tests" / "torch_dist_ranks.py")
WORLD = 2
STEP_KW = dict(learning_rate=1e-3, grad_accum_steps=2, use_ema=True,
               ema_decay=0.5, max_grad_norm=0.05, weight_decay=0.1)
MESHES = [(1, 2), (2, 1)]
OPTIMIZERS = ["adamw", "adamw_bf16m", "adafactor"]
GEN_STEPS = 4
OUT_HW = (24, 20)


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                PYTHONHASHSEED="0")


def launch(inputs: dict, tmp: Path) -> list:
    """Start WORLD ranks of the helper on `inputs`; they write to tmp."""
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return [subprocess.Popen([sys.executable, HELPER, path, str(r), str(WORLD), str(tmp)],
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(WORLD)]


def join(procs: list, timeout: float = 600) -> None:
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out[-4000:]


def global_step(s: int):
    """Step s's global batch ([A, B, ...], A = 2 micro-steps of B = 2 rows),
    its key and the reference's draws of each micro-step."""
    micro = [_batch(B=WORLD, seed=10 * s + i) for i in range(2)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    key = jax.random.PRNGKey(100 + s)
    return batch, key, [jax_draws(k, WORLD) for k in jax.random.split(key, 2)]


def ref_step(jpipe, params, kw, mesh, batch, key):
    """The reference's jitted step on a 2-device JAX mesh."""
    jtr = JT.Trainer(jpipe, JT.TrainConfig(**kw), mesh=mesh)
    state = jtr.init_state(params)
    step_fn = jtr.make_train_step()
    frozen = {"vae": params["vae"], "clip": params["clip"]}
    state, frozen, jb = jtr.place(state, frozen, jax.tree_util.tree_map(jnp.asarray, batch))
    state, m = step_fn(state, frozen, jb, key)
    return state, float(m["loss"])


def port_steps(params, kw, steps, state_dict=None):
    """The port's unsharded trainer after `steps` (batch, draws) pairs."""
    trainer = TT.Trainer(port_pipeline(params), TT.TrainConfig(**kw))
    state = trainer.init_state()
    if state_dict is not None:
        state.load_state_dict(state_dict)
    metrics = [trainer.train_step(state, _t(b), draws=d) for b, d in steps]
    return state, metrics


def gen_config(port: bool, **over):
    kw = dict(height=H, width=W, num_frames=F, num_inference_steps=GEN_STEPS,
              noise_aug_strength=0.0)
    kw.update(over)
    return GenerationConfig(**kw) if port else JGen(**kw)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The ranks' results beside the reference's and the port's unsharded
    ones. The ranks run while this process computes the references."""
    jpipe, params = ref
    tmp = tmp_path_factory.mktemp("dist")
    pipe = port_pipeline(params)
    steps = {s: global_step(s) for s in range(4)}
    batch0, key0, draws0 = steps[0]
    # world size 1 writes the checkpoints the ranks restore (after step 1)
    ckpts, restore_steps = {}, [(_t(steps[s][0]), steps[s][2]) for s in (2, 3)]
    for opt in OPTIMIZERS:
        ckpts[opt] = str(tmp / f"ck_ws1_{opt}"), str(tmp / f"ck_ws2_{opt}")
        st1, _ = port_steps(params, dict(STEP_KW, optimizer=opt), [steps[1][::2]])
        CheckpointManager(ckpts[opt][0]).save(st1.step, st1.state_dict())

    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.uniform(-1, 1, (WORLD, H, W, 3)).astype(np.float32))
    actions = torch.from_numpy(rng.integers(1, 4, (WORLD, F)).astype(np.int32))
    noise = torch.from_numpy(rng.standard_normal((WORLD, F, H // 2, W // 2, 4)
                                                 ).astype(np.float32))
    gen = gen_config(True)
    drawn = dict(actions=actions, seed=3, gen=gen_config(True, noise_aug_strength=0.02))
    inputs = {
        "cfgs": (pipe.unet_config, pipe.vae_config, pipe.clip_config),
        "weights": tuple(t.state_dict() for t in (pipe.unet, pipe.vae, pipe.clip)),
        "scenarios": {
            "adamw": {"run": "steps", "kw": STEP_KW, "meshes": MESHES,
                      "batch": _t(batch0), "draws": draws0},
            "adafactor": {"run": "steps", "kw": dict(STEP_KW, optimizer="adafactor"),
                          "meshes": [(1, 2)], "batch": _t(batch0), "draws": draws0},
            **{f"checkpoint {opt}": {
                "run": "checkpoint", "kw": dict(STEP_KW, optimizer=opt), "mesh": (1, 2),
                "restore": (ckpts[opt][0], 1), "save": (ckpts[opt][1], 1),
                "steps": restore_steps} for opt in OPTIMIZERS},
            "draws": {"run": "draws", "mesh": (1, 2), "shape": (1, F, H, W, 3), "seed": 4},
            "generate": {"run": "generate", "mesh": (2, 1), "image": image, "gen": gen,
                         "calls": {"video": dict(actions=actions, init_latents=noise),
                                   "u8": dict(actions=actions, init_latents=noise,
                                              out_uint8_hw=OUT_HW),
                                   "drawn": drawn},
                         "refusals": {"odd": (image[:1], dict(actions=actions[:1])),
                                      "shard_clip": (image, dict(
                                          shard_clip=True, mesh_dims={"dp": WORLD}))}},
        }}
    procs = launch(inputs, tmp)
    try:
        out = {"ref": {}, "port": {}}
        # one reference step each, at mesh (1, 2): the reference's (2, 1)
        # computes the same global-batch step, and a trace costs ~25 s
        jmesh = jax_mesh(dp=1, fsdp=2, devices=jax.devices()[:WORLD])
        for name, kw in (("adamw", STEP_KW), ("adafactor", dict(STEP_KW, optimizer="adafactor"))):
            out["ref"][name] = ref_step(jpipe, params, kw, jmesh, batch0, key0)
        for name, kw in (("adamw", STEP_KW), ("adafactor", dict(STEP_KW, optimizer="adafactor"))):
            out["port"][name] = port_steps(params, kw, [(batch0, draws0)])
        jmesh = jax_mesh(dp=2, fsdp=1, devices=jax.devices()[:WORLD])
        jgen = gen_config(False)
        kw = dict(actions=actions.numpy(), init_latents=noise.numpy(), mesh=jmesh)
        out["ref"]["video"] = np.asarray(jpipe.generate(jax.random.PRNGKey(1), image.numpy(),
                                                        jgen, **kw))
        out["ref"]["u8"] = np.asarray(jpipe.generate(jax.random.PRNGKey(1), image.numpy(),
                                                     jgen, out_uint8_hw=OUT_HW, **kw))
        out["port"]["drawn"] = pipe.generate(
            image, drawn["gen"], actions=actions, generator=torch.Generator().manual_seed(3))
    finally:
        join(procs)
    for name in inputs["scenarios"]:
        out[name] = torch.load(tmp / f"{name}.pt", weights_only=False)
    out.update(params=params, ckpts=ckpts, steps=steps)
    return out


def _close_to(got: dict, want: dict, label: str):
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), atol=STEP_ATOL, rtol=0,
                                   err_msg=f"{label}: {n}")


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dp,fsdp", MESHES)
def test_sharded_adamw_step_matches_reference_and_unsharded(runs, dp, fsdp):
    """One step, grad-accum 2 over the global batch of 2 (a row a rank),
    the clip live, AdamW and the EMA, at mesh (dp, fsdp): against the
    reference's step on a 2-device mesh (1, 2) and the port's unsharded
    step."""
    got = runs["adamw"][f"{dp}x{fsdp}"]
    jstate, jloss = runs["ref"]["adamw"]
    pstate, pm = runs["port"]["adamw"]
    m = got["metrics"][0]
    assert abs(m["loss"] - jloss) <= LOSS_REL * abs(jloss)
    assert m["grad_norm"] > STEP_KW["max_grad_norm"]  # the clip is live
    assert m["grad_norm"] == pytest.approx(float(pm[0]["grad_norm"]), rel=1e-5)
    sd = got["state"]
    assert sd["step"] == 1
    _close_to(sd["params"], _flat(jstate["params"]), "params vs reference")
    _close_to(sd["ema_params"], _flat(jstate["ema_params"]), "EMA vs reference")
    _close_to(sd["params"], {n: p.detach() for n, p in pstate.params.items()},
              "params vs unsharded")
    # the reference's rule on the flax leaf, in the port's layout: a
    # cross-attention key [1024, 64] (flax) splits its 1024 axis, torch's 1
    name = "mid_block.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    assert got["shard_axes"][name] == [1 if fsdp == 2 else 0]


def test_sharded_adafactor_step_matches_reference(runs):
    """Adafactor at fsdp 2: its row and column means and the parameter RMS
    span whole leaves, so they must see both shards."""
    got = runs["adafactor"]["1x2"]
    jstate, jloss = runs["ref"]["adafactor"]
    pstate, _ = runs["port"]["adafactor"]
    assert abs(got["metrics"][0]["loss"] - jloss) <= LOSS_REL * abs(jloss)
    grads = {n: p.grad for n, p in pstate.params.items() if p.grad is not None}
    start = _flat(runs["params"]["unet"])
    lr = STEP_KW["learning_rate"]
    assert_steps_close(got["state"]["params"], _flat(jstate["params"]), grads, start, lr, 1,
                       True, "vs reference")
    assert_steps_close(got["state"]["params"], {n: p.detach() for n, p in pstate.params.items()},
                       grads, start, lr, 1, True, "vs unsharded")
    osd = got["state"]["opt_state"]["state"]
    assert any("v_row" in s for s in osd.values()) and any("v" in s for s in osd.values())


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_checkpoints_restore_across_world_sizes(runs, optimizer):
    """A checkpoint written at world size 1 restores at 2 and one written
    at 2 restores at 1: each continuation equals the uninterrupted run, the
    optimizer's state too (the bf16 moment restored bf16 into the shards,
    Adafactor's factored moments whole from their shards). Adafactor's
    parameters and EMA: but where rounding decides its update
    (`assert_steps_close`, over the two steps after the restore)."""
    params, steps = runs["params"], runs["steps"]
    kw = dict(STEP_KW, optimizer=optimizer)
    seq = [(steps[s][0], steps[s][2]) for s in (2, 3)]
    got = runs[f"checkpoint {optimizer}"]["state"]
    ck1, ck2 = runs["ckpts"][optimizer]
    assert got["step"] == 3
    restored = CheckpointManager(ck1).restore(1)
    whole, _ = port_steps(params, kw, seq, restored)

    def close(got_, want, label):
        if optimizer != "adafactor":
            return _close_to(got_, want, label)
        grads = {n: p.grad for n, p in whole.params.items() if p.grad is not None}
        assert_steps_close(got_, want, grads, restored["params"], STEP_KW["learning_rate"],
                           2, True, label)

    close(got["params"], {n: p.detach() for n, p in whole.params.items()}, "ws1 -> ws2")
    mgr = CheckpointManager(ck2)
    assert mgr.latest_step() == 2
    resumed, _ = port_steps(params, kw, seq[1:], mgr.restore(2))
    assert resumed.step == 3
    close(got["params"], {n: p.detach() for n, p in resumed.params.items()}, "ws2 -> ws1")
    close(got["ema_params"], dict(zip(resumed.params, resumed.ema)), "EMA ws2 -> ws1")
    want = resumed.state_dict()["opt_state"]["state"]
    assert got["opt_state"]["state"].keys() == want.keys()
    for n, st in want.items():
        assert got["opt_state"]["state"][n].keys() == st.keys(), n
        for key, w in st.items():
            g = got["opt_state"]["state"][n][key]
            assert g.dtype == w.dtype and g.shape == w.shape, (n, key)
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       atol=STEP_ATOL, rtol=0, err_msg=f"{n} {key}")
    if optimizer == "adamw_bf16m":
        assert all(st["mu"].dtype == torch.bfloat16 for st in want.values())


def test_each_rank_draws_its_rows_of_the_global_draw(runs, ref):
    """With a generator, every rank draws the global batch's tensors and
    keeps its rows: together they are one device's draw for the batch."""
    whole = TT.Trainer(port_pipeline(ref[1]), TT.TrainConfig()).sample_draws(
        (WORLD, F, H, W, 3), True, torch.Generator().manual_seed(4))
    every = runs["draws"]
    assert len(every) == WORLD
    for k, v in whole.items():
        torch.testing.assert_close(torch.cat([d[k] for d in every]), v, rtol=0, atol=0,
                                   msg=k)


# ------------------------------------------------------------- generate
def test_generate_on_a_mesh_matches_reference(runs):
    """generate(mesh=) at world size 2 (a row a rank, the UNet whole on
    each) against the reference's generate(mesh=make_mesh(dp=2, fsdp=1))
    from the same init latents; the drawn noise is the global draw cut to
    the rank's rows: the frames equal the port's unsharded generate from
    the same generator."""
    got, ref_ = runs["generate"], runs["ref"]
    assert got["video"].shape == ref_["video"].shape == (WORLD, F, H, W, 3)
    np.testing.assert_allclose(got["video"].numpy(), ref_["video"], atol=1e-4, rtol=0)
    assert got["u8"].dtype == torch.uint8 and got["u8"].shape == (WORLD, F, *OUT_HW, 3)
    diff = np.abs(got["u8"].numpy().astype(np.int16) - ref_["u8"].astype(np.int16))
    assert diff.max() <= 1
    np.testing.assert_allclose(got["drawn"].numpy(), runs["port"]["drawn"].numpy(),
                               atol=1e-5, rtol=0)


def test_generate_mesh_refusals(runs):
    got = runs["generate"]
    assert got["odd"].startswith("ValueError: batch 1 must be a multiple of the mesh size 2")
    assert got["shard_clip"].startswith(
        "ValueError: shard_clip shards latent spatial rows over an 'fsdp' mesh axis, "
        "absent from this mesh (axes: ('dp',))")


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("shape", [(7,), (320,), (1024, 64), (64, 1024), (3, 3, 64, 64),
                                   (3, 3, 320, 640), (3, 1, 1, 640, 640), (5, 1024, 13),
                                   (255, 257), (1024,) * 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_leaf_axis_is_the_references_rule(shape, n):
    spec = _leaf_spec(None, np.empty(shape, np.bool_), n)
    want = next((i for i, a in enumerate(spec) if a == "fsdp"), None)
    assert TM.leaf_axis(shape, n) == want


def test_batch_rows_and_mesh_refusals(tmp_path):
    import torch.distributed as dist

    multihost.initialize_distributed("cpu", init_method=f"file://{tmp_path}/pg",
                                     world_size=1, rank=0)
    try:
        assert multihost.is_primary()
        mesh = TM.make_mesh(1, 1)
        assert mesh.mesh_dim_names == ("dp", "fsdp") and mesh.device_type == "cpu"
        assert TM.batch_rows(mesh, 0, 3) == range(0, 3)
        with pytest.raises(ValueError, match=r"dp\(2\) \* fsdp\(1\) != devices\(1\)"):
            TM.make_mesh(2, 1)
    finally:
        dist.destroy_process_group()

    class Mesh:  # the rows of a (2, 2) mesh whose ranks are laid out 3, 1, 0, 2
        mesh = torch.tensor([[3, 1], [0, 2]])

        def size(self):
            return 4

    assert [TM.batch_rows(Mesh(), r, 8) for r in range(4)] == [
        range(4, 6), range(2, 4), range(6, 8), range(0, 2)]
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        TM.batch_rows(Mesh(), 0, 6)


def test_a_failed_init_raises(monkeypatch):
    """R4: the launcher's environment asks for a group whose store nobody
    serves; the reference would train alone, the port raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="refusing to run as a single process"):
        multihost.initialize_distributed("cpu", timeout=datetime.timedelta(seconds=2))
    assert time.monotonic() - t < 60


def test_prefetch_loader_fetches_its_rows():
    """A rank fetches items s * global + i of step s for its rows i of the
    global batch, as `batch_rows` gives them (a mesh of 3 whose ranks are
    laid out 2, 0, 1)."""
    from wiw_tpu_torch.data.loader import PrefetchLoader

    class Items:
        def __getitem__(self, i):
            return {"i": np.array(i)}

    class Mesh:
        mesh = torch.tensor([[2, 0, 1]])

        def size(self):
            return 3

    got = [[b["i"].tolist() for b in PrefetchLoader(
        Items(), 6, 3, num_workers=1, rows=TM.batch_rows(Mesh(), r, 6))]
        for r in range(3)]
    assert got[0] == [[2, 3], [8, 9], [14, 15]]
    assert sorted(sum((sum(g, []) for g in got), [])) == list(range(18))


# ------------------------------------------------------------------ CLI
def test_train_cli_under_torchrun_trains_writes_from_rank_0_and_resumes(
        traj_root, tmp_path):  # noqa: F811
    cfgs = str(tmp_path / "towers.pt")
    torch.save({"vae": port_cfg(TV.VAEConfig, TINY_VAE),
                "clip": port_cfg(TC.CLIPVisionConfig, J_CLIP)}, cfgs)
    out = str(tmp_path / "run")
    argv = ["--data_root", traj_root, "--output_dir", out, "--device", "cpu",
            "--fsdp", "2", "--unet_channels", "16", "32", "--unet_heads", "1", "2",
            "--sample_frames", "4", "--action_input_channel", "4",
            "--width", "32", "--height", "16", "--grad_accum", "2",
            "--checkpointing_steps", "2", "--validation_steps", "2",
            "--loader_workers", "1", "--use_ema", "--gradient_checkpointing"]

    def run(*extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(WORLD), HELPER, "cli", cfgs, *argv, *extra]
        p = subprocess.run(cmd, env=_env(), cwd=tmp_path, capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
        return p.stdout

    text = run("--max_steps", "2")
    assert text.count("validation @ 2: {'psnr':") == 1  # rank 0 alone prints
    mgr = CheckpointManager(out)
    assert mgr.latest_step() == 2
    assert sorted(os.listdir(out + "/checkpoint-2")) == ["state.pt"]
    first = mgr.restore()
    assert first["step"] == 2 and "ema_params" in first
    name = "conv_in.weight"
    assert first["params"][name].shape == (16, 8, 3, 3)  # gathered whole
    text = run("--max_steps", "3", "--resume_from_checkpoint", "latest")
    assert text.count("resumed at step 2") == 1
    last = CheckpointManager(out).restore()
    assert last["step"] == 3
    assert not torch.equal(last["params"][name], first["params"][name])

