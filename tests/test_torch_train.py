"""Port parity of SVD-dagger post-training: the trainer, its draws, the
data feed, checkpoints, the CLI and the validation metrics, on the CPU.

Tiny towers (TINY_UNET with micro_cond, TINY_VAE, TINY_CLIP projecting to
the UNet's context width), fp32, the same weights in both packages
(`load_flax_params`), seeded numpy inputs. JAX and torch random streams
differ, so the port's loss takes every random tensor as `draws`; the tests
recompute JAX's own draws from `jax.random.split(key, 6)` the way the
reference's `loss_fn` makes them and hand them to the port. Tolerances:
the loss within 1e-5 relative; each gradient leaf within 1e-4 relative
Frobenius error (fp32 reordering through ~40 stacked layers); parameters
and EMA after two AdamW steps within 1e-4.
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data import traj_root  # noqa: F401  (the synthetic trajectory tree)
from test_models import TINY_CLIP, TINY_UNET, TINY_VAE
from test_torch_models import port_cfg
from wiw_tpu.core import schedule as JS
from wiw_tpu.data import dataset as JD
from wiw_tpu.data import loader as JL
from wiw_tpu.eval import metrics as JM
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.sampling.pipeline import SVDPipeline as JPipe
from wiw_tpu.train import trainer as JT
from wiw_tpu_torch.core import schedule as TS
from wiw_tpu_torch.data import dataset as TD
from wiw_tpu_torch.data import loader as TL
from wiw_tpu_torch.eval import metrics as TM
from wiw_tpu_torch.models import clip as TC
from wiw_tpu_torch.models import convert as TCV
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.models import vae as TV
from wiw_tpu_torch.sampling.pipeline import SVDPipeline
from wiw_tpu_torch.train import checkpoints as TCK
from wiw_tpu_torch.train import train_cli
from wiw_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

J_UNET = dataclasses.replace(TINY_UNET, action_strategy="micro_cond",
                             action_input_channel=3)
J_CLIP = dataclasses.replace(TINY_CLIP, projection_dim=TINY_UNET.cross_attention_dim)
F, H, W = 3, 16, 32  # frames; the latent width 16 takes the pano-correlated noise
SCALE = 2  # TINY_VAE's spatial scale
LOSS_REL, GRAD_REL, STEP_ATOL = 1e-5, 1e-4, 1e-4


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def ref():
    """The reference pipeline and its random weights (numpy leaves)."""
    jpipe = JPipe(J_UNET, TINY_VAE, J_CLIP)
    jpipe.init_params(jax.random.PRNGKey(0), JGen(height=H, width=W, num_frames=F))
    return jpipe, jax.tree_util.tree_map(np.asarray, jpipe.params)


def port_pipeline(params, **unet_over) -> SVDPipeline:
    """The port's pipeline on the reference's weights, with the training
    layout: fp32 UNet parameters (trainable once a trainer unfreezes them)."""
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, J_UNET, param_dtype="float32", **unet_over),
                       port_cfg(TV.VAEConfig, TINY_VAE),
                       port_cfg(TC.CLIPVisionConfig, J_CLIP), device="cpu")
    pipe.load_flax_params(params)
    return pipe


def _batch(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            "actions": rng.integers(1, 4, (B, F)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_draws(key, B):
    """Every random tensor of the reference's loss_fn for `key`, recomputed
    as it makes them (trainer.py: keys = jax.random.split(key, 6))."""
    k = jax.random.split(key, 6)
    h, w = H // SCALE, W // SCALE

    def normal(kk, shape):
        return torch.from_numpy(np.asarray(jax.random.normal(kk, shape, jnp.float32)))

    return {"vae_eps": normal(k[0], (B * F, h, w, 4)),
            "cond_sigma_z": normal(k[1], (B, 1, 1, 1)),
            "cond_noise": normal(k[2], (B, H, W, 3)),
            "latent_noise": normal(k[3], (B, F, 4, h, w)),
            "sigma_z": normal(k[4], (B, 1, 1, 1, 1)),
            "dropout_u": torch.from_numpy(np.asarray(jax.random.uniform(k[5], (B,))))}


def _flat(tree) -> dict:
    """Reference tree -> {port parameter name: fp32 tensor}."""
    return TCV.flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------- draws, VAE
def test_training_draws_match_reference():
    sig = np.asarray([0.01, 0.3, 2.0, 80.0], np.float32)
    np.testing.assert_allclose(TS.edm_loss_weight(torch.from_numpy(sig)).numpy(),
                               np.asarray(JS.edm_loss_weight(jnp.asarray(sig))),
                               rtol=1e-6)
    key = jax.random.PRNGKey(5)
    z5 = torch.from_numpy(np.asarray(jax.random.normal(key, (3, 1, 1, 1, 1), jnp.float32)))
    z4 = torch.from_numpy(np.asarray(jax.random.normal(key, (3, 1, 1, 1), jnp.float32)))
    np.testing.assert_allclose(TS.sample_training_sigmas(3, z=z5).numpy(),
                               np.asarray(JS.sample_training_sigmas(key, 3)), rtol=1e-6)
    np.testing.assert_allclose(TS.sample_cond_sigmas(3, z=z4).numpy(),
                               np.asarray(JS.sample_cond_sigmas(key, 3)), rtol=1e-6)
    # drawn from a generator: the lognormal's parameters
    g = torch.Generator().manual_seed(0)
    s = TS.sample_training_sigmas(20000, generator=g).log()
    assert s.shape == (20000, 1, 1, 1, 1)
    assert abs(s.mean().item() - 0.7) < 0.05 and abs(s.std().item() - 1.6) < 0.05
    with pytest.raises(ValueError):
        TS.sample_cond_sigmas(2, z=z4)


def test_vae_posterior_sample_matches_reference(ref):
    jpipe, params = ref
    tvae = port_pipeline(params).vae
    frames = np.random.default_rng(1).uniform(-1, 1, (3, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jpipe.vae.apply({"params": params["vae"]}, frames, key,
                                      method=jpipe.vae.encode))
    eps = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = tvae.encode(torch.from_numpy(frames), eps=torch.from_numpy(eps))
        mean = tvae.encode(torch.from_numpy(frames))
        drawn = tvae.encode(torch.from_numpy(frames), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(got, mean) and not torch.allclose(drawn, mean)


# --------------------------------------------------------- loss, gradients
@pytest.fixture(scope="module")
def ref_loss_and_grads(ref):
    jpipe, params = ref
    jtr = JT.Trainer(jpipe, JT.TrainConfig())
    frozen = {"vae": params["vae"], "clip": params["clip"]}
    batch = _batch()
    key = jax.random.PRNGKey(3)
    loss, grads = jax.jit(jax.value_and_grad(jtr.loss_fn))(
        params["unet"], frozen, jax.tree_util.tree_map(jnp.asarray, batch), key)
    return batch, key, float(loss), _flat(grads)


def _port_grads(params, batch, draws, **unet_over):
    pipe = port_pipeline(params, **unet_over)
    trainer = TT.Trainer(pipe, TT.TrainConfig())
    state = trainer.init_state()
    loss = trainer.loss_fn(_t(batch), draws=draws)
    loss.backward()
    return loss, {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                  for n, p in state.params.items()}


def test_loss_and_every_unet_gradient_match_reference(ref, ref_loss_and_grads):
    _, params = ref
    batch, key, want_loss, want = ref_loss_and_grads
    loss, grads = _port_grads(params, batch, jax_draws(key, 2))
    assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss)
    assert set(grads) == set(want)
    top = max(float(torch.linalg.vector_norm(g)) for g in want.values())
    checked = 0
    for name, r in want.items():
        g, rn = grads[name], float(torch.linalg.vector_norm(r))
        assert g.shape == r.shape, name
        if rn <= 1e-6 * top:
            # zero in exact arithmetic (add_embedding is unused under
            # micro_cond; a bias right before a GroupNorm of one channel per
            # group is normalised away): both sides are rounding noise
            assert float(torch.linalg.vector_norm(g)) <= 1e-5 * top, name
            continue
        assert _rel(g.numpy(), r.numpy()) < GRAD_REL, name
        checked += 1
    assert checked > 0.8 * len(want)


def test_remat_gradients_equal_plain_gradients(ref, ref_loss_and_grads):
    _, params = ref
    batch, key, _, _ = ref_loss_and_grads
    draws = jax_draws(key, 2)
    loss0, plain = _port_grads(params, batch, draws)
    loss1, remat = _port_grads(params, batch, draws, remat=True)
    assert loss0.item() == loss1.item()
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, rtol=0, atol=0, msg=name)


def test_two_accumulated_steps_with_ema_match_reference(ref):
    """Two optimizer steps, each over two micro-batches (grad_accum 2), with
    clipping (the norm of these gradients is above 0.05), AdamW and the EMA:
    the parameters and the EMA against the reference's jitted train step."""
    jpipe, params = ref
    kw = dict(learning_rate=1e-3, grad_accum_steps=2, use_ema=True,
              ema_decay=0.5, max_grad_norm=0.05, weight_decay=0.1)
    jtr = JT.Trainer(jpipe, JT.TrainConfig(**kw))
    jstate = jtr.init_state(params)
    frozen = {"vae": params["vae"], "clip": params["clip"]}
    step_fn = jtr.make_train_step()

    pipe = port_pipeline(params)
    trainer = TT.Trainer(pipe, TT.TrainConfig(**kw))
    state = trainer.init_state()
    for s in range(2):
        micro = [_batch(B=1, seed=10 * s + i) for i in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        key = jax.random.PRNGKey(100 + s)
        jstate, jm = step_fn(jstate, frozen, jax.tree_util.tree_map(jnp.asarray, batch), key)
        draws = [jax_draws(k, 1) for k in jax.random.split(key, 2)]
        m = trainer.train_step(state, _t(batch), draws=draws)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
        assert float(m["grad_norm"]) > kw["max_grad_norm"]  # the clip is live
    assert state.step == 2 == int(jstate["step"])
    want_p, want_e = _flat(jstate["params"]), _flat(jstate["ema_params"])
    moved = 0
    for i, (name, p) in enumerate(state.params.items()):
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(state.ema[i].numpy(), want_e[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)
        moved += not torch.allclose(p, _flat(params["unet"])[name], atol=1e-4)
    assert moved > 0.5 * len(state.params)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("mode", ["full", "new", "new+temp_layer"])
def test_trainable_mask_selects_the_reference_parameters(ref, mode):
    _, params = ref
    want = {TCV.torch_key(path): bool(v) for path, v in
            TCV._flatten(JT.trainable_mask(params["unet"], mode))}
    got = TT.trainable_mask(port_pipeline(params).unet, mode)
    assert got == want
    assert any(got.values()) and (mode == "full") == all(got.values())


@pytest.mark.parametrize("sched,warm", [("constant", 0), ("constant", 10),
                                        ("constant_with_warmup", 10),
                                        ("linear", 10), ("cosine", 10),
                                        ("cosine", 0)])
def test_lr_schedules_equal_optax(sched, warm):
    cfg = dict(learning_rate=1e-3, lr_scheduler=sched, lr_warmup_steps=warm,
               lr_total_steps=100)
    jtr = JT.Trainer.__new__(JT.Trainer)
    jtr.cfg = JT.TrainConfig(**cfg)
    want = jtr._make_schedule()
    got = TT.lr_schedule(TT.TrainConfig(**cfg))
    for count in (0, 1, 10, 55, 110):
        w = float(want(count)) if callable(want) else float(want)
        assert got(count) == pytest.approx(w, rel=1e-6, abs=1e-12), count


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_conditioning_dropouts_match_reference(kind):
    key = jax.random.PRNGKey(11)
    B = 64
    rng = np.random.default_rng(2)
    clip, cond = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, 1, 8), (B, 4, 4, 4)))
    acts = rng.standard_normal((B, F, F)).astype(np.float32)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (B,))))
    if kind == "discrete":
        want = JT.apply_discrete_dropout(key, clip, cond, acts)
        got = TT.apply_discrete_dropout(u, *map(torch.from_numpy, (clip, cond, acts)))
    else:
        want = JT.apply_continuous_dropout(key, 0.1, clip, cond, acts)
        got = TT.apply_continuous_dropout(u, 0.1, *map(torch.from_numpy, (clip, cond, acts)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_trainer_refuses_what_is_not_ported(ref):
    _, params = ref
    pipe = port_pipeline(params)
    for opt in ("adamw_bf16m", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.Trainer(pipe, TT.TrainConfig(optimizer=opt))
    with pytest.raises(NotImplementedError, match="mesh"):
        TT.Trainer(pipe, TT.TrainConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="fsdp"):
        train_cli.build(train_cli.parse_args(["--data_root", "x", "--fsdp", "2",
                                              "--device", "cpu"]))


# ------------------------------------------------------------ checkpoints
def _state(step: int, scale: float):
    return {"params": {"w": torch.full((4, 3), scale),
                       "b": torch.arange(3, dtype=torch.float32) * scale},
            "opt_state": {"mu": torch.ones(4, 3, dtype=torch.bfloat16),
                          "groups": [{"lr": 1e-3, "betas": (0.9, 0.999)}]},
            "step": step}


def _assert_states_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_states_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_states_equal(x, y)
    else:
        assert a == b


class TestCheckpointManager:
    def test_roundtrip_and_latest(self, tmp_path):
        mgr = TCK.CheckpointManager(str(tmp_path))
        s7 = _state(7, 0.5)
        mgr.save(7, s7)
        mgr.save(9, _state(9, 2.0))
        assert mgr.latest_step() == 9
        assert mgr.restore()["step"] == 9
        _assert_states_equal(mgr.restore(step=7), s7)
        assert osp.isfile(tmp_path / "checkpoint-7" / TCK.STATE_FILE)

    def test_keep_limit_prunes_oldest(self, tmp_path):
        mgr = TCK.CheckpointManager(str(tmp_path), total_limit=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, _state(step, float(step)))
        assert mgr.latest_step() == 4
        assert not osp.isdir(tmp_path / "checkpoint-1")
        assert not osp.isdir(tmp_path / "checkpoint-2")
        assert osp.isdir(tmp_path / "checkpoint-3")

    def test_restore_empty_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            TCK.CheckpointManager(str(tmp_path)).restore()

    def test_async_save_snapshots_and_joins(self, tmp_path):
        mgr = TCK.CheckpointManager(str(tmp_path), total_limit=2, async_save=True)
        states = {s: _state(s, float(s)) for s in (1, 2, 3)}
        want = _state(3, 3.0)
        for s in (1, 2, 3):
            mgr.save(s, states[s])  # returns before the write lands
        states[3]["params"]["w"].fill_(-1.0)  # the snapshot was taken at save()
        restored = mgr.restore()  # joins the write in flight
        _assert_states_equal(restored, want)
        mgr.wait()
        assert not osp.isdir(tmp_path / "checkpoint-1")
        assert osp.isdir(tmp_path / "checkpoint-2")

    def test_async_save_prunes_mid_run(self, tmp_path):
        limit = 2
        mgr = TCK.CheckpointManager(str(tmp_path), total_limit=limit, async_save=True)
        for s in range(1, 8):
            mgr.save(s, _state(s, float(s)))
            n_dirs = len([d for d in tmp_path.iterdir()
                          if d.name.startswith("checkpoint-")])
            assert n_dirs <= limit + 1, f"after save({s}): {n_dirs} dirs"
        mgr.wait()
        assert mgr.latest_step() == 7
        assert not osp.isdir(tmp_path / "checkpoint-5")
        assert osp.isdir(tmp_path / "checkpoint-6")

    def test_async_then_sync_manager_resumes(self, tmp_path):
        mgr = TCK.CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(5, _state(5, 1.5))
        mgr.wait()
        assert TCK.CheckpointManager(str(tmp_path)).restore()["step"] == 5


def test_train_state_roundtrips_through_a_checkpoint(ref, tmp_path):
    """Model, optimizer, EMA and step: a trained state saved and restored
    into a fresh trainer continues with the same next step."""
    _, params = ref
    kw = dict(learning_rate=1e-3, use_ema=True, ema_decay=0.5)

    def fresh():
        trainer = TT.Trainer(port_pipeline(params), TT.TrainConfig(**kw))
        return trainer, trainer.init_state()

    batch = _t(_batch(B=1))
    draws = [jax_draws(jax.random.PRNGKey(s), 1) for s in range(2)]
    tr, st = fresh()
    tr.train_step(st, batch, draws=draws[:1])
    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save(st.step, st.state_dict())
    tr2, st2 = fresh()
    st2.load_state_dict(mgr.restore())
    assert st2.step == 1
    for st_, tr_ in ((st, tr), (st2, tr2)):
        tr_.train_step(st_, batch, draws=draws[1:])
    for (n, p), p2, e, e2 in zip(st.params.items(), st2.params.values(), st.ema, st2.ema):
        torch.testing.assert_close(p2, p, rtol=0, atol=0, msg=n)
        torch.testing.assert_close(e2, e, rtol=0, atol=0, msg=n)


# ------------------------------------------------------------- data feed
def _items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("cls,kw", [
    ("TrajectoryDataset", {}),
    ("WeightedDataset", dict(weighted_method="exponential", cutoff_thr=0.45)),
    ("StraightDataset", {})])
def test_datasets_match_reference(traj_root, cls, kw):  # noqa: F811
    args = ([traj_root],)
    common = dict(sample_frames=4, width=24, height=12, fix_seed=True, **kw)
    ref_ds, port_ds = getattr(JD, cls)(*args, **common), getattr(TD, cls)(*args, **common)
    assert len(port_ds) == len(ref_ds)
    for i in range(min(len(ref_ds), 4)):
        _items_equal(port_ds[i], ref_ds[i])
    if cls == "WeightedDataset":
        np.testing.assert_array_equal(port_ds.sample_weights, ref_ds.sample_weights)


def test_iterate_batches_and_prefetch_loader_match_reference(traj_root):  # noqa: F811
    """Each dataset draws its windows from its own seeded stream in call
    order, so every run gets a fresh dataset and one fetch thread."""
    def fresh(mod):
        return mod.TrajectoryDataset([traj_root], sample_frames=4, width=24,
                                     height=12, fix_seed=True)

    want = list(JD.iterate_batches(fresh(JD), batch_size=2, num_steps=3))
    for got in (list(TD.iterate_batches(fresh(TD), batch_size=2, num_steps=3)),
                list(TL.PrefetchLoader(fresh(TD), 2, 3, num_workers=1))):
        assert len(got) == 3
        for g, w in zip(got, want):
            for k in ("pixel_values", "actions"):
                np.testing.assert_array_equal(g[k], w[k])
    ref_l = list(JL.PrefetchLoader(fresh(JD), 2, 2, num_workers=1))
    port_l = list(TL.PrefetchLoader(fresh(TD), 2, 2, num_workers=1))
    assert len(port_l) == len(ref_l) == 2
    for g, w in zip(port_l, ref_l):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_loader_places_batches_in_the_background(ref):
    """The trainer's place_batch as the loader's hook: tensors on the
    trainer's device, assembled and placed off the main thread, errors
    surfaced to the consumer."""
    import threading

    _, params = ref
    trainer = TT.Trainer(port_pipeline(params), TT.TrainConfig())
    seen = set()

    class Items:
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("corrupt item")
            return {"pixel_values": np.full((2, 2), i, np.float32),
                    "actions": np.array([i], np.int64)}

    def place(b):
        seen.add(threading.get_ident())
        return trainer.place_batch(b)

    out = list(TL.PrefetchLoader(Items(), 2, 2, transform=train_cli.accum_transform(2),
                                 place=place))
    assert seen and threading.get_ident() not in seen
    assert isinstance(out[1]["actions"], torch.Tensor)
    assert out[1]["actions"].shape == (2, 2, 1)
    assert out[1]["actions"][1].ravel().tolist() == [2, 3]
    with pytest.raises(RuntimeError, match="corrupt item"):
        list(TL.PrefetchLoader(Items(), 4, 3, place=place))


# ------------------------------------------------------------------- CLI
def test_train_cli_trains_checkpoints_and_resumes(traj_root, tmp_path, monkeypatch,  # noqa: F811
                                                  capsys):
    monkeypatch.setattr(train_cli, "VAE_CONFIG", port_cfg(TV.VAEConfig, TINY_VAE))
    monkeypatch.setattr(train_cli, "CLIP_CONFIG", port_cfg(TC.CLIPVisionConfig, J_CLIP))
    out = str(tmp_path / "run")
    argv = ["--data_root", traj_root, "--output_dir", out, "--device", "cpu",
            "--unet_channels", "16", "32", "--unet_heads", "1", "2",
            "--sample_frames", "4", "--action_input_channel", "4",
            "--width", "32", "--height", "16", "--grad_accum", "2",
            "--checkpointing_steps", "2", "--validation_steps", "2",
            "--loader_workers", "2", "--use_ema", "--gradient_checkpointing"]
    train_cli.main(argv + ["--max_steps", "2"])
    text = capsys.readouterr().out
    assert "validation @ 2: {'psnr':" in text
    mgr = TCK.CheckpointManager(out)
    assert mgr.latest_step() == 2
    first = mgr.restore()
    assert first["step"] == 2 and "ema_params" in first
    train_cli.main(argv + ["--max_steps", "3", "--resume_from_checkpoint", "latest"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert mgr.latest_step() == 3
    last = mgr.restore()
    assert last["step"] == 3
    name = "conv_in.weight"
    assert not torch.equal(last["params"][name], first["params"][name])


# --------------------------------------------------------------- metrics
def test_psnr_ssim_match_reference():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (2, 3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(TM.psnr(ta, tb).numpy(), np.asarray(JM.psnr(a, b)),
                               rtol=1e-5)
    np.testing.assert_allclose(TM.ssim(ta, tb).numpy(), np.asarray(JM.ssim(a, b)),
                               rtol=1e-4, atol=1e-5)
    got = TM.evaluate_video_metrics(ta, tb, metrics=("psnr", "ssim"))
    want = JM.evaluate_video_metrics(a, b, metrics=("psnr", "ssim"))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5)
    # LPIPS through `lpips_fn`, the same random upstream-layout weights in
    # both packages (64x64 frames: AlexNet's trunk takes no less than ~63);
    # 1e-4 relative, fp32 convolutions
    from test_torch_eval import lpips_state_dict
    from wiw_tpu.eval import lpips as JLP
    from wiw_tpu_torch.eval import lpips as TLP

    sd = lpips_state_dict(seed=1)
    params = {"net": {}}
    for n, name in {0: "conv0", 3: "conv1", 6: "conv2", 8: "conv3", 10: "conv4"}.items():
        params["net"][name] = {
            "kernel": sd[f"net.features.{n}.weight"].numpy().transpose(2, 3, 1, 0),
            "bias": sd[f"net.features.{n}.bias"].numpy()}
    for i in range(5):
        params[f"lin{i}"] = sd[f"lin{i}.model.1.weight"].numpy().reshape(-1)
    a = rng.uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = TM.evaluate_video_metrics(torch.from_numpy(a), torch.from_numpy(b),
                                    metrics=("lpips",),
                                    lpips_fn=TLP.lpips_with_params(sd))
    want = JM.evaluate_video_metrics(a, b, metrics=("lpips",),
                                     lpips_fn=JLP.lpips_with_params(params))
    assert set(got) == set(want) == {"lpips"}
    assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-4)


# -------------------------------------------- the environment's switches
# The reference reads WIW_FUSED_FF, WIW_FUSED_FF_GATE and WIW_TEMPORAL_ATTN
# at trace time for every caller, its trainer included
# (wiw_tpu/models/layers.py:56, ops/fused_mlp.py:192,
# ops/temporal_attention.py:167); the port's train CLI passes the same
# readings (`unet.env_switches`) into the UNet's config.
def _built_unet_config(monkeypatch, env: dict) -> TU.UNetConfig:
    for k in ("WIW_FUSED_FF", "WIW_FUSED_FF_GATE", "WIW_TEMPORAL_ATTN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}

    class Recorder:  # no weights are made
        def __init__(self, unet_cfg, vae_cfg, clip_cfg, device):
            seen["unet"] = unet_cfg

        def init_params(self, generator):
            pass

    class NoTrainer:
        def __init__(self, pipe, cfg):
            pass

        def init_state(self):
            return None

    monkeypatch.setattr(train_cli, "SVDPipeline", Recorder)
    monkeypatch.setattr(train_cli, "Trainer", NoTrainer)
    train_cli.build(train_cli.parse_args(["--data_root", "x", "--device", "cpu"]))
    return seen["unet"]


@pytest.mark.parametrize("env,fused,gate,mode", [
    ({}, False, "f32", "batched"),
    ({"WIW_FUSED_FF": "1"}, True, "f32", "batched"),
    ({"WIW_FUSED_FF": "true"}, False, "f32", "batched"),
    ({"WIW_FUSED_FF": "1", "WIW_FUSED_FF_GATE": "bf16"}, True, "bf16", "batched"),
    ({"WIW_FUSED_FF_GATE": "BF16"}, False, "f32", "batched"),
    ({"WIW_TEMPORAL_ATTN": "xla"}, False, "f32", "xla"),
    ({"WIW_TEMPORAL_ATTN": "pallas"}, False, "f32", "pallas"),
    ({"WIW_TEMPORAL_ATTN": "flash"}, False, "f32", "batched"),
])
def test_train_cli_reads_the_model_switches(monkeypatch, env, fused, gate, mode):
    from wiw_tpu.models import layers as JLY

    cfg = _built_unet_config(monkeypatch, env)
    assert (cfg.fused_ff, cfg.fused_ff_gate, cfg.temporal_attention) == (fused, gate, mode)
    assert cfg.fused_ff == JLY._fused_ff_on()  # the reference's own reader
    assert cfg.remat is False and cfg.param_dtype == "float32"


def test_fused_ff_step_matches_reference_under_the_same_environment(ref, monkeypatch):
    """One optimizer step under WIW_FUSED_FF=1, the port's UNet taking the
    switches `train_cli.build` reads, against the reference's jitted step
    traced under the same environment (its fused formulation and custom
    VJP). Batch 4 makes 384 rows at the 64-channel level, which K6's rule
    takes: the port's feed-forwards there go through K6's autograd Function
    (its plain version on the CPU, backward by recompute)."""
    from wiw_tpu_torch.models import layers as TLY

    jpipe, params = ref
    cfg = _built_unet_config(monkeypatch, {"WIW_FUSED_FF": "1"})
    kw = dict(learning_rate=1e-3, max_grad_norm=0.05, weight_decay=0.1)
    jtr = JT.Trainer(jpipe, JT.TrainConfig(**kw))
    jstate = jtr.init_state(params)
    frozen = {"vae": params["vae"], "clip": params["clip"]}
    batch = _batch(B=4, seed=21)
    key = jax.random.PRNGKey(7)
    jstate, jm = jtr.make_train_step()(
        jstate, frozen, jax.tree_util.tree_map(jnp.asarray, batch), key)

    calls = []
    fused = TLY.ln_geglu_ffn_residual
    monkeypatch.setattr(TLY, "ln_geglu_ffn_residual",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    pipe = port_pipeline(params, fused_ff=cfg.fused_ff, fused_ff_gate=cfg.fused_ff_gate,
                         temporal_attention=cfg.temporal_attention)
    trainer = TT.Trainer(pipe, TT.TrainConfig(**kw))
    state = trainer.init_state()
    m = trainer.train_step(state, _t(batch), draws=[jax_draws(key, 4)])
    assert calls, "no feed-forward went through K6"
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
    want = _flat(jstate["params"])
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)
