"""Port parity: the serving plane (continuous engine, manager, server CLI).

The tiny towers (TINY_UNET with micro_cond or action_block, TINY_VAE,
TINY_CLIP projecting to the UNet's context width) get random weights on the
port's side; the reference's own converter carries them to `wiw_tpu`, so
both engines hold the same weights. Both serve 32x64, 3 frames, 4 Euler
steps under SERVING_CFG (full ticks for steps 0-2, the cond-only tail at
step 3) with noise_aug_strength 0; everything runs in fp32 on the CPU,
with JAX matmuls pinned to fp32 (tests/conftest.py).

Also here: the reference's engine semantics on the port (capacity
queueing, inactive slots frozen, cancel, sigma isolation, bucket
rejection, when the tail tick runs), the port's manager against the
reference's client and the reverse, `server_cli.build_executors` with
`--device cpu`, the worker's warmup, and the import guard over the new
modules.
"""

import dataclasses
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from test_models import TINY_CLIP, TINY_UNET, TINY_VAE
from test_torch_pipeline import BLOCKED, REPO, _reference_imports
from wiw_tpu.core.schedule import SERVING_CFG as J_SERVING_CFG
from wiw_tpu.models import convert as JCV
from wiw_tpu.sampling.pipeline import GenerationConfig as JGen
from wiw_tpu.sampling.pipeline import SVDPipeline as JPipe
from wiw_tpu.serve import manager as JM
from wiw_tpu.serve.continuous import ContinuousEngine as JEngine
from wiw_tpu_torch.core import actions as TA
from wiw_tpu_torch.core import schedule as TS
from wiw_tpu_torch.models.clip import CLIPVisionConfig
from wiw_tpu_torch.models.unet import UNetConfig
from wiw_tpu_torch.models.vae import VAEConfig
from wiw_tpu_torch.sampling.pipeline import GenerationConfig, SVDPipeline
from wiw_tpu_torch.serve import manager as TM
from wiw_tpu_torch.serve import server_cli
from wiw_tpu_torch.serve.continuous import ContinuousEngine
from wiw_tpu_torch.serve.protocol import read_framed, write_framed
from wiw_tpu_torch.workers import svd_action

torch.set_num_threads(1)

H, W, F, STEPS, SLOTS = 32, 64, 3, 4, 3
ACTS = {"micro_cond": np.array([4, 2, 1]), "action_block": np.array([4, 3, 1])}
# frames in [0, 1] after 4 steps of 2 rows through the UNet, CLIP, the VAE
# encode and the whole-clip decode, fp32 at random weights: the slice
# test's bound (tests/test_torch_pipeline.py), 1e-4
VIDEO_ATOL = 1e-4


def port_cfg(cls, jcfg, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    return cls(**dict(kw, **over))


def reference_tree(module: torch.nn.Module) -> dict:
    return jax.tree_util.tree_map(np.asarray, JCV.convert_state_dict(
        {k: v.detach().numpy() for k, v in module.state_dict().items()}))


def _jcfg(strategy):
    return dataclasses.replace(TINY_UNET, action_strategy=strategy,
                               action_input_channel=F,
                               cross_attention_dim=TINY_CLIP.projection_dim)


def _gen(**over):
    kw = dict(height=H, width=W, num_frames=F, num_inference_steps=STEPS,
              noise_aug_strength=0.0, cfg=TS.SERVING_CFG)
    return GenerationConfig(**dict(kw, **over))


def port_pipe(strategy="micro_cond", seed=0):
    pipe = SVDPipeline(port_cfg(UNetConfig, _jcfg(strategy)),
                       port_cfg(VAEConfig, TINY_VAE),
                       port_cfg(CLIPVisionConfig, TINY_CLIP), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(seed))
    return pipe


@pytest.fixture(scope="module")
def served():
    """{strategy: (port pipeline, reference engine)}; the reference's
    engine compiles its step, cond-only step, encode and decode once here,
    for every test of this file."""
    out = {}
    for strategy in ("micro_cond", "action_block"):
        pipe = port_pipe(strategy)
        jpipe = JPipe(_jcfg(strategy), TINY_VAE, TINY_CLIP,
                      params={k: reference_tree(t) for k, t in
                              (("unet", pipe.unet), ("vae", pipe.vae),
                               ("clip", pipe.clip))})
        jgen = JGen(height=H, width=W, num_frames=F, num_inference_steps=STEPS,
                    noise_aug_strength=0.0, cfg=J_SERVING_CFG)
        out[strategy] = (pipe, JEngine(jpipe, jgen, num_slots=SLOTS))
    return out


def _state(strategy, seed=0):
    """A pool at mixed depths: slots at sigma index 0, 2 and 3, the last
    inactive; latents at each slot's noise level; a carried uncond."""
    rng = np.random.default_rng(seed)
    idx = np.array([0, 2, 3], np.int32)
    sig = TS.karras_sigmas_np(STEPS)[idx].astype(np.float32)
    shape = (SLOTS, F, H // 2, W // 2, 4)
    nav = rng.integers(1, 4, (SLOTS, F))
    acts = (TA.encode_idx(torch.from_numpy(nav)).float().numpy()
            if strategy == "micro_cond"
            else TA.encode_onehot(torch.from_numpy(nav)).numpy())
    return {
        "latents": (rng.standard_normal(shape) * sig[:, None, None, None, None]
                    ).astype(np.float32),
        "img_latents": rng.standard_normal(shape).astype(np.float32),
        "context": (rng.standard_normal((SLOTS, 1, TINY_CLIP.projection_dim))
                    * 0.3).astype(np.float32),
        "sigma_idx": idx,
        "active": np.array([True, True, False]),
        "action_ids": acts,
        "uncond": rng.standard_normal(shape).astype(np.float32),
    }


def _torch_state(state):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "sigma_idx" else v)
            for k, v in state.items()}


@pytest.mark.parametrize("strategy", ["micro_cond", "action_block"])
@pytest.mark.parametrize("cond_only", [False, True])
def test_step_once_matches_reference(served, strategy, cond_only):
    """One tick of the pool at mixed sigma indices, full (6 UNet rows, the
    CFG pair; action_block's uncond rows take the dropped sentinel) and
    cond-only (3 rows against the carried uncond)."""
    pipe, jeng = served[strategy]
    eng = ContinuousEngine(pipe, _gen(), num_slots=SLOTS)
    state = _state(strategy)
    fn = jeng._step_cond_jit if cond_only else jeng._step_jit
    ref = {k: np.asarray(v) for k, v in fn(jeng.params, state).items()}
    out = {k: v.numpy() for k, v in eng._step_once(_torch_state(state),
                                                   cond_only).items()}
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["sigma_idx"], [1, 3, 3])
    np.testing.assert_array_equal(out["sigma_idx"], ref["sigma_idx"])
    # the inactive slot is frozen bit for bit
    np.testing.assert_array_equal(out["latents"][2], state["latents"][2])
    # latents of magnitude up to sigma_0 = 700: one fp32 UNet forward
    # (2e-4 on its output) times c_out and the Euler step's factor, plus
    # fp32 rounding of the latents themselves (6e-5 at 700)
    for key in ("latents", "uncond"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-3, rtol=1e-5,
                                   err_msg=key)
    if cond_only:  # the carry is read, not refreshed
        np.testing.assert_array_equal(out["uncond"], state["uncond"])


@pytest.mark.parametrize("strategy", ["micro_cond", "action_block"])
def test_whole_engine_run_matches_reference(served, strategy):
    """Two requests, the second admitted one tick later, through both
    engines: the admitted conditioning (CLIP, VAE encode, action ids)
    matches, and with the reference's init latents written into the
    port's slots the decoded clips match."""
    pipe, jeng = served[strategy]
    # a fresh pool, keeping the compiled programs
    jeng._slots = [type(jeng._slots[0])() for _ in range(SLOTS)]
    jeng._state, jeng._next_req, jeng._pending_decodes = jeng._empty_state(), 0, []
    eng = ContinuousEngine(pipe, _gen(), num_slots=SLOTS)
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    acts = [ACTS[strategy], np.array([4, 1, 2])]

    def admit(k):
        jr = jeng.admit(images[k], acts[k], jax.random.PRNGKey(k))
        r = eng.admit(images[k], acts[k], torch.Generator().manual_seed(k))
        assert r == jr == k
        for key in ("img_latents", "context", "action_ids"):
            # CLIP and the VAE encoder, fp32: 1e-4 on values of magnitude ~1
            np.testing.assert_allclose(eng._state[key][k].numpy(),
                                       np.asarray(jeng._state[key][k]),
                                       atol=1e-4, rtol=1e-4, err_msg=key)
        eng._state["latents"][k] = torch.from_numpy(
            np.array(jeng._state["latents"][k]))

    admit(0)
    ref, out = jeng.step(), eng.step()
    admit(1)
    while jeng.busy or eng.busy:
        ref.update(jeng.step())
        out.update(eng.step())
    assert set(out) == set(ref) == {0, 1}
    for k in (0, 1):
        assert out[k].shape == ref[k].shape == (F, H, W, 3)
        np.testing.assert_allclose(out[k], ref[k], atol=VIDEO_ATOL, rtol=0)


def test_admitted_nav_noise_is_pano_correlated():
    """The port draws its own noise (its generator, not the reference's
    key); for navigation ids it is the reference's pano-correlated form:
    a turn frame is the previous frame rolled by W/16 of the latent."""
    eng = ContinuousEngine(port_pipe(), _gen(), num_slots=1)
    eng.admit(np.zeros((H, W, 3), np.float32), np.array([4, 2, 3]),
              torch.Generator().manual_seed(0))
    lat = eng._state["latents"][0]
    shift = (W // 2) // 16
    torch.testing.assert_close(lat[1], torch.roll(lat[0], shift, dims=1),
                               rtol=0, atol=0)
    torch.testing.assert_close(lat[2], torch.roll(lat[1], -shift, dims=1),
                               rtol=0, atol=0)
    assert torch.allclose(lat.std(), torch.tensor(TS.karras_sigmas_np(STEPS)[0],
                                                  dtype=torch.float32), rtol=0.2)


# ------------------------------------------------ the reference's semantics
IMG = np.zeros((H, W, 3), np.float32)
# full CFG every step, as the reference's adversarial tests: with a stale
# tail a slot's tick form (full or cond-only) depends on its neighbours
FULL = dict(cfg=TS.CFGSchedule())


def _solo(pipe, seed, gen=None):
    eng = ContinuousEngine(pipe, gen or _gen(**FULL), num_slots=2)
    rid = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(seed))
    results = {}
    while not results:
        results = eng.step()
    return results[rid]


@pytest.fixture(scope="module")
def pipe():
    return port_pipe()


def test_capacity_queueing_and_frozen_slots(pipe):
    eng = ContinuousEngine(pipe, _gen(), num_slots=2)
    eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(0))
    before = eng._state["latents"][1].clone()
    eng.step()
    np.testing.assert_array_equal(eng._state["sigma_idx"].numpy(), [1, 0])
    assert torch.equal(eng._state["latents"][1], before)  # empty slot frozen
    eng = ContinuousEngine(pipe, _gen(), num_slots=2)
    reqs = [(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(i))
            for i in range(3)]
    results = eng.run_to_completion(reqs)
    assert sorted(results) == [0, 1, 2] and not eng.busy
    for v in results.values():
        assert v.shape == (F, H, W, 3) and np.isfinite(v).all()
        assert 0.0 <= v.min() and v.max() <= 1.0


def test_cancel_mid_denoise_frees_slot_no_contamination(pipe):
    solo = _solo(pipe, 0)
    eng = ContinuousEngine(pipe, _gen(**FULL), num_slots=2)
    r0 = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(0))
    r1 = eng.admit(IMG + 0.25, ACTS["micro_cond"], torch.Generator().manual_seed(7))
    eng.step()
    assert eng.cancel(r1)
    assert not eng.cancel(r1) and not eng.cancel(999)
    assert len(eng._free_slots()) == 1
    r2 = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(9))
    results = {}
    while eng.busy:
        results.update(eng.step())
    assert r1 not in results and {r0, r2} <= set(results)
    # rows are independent: the survivor equals its solo run bit for bit
    np.testing.assert_array_equal(results[r0], solo)


def test_cancel_after_finish_discards_pending_decode(pipe):
    """A finished slot is free at once while its decode is in flight (held
    in flight here, as on the card before its event); cancelling the
    request then discards the decode, which is never delivered."""
    eng = ContinuousEngine(pipe, _gen(), num_slots=1)
    real = eng._dispatch_decode
    eng._dispatch_decode = lambda rid, i: dataclasses.replace(
        real(rid, i), done=_NeverDone())
    r0 = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(0))
    for _ in range(STEPS):
        assert eng.step() == {}
    assert eng._free_slots() == [0] and eng.busy
    assert eng.cancel(r0) and not eng.cancel(r0)
    assert not eng.busy and eng.step() == {}


class _NeverDone:
    """A decode event that never completes (a decode still on the card)."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("a cancelled decode was waited for")


def test_mixed_depth_sigma_isolation(pipe):
    """Slots at different sigma depths in one UNet batch each equal their
    solo run exactly: per-row sigma never leaks across rows."""
    solo0, solo1 = _solo(pipe, 0), _solo(pipe, 1)
    eng = ContinuousEngine(pipe, _gen(**FULL), num_slots=2)
    r0 = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(0))
    eng.step()
    r1 = eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(1))
    results = {}
    while eng.busy:
        results.update(eng.step())
    np.testing.assert_array_equal(results[r0], solo0)
    np.testing.assert_array_equal(results[r1], solo1)


def test_admit_rejects_another_bucket(pipe):
    eng = ContinuousEngine(pipe, _gen(), num_slots=1)
    with pytest.raises(ValueError, match="bucket"):
        eng.admit(np.zeros((W, W, 3), np.float32), ACTS["micro_cond"],
                  torch.Generator().manual_seed(0))


def test_tail_tick_only_when_every_slot_is_past_the_boundary(pipe):
    """Tail at step 3 of 4. r0 at steps 0-3, r1 admitted one tick later:
    the tick where r0 is at 3 and r1 at 2 stays full; r1's own step 3,
    alone in the pool, runs cond-only."""
    eng = ContinuousEngine(pipe, _gen(), num_slots=2)
    assert eng._tail_start == 3
    calls = []
    real = eng._step_once
    eng._step_once = lambda s, cond_only=False: (
        calls.append(cond_only) or real(s, cond_only))
    eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(0))
    eng.step()
    eng.admit(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(1))
    while eng.busy:
        eng.step()
    assert calls == [False, False, False, False, True]
    # a lone request takes the tail at its own boundary
    calls.clear()
    eng.run_to_completion([(IMG, ACTS["micro_cond"], torch.Generator().manual_seed(2))])
    assert calls == [False, False, False, True]


def test_tail_matches_full_at_unit_guidance(pipe):
    """At guidance 1 the combine is the identity for any carry, so the tail
    engine reproduces the full-CFG engine to fp32 rounding."""
    unit = dict(min_guidance_scale=1.0, max_guidance_scale=1.0)
    full = _solo(pipe, 0, _gen(cfg=TS.CFGSchedule(), **unit))
    tail = _solo(pipe, 0, _gen(**unit))
    np.testing.assert_allclose(tail, full, atol=VIDEO_ATOL, rtol=0)


def test_engine_refuses_other_tails(pipe):
    with pytest.raises(ValueError, match="stale"):
        ContinuousEngine(pipe, _gen(cfg=TS.CFGSchedule(tail_sigma=0.2,
                                                       tail_policy="cond")))


def test_uint8_decode_is_the_resized_float_decode(pipe):
    lat = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, F, H // 2, W // 2, 4)).astype(np.float32))
    flt = ContinuousEngine(pipe, _gen(), num_slots=1)._decode_slot(lat)
    u8 = ContinuousEngine(pipe, _gen(), num_slots=1, out_hw=(24, 20),
                          out_uint8=True)._decode_slot(lat)
    from wiw_tpu_torch.ops.resize import resize_cubic

    want = torch.round(resize_cubic(flt, (24, 20), dims=(1, 2)).clamp(0, 1) * 255)
    assert u8.dtype == torch.uint8 and u8.shape == (F, 24, 20, 3)
    torch.testing.assert_close(u8, want.to(torch.uint8), rtol=0, atol=0)


# ---------------------------------------------------------------- serving
def _encode_item(payload, i):
    img = np.transpose(np.asarray(payload["b_image"])[i][:3], (1, 2, 0))
    return img.astype(np.float32) / 127.5 - 1.0, np.asarray(payload["b_action"][i])


def _postprocess(video01):
    return np.transpose((np.clip(video01, 0, 1) * 255).astype(np.uint8), (0, 3, 1, 2))


def _request(n, acts=None, save_dirs=None):
    return {"b_action": np.tile(np.asarray([ACTS["micro_cond"]] if acts is None
                                           else acts, np.int64), (n, 1)),
            "b_image": np.zeros((n, 3, H, W), np.uint8),
            "save_dirs": save_dirs or [f"d{i}" for i in range(n)],
            "request_model_name": "igenex", "return_objects": [True] * n}


@pytest.mark.parametrize("client", ["reference", "port"])
def test_port_manager_serves_both_clients(pipe, client):
    """The port's ManagerServer with a ContinuousExecutor answers two
    clients at once (3 + 1 items through a 2-slot pool), over the
    reference's framing: the reference's WMClient reads the port's answers
    as its own; stats count them."""
    eng = ContinuousEngine(pipe, _gen(), num_slots=2)
    ex = TM.ContinuousExecutor(eng, _encode_item, _postprocess)
    server = TM.ManagerServer([ex], port=18210)
    port = server.start()
    Client = JM.WMClient if client == "reference" else TM.WMClient
    outs = {}

    def send(name, n):
        c = Client(port=port)
        outs[name] = c.send_batch(_request(n, save_dirs=[f"{name}{i}" for i in range(n)]))
        c.close()

    try:
        threads = [threading.Thread(target=send, args=a) for a in (("a", 3), ("b", 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert outs["a"]["save_dirs"] == ["a0", "a1", "a2"]
        assert outs["a"]["pred_frames"].shape == (3, F, 3, H, W)
        assert outs["b"]["pred_frames"].shape == (1, F, 3, H, W)
        assert outs["a"]["pred_frames"].dtype == np.uint8
        c = TM.WMClient(port=port).connect()
        write_framed(c._sock, {"__stats__": True})
        stats = read_framed(c._sock)
        c.close()
        assert stats["requests"] == 2 and stats["items"] == 4 and stats["errors"] == 0
        assert all(v > 0 for k, v in ex.phase_s.items() if k != "post")
    finally:
        server.stop()


def test_wrong_shape_item_errors_alone_through_port_manager(pipe):
    eng = ContinuousEngine(pipe, _gen(), num_slots=2)

    def encode_item(payload, i):
        img, acts = _encode_item(payload, i)
        return (np.zeros((8, 8, 3), np.float32) if payload["save_dirs"][i] == "bad"
                else img), acts

    server = TM.ManagerServer([TM.ContinuousExecutor(eng, encode_item, _postprocess)],
                              port=18230)
    port = server.start()
    try:
        c = JM.WMClient(port=port)
        bad = c.send_batch(_request(1, save_dirs=["bad"]))
        assert "bucket" in bad["error"]
        ok = c.send_batch(_request(1))
        assert "error" not in ok and ok["pred_frames"].shape[0] == 1
        c.close()
    finally:
        server.stop()


def test_stop_ends_the_accept_thread_and_frees_the_model():
    """`stop` wakes the threads blocked in accept() and in a connected
    client's recv() (a close alone does not, on Linux) and returns when the
    server's, its handlers' and its executors' threads have ended: nothing
    of the server, its executors or their model is left alive after it, so
    a process that builds servers in turn (chip_smoke's serve and rollouts
    phases) gets the card's memory back."""
    import gc
    import weakref

    class Model:
        def __call__(self, d):
            return {"save_dirs": d["save_dirs"]}

    model = Model()
    ref = weakref.ref(model)
    ex = TM.InProcessExecutor(model)
    server = TM.ManagerServer([ex], port=18280)
    port = server.start()
    client = TM.WMClient(port=port)  # stays connected through the stop
    assert client.send_batch(_request(1))["save_dirs"] == ["d0"]
    (handler,) = server._clients.values()
    del model
    server.stop()
    assert not any(t.is_alive() for t in (server._acceptor, server._router,
                                          ex._thread, handler))
    client.close()
    del server, ex, handler
    gc.collect()
    assert ref() is None
    TM.ManagerServer([]).stop()  # never started: nothing to stop


@pytest.fixture
def tiny_worlds(monkeypatch):
    """SVDActionWorker builds the tiny towers (the given UNetConfig with
    TINY_UNET's widths, TINY_VAE, TINY_CLIP), fp32, on the CPU."""
    def tiny_pipeline(unet_cfg, device):
        cfg = dataclasses.replace(
            unet_cfg, block_out_channels=TINY_UNET.block_out_channels,
            num_attention_heads=TINY_UNET.num_attention_heads,
            layers_per_block=TINY_UNET.layers_per_block,
            cross_attention_dim=TINY_CLIP.projection_dim, dtype="float32")
        return SVDPipeline(cfg, port_cfg(VAEConfig, TINY_VAE),
                           port_cfg(CLIPVisionConfig, TINY_CLIP), device=device)

    monkeypatch.setattr(svd_action, "SVDPipeline", tiny_pipeline)


def test_reference_manager_serves_the_port_worker_to_the_port_client(tiny_worlds):
    """The other way round: the reference's ManagerServer with the port's
    worker in-process answers the port's WMClient."""
    worker = svd_action.SVDActionWorker(width=W, height=H, num_frames=F,
                                        action_input_channel=F,
                                        num_inference_steps=2, out_width=24,
                                        out_height=20, device="cpu")
    server = JM.ManagerServer([JM.InProcessExecutor(worker)], port=18250)
    port = server.start()
    try:
        c = TM.WMClient(port=port)
        out = c.send_batch(_request(2))
        c.close()
        assert out["save_dirs"] == ["d0", "d1"]
        assert out["pred_frames"].shape == (2, F, 3, 20, 24)
        assert out["pred_frames"].dtype == np.uint8
    finally:
        server.stop()


def test_build_executors_on_the_cpu(tiny_worlds):
    """`server_cli`'s defaults with --device cpu: one continuous 4-slot
    engine, int8, the serving CFG, plus a --buckets engine on the same
    resident weights, which serves a request sized by extra['gen_size']."""
    args, extra = server_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--warmup_batches", "", "--buckets", f"{H}x{W}",
         "--num_inference_steps", "2", "--out_width", "24", "--out_height", "20"])
    assert (args.executor, args.num_slots, args.quantize, args.wm_type) == (
        "continuous", 4, "int8", "igenex")
    execs = server_cli.build_executors(args, extra)
    assert len(execs) == 2 and execs[0].is_default and execs[1].bucket == (H, W)
    e0, e1 = execs[0].engine, execs[1].engine
    assert e0.pipe is e1.pipe and e0.device == torch.device("cpu")
    assert (e0.S, e0.gen.height, e0.gen.width, e0.F) == (4, 576, 1024, 14)
    assert e0._tail_start is not None and e0.out_uint8 and e0.out_hw == (20, 24)
    assert e0.pipe.unet_config.action_strategy == "micro_cond"
    assert any(m.weight.dtype == torch.int8 for m in e0.pipe.unet.modules()
               if isinstance(m, torch.nn.Linear))
    # the bucket engine alone: the default executor accepts sized requests
    # too (the reference's routing), and a 576x1024 run is no CPU test
    server = TM.ManagerServer([execs[1]], port=18270)
    port = server.start()
    try:
        c = JM.WMClient(port=port)
        req = dict(_request(1, acts=[[4, 1, 2] + [1] * 11]),
                   b_image=np.zeros((1, 3, H, W), np.uint8),
                   extra={"gen_size": [H, W]})
        out = c.send_batch(req)
        c.close()
        assert "error" not in out, out["error"]
        assert out["pred_frames"].shape == (1, 14, 3, 20, 24)
        assert e1._next_req == 1
    finally:
        server.stop()


@pytest.mark.parametrize("argv,kind", [
    (["--executor", "batch"], TM.InProcessExecutor),
    (["--external_cmd", "python -m wiw_tpu_torch.workers.svd_action",
      "--num_workers", "2"], TM.SubprocessExecutor)])
def test_build_executors_other_executors(tiny_worlds, argv, kind):
    args, extra = server_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--warmup_batches", ""] + argv)
    execs = server_cli.build_executors(args, extra)
    assert execs and all(type(e) is kind for e in execs)


def test_manipulation_world_builds_and_warms_up(tiny_worlds, capsys):
    """igenex_manip: 448x448, 10 action channels, pose actions; warmup
    generates once with poses at the identity rotation."""
    args, extra = server_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--warmup_batches", "", "--wm_type", "igenex_manip"])
    execs = server_cli.build_executors(args, extra)
    eng = execs[0].engine
    assert (eng.gen.height, eng.gen.width, eng.gen.task_type) == (448, 448,
                                                                  "manipulation")
    assert eng.pipe.unet_config.action_input_channel == 10
    worker = svd_action.SVDActionWorker(
        width=W, height=H, num_frames=F, num_inference_steps=2, device="cpu",
        task_type="manipulation", action_input_channel=10)
    worker.warmup((1, 2))
    assert capsys.readouterr().out.count("[svd_action] warmed batch=") == 2


@pytest.mark.parametrize("strategy", ["action_block", ""])
def test_worker_action_block_and_zero_shot(tiny_worlds, strategy):
    from wiw_tpu_torch.workers.svd_zero_shot import SVDZeroShotWorker

    kw = dict(width=W, height=H, num_frames=F, action_input_channel=F,
              num_inference_steps=2, out_width=24, out_height=20, device="cpu")
    worker = (SVDZeroShotWorker(**kw) if not strategy
              else svd_action.SVDActionWorker(action_strategy=strategy, **kw))
    assert worker.pipe.unet_config.action_strategy == (strategy or None)
    worker.warmup((1,))
    out = worker(_request(1))
    assert out["pred_frames"].shape == (1, F, 3, 20, 24)


def test_import_guard_covers_the_serving_modules():
    """The new modules are in the static scan's files and import in a
    fresh interpreter with jax, flax and wiw_tpu blocked."""
    new = ["serve/batcher.py", "serve/queues.py", "serve/continuous.py",
           "serve/manager.py", "serve/server_cli.py", "utils/config.py",
           "utils/logging.py", "workers/svd_zero_shot.py", "core/actions.py"]
    for rel in new:
        path = REPO / "wiw_tpu_torch" / rel
        assert path.is_file() and not _reference_imports(path.read_text()), rel
    mods = ["wiw_tpu_torch." + rel[:-3].replace("/", ".") for rel in new]
    code = r"""
import importlib, sys
BLOCKED = %r
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in %r:
    importlib.import_module(m)
assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]
""" % (BLOCKED, mods)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_nwm_registry_names_the_ports_worker():
    """`WM_REGISTRY['nwm']` names the port's NWM worker (it named the JAX
    package's), and the deployment's worker command runs it."""
    from wiw_tpu_torch.utils.config import WorkerConfig, build_worker_commands

    spec = server_cli.WM_REGISTRY["nwm"]
    assert spec["worker"] == "wiw_tpu_torch.workers.nwm_worker"
    assert (REPO / "wiw_tpu_torch" / "workers" / "nwm_worker.py").is_file()
    (argv, _env), = build_worker_commands(WorkerConfig(wm_type="nwm"))
    assert argv[1:3] == ["-m", "wiw_tpu_torch.workers.nwm_worker"]
    assert (spec["width"], spec["height"]) == (224, 224)


def test_server_cli_nwm_needs_its_own_worker(tiny_worlds):
    """`server_cli --wm_type nwm` without --external_cmd raises and names the
    command that serves NWM, where the reference builds an SVD action worker
    at 224x224 under that name (R6); with the command, a subprocess
    executor runs the port's NWM worker."""
    args, extra = server_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--warmup_batches", "", "--wm_type", "nwm"])
    with pytest.raises(SystemExit, match='--external_cmd "python -m '
                                         r'wiw_tpu_torch\.workers\.nwm_worker"'):
        server_cli.build_executors(args, extra)
    args, extra = server_cli.build_parser().parse_known_args(
        ["--wm_type", "nwm", "--external_cmd",
         "python -m wiw_tpu_torch.workers.nwm_worker"])
    execs = server_cli.build_executors(args, extra)
    assert len(execs) == 1 and type(execs[0]) is TM.SubprocessExecutor
