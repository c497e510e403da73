"""Port parity: the worker base class and the closed-loop rollout client.

`wiw_tpu_torch/workers/base.py` against `wiw_tpu/workers/base.py` (the
conditioning images from a BCHW or BHWC `b_image` or from cond_rgb.png, the
prompts, the output in-band or written to disk, and a `WorkerModelBase`
subclass end to end), and `wiw_tpu_torch/serve/benchmarks.py` with its
minimal `agents/solver.py` against `wiw_tpu/serve/benchmarks.py`: for the
same seeds the port's client sends the reference's request dicts (captured
through an `InProcessExecutor`), `--fake` reports the reference's keys, and
each package's client runs against the other's manager. Everything is host
logic: the comparisons are exact (uint8 frames, int64 actions, names).
"""

import json
import os
import os.path as osp
import re

import numpy as np
import pytest

from wiw_tpu.agents import saver as JSaver
from wiw_tpu.serve import benchmarks as JB
from wiw_tpu.serve import manager as JM
from wiw_tpu.workers import base as JBase
from wiw_tpu_torch.agents import saver as TSaver
from wiw_tpu_torch.agents import solver as TSolver
from wiw_tpu_torch.serve import benchmarks as TB
from wiw_tpu_torch.serve import manager as TM
from wiw_tpu_torch.workers import base as TBase


# ------------------------------------------------------------ workers/base
def _input(layout, n=2, h=20, w=36, save_dirs=None, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    d = {"b_action": rng.integers(1, 5, (n, 6)),
         "save_dirs": save_dirs or [f"d{i}" for i in range(n)],
         "request_model_name": "igenex"}
    if layout == "bchw":
        d["b_image"] = np.transpose(imgs, (0, 3, 1, 2))
    elif layout == "bchw4":  # an alpha channel is dropped
        d["b_image"] = np.concatenate(
            [np.transpose(imgs, (0, 3, 1, 2)), np.zeros((n, 1, h, w), np.uint8)], 1)
    elif layout == "bhwc":
        d["b_image"] = imgs
    return d, imgs


@pytest.mark.parametrize("layout", ["bchw", "bchw4", "bhwc"])
@pytest.mark.parametrize("task_type", ["navigation", "manipulation"])
def test_process_input_dict_matches_reference(layout, task_type):
    d, _ = _input(layout)
    got = TBase.process_input_dict(d, task_type, 48, 24)
    want = JBase.process_input_dict(d, task_type, 48, 24)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w
    assert got[4].shape == (2, 24, 48, 3)


def test_cond_images_from_cond_rgb_png(tmp_path):
    dirs = [str(tmp_path / f"c{i}") for i in range(2)]
    _, imgs = _input("none")
    for d, im in zip(dirs, imgs):
        JSaver.save_image(osp.join(d, "cond_rgb.png"), im)
    d = {"b_action": np.ones((2, 4), np.int64), "save_dirs": dirs}
    got = TBase.load_cond_images(d, 40, 30)
    want = JBase.load_cond_images(d, 40, 30)
    assert got.shape == (2, 30, 40, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("in_band", [True, False])
def test_process_output_dict_matches_reference(tmp_path, in_band):
    frames = np.random.default_rng(3).integers(0, 256, (2, 3, 20, 36, 3), np.uint8)
    outs = {}
    for name, mod in (("port", TBase), ("ref", JBase)):
        dirs = [str(tmp_path / name / f"d{i}") for i in range(2)]
        outs[name] = (dirs, mod.process_output_dict(dirs, [in_band] * 2, frames,
                                                    32, 16))
    (pdirs, got), (rdirs, want) = outs["port"], outs["ref"]
    assert got["save_dirs"] == pdirs and want["save_dirs"] == rdirs
    if in_band:
        assert got["pred_frames"].shape == (2, 3, 3, 16, 32)
        assert np.array_equal(got["pred_frames"], want["pred_frames"])
    else:
        assert "pred_frames" not in got and "pred_frames" not in want
        for pd, rd in zip(pdirs, rdirs):
            assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
            (f,) = os.listdir(pd)
            assert f.startswith("pred.")
            if f.endswith(".mp4"):
                assert np.array_equal(TSaver.load_video_frames(osp.join(pd, f)),
                                      JSaver.load_video_frames(osp.join(rd, f)))
            else:  # no video codec here: both fell back to the same GIF
                with open(osp.join(pd, f), "rb") as a, open(osp.join(rd, f), "rb") as b:
                    assert a.read() == b.read()


def test_worker_model_base_subclass_matches_reference():
    """A zoo worker written against each base class: the same answers."""
    def make(base):
        class Echo(base):
            width, height, out_width, out_height = 36, 20, 24, 12

            def generate(self, images, actions, prompts):
                self.prompts = prompts
                T = actions.shape[1]
                return np.stack([np.stack([np.roll(im, t, axis=1) for t in range(T)])
                                 for im in images])
        return Echo()

    d, _ = _input("bchw")
    d["return_objects"] = [True, True]
    port, ref = make(TBase.WorkerModelBase), make(JBase.WorkerModelBase)
    got, want = port(d), ref(d)
    assert port.prompts == ref.prompts
    assert got["save_dirs"] == want["save_dirs"]
    assert got["pred_frames"].shape == (2, 6, 3, 12, 24)
    assert np.array_equal(got["pred_frames"], want["pred_frames"])
    with pytest.raises(NotImplementedError):
        TBase.WorkerModelBase()(d)


# ---------------------------------------------------------- rollout client
@pytest.fixture
def no_tmp_writes(monkeypatch, tmp_path):
    """The reference's client makes its candidate directories under
    /tmp/wiw_bench: move them into the test's own directory."""
    real = JSaver.Saver.get_igenex_save_dirs

    def moved(base_dir, ids):
        return real(base_dir.replace("/tmp/wiw_bench", str(tmp_path / "ref")), ids)

    monkeypatch.setattr(JSaver.Saver, "get_igenex_save_dirs", staticmethod(moved))
    return tmp_path


def _capture_server(mod, port):
    """`mod`'s manager with an in-process executor that records every
    request whole (batch_size 16 keeps a request one task) and answers
    zero frames."""
    seen = []

    def record(d):
        seen.append(d)
        return TB.fake_wm(d)

    server = mod.ManagerServer([mod.InProcessExecutor(record, max_batch=16)],
                               port=port, batch_size=16)
    return server, server.start(), seen


def _stamp_free(dirs):
    return [re.sub(r"_\d{4}_\d{6}$", "", osp.basename(d)) for d in dirs]


@pytest.mark.parametrize("idx", [0, 3])
def test_port_client_sends_the_reference_requests(no_tmp_writes, idx):
    """Two decision steps of 2 candidates from client `idx` (its
    FakeSimulator's seed): the same b_action, b_image, return_objects and
    model name, and per-candidate directories of the same names
    (PredA-<i>, less the timestamp)."""
    got, want = {}, {}
    for name, run, mod, port in (
            ("port", lambda p: TB.rollout_client(p, 2, 2, 14, [None] * 4, idx,
                                                 str(no_tmp_writes / "port")),
             TM, 18310 + idx),
            ("ref", lambda p: JB.rollout_client(p, 2, 2, 14, [None] * 4, idx),
             JM, 18320 + idx)):
        server, port, seen = _capture_server(mod, port)
        try:
            run(port)
        finally:
            server.stop()
        (got if name == "port" else want)["seen"] = seen
    assert len(got["seen"]) == len(want["seen"]) == 2
    for g, w in zip(got["seen"], want["seen"]):
        assert set(g) == set(w) == {"b_action", "b_image", "save_dirs",
                                    "request_model_name", "return_objects"}
        assert g["b_action"].dtype == w["b_action"].dtype == np.int64
        assert np.array_equal(g["b_action"], w["b_action"])
        assert g["b_action"].shape == (2, 14)
        assert g["b_image"].dtype == w["b_image"].dtype == np.uint8
        assert np.array_equal(g["b_image"], w["b_image"])
        assert g["return_objects"] == w["return_objects"] == [True, True]
        assert g["request_model_name"] == w["request_model_name"]
        assert _stamp_free(g["save_dirs"]) == _stamp_free(w["save_dirs"]) == [
            "PredA-0", "PredA-1"]
        assert all(d.startswith(str(no_tmp_writes / "port" / f"c{idx}"))
                   for d in g["save_dirs"])


def test_solver_helpers_match_reference():
    """The heuristic sampler, the prefix analysis and the padding, for the
    reference's seeds, and the pano roll."""
    from wiw_tpu.agents import solver as JS

    cfg = dict(igenex_n_frame=14, look_ahead_action_num=4)
    port = TSolver.Solver(TSolver.SolverConfig(**cfg))
    ref = JS.Solver(JS.SolverConfig(**cfg), sim=None)
    for prefix in ([], ["turn_left 22.5\N{DEGREE SIGN}"] * 4, ["forward 0.2m"]):
        for q in (1, 2, 5):
            assert (port.heur_sample_next_action_seqs(prefix, q)
                    == ref.heur_sample_next_action_seqs(prefix, q))
    seqs, _ = ref.heur_sample_next_action_seqs([], 6)
    seqs += [["turn_left 22.5\N{DEGREE SIGN}", "turn_left 22.5\N{DEGREE SIGN}",
              "forward 0.2m", "turn_right 22.5\N{DEGREE SIGN}"]]
    got, want = port.get_action_info_from_prior(seqs), ref.get_action_info_from_prior(seqs)
    assert got == want
    for ids in want[1].values():
        assert port._pad_action_seq(ids) == ref._pad_action_seq(ids)
    sim, jsim = TSolver.FakeSimulator(seed=2), JS.FakeSimulator(seed=2)
    for act in ("forward", "turn_left", "turn_left", "forward", "turn_right"):
        sim.step(act)
        jsim.step(act)
        assert np.array_equal(sim.get_pano(), jsim.get_pano())
    pano = sim.get_pano()
    for deg in (0.0, 45.0, -67.5):
        assert np.array_equal(TSolver.roll_pano_np(pano, deg), JS.roll_pano_np(pano, deg))
    with pytest.raises(NotImplementedError, match="pano WMs"):
        TSolver.Solver(TSolver.SolverConfig(world_model_type="GTsim")
                       ).imagine_by_model_type(seqs[:1], "unused")


def test_fake_benchmark_reports_the_reference_keys(no_tmp_writes, capsys):
    got = TB.main(["--fake", "--clients", "3", "--steps", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    JB.main(["--fake", "--clients", "3", "--steps", "2"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(printed) == set(want) == {
        "clients", "rollout_steps_per_sec", "latency_p50_s", "latency_p95_s",
        "wall_s"}
    assert got["clients"] == want["clients"] == 3
    assert got["rollout_steps_per_sec"] > 0 and got["latency_p95_s"] >= got["latency_p50_s"]


@pytest.mark.parametrize("client,server", [("reference", "port"), ("port", "reference")])
def test_clients_against_the_other_package_manager(no_tmp_writes, client, server):
    """4 concurrent rollouts of 2 steps x 2 candidates: each package's
    client against the other's manager answering with the fake WM."""
    mod = TM if server == "port" else JM
    srv = mod.ManagerServer([mod.InProcessExecutor(TB.fake_wm, max_batch=16)],
                            port=18340 if server == "port" else 18350)
    port = srv.start()
    try:
        if client == "port":
            out = TB.run_benchmark(port, clients=4, steps=2,
                                   save_root=str(no_tmp_writes / "port"))
        else:
            out = JB.run_benchmark(port, clients=4, steps=2)
    finally:
        stats = srv.get_stats()
        srv.stop()
    assert out["clients"] == 4 and out["rollout_steps_per_sec"] > 0
    assert stats["requests"] == 8 and stats["items"] == 16 and stats["errors"] == 0


def test_run_benchmark_raises_when_a_client_fails(no_tmp_writes):
    """A client that gets no answer fails the benchmark (the reference's
    thread dies and its rollouts are left out of the figures)."""
    srv = TM.ManagerServer([TM.InProcessExecutor(
        lambda d: {"save_dirs": d["save_dirs"], "error": "boom"}, max_batch=16)],
        port=18360)
    port = srv.start()
    try:
        with pytest.raises(RuntimeError, match="rollout clients failed"):
            TB.run_benchmark(port, clients=2, steps=1,
                             save_root=str(no_tmp_writes / "port"))
    finally:
        srv.stop()
