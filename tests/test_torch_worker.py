"""The port's worker side against the reference's: the wire protocol both
ways, the worker SDK driven by the reference's framing, the deployment
switches (WIW_CFG, WIW_QUANT, WIW_FUSED_FF, WIW_TEMPORAL_ATTN,
WIW_FUSED_FF_GATE) resolved as the reference resolves them, and the entry
points' default device.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wiw_tpu.core.schedule import SERVING_CFG as J_SERVING_CFG
from wiw_tpu.models import layers as JL
from wiw_tpu.serve import protocol as JP
from wiw_tpu_torch.core.schedule import CFGSchedule
from wiw_tpu_torch.sampling.pipeline import SVDPipeline
from wiw_tpu_torch.serve import protocol as TP
from wiw_tpu_torch.workers import svd_action as W

REPO = Path(__file__).resolve().parent.parent
MSG = (7, "task-3", {"b_action": np.arange(14)[None], "save_dirs": ["a", "b"],
                     "b_image": np.full((1, 3, 4, 5), 9, np.uint8)})


def _same(a, b):
    assert a[:2] == b[:2] and a[2].keys() == b[2].keys()
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])


@pytest.mark.parametrize("writer,reader", [(TP, JP), (JP, TP)])
def test_protocol_frames_cross_read(writer, reader):
    r, w = os.pipe()
    try:
        writer.write_pickled_fd(w, MSG)
        _same(reader.read_pickled_fd(r, watchdog_secs=10), MSG)
    finally:
        os.close(r)
        os.close(w)


def test_protocol_frames_are_the_same_bytes():
    frames = []
    for mod in (TP, JP):
        r, w = os.pipe()
        try:
            mod.write_pickled_fd(w, MSG)
            frames.append(os.read(r, 1 << 20))
        finally:
            os.close(r)
            os.close(w)
    assert frames[0] == frames[1]


def test_port_worker_sdk_serves_the_reference_framing():
    """A subprocess runs the port's `main_from_argv`; the test talks to it
    as the reference's manager does: tasks framed on stdin, results framed
    on the pipe fd given as the last argument."""
    code = (
        "import numpy as np\n"
        "from wiw_tpu_torch.serve.worker import main_from_argv\n"
        "def task(p):\n"
        "    if p.get('fail'):\n"
        "        raise ValueError('boom')\n"
        "    return {'save_dirs': p['save_dirs'],\n"
        "            'pred_frames': np.full((1, 2, 3, 4, 4), 5, np.uint8)}\n"
        "main_from_argv(task)\n")
    r, w = os.pipe()
    proc = subprocess.Popen([sys.executable, "-c", code, str(w)], cwd=REPO,
                            stdin=subprocess.PIPE, pass_fds=(w,))
    os.close(w)
    try:
        JP.write_pickled_fd(proc.stdin.fileno(), (1, "t1", {"save_dirs": ["x"]}))
        JP.write_pickled_fd(proc.stdin.fileno(), (1, "t2", {"save_dirs": ["y"],
                                                           "fail": True}))
        cid, tid, out = JP.read_pickled_fd(r, watchdog_secs=60)
        assert (cid, tid, out["save_dirs"]) == (1, "t1", ["x"])
        assert out["pred_frames"].dtype == np.uint8
        cid, tid, out = JP.read_pickled_fd(r, watchdog_secs=60)
        assert tid == "t2" and "boom" in out["error"] and out["save_dirs"] == ["y"]
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(r)


# ---------------------------------------------------------------- switches
# The reference worker (wiw_tpu/workers/svd_action.py:60-61, :80) and its
# modules (models/layers.py:45-56, ops/temporal_attention.py:167-177):
#   cfg  = cfg_schedule or $WIW_CFG or 'serving'; 'serving' -> SERVING_CFG,
#          anything else -> full CFG
#   int8 = (quantize or $WIW_QUANT) == 'int8'
#   fused feed-forward iff $WIW_FUSED_FF == '1'
#   frame attention: 'pallas' | 'xla' as given, anything else 'batched'
@pytest.mark.parametrize("env,args,cfg,fused,mode", [
    ({}, {}, "serving", False, "batched"),
    ({"WIW_CFG": "full"}, {}, "full", False, "batched"),
    ({"WIW_CFG": "other"}, {}, "full", False, "batched"),
    ({"WIW_CFG": "full"}, {"cfg_schedule": "serving"}, "serving", False, "batched"),
    ({"WIW_FUSED_FF": "1", "WIW_TEMPORAL_ATTN": "pallas"}, {}, "serving", True, "pallas"),
    ({"WIW_FUSED_FF": "true", "WIW_TEMPORAL_ATTN": "xla"}, {}, "serving", False, "xla"),
    ({"WIW_FUSED_FF": "0", "WIW_TEMPORAL_ATTN": "flash"}, {}, "serving", False, "batched"),
    ({"WIW_FUSED_FF": "1", "WIW_TEMPORAL_ATTN": "pallas"},
     {"fused_ff": False, "temporal_attention": "batched"}, "serving", False, "batched"),
    ({"WIW_QUANT": "bf16"}, {}, "serving", False, "batched"),
    ({"WIW_QUANT": "int8"}, {"quantize": "bf16"}, "serving", False, "batched"),
])
def test_switches_resolve_as_the_reference(monkeypatch, env, args, cfg, fused, mode):
    for k in ("WIW_CFG", "WIW_QUANT", "WIW_FUSED_FF", "WIW_TEMPORAL_ATTN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sw = W.resolve_switches(**args)
    int8 = (args.get("quantize") or env.get("WIW_QUANT", "")) == "int8"
    assert sw["quantize"] == ("int8" if int8 else "bf16")
    want_cfg = J_SERVING_CFG if cfg == "serving" else CFGSchedule()
    assert (sw["cfg"].tail_sigma, sw["cfg"].tail_policy) == (
        want_cfg.tail_sigma, want_cfg.tail_policy)
    assert sw["fused_ff"] == fused and sw["temporal_attention"] == mode
    if "fused_ff" not in args:  # the reference's own reader of the switch
        assert sw["fused_ff"] == JL._fused_ff_on()


# K6's gate: the reference's `_lnff_kernel` (ops/fused_mlp.py:192) reads
#   os.environ.get("WIW_FUSED_FF_GATE", "f32") == "bf16"  -> bf16 gate
@pytest.mark.parametrize("env,gate", [
    (None, "f32"), ("bf16", "bf16"), ("f32", "f32"), ("BF16", "f32"),
    ("1", "f32"), ("", "f32"),
])
def test_fused_ff_gate_resolves_as_the_reference(monkeypatch, env, gate):
    monkeypatch.delenv("WIW_QUANT", raising=False)
    if env is None:
        monkeypatch.delenv("WIW_FUSED_FF_GATE", raising=False)
    else:
        monkeypatch.setenv("WIW_FUSED_FF_GATE", env)
    assert W.resolve_switches()["fused_ff_gate"] == gate
    reference = os.environ.get("WIW_FUSED_FF_GATE", "f32") == "bf16"
    assert (gate == "bf16") == reference


@pytest.mark.parametrize("env,args", [({"WIW_QUANT": "int8"}, {}),
                                      ({}, {"quantize": "int8"}),
                                      ({"WIW_QUANT": "bf16"}, {"quantize": "int8"})])
def test_int8_resolves_from_either_source(monkeypatch, env, args):
    """W8A8 is served, not refused: from WIW_QUANT or an explicit argument,
    which wins over the environment."""
    monkeypatch.delenv("WIW_QUANT", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert W.resolve_switches(**args)["quantize"] == "int8"


def test_worker_quantizes_before_loading(monkeypatch, capsys):
    """In int8 the worker asks the pipeline for W8A8 before its weights are
    made (they are quantised as loaded), and prints the reference's line
    with the count; in bf16 it does not ask."""
    calls = []

    class Recorder:
        def __init__(self, unet_config, device):
            pass

        def quantize_unet(self):
            calls.append("quantize_unet")
            return 30

        def init_params(self, generator):
            calls.append("init_params")

    monkeypatch.setattr(W, "SVDPipeline", Recorder)
    monkeypatch.delenv("WIW_QUANT", raising=False)
    worker = W.SVDActionWorker(device="cpu", quantize="int8")
    assert calls == ["quantize_unet", "init_params"] and worker.quantize == "int8"
    assert "[svd_action] W8A8 serving mode: 30 int8 kernels" in capsys.readouterr().out
    calls.clear()
    assert W.SVDActionWorker(device="cpu").quantize == "bf16"
    assert calls == ["init_params"]


@pytest.mark.parametrize("args", [{"quantize": "fp8"}, {"cfg_schedule": "ful"}])
def test_unknown_explicit_switch_raises(monkeypatch, args):
    """An explicit value outside the CLI's choices is refused, never served
    as bf16 or as full CFG; the environment keeps the reference's readings
    (WIW_CFG=other is full CFG, above)."""
    monkeypatch.delenv("WIW_QUANT", raising=False)
    monkeypatch.delenv("WIW_CFG", raising=False)
    with pytest.raises(ValueError, match=next(iter(args.values()))):
        W.resolve_switches(**args)
    with pytest.raises(ValueError):
        W.SVDActionWorker(device="cpu", **args)


def test_worker_reads_switches_into_unet_config(monkeypatch):
    """The switches reach the UNet config at construction (the pipeline is
    replaced by a recorder: no weights are made)."""
    seen = {}

    class Recorder:
        def __init__(self, unet_config, device):
            seen["unet"], seen["device"] = unet_config, device

        def init_params(self, generator):
            seen["init"] = True

    monkeypatch.setattr(W, "SVDPipeline", Recorder)
    monkeypatch.setenv("WIW_FUSED_FF", "1")
    monkeypatch.setenv("WIW_TEMPORAL_ATTN", "pallas")
    monkeypatch.setenv("WIW_CFG", "full")
    monkeypatch.setenv("WIW_FUSED_FF_GATE", "bf16")
    worker = W.SVDActionWorker(device="cpu")
    assert seen["unet"].fused_ff and seen["unet"].temporal_attention == "pallas"
    assert seen["unet"].fused_ff_gate == "bf16"
    assert worker.gen.cfg == CFGSchedule() and seen["init"]
    W.SVDActionWorker(device="cpu", fused_ff=False, temporal_attention="xla",
                      cfg_schedule="serving")
    assert (seen["unet"].fused_ff, seen["unet"].temporal_attention) == (False, "xla")


@pytest.mark.parametrize("argv,fused,mode", [
    ([], None, None),
    (["--fused_ff", "1", "--temporal_attention", "pallas"], True, "pallas"),
    (["--fused_ff", "0"], False, None),
])
def test_cli_passes_the_switches(monkeypatch, argv, fused, mode):
    seen = {}

    def record(**kw):
        seen.update(kw)
        return lambda task: None

    monkeypatch.setattr(W, "SVDActionWorker", record)
    monkeypatch.setattr(W, "main_from_argv", lambda worker: None)
    W.main(argv)
    assert (seen["fused_ff"], seen["temporal_attention"]) == (fused, mode)
    assert seen["quantize"] == "int8" and seen["cfg_schedule"] == ""


@pytest.mark.parametrize("argv", [[], ["--quantize", "bf16"], ["--quantize", ""]])
def test_cli_quantize_default_is_the_reference(monkeypatch, argv):
    """The port's CLI passes the reference CLI's `--quantize`: int8 with no
    flag (wiw_tpu/workers/svd_action.py), bf16 or the environment's when
    told."""
    from wiw_tpu.workers import svd_action as JW

    seen = {}

    def record(key):
        def make(**kw):
            seen[key] = kw["quantize"]
            return lambda task: {"pred_frames": np.zeros((1,))}
        return make

    monkeypatch.setattr(W, "SVDActionWorker", record("port"))
    monkeypatch.setattr(W, "main_from_argv", lambda worker: None)
    monkeypatch.setattr(JW, "SVDActionWorker", record("reference"))
    W.main(argv)
    JW.main(argv + ["--debug"])
    assert seen["port"] == seen["reference"] == (argv[1] if argv else "int8")


def test_entry_points_default_to_the_card():
    for fn in (SVDPipeline, W.SVDActionWorker):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------ conditioning image
# The reference (wiw_tpu/workers/svd_action.py `_load_cond_images`) makes the
# conditioning image on the host: astype(np.uint8), PIL's default filter to
# (W, H), / 127.5 - 1. Both methods are called unbound on a stub that holds
# only what they read, so no worker (and no JAX model) is built. PIL runs on
# both sides and the scaling is the same fp32 arithmetic: the bits are equal.
@pytest.mark.parametrize("shape,dtype,layout", [
    ((2, 40, 72, 3), np.uint8, "bhwc"),     # above the generation size
    ((1, 12, 20, 3), np.uint8, "bhwc"),     # below it
    ((2, 24, 48, 3), np.uint8, "bhwc"),     # equal to it
    ((2, 40, 72, 3), np.float32, "bhwc"),   # float: truncated, not rounded
    ((1, 3, 12, 20), np.float32, "bchw"),
    ((1, 4, 40, 72), np.uint8, "bchw"),     # RGBA channels first
])
def test_cond_images_match_the_reference(shape, dtype, layout):
    from types import SimpleNamespace

    from wiw_tpu.workers import svd_action as JW

    rng = np.random.default_rng(sum(shape))
    imgs = rng.uniform(0, 255.99, shape).astype(dtype)
    stub = SimpleNamespace(gen=SimpleNamespace(height=24, width=48),
                           device=torch.device("cpu"))
    task = {"b_image": imgs}
    want = JW.SVDActionWorker._load_cond_images(stub, task)
    got = W.SVDActionWorker._load_cond_images(stub, task)
    assert got.shape == (shape[0], 24, 48, 3) and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cond_images_from_save_dirs_match_the_reference(tmp_path):
    from types import SimpleNamespace

    from PIL import Image

    from wiw_tpu.workers import svd_action as JW

    rng = np.random.default_rng(7)
    dirs = []
    for i in range(2):
        d = tmp_path / str(i)
        d.mkdir()
        Image.fromarray(rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)).save(
            d / "cond_rgb.png")
        dirs.append(str(d))
    stub = SimpleNamespace(gen=SimpleNamespace(height=16, width=32),
                           device=torch.device("cpu"))
    task = {"save_dirs": dirs}
    np.testing.assert_array_equal(
        W.SVDActionWorker._load_cond_images(stub, task).numpy(),
        JW.SVDActionWorker._load_cond_images(stub, task))
