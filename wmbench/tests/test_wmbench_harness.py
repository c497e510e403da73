"""The harness's own arithmetic on the CPU: the import guard, the kernels'
and the model's operation counts against hand arithmetic, the window's
credit and whole-step rule, the trace's reduction."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from wmbench import harness as H
from wmbench import opcount
from wmbench.runners import serve, train
from wmbench.reference import svd as ref
from wmbench.tests import tiny


def test_guard_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "wiw_tpu_torch_fake", types.ModuleType("x"))
    assert not any(m.startswith("wiw_tpu_torch") for m in H.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "wiw_tpu.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert H.forbidden_loaded() == ["jaxlib", "wiw_tpu.fake"] or set(
        H.forbidden_loaded()) >= {"jaxlib", "wiw_tpu.fake"}


def test_kernel_counts_by_hand():
    assert opcount.k1(1, 1, 2, 2, 1) == (16.0, 16)
    assert opcount.k1(1, 1, 2, 2, 1, lse=True) == (16.0, 24)
    assert opcount.k3(1, 1, 2, 2, 1) == (40.0, 2 * 16 + 8)
    assert opcount.k7_dense(2, 3, 4) == (48.0, 12 + 12 + 16 + 16 + 16)
    ops, nbytes = opcount.k7_conv(1, 4, 4, 2, 3, 3, 1, 1)
    assert ops == 2.0 * 16 * 3 * 9 * 2 and nbytes == 64 + 54 + 12 + 12 + 96
    assert opcount.bound_s(989e12, 0, opcount.PEAK["bf16"]) == 1.0


def test_model_counts_match_torch_flop_counter(monkeypatch):
    """The tally on the meta device equals torch's own count of the
    reference's products, tower by tower, at a tiny size (attention written
    out as its two products, which torch's counter sees on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    def attention(q, k, v):
        w = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
        return w @ v

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", attention)

    cfg = tiny.config("svd_dagger_int8")
    spec = ref.param_spec(cfg)
    P = {k: v for t in spec for k, v in ref.make_tower(spec[t], t, 0, torch.float32, "cpu").items()}
    g = cfg["generation"]
    F_ = g["num_frames"]
    x = torch.randn(2, F_, 8, 16, 8)
    calls = {
        "unet": lambda q: ref.unet(P, cfg["unet"], x, torch.zeros(2), torch.randn(2, 1, 32),
                                   torch.zeros(2), torch.zeros(2, F_, 3), q),
        "vae_decode": lambda q: ref.vae_decode(P, cfg["vae"], torch.randn(2 * F_, 8, 16, 4), F_, q),
        "vae_encode": lambda q: ref.vae_encode(P, cfg["vae"], torch.randn(2, 16, 32, 3), None, q),
        "clip": lambda q: ref.clip_embed(P, cfg["clip"], torch.randn(2, 16, 32, 3), q),
    }
    for what, call in calls.items():
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            call(ref.FP32)
        counted = opcount.tower_ops(cfg, what, rows=2)
        # CLIP's input resize (two products, 16 -> 224 rows, 32 -> 224
        # columns) is preprocessing, not the model's: the tally leaves it out
        resize = 2 * (2 * 32 * 3) * 16 * 224 + 2 * (2 * 224 * 3) * 32 * 224 if what == "clip" else 0
        assert sum(counted.values()) + resize == pytest.approx(fc.get_total_flops(), rel=1e-9), what
    unet = opcount.tower_ops(cfg, "unet")
    assert unet["int8"] > 0 and unet["float"] > 0


def test_candidate_step_credit():
    ticks = [(0.0, 0.5, 4, False), (1.0, 1.5, 4, True), (2.0, 2.5, 2, False)]
    steps, n, rows = serve.credit(ticks, 0.5, 2.25)
    # half of tick 0, all of tick 1, half of the last (call 2.0 to return 2.5)
    assert steps == pytest.approx(2 + 4 + 1) and n == pytest.approx(2.0)
    assert rows == {"full": pytest.approx(3.0), "cond": pytest.approx(4.0)}
    # 14 frames a clip of 30 steps: the credit moves by 1/30 of a clip
    assert 14 * 7 / 30 / 1.75 == pytest.approx(1.8666666)


def test_whole_step_rule():
    # step k half done at 10 s, 4 s a step: step k + 1 ends near 16 s
    assert train.another_step_fits(10.0, 4.0, 16.4)
    assert not train.another_step_fits(10.0, 4.0, 16.3)


def test_ledger_keeps_the_engines_tail_rule():
    led = serve.Ledger(steps=4, tail=3)
    led.next_item = "a"
    led.admitted(0, torch.Generator().manual_seed(9))
    for _ in range(2):
        assert led.stepping() == (1, False)
    led.next_item = "b"
    led.admitted(1, torch.Generator().manual_seed(10))
    assert led.stepping() == (2, False)  # "b" is not past the tail
    assert led.stepping() == (2, False)
    assert led.kinds[0] == ["full"] * 4 and led.items["a"] == {"seed": 9, "rid": 0}
    assert led.stepping() == (1, False) and led.stepping() == (1, True)


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "wmbench.traced", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "wmbench.k7", "ts": 5, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k7_kernel", "ts": 20, "dur": 30, "tid": 9,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 40, "dur": 20, "tid": 9,
         "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = H.reduce_trace(path, "wmbench.traced")
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(40e-6)
    assert r["span_device_s"] == {"wmbench.k7": pytest.approx(30e-6)}
    assert r["idle_gaps"][0] == ["host", pytest.approx(40e-6)]
    assert r["device_ops"][0] == ["k7_kernel", pytest.approx(30e-6)]


_BENCH = H.load_benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in _BENCH["workloads"]])
def test_traced_metrics_have_the_result_lines_form(workload):
    """Every per-layer metric of the cell is read from a traced run's view,
    and each comes out as {"value": number, "unit": the unit BENCHMARK.json
    gives it}, as the result line has to carry it."""
    units = H.metric_units(_BENCH, workload, "per_layer")
    assert units and H.metric_units(_BENCH, workload, "end_to_end")
    kernels = types.SimpleNamespace(bound_in=lambda kind, t0, t1: 1e-3)
    trace = {"window_s": 2.0, "busy_s": 1.5, "host_t0": 0.0, "host_t1": 2.0,
             "span_device_s": {f"wmbench.{k}": 4e-3 for k in ("k1", "k3", "k7", "optim_ema")}}
    counters = {"window_s": 40.0, "ticks": 100, "candidate_steps": 300, "slots": 4,
                "ops_per_clip": 1e15, "untraced_clips": 20, "untraced_s": 38.0,
                "traced_steps": 1}
    view = types.SimpleNamespace(trace=trace, counters=counters, kernels=kernels,
                                 work={"int8": 1e16, "bf16": 1e15}, window_s=40.0,
                                 peak_bytes=50 * 2 ** 30)
    metrics = H.read_per_layer(units, view)
    assert set(metrics) == set(units)
    for name, m in metrics.items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], float) and m["value"] > 0
    json.dumps(metrics)
