"""What every cell's run shares: the cell's files found by name, the caches
inside the checkout, the import guard, spans, the clock and power record,
the reduction of a profiler trace, and the result line.

A run is `run.py --workload W --seed N --seconds S --trace 0|1`. The cell W
is an entry of BENCHMARK.json's `workloads`; its configuration is
`configs/<config>.json` and its traffic `traffic/<traffic>.json`, whose
`runner` names the module of `runners/` that runs it. Per-layer metrics are
`metrics/<name>.py`, each a `read(run)` that returns a number or None.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "_cache"  # fixed: every run in a checkout reuses it
FORBIDDEN = ("jax", "jaxlib", "flax", "wiw_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2, no result line)."""


# ---------------------------------------------------------------- files
def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"{path} is missing: run from a checkout of the repository")
    return json.loads(path.read_text())


def cell_files(bench: dict, workload: str):
    """(cell, config, traffic) of the workload named `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_units(bench: dict, workload: str, kind: str) -> Dict[str, str]:
    """The cell's metrics of `kind` ('end_to_end' or 'per_layer'), each
    name with its unit: those whose `workloads` name it, or that have no
    such key."""
    return {m["name"]: m["unit"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}


def read_per_layer(units: Dict[str, str], run) -> Dict[str, dict]:
    """Each metric's reader over the run, as the result line gives a
    metric: {"value": ..., "unit": ...}. A reader that finds nothing
    returns None and its metric is left out."""
    out = {}
    for name, unit in units.items():
        value = load_module(HERE / "metrics" / f"{name}.py", f"wmbench_metric_{name}").read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out


# ---------------------------------------------------------------- environment
def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX behind a
    library's back. Called before torch is imported."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def place_kernel_builds() -> None:
    """The port builds its CUDA kernels into a directory it names in code;
    the benchmark gives it one inside the checkout, under this folder."""
    from wiw_tpu_torch.ops import native

    native.BUILD_DIR = CACHE / "nvcc"


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} present")


# ---------------------------------------------------------------- records
def smi() -> dict:
    """One reading of the card's clocks and power (nvidia-smi, read only)."""
    fields = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": repr(e)}
    if not out:
        return {"error": "no output"}
    vals = [v.strip() for v in out[0].split(",")]
    return dict(zip(fields.split(","), vals))


def log(**fields) -> None:
    """An earlier line of the run's output, for the record."""
    print("wmbench " + json.dumps(fields, default=str), flush=True)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0


class Spans:
    """Host-clock spans kept in memory; with `trace` on, each is also a
    `record_function` range, so the profiler's trace can attribute device
    work to it."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def open(self, name: str):
        rf = None
        if self.trace:
            import torch

            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
        return (Span(name, time.perf_counter()), rf)

    def close(self, handle) -> Span:
        span, rf = handle
        if rf is not None:
            rf.__exit__(None, None, None)
        span.t1 = time.perf_counter()
        with self._lock:
            self.spans.append(span)
        return span

    def wrap(self, fn, name: str, on_call=None):
        """fn wrapped in a span `name`; `on_call(args, kwargs)` sees each
        call's arguments first. The wrapper carries fn's attributes (a
        kernel entry counts its launches on itself, under its module name)."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if on_call is not None:
                on_call(args, kwargs)
            h = self.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.close(h)
        return wrapped


# ---------------------------------------------------------------- trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: Path, window_span: str, span_prefix: str = "wmbench.") -> dict:
    """From a chrome trace written by torch.profiler: the traced window (the
    user annotation `window_span`), the device's busy seconds in it (union of
    kernels, copies and sets), the top device operations, the longest idle
    gaps labelled by the innermost harness span around them, and each
    harness span's device seconds (the device work launched inside it, on
    the thread that opened it)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in x if e.get("cat") == "user_annotation" and e["name"] == window_span]
    if not wins:
        raise RunError(f"the trace has no {window_span!r} annotation")
    w0 = wins[0]["ts"]
    w1 = w0 + wins[0]["dur"]
    dev = [e for e in x if e.get("cat") in DEVICE_CATS]
    inside = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev
              if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union(inside)
    busy_us = sum(b - a for a, b in busy)
    spans = [e for e in x if e.get("cat") == "user_annotation"
             and e["name"].startswith(span_prefix) and e["name"] != window_span]
    by_tid: Dict[object, list] = {}
    for s in spans:
        by_tid.setdefault(s["tid"], []).append(s)
    launch = {}
    for e in x:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    span_dev: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for e in dev:
        if not (w0 <= e["ts"] < w1):
            continue
        ops[e["name"][:64]] = ops.get(e["name"][:64], 0.0) + e["dur"] * 1e-6
        le = launch.get(e.get("args", {}).get("correlation"))
        if le is None:
            continue
        for s in by_tid.get(le["tid"], ()):
            if s["ts"] <= le["ts"] <= s["ts"] + s["dur"]:
                span_dev[s["name"]] = span_dev.get(s["name"], 0.0) + e["dur"] * 1e-6
    gaps = []
    edges = [w0] + [v for ab in busy for v in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            cover = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
            label = min(cover, key=lambda s: s["dur"])["name"] if cover else "host"
            gaps.append([label, (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "span_device_s": span_dev,
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda o: -o[1])[:10],
        "idle_gaps": gaps[:10],
    }


class Profiler:
    """torch.profiler over one sub-window, written to a chrome trace in
    TMPDIR and reduced."""

    def __init__(self, spans: Spans, name: str = "wmbench.traced"):
        self.spans, self.name = spans, name
        self.result: Optional[dict] = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.h = self.spans.open(self.name)
        return self

    def __exit__(self, *exc):
        import tempfile

        import torch

        torch.cuda.synchronize()
        span = self.spans.close(self.h)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="wmbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.result = reduce_trace(Path(path), self.name)
            self.result.update(host_t0=span.t0, host_t1=span.t1)
        finally:
            os.unlink(path)
        return False


# ---------------------------------------------------------------- result
def device_record(device, count: int, peak_bytes: int, trace: Optional[dict] = None) -> dict:
    """The result's device: the card's name and the peak on it (a CPU
    rehearsal says "cpu" and is no measurement)."""
    import torch

    on_card = torch.device(device).type == "cuda"
    d = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": count,
         "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        d["busy_s"] = trace["busy_s"]
        d["window_s"] = trace["window_s"]
    return d


def finish(result: dict, checks: List[tuple]) -> None:
    """Print the compared numbers beside their limits (standard error, last
    lines) and the result line (standard output, last line), with the
    checks last in it. Refuses to print when a forbidden module is loaded."""
    bad = forbidden_loaded()
    if bad:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {bad}")
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
