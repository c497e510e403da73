"""One run of one cell of the benchmark.

  python3 wmbench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

Prints earlier lines (`wmbench {...}`: clocks and power at the window's
edges, counters, the checks' readings) and, last, one JSON result line:
correct, attempted, failed, metrics (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), device, breakdown (traced
runs), checks. Exits 2 with no result line where it cannot measure: no card,
fewer cards than the cell asks for, a missing file, or a module of JAX or
of the JAX package loaded.
"""

from __future__ import annotations

import argparse
import sys
import time
import types
from pathlib import Path

T_PROCESS = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wmbench import harness as H  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        H.prepare_environment()
        bench = H.load_benchmark()
        cell, config, traffic = H.cell_files(bench, args.workload)
        H.require_devices(cell["chips"])
        H.place_kernel_builds()
        runner = H.load_module(H.HERE / "runners" / f"{traffic['runner']}.py",
                               f"wmbench_runner_{traffic['runner']}")
        ctx = types.SimpleNamespace(
            args=args, cell=cell, config=config, traffic=traffic, device="cuda",
            t_process=T_PROCESS,
            end_to_end=H.metric_units(bench, args.workload, "end_to_end"),
            per_layer=H.metric_units(bench, args.workload, "per_layer"))
        H.log(phase="start", workload=args.workload, seed=args.seed, smi=H.smi())
        result, checks = runner.run(ctx)
        H.finish(result, checks)
    except H.RunError as e:
        print(f"wmbench: {e}", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
