"""The readings that the checks' limits are set from, for a cell, on the
card at the cell's own size: the control (the reference put in the
system's place, one precision down) and, for a training cell, a planted
fault, each judged by the cell's own check, which has to find it not
correct. The benchmark's runs never run this.

  python3 wmbench/controls.py --workload <name> --seeds 1 2 3

Serving cells: for each seed, one candidate of the cell's traffic (its
first agent's first request) made by the reference with the int4 control
in the system's place, the same image, actions, noise and tick kinds (the
schedule's full and cond-only steps), handed to the serving check as the
served clip. Training cells: for each seed, the reference's readings of
the followed steps with fp8 products (the control) and with half of every
micro-batch left out (a fault), each handed to the training check as the
program's readings. Prints one JSON line a seed: each one's numbers, their
limits and `correct`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wmbench import harness as H  # noqa: E402


def judged(checks, correct) -> dict:
    return {"checks": {name: {"value": value, "limit": limit} for name, value, limit in checks},
            "correct": correct}


def serve_control(ctx) -> dict:
    import torch

    from wmbench.runners import serve
    from wmbench.reference import svd as ref

    config, g, seed = ctx.config, ctx.config["generation"], ctx.args.seed
    spec = ref.param_spec(config)
    P = {}
    for t in spec:
        P.update({k: v.float() for k, v in ref.make_tower(
            spec[t], t, seed, getattr(torch, config[t]["dtype"]), ctx.device).items()})
    acts, imgs = serve.request(seed, 0, 0, ctx.traffic, g)
    tail = ref.tail_start(g)
    kinds = ["full" if tail is None or i < tail else "cond"
             for i in range(g["num_inference_steps"])]
    t = time.perf_counter()
    clip = ref.serve_clip(P, config, imgs[0], acts[0], seed, kinds, ref.Quant("int4"),
                          device=ctx.device)
    H.log(phase="control", mode="int4", seconds=time.perf_counter() - t)
    del P
    name = "a0/r0/c0"
    return {"control_int4": judged(*serve.check(
        ctx, {name: clip}, {name: {"seed": seed, "rid": 0}}, {0: kinds}, {0: 0}))}


def train_control(ctx) -> dict:
    from wmbench.runners import train
    from wmbench.reference import svd as ref

    t = time.perf_counter()
    want = train.reference_readings(ctx)
    H.log(phase="reference", seconds=time.perf_counter() - t, loss=want["loss"])
    out = {}
    for name, kw in (("control_fp8", {"quant": ref.Quant("fp8")}), ("fault_half", {"half": True})):
        t = time.perf_counter()
        got = train.reference_readings(ctx, **kw)
        H.log(phase=name, seconds=time.perf_counter() - t, loss=got["loss"])
        out[name] = judged(*train.check(ctx, got, want))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    H.prepare_environment()
    bench = H.load_benchmark()
    cell, config, traffic = H.cell_files(bench, args.workload)
    H.require_devices(cell["chips"])
    for seed in args.seeds:
        ctx = types.SimpleNamespace(args=types.SimpleNamespace(seed=seed), config=config,
                                    traffic=traffic, device="cuda")
        fn = serve_control if traffic["runner"] == "serve" else train_control
        print(json.dumps({"workload": args.workload, "seed": seed, **fn(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
