"""Serving-plane throughput benchmark: concurrent closed-loop rollouts.

Port of `wiw_tpu/serve/benchmarks.py`. It measures the serving target of
at least 8 concurrent closed-loop agent rollouts: N client threads each
run the solver's decision loop (propose candidates -> WM imagine -> pick
-> step) against one manager, and it reports rollout steps/s and the
percentiles of a request's latency. The clients are host logic: the
server they talk to runs the model on the card.

Against a running server (`python -m wiw_tpu_torch.serve.server_cli
--wm_type igenex`, which serves on the card by default):
  python -m wiw_tpu_torch.serve.benchmarks --port 7000 --clients 8 --steps 5
Self-contained, with an in-process fake WM (no model, runs on the CPU):
  python -m wiw_tpu_torch.serve.benchmarks --fake
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import threading
import time

import numpy as np


def rollout_client(port: int, steps: int, candidates: int, frames: int,
                   results: list, idx: int, save_root: str = "",
                   host: str = "127.0.0.1"):
    """One agent: `steps` decisions of `candidates` heuristic candidates,
    each one WM request; appends its request latencies at results[idx].
    Candidate directories go under `save_root` (default: the temporary
    directory's wiw_bench)."""
    from wiw_tpu_torch.agents.solver import FakeSimulator, Solver, SolverConfig

    save_root = save_root or osp.join(tempfile.gettempdir(), "wiw_bench")
    sim = FakeSimulator(seed=idx)
    solver = Solver(
        SolverConfig(world_model_type="action", igenex_n_frame=frames,
                     look_ahead_action_num=4, wm_host=host, wm_port=port),
        sim=sim)
    latencies = []
    for _ in range(steps):
        seqs, _ = solver.heur_sample_next_action_seqs([], candidates)
        t0 = time.perf_counter()
        out = solver.imagine_by_model_type(seqs, osp.join(save_root, f"c{idx}"))
        latencies.append(time.perf_counter() - t0)
        sim.step("forward")
        assert out["pred_frames"].shape[0] == candidates
    results[idx] = latencies


def run_benchmark(port: int, clients: int = 8, steps: int = 5,
                  candidates: int = 2, frames: int = 14, save_root: str = "",
                  host: str = "127.0.0.1") -> dict:
    """`clients` rollout threads against the manager at host:port. A
    client that fails raises here after every thread has ended."""
    results: list = [None] * clients
    errors: list = []

    def run(i):
        try:
            rollout_client(port, steps, candidates, frames, results, i,
                           save_root, host)
        except Exception as e:  # re-raised below, with the client's index
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"rollout clients failed: {errors}") from errors[0][1]
    lats = np.array([lat for r in results if r for lat in r])
    total_steps = clients * steps
    return {
        "clients": clients,
        "rollout_steps_per_sec": round(total_steps / wall, 3),
        "latency_p50_s": round(float(np.percentile(lats, 50)), 3),
        "latency_p95_s": round(float(np.percentile(lats, 95)), 3),
        "wall_s": round(wall, 2),
    }


def fake_wm(input_dict: dict) -> dict:
    """A WM that answers every candidate with zero frames [F, 3, 64, 128]."""
    acts = np.asarray(input_dict["b_action"])
    b, f = acts.shape[:2]
    return {"save_dirs": list(input_dict["save_dirs"]),
            "pred_frames": np.zeros((b, f, 3, 64, 128), np.uint8)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7000)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--candidates", type=int, default=2)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--fake", action="store_true",
                    help="spin up an in-process fake WM server first")
    args = ap.parse_args(argv)

    server = None
    port = args.port
    if args.fake:
        from wiw_tpu_torch.serve.manager import InProcessExecutor, ManagerServer

        server = ManagerServer([InProcessExecutor(fake_wm, max_batch=16)],
                               host=args.host, port=17900)
        port = server.start()
    try:
        result = run_benchmark(port, args.clients, args.steps, args.candidates,
                               args.frames, host=args.host)
        print(json.dumps(result))
    finally:
        if server is not None:
            server.stop()
    return result


if __name__ == "__main__":
    main()
