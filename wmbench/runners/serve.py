"""Serving cells: closed-loop agents against the served path.

The system under test is built as `server_cli` builds its default
in-process worker (the W8A8 UNet, the serving CFG schedule, the continuous
engine of `make_continuous_executor`), with weights made on the card from
the seed, behind a `ManagerServer` on an ephemeral localhost port. Agent
threads talk to it through `WMClient`, each sending its next request when
the last one's frames come back.

The traffic file sets: agents, candidates a request and turns at most in
a proposal.

Spans and counters come from wrappers that this file puts around the
engine's public `admit` and `step` and the executor's `encode_item`; with
`--trace 1` also around the kernels' entry points (K7's `w8a8_dense` and
`w8a8_conv` as the model's layers call them).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import socket
import threading
import time
import types

import numpy as np

from wmbench import harness as H
from wmbench import opcount
from wmbench.reference import svd as ref

CHECK_CANDIDATES = 2   # served candidates the check compares, in the pool together
TRACE_START_S = 6      # the traced sub-window of --trace 1: its start in the window
TRACE_SECONDS = 6      # and its length


# ---------------------------------------------------------------- traffic
def proposal(rng: random.Random, frames: int, turn_max: int) -> list:
    """One candidate's actions, the heuristic of the solvers' look-ahead: a
    run of up to `turn_max` turns one way, then forward moves (frame 0 is
    the current view)."""
    turn = rng.choice((2, 3))
    k = rng.randint(0, turn_max)
    return [1] + [turn] * k + [1] * (frames - 1 - k)


def cond_image(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """A smooth random uint8 view [H, W, 3]: a 9 x 16 grid of colours,
    bilinearly upsampled."""
    from PIL import Image

    small = rng.integers(0, 256, size=(9, 16, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((width, height), Image.BILINEAR))


def request(seed: int, agent: int, index: int, traffic: dict, gen: dict):
    """The agent's index-th request: actions [C, F] and images [C, H, W, 3]
    uint8, the same sizes for every seed."""
    rng = random.Random(f"{seed}/{agent}/{index}")
    nrng = np.random.default_rng([seed % (1 << 63), agent + 1, index])
    C, Fr = traffic["candidates"], gen["num_frames"]
    acts = np.array([proposal(rng, Fr, traffic["turn_max"]) for _ in range(C)], np.int64)
    imgs = np.stack([cond_image(nrng, gen["height"], gen["width"]) for _ in range(C)])
    return acts, imgs


# ---------------------------------------------------------------- the system
def build_pipe(config: dict, seed: int, device):
    """The served pipeline with weights made on the card from the seed, in
    the types they are served in (UNet and VAE bf16, CLIP fp32)."""
    import torch

    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    u, v, c = config["unet"], config["vae"], config["clip"]
    pipe = SVDPipeline(
        UNetConfig(**{k: tuple(x) if isinstance(x, list) else x for k, x in u.items()}),
        VAEConfig(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()}),
        CLIPVisionConfig(**c), device=device)
    if config["serving"]["quantize"] == "int8":
        pipe.quantize_unet()
    spec = ref.param_spec(config)
    towers = {t: ref.make_tower(spec[t], t, seed, getattr(torch, config[t]["dtype"]), device)
              for t in ("unet", "vae", "clip")}
    pipe.load_state_dicts(towers["unet"], towers["vae"], towers["clip"])
    return pipe


def generation(config: dict):
    from wiw_tpu_torch.core.schedule import CFGSchedule
    from wiw_tpu_torch.sampling.pipeline import GenerationConfig

    g = config["generation"]
    return GenerationConfig(
        height=g["height"], width=g["width"], num_frames=g["num_frames"],
        num_inference_steps=g["num_inference_steps"],
        min_guidance_scale=g["min_guidance_scale"], max_guidance_scale=g["max_guidance_scale"],
        fps=g["fps"], motion_bucket_id=g["motion_bucket_id"],
        noise_aug_strength=g["noise_aug_strength"], task_type=g["task_type"],
        cfg=CFGSchedule(tail_sigma=g["cfg_tail_sigma"], tail_policy=g["cfg_tail_policy"]))


def warm_up(pipe, gen, config, traffic, seed, device):
    """The cell's own shapes once: one request through an engine of the
    same pool whose schedule is 2 steps (a full tick of every slot's two
    rows, a cond-only tick, one clip's decode), the request's encode."""
    import torch

    from wiw_tpu_torch.serve.continuous import ContinuousEngine

    g = config["generation"]
    eng = ContinuousEngine(pipe, dataclasses.replace(gen, num_inference_steps=2),
                           num_slots=config["serving"]["num_slots"],
                           out_hw=(g["out_height"], g["out_width"]), out_uint8=True)
    acts, imgs = request(seed, -1, 0, traffic, g)
    eng.admit(imgs[0].astype(np.float32) / 127.5 - 1.0, acts[0],
              torch.Generator(device=device).manual_seed(0))
    while eng.busy:
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ledger:
    """What the wrappers see at the engine's public boundaries: each
    admission (candidate, noise seed, request id), each tick (entry and
    return time, slots stepping, cond-only or not), and each request id's
    tick kinds, kept by the same rule the engine states (the stale tail only
    when every stepping slot is past its start), and the tick it first
    stepped in (two request ids whose first ticks lie fewer than `steps`
    apart were in the pool together, in two slots)."""

    def __init__(self, steps: int, tail: int | None):
        self.steps, self.tail = steps, tail
        self.lock = threading.Lock()
        self.next_item = None
        self.items = {}      # save_dir -> {"seed", "rid"}
        self.kinds = {}      # rid -> ["full" | "cond", ...]
        self.start = {}      # rid -> the index of its first UNet tick
        self.nticks = 0
        self.ticks = []      # (t_call, t_ret, active, cond_only)

    def on_encode(self, payload, i):
        self.next_item = payload["save_dirs"][i]

    def admitted(self, rid, generator):
        if rid is not None:
            with self.lock:
                self.items[self.next_item] = {"seed": generator.initial_seed(), "rid": rid}
                self.kinds[rid] = []

    def stepping(self):
        active = [r for r, k in self.kinds.items() if len(k) < self.steps]
        cond = self.tail is not None and bool(active) and all(
            len(self.kinds[r]) >= self.tail for r in active)
        for r in active:
            if not self.kinds[r]:
                self.start[r] = self.nticks
            self.kinds[r].append("cond" if cond else "full")
        if active:
            self.nticks += 1
        return len(active), cond


def credit(ticks, t0: float, t1: float):
    """Candidate-steps done in [t0, t1): tick k's steps spread evenly over
    [its call, the next tick's call) (the last tick: its call to its
    return), counted by the part that lies in the window. A tick with no
    slot stepping (it only collects decodes) is no tick of the UNet's.
    Returns (candidate-steps, UNet ticks, slot-steps by tick kind)."""
    steps = nticks = 0.0
    rows = {"full": 0.0, "cond": 0.0}
    for k, (a, r, active, cond) in enumerate(ticks):
        b = ticks[k + 1][0] if k + 1 < len(ticks) else r
        if b <= a:
            continue
        share = max(0.0, min(b, t1) - max(a, t0)) / (b - a)
        steps += share * active
        nticks += share if active else 0.0
        rows["cond" if cond else "full"] += share * active
    return steps, nticks, rows


# ---------------------------------------------------------------- the run
def run(ctx) -> tuple:
    import torch

    from wiw_tpu_torch.ops import native
    from wiw_tpu_torch.serve import server_cli
    from wiw_tpu_torch.serve.manager import ManagerServer, WMClient

    config, traffic, args = ctx.config, ctx.traffic, ctx.args
    g, device = config["generation"], torch.device(ctx.device)
    spans = H.Spans(args.trace)
    if device.type == "cuda":
        native.load_libraries(*native.LIBRARIES)
    pipe = build_pipe(config, args.seed, device)
    gen = generation(config)
    warm_up(pipe, gen, config, traffic, args.seed, device)
    worker = types.SimpleNamespace(gen=gen, pipe=pipe, out_size=(g["out_width"], g["out_height"]))
    executor = server_cli.make_continuous_executor(worker, config["serving"]["num_slots"])
    engine = executor.engine
    led = Ledger(g["num_inference_steps"], ref.tail_start(g))
    kernels = opcount.KernelCalls()
    if args.trace:
        kernels.install(spans)
    encode_item, admit, step = executor.encode_item, engine.admit, engine.step

    def wrapped_encode(payload, i):
        led.on_encode(payload, i)
        return encode_item(payload, i)

    def wrapped_admit(image, actions, generator):
        h = spans.open("wmbench.admit")
        try:
            rid = admit(image, actions, generator)
        finally:
            spans.close(h)
        led.admitted(rid, generator)
        return rid

    # the profiler records the host's side of the thread it is started in:
    # the engine's loop thread starts and stops it, at tick boundaries
    tracer = {"prof": None, "start": None, "result": None}

    def wrapped_step():
        with led.lock:
            active, cond = led.stepping()
        t = time.perf_counter()
        if args.trace and tracer["start"] is None and t >= t_window[0] + TRACE_START_S:
            tracer["prof"], tracer["start"] = H.Profiler(spans).__enter__(), t
        h = spans.open("wmbench.tick")
        try:
            return step()
        finally:
            spans.close(h)
            now = time.perf_counter()
            led.ticks.append((t, now, active, cond))
            prof = tracer["prof"]
            if prof is not None and now >= tracer["start"] + TRACE_SECONDS:
                tracer["prof"] = None
                prof.__exit__(None, None, None)
                tracer["result"] = prof.result

    executor.encode_item, engine.admit, engine.step = wrapped_encode, wrapped_admit, wrapped_step
    port = free_port()
    server = ManagerServer([executor], host="127.0.0.1", port=port)
    port = server.start()

    stop = threading.Event()
    sent = []      # (agent, index, t_send)
    done = []      # (agent, index, t_send, t_recv, ok, frames by save_dir)
    errors = []

    def agent(a):
        client = WMClient("127.0.0.1", port)
        try:
            for j in range(10 ** 6):
                if stop.is_set():
                    return
                acts, imgs = request(args.seed, a, j, traffic, g)
                dirs = [f"a{a}/r{j}/c{c}" for c in range(len(acts))]
                payload = {"b_action": acts, "b_image": np.ascontiguousarray(
                    imgs.transpose(0, 3, 1, 2)), "save_dirs": dirs,
                    "request_model_name": "igenex", "return_objects": [True] * len(dirs)}
                t0 = time.perf_counter()
                sent.append((a, j, t0))
                out = client.send_batch(payload)
                t1 = time.perf_counter()
                frames = out.get("pred_frames")
                ok = ("error" not in out and frames is not None
                      and frames.shape == (len(dirs), g["num_frames"], 3,
                                           g["out_height"], g["out_width"]))
                done.append((a, j, t0, t1, ok, dict(zip(dirs, frames)) if ok else {}))
        except (EOFError, OSError) as e:
            if not stop.is_set():
                errors.append((a, repr(e)))
        finally:
            client.close()

    agents = [threading.Thread(target=agent, args=(a,), daemon=True)
              for a in range(traffic["agents"])]
    t_start = time.perf_counter()
    t_window = [t_start]
    for th in agents:
        th.start()
    # the window starts at the agents' first sends; the pool fills at once
    t0 = t_start
    setup_s = t0 - ctx.t_process
    H.log(phase="window", seconds=args.seconds, smi=H.smi())
    time.sleep(max(0.0, t0 + args.seconds - time.perf_counter()))
    t1 = time.perf_counter()
    H.log(phase="window_end", smi=H.smi())
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    # no request is sent after the close; the check's sample waits for
    # answers due in the window, up to a minute and a half past it
    stop.set()
    while (sum(len(d[5]) for d in done) < CHECK_CANDIDATES
           and time.perf_counter() < t1 + 90 and any(th.is_alive() for th in agents)):
        time.sleep(0.05)
    server.stop()
    if tracer["prof"] is not None:  # the engine stopped before the sub-window ended
        raise H.RunError("the traced sub-window did not close before the window's end")
    trace = tracer["result"]
    for th in agents:
        th.join(timeout=120)
    if any(th.is_alive() for th in agents):
        raise H.RunError("an agent thread did not end")
    if errors:
        raise H.RunError(f"agents failed: {errors}")

    attempted = [(a, j) for a, j, t in sent if t0 <= t < t1]
    failed = sum(1 for d in done if (d[0], d[1]) in attempted and not d[4])
    whole = [d for d in done if d[2] >= t0 and d[3] <= t1]
    ticks = list(led.ticks)
    cand_steps, nticks, rows = credit(ticks, t0, t1)
    window = t1 - t0
    steps = g["num_inference_steps"]
    counters = {
        "setup_s": setup_s, "window_s": window, "candidate_steps": cand_steps, "ticks": nticks,
        "slots": config["serving"]["num_slots"], "rows": rows,
        "requests": len(whole),
        "request_s": [d[3] - d[2] for d in whole if d[4]],
        "frames_per_s": g["num_frames"] * cand_steps / steps / window,
    }
    if trace is not None:
        # the per-layer rates leave out the profiled sub-window, which the
        # profiler slows
        ts, te = trace["host_t0"], trace["host_t1"]
        c_steps, c_ticks, c_rows = credit(ticks, ts, te)
        rows = {k: rows[k] - c_rows[k] for k in rows}
        counters.update(window_s=window - (te - ts), candidate_steps=cand_steps - c_steps,
                        ticks=nticks - c_ticks, rows=rows)
    work = opcount.serve_work(config, rows, counters["candidate_steps"] / steps)
    H.log(phase="counters", **{k: v for k, v in counters.items() if k != "rows"},
          rows=rows, requests_done=len(done), attempted=len(attempted), failed=failed)

    # the system's state goes before the reference runs
    served = {k: v for d in done if d[4] for k, v in d[5].items()}
    items = dict(led.items)
    kinds = {r: list(k) for r, k in led.kinds.items()}
    starts = dict(led.start)
    del server, executor, engine, worker, pipe, done
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, correct = check(ctx, served, items, kinds, starts)
    metrics = {}
    if args.trace:
        run_view = types.SimpleNamespace(trace=trace, counters=counters, work=work,
                                         kernels=kernels, window_s=window, peak_bytes=peak)
        metrics = H.read_per_layer(ctx.per_layer, run_view)
    else:
        e2e = {"frames_per_s": (counters["frames_per_s"], "frames/s"),
               "request_s": (float(np.mean(counters["request_s"]))
                             if counters["request_s"] else None, "s"),
               "setup_s": (setup_s, "s")}
        metrics = {k: {"value": e2e[k][0], "unit": e2e[k][1]}
                   for k in ctx.end_to_end if e2e[k][0] is not None}
    result = {"correct": correct, "attempted": len(attempted), "failed": failed,
              "metrics": metrics, "device": H.device_record(device, 1, peak, trace)}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    return result, checks


def sample(names, items: dict, starts: dict, steps: int, seed: int, n: int) -> list:
    """n served candidates drawn from the seed: one, then others that were in
    the pool together with it (so in other slots) before the rest."""
    rng = random.Random(seed)
    names = sorted(names)
    first = rng.choice(names)
    rest = [m for m in names if m != first]
    rng.shuffle(rest)
    s0 = starts.get(items[first]["rid"])

    def apart(m):
        s = starts.get(items[m]["rid"])
        return s is None or s0 is None or abs(s - s0) >= steps

    rest.sort(key=apart)
    return [first] + rest[:n - 1]


def check(ctx, served: dict, items: dict, kinds: dict, starts: dict):
    """The served candidates of the window, a sample drawn from the seed,
    against the reference's clip from the same image, actions and noise
    seed, the same tick kinds: the widest per-clip RMS gap of the uint8
    frames, against its limit."""
    import torch

    config, args = ctx.config, ctx.args
    limit = config["check"]["frame_rms_limit"]  # None: read, never passed
    if not served:
        return [("served_candidates", 0, ">= 1")], False
    g = config["generation"]
    pick = sample(served, items, starts, g["num_inference_steps"], args.seed, CHECK_CANDIDATES)
    spec = ref.param_spec(config)
    device = ctx.device
    P = {}
    for t in ("unet", "vae", "clip"):
        tower = ref.make_tower(spec[t], t, args.seed, getattr(torch, config[t]["dtype"]), device)
        P.update({k: v.float() for k, v in tower.items()})
        del tower
    q = ref.Quant(config["serving"]["quantize"])
    worst = 0.0
    for name in pick:
        t_ref = time.perf_counter()
        a, j, c = (int(p[1:]) for p in name.split("/"))
        acts, imgs = request(args.seed, a, j, ctx.traffic, g)
        item = items[name]
        want = ref.serve_clip(P, config, imgs[c], acts[c], item["seed"], kinds[item["rid"]],
                              q, device=device)
        gap = float(np.sqrt(np.mean((served[name].astype(np.float64) - want) ** 2)))
        H.log(phase="check", candidate=name, first_tick=starts.get(item["rid"]),
              frame_rms=gap, quant=q.mode, seconds=time.perf_counter() - t_ref)
        worst = max(worst, gap)
    return [("frame_rms", worst, limit)], limit is not None and worst <= limit
