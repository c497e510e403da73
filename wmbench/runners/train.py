"""Training cells: whole optimizer steps of `Trainer.train_step`, paced by
the card.

Set-up builds the pipeline (weights made on the card from the seed: the
UNet's fp32 parameters, the frozen VAE in bf16 and CLIP in fp32), the
trainer and its state, and a ring of RING_STEPS optimizer steps' batches
and random draws on the card (clips in [-1, 1], nav actions in {1, 2, 3}).
It then drives that state through the first FOLLOWED_STEPS steps of the
ring, the steps the reference follows from the seed; those are the warm-up.

The window holds whole steps only: it dispatches step k, then waits for
step k - 1's event, and stops dispatching when the next step would end
past `--seconds` (by the last step's time); it ends when the last step
ends. The rate is 4 clips a step over that time. No value is read from the
card inside the window: the followed steps' losses and norms, and the
window's own losses, stay there until it closes.

After the window the check reads what the window did: each leaf's
optimizer step count, whether each parameter and its EMA moved (float64
sums and norms a leaf at the window's start and end), and whether every
window loss is finite. Then the state that the window left is copied to
the host and taken one step further through the same call (the post
step), which the reference follows from that copy.

The traffic file sets the split (micro-batch, accumulation).
"""

from __future__ import annotations

import gc
import math
import time
import types

import numpy as np

from wmbench import harness as H
from wmbench import opcount
from wmbench.reference import svd as ref

RING_STEPS = 3       # steps' batches in the ring: the followed steps' rows all differ
FOLLOWED_STEPS = 2   # set-up's steps, which the reference follows from the seed
TRACED_STEP = 2      # the window's step that --trace 1 profiles


def make_ring(config: dict, traffic: dict, seed: int, device):
    """RING_STEPS steps of batches and draws, made on the card from the
    seed: batch pixel_values [A, B, F, H, W, 3], actions [A, B, F]; draws one
    dict a micro-step, the trainer's keys and shapes."""
    import torch
    import torch.nn.functional as F

    g = config["generation"]
    A, B, Fr = traffic["accumulation"], traffic["micro_batch"], g["num_frames"]
    Hh, W = g["height"], g["width"]
    scale = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    h, w = Hh // scale, W // scale
    gen = torch.Generator(device=device).manual_seed(ref.chunk_seed(seed, "data", 0))
    ring = []
    for _ in range(RING_STEPS):
        small = torch.rand((A * B * Fr, 3, 9, 16), generator=gen, device=device) * 2 - 1
        clips = F.interpolate(small, size=(Hh, W), mode="bilinear", align_corners=False)
        batch = {"pixel_values": clips.permute(0, 2, 3, 1).reshape(A, B, Fr, Hh, W, 3).contiguous(),
                 "actions": torch.randint(1, 4, (A, B, Fr), generator=gen, device=device)}

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device)

        draws = [{"vae_eps": normal(B * Fr, h, w, 4), "cond_sigma_z": normal(B, 1, 1, 1),
                  "cond_noise": normal(B, Hh, W, 3), "latent_noise": normal(B, Fr, 4, h, w),
                  "sigma_z": normal(B, 1, 1, 1, 1),
                  "dropout_u": torch.rand(B, generator=gen, device=device)} for _ in range(A)]
        ring.append((batch, draws))
    return ring


def build(config: dict, traffic: dict, seed: int, device):
    import torch

    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline
    from wiw_tpu_torch.train.trainer import TrainConfig, Trainer

    def cast(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    pipe = SVDPipeline(UNetConfig(**cast(config["unet"])), VAEConfig(**cast(config["vae"])),
                       CLIPVisionConfig(**config["clip"]), device=device)
    spec = ref.param_spec(config)
    dtypes = {"unet": torch.float32, "vae": getattr(torch, config["vae"]["dtype"]),
              "clip": getattr(torch, config["clip"]["dtype"])}
    towers = {t: ref.make_tower(spec[t], t, seed, dtypes[t], device) for t in spec}
    pipe.load_state_dicts(towers["unet"], towers["vae"], towers["clip"])
    del towers
    t = config["train"]
    if traffic["micro_batch"] * traffic["accumulation"] != config["clips_per_step"]:
        raise H.RunError("the traffic's split does not make the configuration's clips a step")
    tc = TrainConfig(
        learning_rate=t["learning_rate"], adam_beta1=t["adam_beta1"], adam_beta2=t["adam_beta2"],
        adam_eps=t["adam_eps"], weight_decay=t["weight_decay"], max_grad_norm=t["max_grad_norm"],
        grad_accum_steps=traffic["accumulation"], ema_decay=t["ema_decay"], use_ema=t["use_ema"],
        conditioning_dropout=t["conditioning_dropout"], fps=t["fps"],
        motion_bucket_id=t["motion_bucket_id"], train_params=t["train_params"],
        lr_scheduler=t["lr_scheduler"], optimizer=t["optimizer"])
    trainer = Trainer(pipe, tc)
    return pipe, trainer, trainer.init_state()


def first_gradients(state, beta1: float) -> dict:
    """Each trained leaf's gradient norm as the optimizer got it in its first
    step, from its state after that step (m = (1 - beta1) g), on the card."""
    import torch

    names = list(state.params)
    # a leaf the optimizer holds no state for has not been stepped: nought
    m = [state.optimizer.state.get(state.params[n], {}).get("exp_avg", torch.zeros(()))
         for n in names]
    return dict(zip(names, [x / (1.0 - beta1) for x in torch._foreach_norm(m)]))


def changes(state, config: dict, seed: int) -> tuple:
    """Each leaf's change of the parameters and of the EMA from the
    initial weights, made again from the seed a draw at a time, on the
    card."""
    import torch

    spec = ref.param_spec(config)["unet"]
    names = list(state.params)
    ema = dict(zip(names, state.ema))
    dp, de = {}, {}
    for i, chunk in enumerate(ref.chunk_plan(spec)):
        p0 = ref.draw_chunk(spec, chunk, ref.chunk_seed(seed, "unet", i), torch.float32,
                            state.params[chunk[0]].device)
        for n in chunk:
            dp[n] = (state.params[n].detach() - p0[n]).norm()
            de[n] = (ema[n] - p0[n]).norm()
        del p0
    for n, (shape, (kind, value)) in spec.items():
        if kind == "const":
            dp[n] = (state.params[n].detach() - value).norm()
            de[n] = (ema[n] - value).norm()
    return dp, de


def fingerprints(state):
    """Each leaf's float64 sum and norm of the parameter and of its EMA, on
    the card ([leaves, 4]): what tells whether a stretch of steps moved it."""
    import torch

    rows = []
    for p, e in zip(state.params.values(), state.ema):
        p = p.detach()
        rows.append(torch.stack([p.sum(dtype=torch.float64),
                                 torch.linalg.vector_norm(p, dtype=torch.float64),
                                 e.sum(dtype=torch.float64),
                                 torch.linalg.vector_norm(e, dtype=torch.float64)]))
    return torch.stack(rows)


def optimizer_steps(state) -> dict:
    """Each leaf's step count in the optimizer's state (None: no state)."""
    out = {}
    for n, p in state.params.items():
        st = state.optimizer.state.get(p, {})
        out[n] = float(st["step"]) if "step" in st else None
    return out


def snapshot(state, steps: int, slot: int) -> dict:
    """The state on the host: each leaf's parameter, AdamW moments and EMA,
    the steps taken, and the ring slot of the next step."""
    import torch

    out = {"step": steps, "slot": slot, "p": {}, "m": {}, "v": {}, "ema": {}}
    for (n, p), e in zip(state.params.items(), state.ema):
        st = state.optimizer.state.get(p, {})
        zero = torch.zeros((), device=p.device)
        for key, t in (("p", p.detach()), ("m", st.get("exp_avg", zero)),
                       ("v", st.get("exp_avg_sq", zero)), ("ema", e)):
            out[key][n] = t.to("cpu", copy=True)
    return out


def post_readings(state, snap: dict, loss, beta1: float) -> dict:
    """The post step's readings, as the followed steps': its loss, each
    leaf's gradient as the optimizer got it ((m' - beta1 m) / (1 - beta1)),
    and each leaf's change of the parameter and of the EMA."""
    import torch

    out = {"loss": [float(loss)], "grad": {}, "change": {}, "ema_change": {}}
    with torch.no_grad():
        for (n, p), e in zip(state.params.items(), state.ema):
            dev = p.device
            m1 = state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros((), device=dev))
            out["grad"][n] = float(((m1 - beta1 * snap["m"][n].to(dev)) / (1.0 - beta1)).norm())
            out["change"][n] = float((p.detach() - snap["p"][n].to(dev)).norm())
            out["ema_change"][n] = float((e - snap["ema"][n].to(dev)).norm())
    return out


def another_step_fits(now: float, step_s: float, end: float) -> bool:
    """Whether step k + 1 would end by `end`, asked when the call of step k
    has returned: the trainer's call waits on the card at each micro-step,
    so step k is then about half done, and step k + 1 would end about
    1.5 steps later (with a tenth of a step to spare)."""
    return now + 1.6 * step_s <= end


def run(ctx):
    import torch

    readings = measure(ctx)
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    checks, correct = check(ctx, readings["program"])
    counters, trace = readings["counters"], readings["trace"]
    if ctx.args.trace:
        view = types.SimpleNamespace(trace=trace, counters=counters, kernels=readings["kernels"],
                                     window_s=counters["window_s"], peak_bytes=readings["peak"])
        metrics = H.read_per_layer(ctx.per_layer, view)
    else:
        e2e = {"clips_per_s": (counters["clips"] / counters["window_s"], "clips/s"),
               "setup_s": (counters["setup_s"], "s")}
        metrics = {k: {"value": e2e[k][0], "unit": e2e[k][1]} for k in ctx.end_to_end}
    result = {"correct": correct, "attempted": counters["steps"], "failed": 0, "metrics": metrics,
              "device": H.device_record(ctx.device, 1, readings["peak"], trace)}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    return result, checks


def measure(ctx) -> dict:
    """Set-up, the followed steps and the window. Returns the readings only:
    everything of the system's is freed when this returns."""
    import torch

    from wiw_tpu_torch.ops import native

    config, traffic, args = ctx.config, ctx.traffic, ctx.args
    device = torch.device(ctx.device)
    on_card = device.type == "cuda"
    if on_card:
        native.load_libraries(*native.LIBRARIES)
    spans = H.Spans(args.trace)
    pipe, trainer, state = build(config, traffic, args.seed, device)
    ring = make_ring(config, traffic, args.seed, device)
    kernels = opcount.KernelCalls()
    if args.trace:
        kernels.install(spans, which=("k1", "k3"))
    opt_step = state.optimizer.step
    pending = []

    def wrapped_opt_step(*a, **k):
        pending.append(spans.open("wmbench.optim_ema"))
        return opt_step(*a, **k)

    state.optimizer.step = wrapped_opt_step

    def step(k):
        batch, draws = ring[k % len(ring)]
        h = spans.open("wmbench.train_step")
        out = trainer.train_step(state, batch, draws=draws)
        spans.close(pending.pop())
        spans.close(h)
        return out["loss"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the followed steps: the warm-up, and what the reference follows; the
    # check's own readings between them are left out of setup_s
    losses, beta1 = [], config["train"]["adam_beta1"]
    t_steps, check_s = [], 0.0
    for k in range(FOLLOWED_STEPS):
        t = time.perf_counter()
        losses.append(step(k))
        sync()
        t_steps.append(time.perf_counter() - t)
        if k == 0:
            t = time.perf_counter()
            grads = first_gradients(state, beta1)
            sync()
            check_s += time.perf_counter() - t
    t = time.perf_counter()
    dp, de = changes(state, config, args.seed)
    start_prints = fingerprints(state)
    sync()
    check_s += time.perf_counter() - t
    step_s = t_steps[-1]

    H.log(phase="window", seconds=args.seconds, followed_step_s=t_steps, check_s=check_s,
          smi=H.smi())
    trace = None
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process - check_s
    k, done, last_event, traced_s = FOLLOWED_STEPS, 0, None, 0.0
    window_losses = []
    while True:
        if args.trace and done == TRACED_STEP:
            sync()
            t_traced = time.perf_counter()
            with H.Profiler(spans) as prof:
                window_losses.append(step(k))
            trace = prof.result
            traced_s = time.perf_counter() - t_traced
            last_event = None
        else:
            window_losses.append(step(k))
        event = torch.cuda.Event() if on_card else None
        if event is not None:
            event.record()
        if last_event is not None:
            last_event.synchronize()
        last_event = event
        k += 1
        done += 1
        if not another_step_fits(time.perf_counter(), step_s, t0 + args.seconds):
            break
    sync()
    t1 = time.perf_counter()
    H.log(phase="window_end", steps=done, smi=H.smi())
    window = t1 - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    clips = done * config["clips_per_step"]
    program = {
        "loss": [float(x) for x in losses],
        "grad": {n: float(v) for n, v in grads.items()},
        "change": {n: float(v) for n, v in dp.items()},
        "ema_change": {n: float(v) for n, v in de.items()},
    }
    # what the window did: step counts, leaves moved, losses
    moved = (fingerprints(state) != start_prints).cpu()
    program["window"] = {
        "expected_steps": FOLLOWED_STEPS + done, "steps": optimizer_steps(state),
        "moved": {n: bool(moved[i, :2].any()) for i, n in enumerate(state.params)},
        "ema_moved": {n: bool(moved[i, 2:].any()) for i, n in enumerate(state.params)},
        "sizes": {n: p.numel() for n, p in state.params.items()},
        "losses": [float(x) for x in window_losses]}
    # the post step: the window's state one step further, from a copy
    t = time.perf_counter()
    snap = snapshot(state, FOLLOWED_STEPS + done, k % RING_STEPS)
    post_loss = step(k)
    sync()
    program["post"] = post_readings(state, snap, post_loss, beta1)
    program["snapshot"] = snap
    H.log(phase="post_step", seconds=time.perf_counter() - t, steps_before=snap["step"],
          slot=snap["slot"], loss=program["post"]["loss"],
          window_losses=program["window"]["losses"])
    counters = {"setup_s": setup_s, "window_s": window, "steps": done, "clips": clips,
                "ops_per_clip": opcount.train_ops_per_clip(config), "traced_steps": 1,
                # the profiled step, slowed by the profiler, is left out of
                # the per-layer rates
                "untraced_s": window - traced_s,
                "untraced_clips": clips - (config["clips_per_step"] if traced_s else 0)}
    H.log(phase="counters", **counters, clips_per_s=clips / window, losses=program["loss"])

    state.optimizer.step = opt_step
    return {"program": program, "counters": counters, "trace": trace, "kernels": kernels,
            "peak": peak}


def reference_readings(ctx, quant=None, half: bool = False, post: dict = None) -> dict:
    """The reference's readings of the followed steps: the same initial
    weights and the same ring, made again from the seed. With `post` (a
    snapshot), also of the post step, followed from that snapshot's
    parameters, moments and EMA."""
    import torch

    config, traffic, args = ctx.config, ctx.traffic, ctx.args
    device = torch.device(ctx.device)
    spec = ref.param_spec(config)
    dtypes = {"unet": torch.float32, "vae": getattr(torch, config["vae"]["dtype"]),
              "clip": getattr(torch, config["clip"]["dtype"])}
    P = {}
    for t in spec:
        P.update({k: v.float() for k, v in ref.make_tower(spec[t], t, args.seed, dtypes[t],
                                                          device).items()})
    ring = make_ring(config, traffic, args.seed, device)
    q = quant or ref.FP32
    want = ref.train_reference(config, P, [ring[k % RING_STEPS] for k in range(FOLLOWED_STEPS)],
                               q, half)
    if post is not None:
        names = list(spec["unet"])
        for n in names:
            P[n] = post["p"][n].to(device)
        start = {key: {n: post[key][n].to(device).expand_as(P[n]).clone() for n in names}
                 for key in ("m", "v", "ema")}
        start["step"] = post["step"]
        want["post"] = ref.train_reference(config, P, [ring[post["slot"]]], q, half, start)
    return want


def whole_gap(program: dict, reference: dict, ref_grad: dict, floor: float = 1e-3) -> float:
    """The gap between two norms taken over all the leaves together, as a
    share of the reference's, over the leaves whose reference gradient is
    above `floor` of the median leaf's."""
    med = float(np.median(list(ref_grad.values())))
    keep = [n for n in reference if ref_grad[n] > floor * med]
    a, b = (math.sqrt(sum(x[n] ** 2 for n in keep)) for x in (program, reference))
    return abs(a - b) / b


def median_gap(program: dict, reference: dict, ref_grad: dict, floor: float = 1e-3) -> float:
    """The median leaf's gap, each leaf's as `ref.leaf_gap` takes it."""
    med_g = float(np.median(list(ref_grad.values())))
    keep = [n for n in reference if ref_grad[n] > floor * med_g]
    med = float(np.median([reference[n] for n in keep]))
    return float(np.median([abs(program[n] - reference[n]) / max(reference[n], med)
                            for n in keep]))


def gaps(program: dict, want: dict) -> dict:
    """The numbers compared: the relative loss gap, the worst over the
    followed steps and the post step; the worst leaf's gap of the first
    step's gradient norm, and of the parameters' and the EMA's change norms
    after the followed steps; and the post step's change of the parameters
    and of the EMA, all leaves together (one warm AdamW step moves a small
    leaf by as much as its gradients' signs agree, which rounding turns).
    The post step's gradient is read, by its worst leaf and its median
    leaf, and not compared (`post_grad_gap_leaf`)."""
    post = "post" in program
    pairs = [(program, want)] + ([(program["post"], want["post"])] if post else [])
    out = {"loss_gap": max(abs(a - b) / abs(b) for p, w in pairs
                           for a, b in zip(p["loss"], w["loss"]))}
    for name, key in (("grad_gap", "grad"), ("change_gap", "change"), ("ema_gap", "ema_change")):
        out[name], leaf = ref.leaf_gap(program[key], want[key], want["grad"])
        out[f"{name}_leaf"] = [leaf, program[key][leaf], want[key][leaf]]
    if post:
        p, w = program["post"], want["post"]
        for name, key in (("post_change_gap", "change"), ("post_ema_gap", "ema_change")):
            out[name] = whole_gap(p[key], w[key], w["grad"])
        worst, leaf = ref.leaf_gap(p["grad"], w["grad"], w["grad"])
        out["post_grad_gap_leaf"] = [leaf, p["grad"][leaf], w["grad"][leaf], worst,
                                     median_gap(p["grad"], w["grad"], w["grad"])]
    return out


def window_gaps(window: dict, want: dict, floor: float = 1e-3, ema_min: int = 1000) -> dict:
    """What the window did, against the counts its steps make: the leaves
    that the reference moves (its first gradient above `floor` of the median
    leaf's) whose optimizer step count is not the steps taken or whose
    parameter did not move in the window, with those of `ema_min` elements
    or more whose EMA the reference's followed steps moved and the window did
    not; and the window's losses that are not finite. Both are exact: nought.
    (An EMA step, (1 - decay) (p - ema), is an ulp or two: a small leaf's can
    round back to where it was, a large leaf's cannot.)"""
    med = float(np.median(list(want["grad"].values())))
    kept = [n for n, g in want["grad"].items() if g > floor * med]
    bad = [n for n in kept
           if window["steps"].get(n) != window["expected_steps"] or not window["moved"][n]
           or (want["ema_change"][n] > 0 and window["sizes"][n] >= ema_min
               and not window["ema_moved"][n])]
    return {"window_bad_leaves": len(bad), "window_bad_leaves_leaf": bad[:4],
            "window_bad_losses": sum(not math.isfinite(x) for x in window["losses"])}


def check(ctx, program: dict, want: dict = None):
    """`program`'s readings against the reference's (`want`, or worked out
    here): the followed steps', and, where `program` has them, the window's
    and the post step's."""
    t = time.perf_counter()
    if want is None:
        want = reference_readings(ctx, post=program.get("snapshot"))
    got = gaps(program, want)
    if "window" in program:
        got.update(window_gaps(program["window"], want))
    H.log(phase="check", seconds=time.perf_counter() - t, reference_loss=want["loss"],
          reference_post_loss=want.get("post", {}).get("loss"), **got)
    limits = ctx.config["check"]
    checks = [(name, value, limits[f"{name}_limit"]) for name, value in got.items()
              if not name.endswith("_leaf")]
    correct = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in checks)
    return checks, correct
