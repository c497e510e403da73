"""The optimizer's device time a step, ms: the device work launched inside
the span from `optimizer.step` to the end of the EMA update, in the traced
step(s), per step."""


def read(run):
    t = run.trace
    if not t or not run.counters.get("traced_steps"):
        return None
    dev = t["span_device_s"].get("wmbench.optim_ema", 0.0)
    return 1e3 * dev / run.counters["traced_steps"] if dev > 0 else None
