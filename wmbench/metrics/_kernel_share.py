"""What the kernels' roofline readers share: the bound time of the calls
made inside the traced sub-window over the device time the trace gives
their spans. Nothing to read (no call, no device time): None."""


def share(run, kind: str):
    t = run.trace
    if not t:
        return None
    device = t["span_device_s"].get(f"wmbench.{kind}", 0.0)
    bound = run.kernels.bound_in(kind, t["host_t0"], t["host_t1"])
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device
