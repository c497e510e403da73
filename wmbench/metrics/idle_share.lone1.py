"""The device's idle share of the traced sub-window, %: 1 - busy / window
by the profiler's trace."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
