"""The engine's time a tick: the window's seconds over the ticks credited
to it (spans around the engine's `step`)."""


def read(run):
    ticks = run.counters["ticks"]
    return 1e3 * run.counters["window_s"] / ticks if ticks else None
