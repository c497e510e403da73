"""The engine's useful share of its pool, %: the candidate-slots stepping
over the pool's slots, summed over the window's ticks (counted at the
engine's `admit` and `step`)."""


def read(run):
    c = run.counters
    if not c["ticks"]:
        return None
    return 100.0 * c["candidate_steps"] / (c["ticks"] * c["slots"])
