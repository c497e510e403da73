"""The training step's share of the bf16 peak, %: the frozen operation
count of a clip (3 x the UNet forward, the frozen VAE encode and CLIP)
times the window's clips, over its seconds, the profiled step (slowed by
the profiler) left out of both."""

from wmbench import opcount


def read(run):
    c = run.counters
    return opcount.utilisation({"bf16": c["ops_per_clip"] * c["untraced_clips"]},
                               c["untraced_s"])
