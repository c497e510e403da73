"""The model step's share of the card's peaks, %: the frozen operation
count of the window's work (the active rows' UNet steps, each clip's
encode and decode), each kind over its peak, over the window's seconds."""

from wmbench import opcount


def read(run):
    return opcount.utilisation(run.work, run.counters["window_s"])
