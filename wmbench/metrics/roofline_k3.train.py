"""K3's share of its roofline, %: the bound time of the attention
backward calls' shapes in the traced step over the device time inside
them (spans `wmbench.k3`)."""

from wmbench.metrics import _kernel_share


def read(run):
    return _kernel_share.share(run, "k3")
