"""K1's share of its roofline, %: the bound time of the attention forward
calls' shapes in the traced step over the device time inside them (spans
`wmbench.k1`)."""

from wmbench.metrics import _kernel_share


def read(run):
    return _kernel_share.share(run, "k1")
