"""K7's share of its roofline, %: the bound time of the int8 products'
shapes called in the traced sub-window over the device time of whatever
ran inside those calls (spans `wmbench.k7`)."""

from wmbench.metrics import _kernel_share


def read(run):
    return _kernel_share.share(run, "k7")
