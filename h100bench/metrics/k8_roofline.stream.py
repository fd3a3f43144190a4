"""Kernel 8's launches' least time over its device time in the traced window, %."""

from h100bench import readers


def read(r):
    return readers.roofline_pct(r, ["kernel 8 (MBConv head)"])
