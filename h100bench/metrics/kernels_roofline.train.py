"""The program's kernels' least time over their device time in the traced window, %."""

from h100bench import readers


def read(r):
    return readers.roofline_pct(r)
