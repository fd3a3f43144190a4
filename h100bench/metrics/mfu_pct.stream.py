"""The reference model's FLOPs of the window's images over the window's seconds, as a share of the bf16 peak, %."""

from h100bench import readers


def read(r):
    return readers.mfu_pct(r)
