"""The device's idle share of the traced window, %."""

from h100bench import readers


def read(r):
    return readers.idle_pct(r)
