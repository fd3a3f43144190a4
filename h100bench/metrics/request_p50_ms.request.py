"""The median request latency of the window, ms."""

from h100bench import readers


def read(r):
    return readers.latency_p50_ms(r)
