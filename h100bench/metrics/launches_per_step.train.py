"""Device operations a train step in the traced window."""

from h100bench import readers


def read(r):
    return readers.launches_per_step(r)
