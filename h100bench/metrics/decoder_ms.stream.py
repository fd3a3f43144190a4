"""The decoder's and the bins head's device ms an image."""

from h100bench import readers


def read(r):
    return readers.stage_ms(r, "decoder")
