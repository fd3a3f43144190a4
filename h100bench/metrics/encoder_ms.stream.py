"""The encoder's device ms an image, from CUDA events at its edges."""

from h100bench import readers


def read(r):
    return readers.stage_ms(r, "encoder")
