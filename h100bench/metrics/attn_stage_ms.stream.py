"""The attention stage's (ObjCAViT or miniViT) device ms an image."""

from h100bench import readers


def read(r):
    return readers.stage_ms(r, "attention")
