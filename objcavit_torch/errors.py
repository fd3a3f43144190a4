"""Error types of the port (``objcavit_tpu/errors.py``)."""


class MissingAssetError(FileNotFoundError):
    """A required external asset (a checkpoint, the BPE merges file) is absent.

    Raised instead of falling back to random weights: a GraphBins run whose
    detector or CLIP tower starts from random weights works on noise with no
    visible failure (the reference fails too: Yolov7Wrapper.py:37,
    CLIPWrapper.py:18). ``--debug`` or the config key
    ``allow_random_detector: true`` asks for the random towers explicitly.
    """
