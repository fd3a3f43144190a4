"""Kernel 1 (``csrc/resize_bilinear.cu``): the decoder's bilinear upsample
(align_corners) in bf16 at inference, in its concat form where the skip
has a multiple of 8 channels: x read, the skip read and the concatenated
conv input written once; else its bare form (x read, the upsample written).
Six fp32 operations an output value (two lerps). Bytes bound it."""

HOOKS = ["objcavit_torch.models.decoder:UpSampleWithSkip"]
KIND = "kernel 1 (resize)"


def launches(module, args, output):
    import torch

    x, skip = args[0], args[1]
    if module.training or x.dtype != torch.bfloat16:
        return []
    b, c, hi, wi = x.shape
    cs, ho, wo = skip.shape[1:]
    ops = 6 * b * c * ho * wo
    if cs % 8 == 0:
        return [{"bytes": 2 * b * (c * hi * wi + cs * ho * wo + (c + cs) * ho * wo), "fp32": ops}]
    return [{"bytes": 2 * b * c * (hi * wi + ho * wo), "fp32": ops}]
