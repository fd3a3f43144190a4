"""Kernel 2 (``csrc/bins_depth.cu``): the bins head at inference in bf16,
the 1x1 conv against each image's (C, 256) product, softmax over the bins
and expectation over their centres in one pass: the features, the weights,
the bias and the centres read once, the fp32 depth written once; the
(B, S, C) x (C, 256) products on the tensor cores. Bytes bound it at the
served shapes. Hooked on the attention stage, whose output the head reads."""

HOOKS = ["objcavit_torch.models.objcavit:ObjCAViT", "objcavit_torch.models.minivit:MiniViT"]
KIND = "kernel 2 (bins)"


def launches(module, args, output):
    import torch

    feat = output[1]
    if module.training or feat.dtype != torch.bfloat16:
        return []
    b, h, w, c = feat.shape
    s, k = h * w, 256
    nbytes = 2 * b * s * c + 2 * b * c * k + 4 * k + 4 * b * k + 4 * b * s
    return [{"bytes": nbytes, "bf16": 2 * b * s * c * k}]
