"""Kernel 7 (``csrc/se_project.cu``): on ``encoder_impl="kernel"``, a
block's SE gate times the depthwise output, the 1x1 project conv, its bias
and the skip in one pass: the (N, M) input, the (B, M) gate, the (M, O)
weight and the bias read once, the skip read and the (N, O) output written
once; 2 N M O products on the tensor cores. Bytes bound it at B5's shapes."""

HOOKS = ["objcavit_torch.models.common:MBConv", "objcavit_torch.models.common:DepthwiseSeparable"]
KIND = "kernel 7 (SE-gate project)"


def launches(module, args, output):
    import torch

    x = args[0]
    if x.dtype != torch.bfloat16 or module.route() != "se_project":
        return []
    project = module.conv_pwl if hasattr(module, "conv_pwl") else module.conv_pw
    o, m = project.weight.shape[:2]
    b, _, ho, wo = output.shape
    n = b * ho * wo
    skip = int(module.has_residual)
    nbytes = 2 * n * m + 2 * b * m + 2 * m * o + 4 * o + 2 * n * o * (1 + skip)
    return [{"bytes": nbytes, "bf16": 2 * n * m * o}]
