"""Kernel 8 (``csrc/mbconv_head.cu``, with its pool-reduce launch): on
``encoder_impl="kernel"``, a stride-1 MBConv's 1x1 expand, SiLU, k x k
depthwise conv, SiLU and the SE block's spatial pool in one pass: x read
and the expanded y written once (bf16), the weights and biases read once,
the fp32 pool written once; the expand's 2 N Cin M products on the tensor
cores and the depthwise's 2 k^2 N M on the CUDA cores, the larger of the
two times. Bytes bound it at B5's shapes."""

HOOKS = ["objcavit_torch.models.common:MBConv"]
KIND = "kernel 8 (MBConv head)"


def launches(module, args, output):
    import torch

    x = args[0]
    if x.dtype != torch.bfloat16 or module.route() != "mbconv_head":
        return []
    b, cin, h, w = x.shape
    m = module.conv_pw.weight.shape[0]
    k = module.conv_dw.weight.shape[-1]
    n = b * h * w
    nbytes = 2 * n * (cin + m) + 2 * k * k * m + 4 * m + 4 * b * m + 2 * cin * m + 4 * m
    return [{"bytes": nbytes, "bf16": 2 * n * cin * m, "fp32": 2 * k * k * n * m}]
