"""Kernel 4 (``csrc/bins_expectation.cu``): the training bins head's
softmax expectation over bf16 logits, forward and backward. Forward: the
logits and centres read once, the fp32 depth written; ~5 fp32 operations a
logit. Backward: the logits and the depth's gradient read, the logits' and
centres' gradients written; ~8 a logit. Bytes bound both. Hooked on the
attention stage: the logits are (B, H, W, 256) at its features' size."""

HOOKS = ["objcavit_torch.models.objcavit:ObjCAViT", "objcavit_torch.models.minivit:MiniViT"]
KIND = "kernel 4 (bins expectation)"


def launches(module, args, output):
    import torch

    feat = output[1]
    if not module.training or feat.dtype != torch.bfloat16:
        return []
    b, h, w, _ = feat.shape
    s, k = h * w, 256
    fwd = {"bytes": 2 * b * s * k + 4 * b * k + 4 * b * s, "fp32": 5 * b * s * k}
    bwd = {"bytes": 4 * b * s * k + 8 * b * k + 4 * b * s, "fp32": 8 * b * s * k}
    return [fwd, bwd] if torch.is_grad_enabled() else [fwd]
