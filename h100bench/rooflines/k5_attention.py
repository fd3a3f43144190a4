"""Kernel 5 (``csrc/attention.cu``): multi-head attention on
``attn_impl="kernel"`` in bf16. Forward: q, k, v and the key bias read, o
written once (and in training the residual, each row's max and log-sum in
fp32); its two products on the tensor cores. Backward: q, k, v, the
output's gradient, the bias and the residual read, dq, dk, dv written; five
products. At the served and trained lengths (221-300 keys) bytes bound the
forward and operations the backward."""

HOOKS = ["objcavit_torch.models.layers:MultiHeadAttention"]
KIND = "kernel 5 (attention)"


def launches(module, args, output):
    import torch

    q_in, k_in = args[0], args[1]
    if module.attn_impl != "kernel" or q_in.dtype != torch.bfloat16:
        return []
    b, sq, e = q_in.shape
    sk = k_in.shape[1]
    h = module.num_heads
    row = 2 * b * e  # a position's H * D bf16 values
    train = module.training and torch.is_grad_enabled()
    fwd = {"bytes": row * (2 * sq + 2 * sk) + 4 * b * sk + (8 * b * h * sq if train else 0),
           "bf16": 4 * b * sq * sk * e}
    if not train:
        return [fwd]
    bwd = {"bytes": row * (3 * sq + 4 * sk) + 4 * b * sk + 8 * b * h * sq,
           "bf16": 10 * b * sq * sk * e}
    return [fwd, bwd]
