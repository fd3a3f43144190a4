"""Multi-head attention core: the plain route, and the kernel route.

Port of ``objcavit_tpu/ops/attention.py::mha_core``. Its two values of
``impl`` are named after the port's routes: ``"plain"`` is JAX's ``"xla"``
(the default, as in JAX), ``"kernel"`` is JAX's ``"pallas"`` (kernel 5,
``kernels/attention.py``). Masking follows torch's ``key_padding_mask``:
boolean, True = ignored key. Scores accumulate in at least fp32 and the
softmax is fp32 on both routes.

The routes differ in bf16, as JAX's do: the plain route casts the weights
to ``v``'s dtype before the product with V and masks with -inf, so a row
whose keys are all masked gives NaN; the kernel route multiplies fp32
weights and masks with -1e30, so such a row is uniform over its keys. So
the plain route here is not the plain version kernel 5 is held against:
that is ``kernels.attention.mha_fused_plain``.
"""

from __future__ import annotations

import math

import torch

from objcavit_torch.kernels.attention import fused_mha, mask_bias, mha_fused_plain

IMPLS = ("plain", "kernel")


def mha_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
    impl: str = "plain",
) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D), mask (B, Sk) -> (B, Sq, H, D).

    ``impl="kernel"`` launches kernel 5 for bf16 on the card; an fp32 (or
    fp64) model on the card takes its plain version under autograd, the
    reference route, and the CPU runs the plain versions.
    """
    if impl == "kernel":
        if q.device.type == "cuda" and q.dtype != torch.bfloat16:
            return mha_fused_plain(q, k, v, mask_bias(key_padding_mask))
        return fused_mha(q, k, v, key_padding_mask)
    if impl != "plain":
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    acc_t = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc_t), k.to(acc_t)) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
