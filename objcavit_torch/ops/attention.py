"""Multi-head attention core, as plain tensor code.

Port of ``objcavit_tpu/ops/attention.py::mha_core`` (its XLA path, the one
the flagship runs). Masking follows torch's ``key_padding_mask``: boolean,
True = ignored key. Scores accumulate in at least fp32, the softmax is fp32,
and the weights are cast to ``v``'s dtype before the product with V, which
is a bf16 rounding point of the JAX package kept here. This is also the plain
version a later port of ``pallas_mha`` is held against, so it does not use
``scaled_dot_product_attention``, whose masking and rounding differ.
"""

from __future__ import annotations

import math

import torch


def mha_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D), mask (B, Sk) -> (B, Sq, H, D)."""
    acc_t = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc_t), k.to(acc_t)) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
