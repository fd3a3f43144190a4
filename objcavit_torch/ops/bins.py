"""Adaptive-bins depth tail (AdaBins/GraphBins), inference form.

Port of ``objcavit_tpu/ops/bins.py``: ``bin_edges_centers`` and the
inference path of ``bins_head_depth_factored``. The range-attention maps
stay factored: per image ``M_b = queries_b^T @ conv_out`` (fp32, then cast to
the feature dtype, as the JAX package does), and the fused 1x1 conv +
softmax + expectation contracts the decoder features with M_b so neither
the range maps nor the logits reach device memory. In bf16 that is CUDA
kernel 2 (``kernels/bins.py``), whose wrapper runs the plain version on CPU
tensors. An fp32 model runs the plain version on any device: on the card
that is the reference route, which launches no kernel (the kernel takes
bf16 only).
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels.bins import (
    conv_bins_depth_batched,
    conv_bins_depth_batched_plain,
)


def bin_edges_centers(bin_widths_normed: torch.Tensor, min_depth: float, max_depth: float):
    """(N, K) normalised widths -> (edges (N, K + 1), centers (N, K))."""
    n = bin_widths_normed.shape[0]
    widths = (max_depth - min_depth) * bin_widths_normed
    first = torch.full((n, 1), min_depth, dtype=widths.dtype, device=widths.device)
    edges = torch.cumsum(torch.cat([first, widths], dim=1), dim=1)
    centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
    return edges, centers


def bins_head_operands(
    bin_widths_normed: torch.Tensor,  # (B, K)
    queries: torch.Tensor,  # (B, K_q, C)
    weight: torch.Tensor,  # (K, K_q, 1, 1) conv_out weight
    bias: torch.Tensor,  # (K,)
    min_depth: float,
    max_depth: float,
    dtype: torch.dtype,
):
    """-> (M (B, C, K) in ``dtype``, bias (K,) fp32, centers (B, K) fp32,
    bin_edges (B, K + 1) fp32): the fused head's arguments after ``feat``."""
    edges, centers = bin_edges_centers(bin_widths_normed.float(), min_depth, max_depth)
    k, kq = weight.shape[0], weight.shape[1]
    m = torch.matmul(queries.float().transpose(1, 2), weight.float().reshape(k, kq).t())
    return m.to(dtype), bias.float(), centers, edges


def bins_head_depth_factored(
    bin_widths_normed: torch.Tensor,  # (B, K)
    feat: torch.Tensor,  # (B, H, W, C) NHWC, model dtype
    queries: torch.Tensor,  # (B, K_q, C)
    weight: torch.Tensor,  # (K, K_q, 1, 1) conv_out weight
    bias: torch.Tensor,  # (K,)
    min_depth: float,
    max_depth: float,
):
    """-> (depth (B, H, W, 1) fp32, bin_edges (B, K + 1) fp32)."""
    m, bias, centers, edges = bins_head_operands(
        bin_widths_normed, queries, weight, bias, min_depth, max_depth, feat.dtype
    )
    head = conv_bins_depth_batched if feat.dtype == torch.bfloat16 else conv_bins_depth_batched_plain
    return head(feat, m, bias, centers), edges
