"""Adaptive-bins depth tail (AdaBins/GraphBins).

Port of ``objcavit_tpu/ops/bins.py``: ``bin_edges_centers``,
``bins_head_depth`` and ``bins_head_depth_factored``.

Inference (a module in eval mode, ``train=False``):

* ``bins_head_depth_factored`` keeps the range-attention maps factored: per
  image ``M_b = queries_b^T @ conv_out`` (fp32, then cast to the feature
  dtype, as the JAX package does), and the fused 1x1 conv + softmax +
  expectation contracts the decoder features with M_b, so neither the range
  maps nor the logits reach device memory. In bf16 that is CUDA kernel 2
  (``kernels/bins.py::conv_bins_depth_batched``).
* ``bins_head_depth`` takes the range maps themselves; in bf16 its fused
  head is kernel 3 (``kernels/bins.py::conv_bins_depth``), kernel 2 with one
  weight shared by the batch.

Training (``train=True``) takes the reference op order, which is
differentiable: range maps (``pixelwise_dot_product``), then the 1x1
``conv_out`` with its bias in the range maps' dtype, which writes the
logits, then the softmax-expectation. For bf16 logits that is kernel 4
(``kernels/bins_expectation.py::fused_bins_depth``) with its backward
kernel, as the JAX package runs ``fused_bins_depth`` there.

Each wrapper runs its plain version on CPU tensors. An fp32 model runs the
plain versions on any device: on the card that is the reference route,
which launches no kernel (the kernels take bf16 only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from objcavit_torch.kernels.bins import (
    conv_bins_depth,
    conv_bins_depth_batched,
    conv_bins_depth_batched_plain,
)
from objcavit_torch.kernels.bins_expectation import bins_expectation_plain, fused_bins_depth
from objcavit_torch.models.layers import pixelwise_dot_product


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


def bins_head_depth(
    bin_widths_normed: torch.Tensor,  # (B, K)
    range_maps: torch.Tensor,  # (B, H, W, C) NHWC, model dtype
    weight: torch.Tensor,  # (K, C, 1, 1) conv_out weight
    bias: torch.Tensor,  # (K,)
    min_depth: float,
    max_depth: float,
    train: bool,
):
    """conv_out 1x1 -> softmax over bins -> expectation over the centres.

    -> (depth (B, H, W, 1) fp32, bin_edges (B, K + 1) fp32).
    """
    edges, centers = bin_edges_centers(bin_widths_normed.float(), min_depth, max_depth)
    k, c = weight.shape[0], weight.shape[1]
    w_kc = weight.reshape(k, c).to(range_maps.dtype)
    if not train and range_maps.dtype == torch.bfloat16:
        return conv_bins_depth(range_maps, w_kc.t().contiguous(), bias.float(), centers), edges
    # the 1x1 conv over NHWC maps is a linear layer; its output is contiguous
    logits = F.linear(range_maps, w_kc, bias.to(range_maps.dtype))
    if logits.dtype == torch.bfloat16:
        return fused_bins_depth(logits, centers), edges
    b, h, w, _ = logits.shape
    depth = bins_expectation_plain(logits.reshape(b, h * w, k), centers)
    return depth.reshape(b, h, w, 1), edges


def bins_head_depth_factored(
    bin_widths_normed: torch.Tensor,  # (B, K)
    feat: torch.Tensor,  # (B, H, W, C) NHWC, model dtype
    queries: torch.Tensor,  # (B, K_q, C)
    weight: torch.Tensor,  # (K, K_q, 1, 1) conv_out weight
    bias: torch.Tensor,  # (K,)
    min_depth: float,
    max_depth: float,
    train: bool = False,
):
    """-> (depth (B, H, W, 1) fp32, bin_edges (B, K + 1) fp32)."""
    if train:
        range_maps = pixelwise_dot_product(feat, queries)
        return bins_head_depth(
            bin_widths_normed, range_maps, weight, bias, min_depth, max_depth, train=True
        )
    m, bias, centers, edges = bins_head_operands(
        bin_widths_normed, queries, weight, bias, min_depth, max_depth, feat.dtype
    )
    head = conv_bins_depth_batched if feat.dtype == torch.bfloat16 else conv_bins_depth_batched_plain
    return head(feat, m, bias, centers), edges
