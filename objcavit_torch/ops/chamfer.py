"""Chamfer distance between bin centres and valid GT depth values.

Port of ``objcavit_tpu/ops/chamfer.py::masked_chamfer_1d`` (pytorch3d
``chamfer_distance`` defaults: squared L2, point and batch means, with the
targets as a dense (N, T) array and a validity mask):

    cham_x[i] = mean_p  min_{valid t} (x[i,p] - y[i,t])^2
    cham_y[i] = mean_{valid t}  min_p (y[i,t] - x[i,p])^2
    loss      = sum_i cham_x[i] / n_rows + sum_i cham_y[i] / n_rows

with n_rows the rows that have a valid target; a row without one adds
nothing. In a process group the two sums and n_rows span the global batch
(``parallel/collectives.py::global_sum``). The JAX package reduces over
the implicit (N, P, T) distance tensor, which XLA never materialises. At
the train shape that tensor is (8, 256, 226,304): 1.85 GB in fp32 a
direction in eager PyTorch. Both directions are
1-D nearest-neighbour searches instead: each point's nearest neighbour in a
sorted set is one of the two elements around its ``searchsorted`` position,
and the loss takes the smaller of their two squared distances, the same fp32
values the JAX package's min compares.

Gradients: ``torch.minimum`` halves the gradient between two candidates at
equal distance, as JAX's ``min`` splits it equally among ties. So a centre
midway between two targets, or a target repeated in the GT, gets the same
gradient on both sides. They differ only where a run of more than two equal
points ties (equal bin centres need equal bin widths): JAX splits among all
of them, the port between two.
"""

from __future__ import annotations

import torch

from objcavit_torch.parallel.collectives import global_sum

_BIG = 1e10  # sentinel for invalid targets; finite, so (a - b)^2 stays finite


def _nearest_sq_dist(points: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Per row, the squared distance from each query (N, Q) to its nearest
    element of ``points`` (N, M), sorted ascending along the row."""
    m = points.shape[1]
    hi = torch.searchsorted(points, queries).clamp_(max=m - 1)
    lo = (hi - 1).clamp_(min=0)
    d_lo = torch.square(queries - points.gather(1, lo))
    d_hi = torch.square(queries - points.gather(1, hi))
    return torch.minimum(d_lo, d_hi)


def masked_chamfer_1d(x: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Scalar chamfer loss: x (N, P) predicted points (bin centres), y (N, T)
    targets (flattened GT depth), y_mask (N, T) True = valid target."""
    y_mask = y_mask.bool()
    lengths = y_mask.sum(1)
    row_valid = lengths > 0

    # invalid targets sort to the end as _BIG and are never nearest to a
    # centre, unless a row has no valid target at all (masked below)
    targets = torch.sort(torch.where(y_mask, y, _BIG).detach(), dim=1).values
    d_x = _nearest_sq_dist(targets, x.contiguous())  # (N, P)
    cham_x = torch.where(row_valid, d_x.mean(1), 0.0)

    centers = torch.sort(x, dim=1).values  # sorted already: a cumsum of widths
    d_y = _nearest_sq_dist(centers, y.contiguous())  # (N, T)
    d_y = torch.where(y_mask, d_y, 0.0)
    cham_y = d_y.sum(1) / lengths.clamp(min=1)

    total_x, total_y, rows = global_sum(torch.stack(
        [cham_x.sum(), cham_y.sum(), row_valid.sum().to(cham_x.dtype)])).unbind()
    n_rows = rows.clamp(min=1)
    return total_x / n_rows + total_y / n_rows
