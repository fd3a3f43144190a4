"""Depth losses, fixed-shape (mask-based) versions of the reference.

Port of ``objcavit_tpu/losses/losses.py``:

* SILog, paper form ``Dg = mean(g^2) - (lam / T^2) sum(g)^2``, alpha 10,
  lam 0.85, after upsampling the prediction to the GT size with
  align_corners=True through the plain, differentiable
  ``ops/resize.py::resize_bilinear`` (never the forward-only kernel 1);
* bins chamfer between each image's bin centres and its valid GT depths
  (``ops/chamfer.py``);
* MSE, unmasked;
* ``LossWrapper``, the weighted sum keyed by names and coefficients.

Layout NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch

from objcavit_torch.ops.chamfer import masked_chamfer_1d
from objcavit_torch.ops.resize import resize_bilinear

_POSSIBLE_LOSSES = ("mse", "silog", "bins_chamfer")


def silog_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
               depth_mask: torch.Tensor | None = None, interpolate: bool = True,
               alpha: float = 10.0, lam: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss (AdaBins paper section 3.4 form)."""
    if interpolate:
        depth_pred = resize_bilinear(depth_pred, depth_gt.shape[1], depth_gt.shape[2],
                                     align_corners=True)
    g = torch.log(depth_pred) - torch.log(depth_gt)
    if depth_mask is None:
        n = float(g.numel())
    else:
        n = depth_mask.sum().to(g.dtype)
        g = torch.where(depth_mask, g, 0.0)
    sum_g = g.sum()
    dg = (g * g).sum() / n - (lam / (n * n)) * (sum_g * sum_g)
    return alpha * torch.sqrt(dg)


def bins_chamfer_loss(depth_gt: torch.Tensor, depth_mask: torch.Tensor,
                      bin_edges: torch.Tensor) -> torch.Tensor:
    """Chamfer distance between per-image bin centres and valid GT depths."""
    centers = 0.5 * (bin_edges[:, 1:] + bin_edges[:, :-1])  # (N, K)
    n = depth_gt.shape[0]
    return masked_chamfer_1d(centers, depth_gt.reshape(n, -1), depth_mask.reshape(n, -1))


def mse_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((depth_pred - depth_gt) ** 2)


class LossWrapper:
    """Weighted sum of loss components (the reference's LossWrapper)."""

    def __init__(self, names: Sequence[str], coeffs: Sequence[float]):
        if not names:
            raise ValueError("no loss names given")
        unknown = [n for n in names if n not in _POSSIBLE_LOSSES]
        if unknown:
            raise ValueError(f"unrecognised losses {unknown}; known: {_POSSIBLE_LOSSES}")
        if len(coeffs) != len(names):
            raise ValueError(f"{len(names)} loss names but {len(coeffs)} coefficients")
        self.names = tuple(names)
        self.coeffs = tuple(float(c) for c in coeffs)

    @classmethod
    def from_args(cls, args) -> "LossWrapper":
        """From a config tree's ``loss.names`` and ``loss.coeffs``."""
        return cls(list(args.loss.names), list(args.loss.coeffs))

    def __call__(self, depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                 depth_mask: torch.Tensor, bin_edges: torch.Tensor | None = None) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=depth_gt.device)
        for name, coeff in zip(self.names, self.coeffs):
            if name == "silog":
                comp = silog_loss(depth_pred, depth_gt, depth_mask)
            elif name == "bins_chamfer":
                comp = bins_chamfer_loss(depth_gt, depth_mask, bin_edges)
            else:
                comp = mse_loss(depth_pred, depth_gt)
            total = total + coeff * comp
        return total
