"""Position-sensitive ROI-align with a 1x1 output, torchvision's rules.

Port of ``objcavit_tpu/ops/roi_align.py``. The reference's
``grid_random_roi_align`` positional strategy calls
``torchvision.ops.ps_roi_align(..., output_size=[1, 1])`` on a learned
embedding grid (modules/ObjCAViT.py:128,144). With one output bin it is
plain ROI-align: the mean of bilinear samples on a ceil(roi_h) x
ceil(roi_w) lattice inside the box.

torchvision's rules, kept as the JAX package keeps them:

* box corners are scaled by ``spatial_scale``, then shifted by -0.5;
* ``roi_w`` and ``roi_h`` are clamped below at 0.1;
* the sample count is ceil of the box size, clamped to ``max_samples`` for
  the sample positions, and the sum is divided by the UNCLAMPED count
  ``n_h * n_w``, rounded to the grid's dtype as the JAX package rounds it
  (in bf16 a count of 851 reads 852);
* a tap outside (-1, size) reads 0, coordinates are clamped at 0, and a tap
  at or past the last row or column collapses onto it.

The JAX package gathers every tap of a (P, max_samples, max_samples) lattice.
Here the lattice is never built: the mask is ``ym x xm`` and a tap's
bilinear weight is a y weight times an x weight, so the masked sum over the
lattice is ``Ay G Ax^T`` per box, with ``Ay[p, i]`` the summed weight of grid
row i over box p's y samples (P x H) and ``Ax`` likewise (P x W). That is
the same function up to summation order, at a fraction of the memory, and
autograd gives the grid's gradient.
"""

from __future__ import annotations

import torch


def _axis_weights(start, size, n_clamped, size_grid: int, max_samples: int) -> torch.Tensor:
    """(..., size_grid) summed bilinear weights of each grid line over the
    n_clamped samples start + (i + 0.5) size / n_clamped along one axis,
    with torchvision's out-of-range, clamp and edge rules."""
    idx = torch.arange(max_samples, dtype=start.dtype, device=start.device)
    pos = start[..., None] + (idx + 0.5) * size[..., None] / n_clamped[..., None].to(start.dtype)
    keep = (idx < n_clamped[..., None]) & (pos >= -1.0) & (pos <= size_grid)
    pos = pos.clamp(min=0.0)
    low = pos.floor().to(torch.int64)
    edge = low >= size_grid - 1
    low = torch.where(edge, torch.full_like(low, size_grid - 1), low)
    high = (low + 1).clamp(max=size_grid - 1)
    frac = torch.where(edge, torch.zeros_like(pos), pos - low.to(pos.dtype))
    keep = keep.to(pos.dtype)
    lines = torch.arange(size_grid, device=start.device)
    onehot_low = (low[..., None] == lines).to(pos.dtype)
    onehot_high = (high[..., None] == lines).to(pos.dtype)
    per_sample = (1.0 - frac)[..., None] * onehot_low + frac[..., None] * onehot_high
    return (keep[..., None] * per_sample).sum(dim=-2)


def ps_roi_align_1x1(grid: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                     max_samples: int = 40) -> torch.Tensor:
    """ps_roi_align with output size (1, 1) over one shared grid.

    grid (H, W, C); boxes (..., P, 4) as (x1, y1, x2, y2) in input pixels;
    ``spatial_scale`` takes them to grid cells. Returns (..., P, C) in at
    least fp32.
    """
    h, w, c = grid.shape
    boxes = boxes.to(torch.promote_types(boxes.dtype, torch.float32))
    x1 = boxes[..., 0] * spatial_scale - 0.5
    y1 = boxes[..., 1] * spatial_scale - 0.5
    x2 = boxes[..., 2] * spatial_scale - 0.5
    y2 = boxes[..., 3] * spatial_scale - 0.5
    roi_w = (x2 - x1).clamp(min=0.1)
    roi_h = (y2 - y1).clamp(min=0.1)
    n_w = roi_w.ceil().to(torch.int64)
    n_h = roi_h.ceil().to(torch.int64)
    ay = _axis_weights(y1, roi_h, n_h.clamp(1, max_samples), h, max_samples)  # (..., P, H)
    ax = _axis_weights(x1, roi_w, n_w.clamp(1, max_samples), w, max_samples)  # (..., P, W)
    pair = (ay[..., :, None] * ax[..., None, :]).flatten(-2)  # (..., P, H W)
    total = pair @ grid.reshape(h * w, c).to(boxes.dtype)
    count = (n_h * n_w).to(grid.dtype).to(boxes.dtype)
    return total / count[..., None]
