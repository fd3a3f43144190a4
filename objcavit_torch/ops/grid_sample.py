"""Bilinear point sampling with ``torch.nn.functional.grid_sample`` semantics.

Port of ``objcavit_tpu/ops/grid_sample.py``. The reference's ``grid_random``
positional strategy samples a learned embedding grid at object or patch
centres with ``F.grid_sample``'s defaults: bilinear, ``padding_mode='zeros'``,
``align_corners=False`` (modules/ObjCAViT.py:99,109), so a tap out of range
reads 0. The JAX package takes a flat list of points per grid instead of
torch's (N, H_out, W_out, 2) grid; this module keeps that interface and
calls ``F.grid_sample`` on it.

The grid is read in fp32: a bf16 grid (a bf16 model's table) times fp32
weights gives fp32, as the JAX package's ``vals * weight`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample ``grid`` (H, W, C) at ``points`` (..., P, 2) of normalised
    (x, y): unnormalised x = ((x + 1) W - 1) / 2; taps out of range read 0.
    Returns (..., P, C) in at least fp32."""
    h, w, c = grid.shape
    lead = points.shape[:-2]
    pts = points.reshape(-1, 1, points.shape[-2], 2)  # (N, 1, P, 2)
    dtype = torch.promote_types(points.dtype, torch.float32)
    g = grid.to(dtype).permute(2, 0, 1).unsqueeze(0).expand(pts.shape[0], c, h, w)
    out = F.grid_sample(g, pts.to(dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=False)  # (N, C, 1, P)
    return out[:, :, 0].transpose(1, 2).reshape(*lead, points.shape[-2], c)
