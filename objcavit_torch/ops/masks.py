"""Instance-mask assembly from YOLO prototypes (yolov7-seg process_mask).

Port of ``objcavit_tpu/ops/masks.py``: masks = sigmoid(proto @ coeffs^T) in
fp32, cropped to each detection's box in prototype coordinates, zeroed for
invalid slots, then bilinearly upsampled (half-pixel) to the image size.
Fixed shapes: always N masks.
"""

from __future__ import annotations

import torch

from objcavit_torch.ops.resize import resize_bilinear


def process_masks(proto: torch.Tensor, coeffs: torch.Tensor, boxes_xyxy: torch.Tensor,
                  valid: torch.Tensor, image_hw: tuple[int, int],
                  upsample: bool = True) -> torch.Tensor:
    """proto (hp, wp, nm), coeffs (N, nm), boxes (N, 4) xyxy in image
    pixels, valid (N,) -> (N, H, W) fp32 masks in [0, 1] ((N, hp, wp)
    without ``upsample``)."""
    hp, wp, _ = proto.shape
    h, w = image_hw
    m = torch.sigmoid(torch.einsum("hwc,nc->nhw", proto.float(), coeffs.float()))
    sx, sy = wp / w, hp / h
    boxes = boxes_xyxy.float()
    x1, y1, x2, y2 = (boxes[:, i, None, None] * s for i, s in enumerate((sx, sy, sx, sy)))
    cols = torch.arange(wp, dtype=torch.float32, device=m.device)[None, None, :]
    rows = torch.arange(hp, dtype=torch.float32, device=m.device)[None, :, None]
    inside = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
    m = m * inside * valid[:, None, None]
    if upsample:
        m = resize_bilinear(m[..., None], h, w, align_corners=False)[..., 0]
    return m
