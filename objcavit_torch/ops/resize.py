"""Bilinear resize with PyTorch's ``interpolate`` semantics, NHWC.

Port of ``objcavit_tpu/ops/resize.py``. The taps are computed on the host in
float64 exactly as the JAX package computes them (``_interp_taps``); the
resize itself gathers the two taps of each axis and lerps in fp32, H first
and then W, and rounds to the input dtype once at the end. That is the
arithmetic of the CUDA kernel in ``objcavit_torch/kernels/resize.py``, for
which this is the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def interp_taps(in_size: int, out_size: int, align_corners: bool):
    """(lo int32, hi int32, frac float32) numpy taps of a 1-D bilinear resize."""
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    for a in (lo, hi, frac):
        a.setflags(write=False)  # cached: shared by every caller
    return lo, hi, frac


@functools.lru_cache(maxsize=128)
def device_taps(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """``interp_taps`` as (int32, int32, float32) tensors on ``device``."""
    return tuple(
        torch.from_numpy(a.copy()).to(device)
        for a in interp_taps(in_size, out_size, align_corners)
    )


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """Bilinear-resize NHWC ``x`` to (out_h, out_w).

    ``align_corners=True`` matches ``F.interpolate(..., mode='bilinear',
    align_corners=True)``; ``False`` matches its default half-pixel mode.
    Returns ``x`` itself when the size is unchanged.
    """
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    y = x.float()
    if h != out_h:
        lo, hi, frac = device_taps(h, out_h, align_corners, x.device)
        f = frac.view(1, -1, 1, 1)
        y = y.index_select(1, lo) * (1.0 - f) + y.index_select(1, hi) * f
    if w != out_w:
        lo, hi, frac = device_taps(w, out_w, align_corners, x.device)
        f = frac.view(1, 1, -1, 1)
        y = y.index_select(2, lo) * (1.0 - f) + y.index_select(2, hi) * f
    return y.to(x.dtype)
