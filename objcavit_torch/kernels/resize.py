"""Kernel 1: the decoder's align_corners=True bilinear upsample (NHWC bf16).

CUDA source: ``objcavit_torch/csrc/resize_bilinear.cu``, which replaces
``objcavit_tpu/ops/resize_pallas.py::resize_bilinear_pallas``. It is bound by
bytes on the H100; the source note says how its design answers that.

``resize_bilinear_align_corners`` launches the kernel for a CUDA tensor and
raises on anything the kernel does not take; for a CPU tensor it runs
``resize_bilinear_align_corners_plain``, the plain PyTorch version. The
decoder calls it for bf16 only: an fp32 model on the card takes the plain
version there, the reference route, and launches no kernel.
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels.build import check_launch, load_library
from objcavit_torch.ops.resize import device_taps, resize_bilinear

_ENTRY = "objcavit_resize_bilinear_ac_nhwc_bf16"


def resize_bilinear_align_corners_plain(
    x: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same taps, fp32 lerp, one rounding."""
    return resize_bilinear(x, out_h, out_w, align_corners=True)


def check_resize_inputs(x: torch.Tensor, out_h: int, out_w: int) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"resize kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"resize kernel takes NHWC (B, H, W, C), got shape {tuple(x.shape)}")
    if x.shape[3] % 8:
        raise ValueError(f"resize kernel needs C % 8 == 0, got C={x.shape[3]}")
    if min(x.shape[1], x.shape[2]) < 1 or min(out_h, out_w) < 1:
        raise ValueError("resize kernel needs non-empty input and output sizes")
    if not x.is_contiguous():
        raise ValueError("resize kernel needs a contiguous NHWC tensor")
    if x.data_ptr() % 16:
        raise ValueError("resize kernel needs a 16-byte aligned tensor")


def resize_bilinear_align_corners(
    x: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """(B, Hi, Wi, C) -> (B, out_h, out_w, C), align_corners=True bilinear."""
    if x.device.type == "cpu":
        return resize_bilinear_align_corners_plain(x, out_h, out_w)
    if x.device.type != "cuda":
        raise ValueError(f"resize kernel runs on CUDA tensors, got {x.device}")
    check_resize_inputs(x, out_h, out_w)
    b, hi, wi, c = x.shape
    h_lo, h_hi, h_frac = device_taps(hi, out_h, True, x.device)
    w_lo, w_hi, w_frac = device_taps(wi, out_w, True, x.device)
    y = torch.empty((b, out_h, out_w, c), dtype=x.dtype, device=x.device)
    rc = getattr(load_library(), _ENTRY)(
        x.data_ptr(), y.data_ptr(),
        h_lo.data_ptr(), h_hi.data_ptr(), h_frac.data_ptr(),
        w_lo.data_ptr(), w_hi.data_ptr(), w_frac.data_ptr(),
        b, hi, wi, c, out_h, out_w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    resize_bilinear_align_corners.launches += 1
    return y


resize_bilinear_align_corners.launches = 0
