"""Kernel 1: the decoder's align_corners=True bilinear upsample (NHWC bf16),
alone or written straight into the decoder's concat buffer.

CUDA source: ``objcavit_torch/csrc/resize_bilinear.cu``, which replaces
``objcavit_tpu/ops/resize_pallas.py::resize_bilinear_pallas``. It is bound by
bytes on the H100; the source note says how its design answers that.

``resize_bilinear_align_corners(x, out_h, out_w)`` is the bare upsample;
``resize_bilinear_align_corners_into_concat(x, skip)`` returns the (B, Ho,
Wo, C + Cs) buffer the decoder's next conv reads: the upsample of x to the
skip's size in channels [0, C) and the skip, bit for bit, in [C, C + Cs).
One kernel computes both (the concat form copies the skip in the same
launch), and one counter, ``resize_bilinear_align_corners.launches``, counts
a launch of either; ``.concat_launches`` counts those of the concat form.
Each launches the kernel for a CUDA tensor and raises on anything the
kernel does not take; for a CPU tensor it runs its plain PyTorch version. The kernel has no backward, so the wrappers also raise, on
any device, when autograd would need its gradient. The decoder calls the
concat form for bf16 outside training only: an fp32 model on the card takes
the plain version there, the reference route, and launches no kernel.

``resize_bilinear_align_corners_rows(x, out_h, out_w, y0, y1, skip=None)``
is the row-window form (spatial serving, ``parallel/spatial.py``): output
rows [y0, y1) of the (out_h, out_w) upsample of the whole x, with a band of
the skip beside them where one is given (the concat form's layout) or
alone. The same kernel from the window's H taps on; its own counter,
``resize_bilinear_align_corners_rows.launches`` (``.concat_launches`` for
those with a skip), which the two whole-image forms' counter does not
include. Its plain version is ``resize_rows_plain``.

``resize_plan`` picks the kernel's channel slice, column strips and row
bands for a shape; the C entry points take it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.build import check_launch, load_library
from objcavit_torch.ops.resize import device_taps, interp_taps, resize_bilinear

_ENTRY = "objcavit_resize_bilinear_ac_nhwc_bf16"
_ENTRY_CONCAT = "objcavit_resize_bilinear_ac_concat_bf16"
_ENTRY_WINDOW = "objcavit_resize_bilinear_ac_window_bf16"

SLOTS = 4  # input rows a block holds in shared memory (csrc kSlots)
SMEM_BUDGET = 55 * 1024  # a block's shared memory: four blocks an SM
BAND_ROWS = 4  # output rows of a block
MAX_SLICE = 256  # channels of x a block takes at most


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    slice_c: int  # channels of x a block takes: 256 where C allows
    strip_w: int  # output columns of a block
    strips: int
    cols: int  # the most input columns a strip reads
    band_rows: int
    smem: int  # a block's shared memory, bytes


def smem_bytes(slice_c: int, cols: int, strip_w: int, c: int, cs: int = 0) -> int:
    """csrc's smem_bytes: SLOTS bf16 rows and one fp32 row of cols x
    slice_c; three bf16 skip rows of cs channels of a slice's share of the
    strip's pixels, ceil(strip_w / (c / slice_c)); and 12 bytes of W taps a
    strip column."""
    skip_px = -(-strip_w // (c // slice_c))
    return cols * slice_c * (2 * SLOTS + 4) + 6 * skip_px * cs + 12 * strip_w


@functools.lru_cache(maxsize=128)
def resize_plan(hi: int, wi: int, c: int, ho: int, wo: int, cs: int = 0) -> ResizePlan:
    """The kernel's tiling for (B, hi, wi, c) -> (ho, wo), with a skip of cs
    channels in the concat form: bands of BAND_ROWS output rows; the widest
    channel slice dividing C up to MAX_SLICE; then the fewest even column
    strips whose input span (read off the host taps) and skip rows keep a
    block within SMEM_BUDGET. Wide
    slices write long runs of each pixel's record: where
    C + Cs channels are not a whole number of 32-byte sectors (the B5
    decoder's up3 and up4), 64-channel slices left each sector at a slice
    boundary to two blocks, and the concat form ran 1.5x slower on an H100."""
    slice_c = next(s for s in (MAX_SLICE, 128, 64, 32, 16, 8) if c % s == 0)
    lo, hi_tap, _ = interp_taps(wi, wo, True)
    for strips in range(1, wo + 1):
        strip_w = -(-wo // strips)
        starts = np.arange(0, wo, strip_w)
        ends = np.minimum(starts + strip_w, wo) - 1
        cols = int((hi_tap[ends] - lo[starts]).max()) + 1
        smem = smem_bytes(slice_c, cols, strip_w, c, cs)
        if smem <= SMEM_BUDGET:
            return ResizePlan(slice_c, strip_w, len(starts), cols, BAND_ROWS, smem)
    raise AssertionError("unreachable: a one-column strip reads at most two columns")


def resize_bilinear_align_corners_plain(
    x: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same taps, fp32 lerp, one rounding."""
    return resize_bilinear(x, out_h, out_w, align_corners=True)


def resize_into_concat_plain(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Plain version of the concat form: cat([upsample of x to skip's size, skip], -1)."""
    return torch.cat([resize_bilinear_align_corners_plain(x, skip.shape[1], skip.shape[2]), skip],
                     -1)


def resize_rows_plain(x: torch.Tensor, out_h: int, out_w: int, y0: int, y1: int,
                      skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the row-window form: rows [y0, y1) of
    ``resize_bilinear_align_corners_plain(x, out_h, out_w)`` (the same
    taps, fp32 lerp, one rounding), then ``skip`` along channels where one
    is given."""
    _, h, w, _ = x.shape
    y = x.to(torch.promote_types(x.dtype, torch.float32))
    if h != out_h:
        lo, hi, frac = (t[y0:y1] for t in device_taps(h, out_h, True, x.device))
        f = frac.view(1, -1, 1, 1)
        y = y.index_select(1, lo) * (1.0 - f) + y.index_select(1, hi) * f
    else:
        y = y[:, y0:y1]
    if w != out_w:
        lo, hi, frac = device_taps(w, out_w, True, x.device)
        f = frac.view(1, 1, -1, 1)
        y = y.index_select(2, lo) * (1.0 - f) + y.index_select(2, hi) * f
    y = y.to(x.dtype)
    return y if skip is None else torch.cat([y, skip], -1)


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
    if x.shape[0] > 65535:
        raise ValueError(f"resize kernel takes at most 65535 images, got {x.shape[0]}")
    if not x.is_contiguous():
        raise ValueError("resize kernel needs a contiguous NHWC tensor")
    if x.data_ptr() % 16:
        raise ValueError("resize kernel needs a 16-byte aligned tensor")


def concat_takes_skip(cs: int) -> bool:
    """Whether the concat form takes a skip of ``cs`` channels: a whole
    number of 16-byte bf16 vectors, so each pixel's record stays aligned.
    The decoder's final upsample, whose skip is the 3-channel image, takes
    the bare form and ``torch.cat``."""
    return cs > 0 and cs % 8 == 0


def check_concat_inputs(x: torch.Tensor, skip: torch.Tensor) -> None:
    """Raise ValueError unless the concat form takes x and skip."""
    if skip.dim() != 4:
        raise ValueError(f"resize kernel takes the skip as NHWC (B, Ho, Wo, Cs), got shape "
                         f"{tuple(skip.shape)}")
    check_resize_inputs(x, skip.shape[1], skip.shape[2])
    if skip.dtype != x.dtype:
        raise ValueError(f"resize kernel takes a bfloat16 skip, got {skip.dtype}")
    if skip.shape[0] != x.shape[0]:
        raise ValueError(f"skip has batch {skip.shape[0]}, x has {x.shape[0]}")
    if not concat_takes_skip(skip.shape[3]):
        raise ValueError(f"resize kernel needs Cs % 8 == 0 and Cs > 0, got Cs={skip.shape[3]}")
    if skip.device != x.device:
        raise ValueError(f"x on {x.device}, skip on {skip.device}")
    if not skip.is_contiguous() or skip.data_ptr() % 16:
        raise ValueError("resize kernel needs a contiguous, 16-byte aligned skip")


def _launch(x: torch.Tensor, skip: torch.Tensor | None, out_h: int, out_w: int) -> torch.Tensor:
    b, hi, wi, c = x.shape
    cs = 0 if skip is None else skip.shape[3]
    plan = resize_plan(hi, wi, c, out_h, out_w, cs)
    taps = (*device_taps(hi, out_h, True, x.device), *device_taps(wi, out_w, True, x.device))
    y = torch.empty((b, out_h, out_w, c + cs), dtype=x.dtype, device=x.device)
    head = (x.data_ptr(), y.data_ptr()) if skip is None else (x.data_ptr(), skip.data_ptr(),
                                                              y.data_ptr())
    sizes = (b, hi, wi, c, out_h, out_w) if skip is None else (b, hi, wi, c, cs, out_h, out_w)
    name = _ENTRY if skip is None else _ENTRY_CONCAT
    rc = getattr(load_library(), name)(
        *head, *(t.data_ptr() for t in taps), *sizes,
        plan.slice_c, plan.strip_w, plan.cols, plan.band_rows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(name, rc)
    resize_bilinear_align_corners.launches += 1
    resize_bilinear_align_corners.concat_launches += skip is not None
    return y


def resize_rows_cuda(x: torch.Tensor, out_h: int, out_w: int, y0: int, y1: int,
                     skip: torch.Tensor | None = None) -> torch.Tensor:
    """The row-window form's launch on CUDA tensors: its checks, then the
    kernel on the window's rows, and its counters."""
    if skip is None:
        check_resize_inputs(x, out_h, out_w)
    else:
        check_concat_inputs(x, skip)
        if skip.shape[1] != y1 - y0 or skip.shape[2] != out_w:
            raise ValueError(f"the window's skip must be (B, {y1 - y0}, {out_w}, Cs), got "
                             f"{tuple(skip.shape)}")
    if not 0 <= y0 <= y1 <= out_h:
        raise ValueError(f"resize kernel: no window of rows [{y0}, {y1}) in {out_h} rows")
    b, hi, wi, c = x.shape
    cs = 0 if skip is None else skip.shape[3]
    plan = resize_plan(hi, wi, c, y1 - y0, out_w, cs)
    taps = (*device_taps(hi, out_h, True, x.device), *device_taps(wi, out_w, True, x.device))
    y = torch.empty((b, y1 - y0, out_w, c + cs), dtype=x.dtype, device=x.device)
    rc = getattr(load_library(), _ENTRY_WINDOW)(
        x.data_ptr(), None if skip is None else skip.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in taps), b, hi, wi, c, cs, out_h, out_w, y0, y1,
        plan.slice_c, plan.strip_w, plan.cols, plan.band_rows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_ENTRY_WINDOW, rc)
    resize_bilinear_align_corners_rows.launches += 1
    resize_bilinear_align_corners_rows.concat_launches += skip is not None
    return y


def resize_cuda(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The bare form's launch on a CUDA tensor: its checks, then the kernel."""
    check_resize_inputs(x, out_h, out_w)
    return _launch(x, None, out_h, out_w)


def resize_into_concat_cuda(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The concat form's launch on CUDA tensors: its checks, then the kernel."""
    check_concat_inputs(x, skip)
    return _launch(x, skip, skip.shape[1], skip.shape[2])


def resize_bilinear_align_corners(
    x: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """(B, Hi, Wi, C) -> (B, out_h, out_w, C), align_corners=True bilinear.
    While ``torch.export`` traces, the custom op ``objcavit::resize_bilinear_ac``."""
    check_no_grad("resize_bilinear_align_corners", x)
    if torch.compiler.is_exporting():
        from objcavit_torch.kernels import ops
        return ops.resize_bilinear_ac(x, out_h, out_w)
    if x.device.type == "cpu":
        return resize_bilinear_align_corners_plain(x, out_h, out_w)
    if x.device.type != "cuda":
        raise ValueError(f"resize kernel runs on CUDA tensors, got {x.device}")
    return resize_cuda(x, out_h, out_w)


def resize_bilinear_align_corners_into_concat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """x (B, Hi, Wi, C), skip (B, Ho, Wo, Cs) -> (B, Ho, Wo, C + Cs): the
    align_corners=True upsample of x, then the skip, along channels. While
    ``torch.export`` traces, the custom op ``objcavit::resize_bilinear_ac_concat``."""
    check_no_grad("resize_bilinear_align_corners_into_concat", x, skip)
    if torch.compiler.is_exporting():
        from objcavit_torch.kernels import ops
        return ops.resize_bilinear_ac_concat(x, skip)
    if x.device.type == "cpu" and skip.device.type == "cpu":
        return resize_into_concat_plain(x, skip)
    if x.device.type != "cuda":
        raise ValueError(f"resize kernel runs on CUDA tensors, got {x.device}")
    return resize_into_concat_cuda(x, skip)


def resize_bilinear_align_corners_rows(x: torch.Tensor, out_h: int, out_w: int, y0: int, y1: int,
                                       skip: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, Hi, Wi, C) -> (B, y1 - y0, out_w, C (+ Cs)): rows [y0, y1) of
    the align_corners=True upsample of x to (out_h, out_w), and ``skip``
    (B, y1 - y0, out_w, Cs) after them along channels where one is given."""
    check_no_grad("resize_bilinear_align_corners_rows", x, *([] if skip is None else [skip]))
    if x.device.type == "cpu" and (skip is None or skip.device.type == "cpu"):
        return resize_rows_plain(x, out_h, out_w, y0, y1, skip)
    if x.device.type != "cuda":
        raise ValueError(f"resize kernel runs on CUDA tensors, got {x.device}")
    return resize_rows_cuda(x, out_h, out_w, y0, y1, skip)


resize_bilinear_align_corners.launches = 0
resize_bilinear_align_corners_rows.launches = 0
resize_bilinear_align_corners_rows.concat_launches = 0
resize_bilinear_align_corners.concat_launches = 0  # those of the concat form
