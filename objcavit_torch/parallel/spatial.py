"""Spatial serving: the image height split over a process grid's model axis.

The JAX package serves an image on bands of rows by sharding its height
over the mesh's ``model`` axis (``objcavit_tpu/serving.py:150-176``, the
frames placed ``P(data, model)``); GSPMD then exchanges the rows each conv
reads across a band edge and gathers around the attention stacks. Here the
ranks of one model group do that by hand, under a ``BandPlan``:

* **The plan.** The height is cut into units of ``UNIT_ROWS`` = 32 image
  rows: EfficientNet-B5's total stride, and two of ObjCAViT's and miniViT's
  16-pixel patches on the half-resolution features. Model rank ``m`` takes
  a contiguous run of units, the first ``units % n_model`` ranks one more
  (480 rows = 15 units: 8 + 7, bands of 256 and 224 rows), so at every
  level of the pyramid a band starts on a row every stride divides. A
  height that is not a whole number of units, a grid with ``n_model == 1``,
  or fewer units than model ranks serves the whole image on every model
  rank, and the plan says why (``BandPlan.reason``). JAX's own fallback is
  ``frames.shape[1] % n_model``: GSPMD pads a ragged split, the hand split
  does not, so the port's condition differs there.
* **Where a module reads it.** ``serving(plan)`` makes a split plan the
  process's for one forward; ``active()`` returns it (None outside, so
  every module runs as before, bit for bit). A tensor's level is read from
  its band height: rank m's band of ``32 u_m`` image rows holds ``32 u_m /
  s`` rows at stride s.
* **The halo exchange** (``halo``): a conv of height k and stride s, with
  ``p`` rows of zero padding before the WHOLE image, reads ``p`` rows from
  the ranks above and ``k - s - p`` from the ranks below; zero padding
  applies only at the image's true top and bottom (``conv2d``). Each rank's
  first and last rows go through one all-reduce of a zeroed (n_model, ...)
  stack (``collectives.stack_over``: a collective of gloo on CUDA tensors
  as well as NCCL's), and a rank takes the rows next to its band, from
  several ranks where a neighbour's band is shorter than the halo.
* **Sums and gathers**: ``band_sum`` (a per-band sum over the model group:
  the SE means) and ``gather_rows`` (every rank's band, padded to the
  largest and trimmed, in row order: the decoder's low-resolution inputs,
  the tokens, the depth).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import torch
import torch.distributed as dist
import torch.nn.functional as F

from objcavit_torch.parallel.collectives import stack_over

UNIT_ROWS = 32  # image rows a unit: B5's total stride, two 16-pixel patches at half resolution
MAX_STRIDE = 32  # the deepest level of the pyramid

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Which image rows each model rank serves, for an image of ``height``
    rows on ``n_model`` model ranks. ``units`` holds each rank's count of
    UNIT_ROWS-row units (empty where the image is served whole, ``reason``
    then saying why); ``index`` is this rank's model index and ``group`` its
    model group."""

    height: int
    n_model: int
    units: tuple[int, ...] = ()
    reason: str | None = None
    index: int = 0
    group: object = None

    @property
    def split(self) -> bool:
        """Whether the image is served on bands (more than one)."""
        return bool(self.units)

    def bands(self, stride: int = 1) -> list[tuple[int, int]]:
        """Each model rank's rows [lo, hi) at ``stride`` (image rows / stride),
        in model-index order: the whole image on every rank where the plan
        does not split."""
        if not self.split:
            return [(0, self.height // stride)] * self.n_model
        out, lo = [], 0
        for u in self.units:
            out.append((lo * UNIT_ROWS // stride, (lo + u) * UNIT_ROWS // stride))
            lo += u
        return out

    def level(self, rows: int) -> tuple[int, list[tuple[int, int]]]:
        """The stride of a tensor whose band (this rank's) has ``rows`` rows,
        and every rank's rows at it."""
        own = self.units[self.index] * UNIT_ROWS
        stride = own // rows if rows else 0
        if not rows or own % rows or stride > MAX_STRIDE or MAX_STRIDE % stride:
            raise ValueError(f"a band of {rows} rows is no level of this rank's {own} image rows")
        return stride, self.bands(stride)


def band_plan(height: int, grid) -> BandPlan:
    """The plan for an image of ``height`` rows on ``grid``'s model axis."""
    n = grid.n_model
    units, reason = height // UNIT_ROWS, None
    if n == 1:
        reason = "the grid has one model rank"
    elif height % UNIT_ROWS:
        reason = f"{height} rows are not a whole number of {UNIT_ROWS}-row units"
    elif units < n:
        reason = f"{height} rows are {units} of {UNIT_ROWS}-row units, fewer than {n} model ranks"
    if reason is not None:
        return BandPlan(height, n, reason=reason, index=grid.model_index)
    base, extra = divmod(units, n)
    return BandPlan(height, n, tuple(base + (m < extra) for m in range(n)), None,
                    grid.model_index, grid.model_group)


_ACTIVE: BandPlan | None = None


def active() -> BandPlan | None:
    """The split plan of the forward that runs now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def serving(plan: BandPlan | None):
    """Make ``plan`` the process's for the block (None, or a plan that does
    not split, leaves every module on the whole image)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, (plan if plan is not None and plan.split else None)
    try:
        yield
    finally:
        _ACTIVE = saved


@contextlib.contextmanager
def suspended():
    """Run the block on whole tensors (a gathered input), the plan put aside."""
    with serving(None):
        yield


def _like(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` in ``x``'s memory format (channels_last where x is)."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        return out.contiguous(memory_format=torch.channels_last)
    return out


def halo(x: torch.Tensor, above: int, below: int, dim: int = 2,
         pad: bool = True) -> tuple[torch.Tensor, int, int]:
    """This rank's band ``x`` (rows along ``dim``) with the ``above`` image
    rows just before it and the ``below`` rows just after it, from the
    other model ranks: -> (the tensor, the rows put before, the rows put
    after). Past the image's top and bottom there are no rows: with ``pad``
    zero rows stand there (the image's zero padding), without it the tensor
    stops at the image's edge and the counts say how many rows were put."""
    plan = active()
    _, bands = plan.level(x.shape[dim])
    sizes = [hi - lo for lo, hi in bands]
    m = plan.index
    xt = x.movedim(dim, 0)
    n = xt.shape[0]
    stack = xt.new_zeros((above + below,) + tuple(xt.shape[1:]))
    if above:
        take = min(above, n)
        stack[above - take:above] = xt[n - take:]
    if below:
        take = min(below, n)
        stack[above:above + take] = xt[:take]
    stack = stack_over(stack, m, plan.n_model, plan.group)
    before = [stack[j, above - min(above, sizes[j]):above] for j in range(m)]
    after = [stack[j, above:above + min(below, sizes[j])] for j in range(m + 1, plan.n_model)]
    top = torch.cat(before)[-above:] if above and before else xt[:0]
    bottom = torch.cat(after)[:below] if below and after else xt[:0]
    parts = [top, xt, bottom]
    if pad:
        parts = [xt.new_zeros((above - top.shape[0],) + tuple(xt.shape[1:])), *parts,
                 xt.new_zeros((below - bottom.shape[0],) + tuple(xt.shape[1:]))]
        put = (above, below)
    else:
        put = (top.shape[0], bottom.shape[0])
    out = torch.cat(parts).movedim(0, dim)
    return _like(out, x), put[0], put[1]


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride, dilation, groups: int,
           pad_top: int, pad_w: tuple[int, int]) -> torch.Tensor:
    """A conv on this rank's band of NCHW ``x``: ``pad_top`` is the whole
    image's zero padding before its first row, ``pad_w`` (left, right) the
    width's. It reads ``pad_top`` rows from above and ``k - s - pad_top``
    from below (``halo``, zeros past the image), then convolves with no
    height padding; the band's output rows are its rows / s."""
    kh = (weight.shape[2] - 1) * dilation[0] + 1
    sh, n = stride[0], x.shape[2]
    below = max(kh - sh - pad_top, 0)
    if pad_top or below:
        x = halo(x, pad_top, below)[0]
    if pad_w[0] == pad_w[1]:
        out = F.conv2d(x, weight, bias, stride, (0, pad_w[0]), dilation, groups)
    else:
        out = F.conv2d(F.pad(x, [pad_w[0], pad_w[1], 0, 0]), weight, bias, stride, 0, dilation,
                       groups)
    if n % sh or out.shape[2] != n // sh:
        raise ValueError(f"a band of {n} rows through a conv of height {kh}, stride {sh} gave "
                         f"{out.shape[2]} rows, not {n // sh}")
    return out


def whole_rows(rows: int) -> int:
    """The image's rows at the level of a band of ``rows`` rows."""
    plan = active()
    stride, _ = plan.level(rows)
    return plan.height // stride


def band_window(rows: int) -> tuple[int, int, int]:
    """(lo, hi, whole): this rank's rows at the level of a band of ``rows``
    rows, and the image's rows there."""
    plan = active()
    stride, bands = plan.level(rows)
    lo, hi = bands[plan.index]
    return lo, hi, plan.height // stride


def band_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a per-band sum) summed over the model group."""
    t = t.contiguous().clone()
    dist.all_reduce(t, group=active().group)
    return t


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The whole image's spatial mean of NCHW ``x``, (B, C, 1, 1) in x's
    dtype: the band's sum in fp32 or wider, summed over the model group,
    over the image's H x W."""
    acc = torch.promote_types(x.dtype, torch.float32)
    total = band_sum(x.to(acc).sum((2, 3), keepdim=True))
    return (total / (whole_rows(x.shape[2]) * x.shape[3])).to(x.dtype)


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's band of ``x`` (rows along ``dim``), joined in row
    order: the bands padded to the largest, stacked by one all-reduce, and
    trimmed."""
    plan = active()
    _, bands = plan.level(x.shape[dim])
    sizes = [hi - lo for lo, hi in bands]
    xt = x.movedim(dim, 0)
    stack = xt.new_zeros((max(sizes),) + tuple(xt.shape[1:]))
    stack[:xt.shape[0]] = xt
    stack = stack_over(stack, plan.index, plan.n_model, plan.group)
    return _like(torch.cat([stack[j, :s] for j, s in enumerate(sizes)]).movedim(0, dim), x)


def log_whole(plan: BandPlan) -> None:
    """Say once a height that a spatial server serves whole, and why."""
    key = (plan.height, plan.n_model, plan.reason)
    if key not in _WHOLE_LOGGED:
        _WHOLE_LOGGED.add(key)
        log.warning("spatial serving: %d rows served whole on every model rank: %s",
                    plan.height, plan.reason)


_WHOLE_LOGGED: set = set()
