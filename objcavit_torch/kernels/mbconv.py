"""Kernels 8, 9 and 10: the fused MBConv head and the depthwise conv alone.

CUDA sources: ``objcavit_torch/csrc/mbconv_head.cu`` (kernels 8 and 9, one
kernel in two forms) and ``objcavit_torch/csrc/dw_silu_pool.cu`` (kernel
10). Each is bound by bytes on the H100; the source notes say how their
designs answer that.

* Kernel 8, ``mbconv_expand_dw_pool``: ``silu(dw(silu(x @ we + be)) + bd)``
  and its spatial sum on NHWC tensors; replaces
  ``objcavit_tpu/ops/mbconv_pallas.py::mbconv_expand_dw_pool``, the MBConv
  body of ``EfficientNetEncoder(fused_mbconv_head=True)``.
* Kernel 8's row-window form, ``mbconv_expand_dw_pool_rows``: kernel 8 on
  a band of the image and its halo rows as one tensor (spatial serving,
  ``parallel/spatial.py``), writing and pooling the band's rows alone; the
  same kernel, another window of output rows, its own counter.
* Kernel 9, ``mbconv_bs_expand_dw_pool``: the same on (H, W, B, C) tensors;
  replaces ``objcavit_tpu/ops/mbconv_bs.py::mbconv_bs_expand_dw_pool``. The
  kernel reads and writes through strides, so only they differ.
* Kernel 10, ``dw_conv_silu_pool``: ``silu(dw(x) + b)`` and, optionally, its
  spatial sum, with no expand; replaces
  ``objcavit_tpu/ops/dw_pallas.py::dw_conv_silu_pool``. ``dw_plan`` picks
  its work items and ring, which the wrapper passes to the C entry.

Each wrapper has the JAX function's name, arguments and layouts (``we``
(Cin, M), ``wd`` (k, k, 1, M), any (k, k, ...) form of it, or the packed
(k*k, M)), its own ``launches`` counter and a plain PyTorch version beside
it, which rounds where the TPU kernel does: the weights to the input's dtype, the expanded
band to the input's dtype before the depthwise (the zero padding of the
band is zero, not ``silu(be)``), ``y`` to the input's dtype once; the pool
is the sum of the fp32 ``y``. A wrapper launches the kernel for CUDA tensors
and raises on anything the kernel does not take (bf16 activations and
weights, fp32 biases, contiguous tensors, Cin and M multiples of 8, k 3 or
5); for CPU tensors it runs the plain version. The kernel has no backward,
so a wrapper raises when autograd would need its gradient.
``pack_mbconv`` lays a block's expand and depthwise convs out as the kernel
reads them; the encoder makes it once per set of weights.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_mbconv_head"
_ROWS_ENTRY = "objcavit_mbconv_head_rows"
_DW_ENTRY = "objcavit_dw_silu_pool"
KSIZES = (3, 5)
CHANNEL_ALIGN = 8  # Cin and M: 16-byte rows of bf16

# kernel 8's launch (csrc/mbconv_head.cu, the note there): the numbers the
# plan and the source share
SLAB = 64  # channels a work item: a warp's 32 lanes, a channel pair each
K_CHUNK = 64  # input channels a TMA box and a 128-byte swizzled row
M_TILE = 64  # pixels a wgmma row tile
MAX_MTILES = 2  # row tiles a group: 64 fp32 accumulators a thread
RING_GROUPS = 4  # groups of expanded rows the ring holds: even, as the stages
RING_PIXEL_BYTES = 144  # a ring pixel's 64 bf16 channels, padded against bank conflicts
RUN = 8  # output columns a depthwise item
DW_WARPS = 7
SMEM_LIMIT = 232448  # shared memory a block may use on the H100
PLAN_SMS, PLAN_BATCH = 132, 8  # the card and batch the plan is chosen for


@dataclass(frozen=True)
class MBConvPlan:
    """Kernel 8's launch for (H, W, Cin, M, k). A work item is one slab of
    SLAB channels, one image, a column strip of ``strip_w`` output columns
    and a segment of ``seg_groups`` groups of ``group_rows`` output rows; the
    block that takes it walks the segment's band of input rows down a group
    at a time. A persistent grid of at most one block an SM takes the items
    in slab-major order, an equal share each."""

    h: int
    w: int
    cin: int
    m: int
    k: int
    strip_w: int
    group_rows: int
    seg_groups: int
    stages: int

    @property
    def band_w(self) -> int:  # input columns a strip reads: its halo too
        return self.strip_w + 2 * (self.k // 2)

    @property
    def strips(self) -> int:
        return -(-self.w // self.strip_w)

    @property
    def segments(self) -> int:
        return -(-(-(-self.h // self.group_rows)) // self.seg_groups)

    @property
    def slabs(self) -> int:
        return -(-self.m // SLAB)

    @property
    def partials(self) -> int:  # pool partials an image: one a (strip, segment)
        return self.strips * self.segments

    @property
    def mtiles(self) -> int:
        return -(-self.group_rows * self.band_w // M_TILE)

    @property
    def kchunks(self) -> int:
        return -(-self.cin // K_CHUNK)

    @property
    def smem(self) -> int:
        return smem_bytes(self.k, self.band_w, self.group_rows, self.kchunks, self.stages)

    def work_items(self, batch: int) -> int:
        return self.slabs * batch * self.partials

    def grid(self, batch: int, sms: int = PLAN_SMS) -> int:
        """Blocks a launch on ``batch`` images takes on a card of ``sms`` SMs."""
        return min(self.work_items(batch), sms)


def smem_bytes(k: int, band_w: int, group_rows: int, kchunks: int, stages: int) -> int:
    """Shared memory of a block, as the source lays it out: 1024 bytes of
    alignment, the x stages (a group's row tiles of every K chunk each), the
    weight slab (a K chunk of SLAB rows each), the ring of RING_GROUPS
    groups of expanded rows with RUN pixels of slack for the last run's
    reads, the depthwise warps' pool sums, two mbarriers a stage and two a
    ring slot."""
    mtiles = -(-group_rows * band_w // M_TILE)
    ring = (RING_GROUPS * group_rows * band_w + RUN) * RING_PIXEL_BYTES
    return (1024 + stages * mtiles * kchunks * M_TILE * 128 + kchunks * SLAB * 128 + ring
            + DW_WARPS * SLAB * 4 + 16 * stages + 16 * RING_GROUPS)


@functools.lru_cache(maxsize=None)
def mbconv_plan(h: int, w: int, cin: int, m: int, k: int) -> MBConvPlan:
    """Kernel 8's launch: the strip width, the group and segment, the stages,
    the shared memory and (``plan.grid(b, sms)``) the grid. Of the strips of
    a multiple of RUN columns (or the whole width) and the groups of at
    least 2p rows whose row tiles fit MAX_MTILES and whose block fits
    SMEM_LIMIT with two or four stages (even: each expand warpgroup owns
    half the stages and ring slots), it takes the one with the least
    estimated time at batch PLAN_BATCH on PLAN_SMS SMs: a block's share of
    the work items x a segment's band groups (its output groups and one
    more) x a group's cost, the larger of the depthwise's and the expand's
    (they run at once), plus a weight slab's load for each slab a block
    meets. Raises ValueError when none fits."""
    if k not in KSIZES or min(h, w, cin, m) <= 0:
        raise ValueError(f"mbconv_plan: no plan for H={h}, W={w}, Cin={cin}, M={m}, k={k}")
    p = k // 2
    kchunks = -(-cin // K_CHUNK)
    slabs = -(-m // SLAB)
    best, best_cost = None, None
    for strip_w in sorted({w, *range(RUN, w, RUN)}):
        band_w = strip_w + 2 * p
        strips = -(-w // strip_w)
        for group_rows in range(max(2 * p, 1), 17):
            mtiles = -(-group_rows * band_w // M_TILE)
            if mtiles > MAX_MTILES:
                break
            stages = max((s for s in (2, 4) if smem_bytes(k, band_w, group_rows, kchunks, s)
                          <= SMEM_LIMIT), default=None)
            if stages is None:
                continue
            # lane operations a group takes: the depthwise's items over its
            # warps; the expand's row tiles (SiLU on each value) over two
            # warpgroups in turns
            dw = group_rows * (-(-strip_w // RUN) * RUN * 2 * k * k + strip_w * 24) / DW_WARPS
            ex = mtiles * M_TILE * 72 / DW_WARPS + kchunks * 20
            step = max(dw, ex) + 150
            groups = -(-h // group_rows)
            for seg_groups in range(1, groups + 1):
                segments = -(-groups // seg_groups)
                if seg_groups > 1 and -(-groups // (seg_groups - 1)) == segments:
                    continue  # a shorter segment with as many segments
                items = slabs * PLAN_BATCH * strips * segments
                share = -(-items // PLAN_SMS)
                slab_loads = 1 + -(-share // (PLAN_BATCH * strips * segments))
                cost = share * ((seg_groups + 1) * step + 100) + slab_loads * kchunks * 300
                if best_cost is None or cost < best_cost:
                    best_cost = cost
                    best = MBConvPlan(h, w, cin, m, k, strip_w, group_rows, seg_groups, stages)
    if best is None:
        raise ValueError(f"mbconv_plan: no block of H={h}, W={w}, Cin={cin}, M={m}, k={k} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best


def pool_scratch(plan: MBConvPlan, batch: int) -> tuple[int, int, int] | None:
    """The shape of kernel 8's pool-partial scratch: one fp32 partial a
    (strip, segment), image and channel; None when a block covers a whole
    image and writes the pool itself."""
    return None if plan.partials == 1 else (plan.partials, batch, plan.m)


def mbconv_eligible(cin: int, m: int, ksize: int, stride: int) -> bool:
    """Whether the kernel takes a block of these widths (any H and W: a plan
    that fits at 8 x 8 fits at any size, its 8-column strips among the
    choices)."""
    if not (stride == 1 and ksize in KSIZES and cin % CHANNEL_ALIGN == 0
            and m % CHANNEL_ALIGN == 0 and cin > 0 and m > 0):
        return False
    try:
        mbconv_plan(8, 8, cin, m, ksize)
    except ValueError:
        return False
    return True


# kernel 10's launch (csrc/dw_silu_pool.cu, the note there): the numbers
# the plan and the source share
DW_COLS = {3: 10, 5: 5}  # output columns a tap warp takes, by k
DW_MAX_WARPS = 8  # tap warps a block, beside the producer warp
DW_MAX_STAGES = 8  # input rows the ring holds
DW_PIXEL_BYTES = SLAB * 2  # a pixel's 64-channel slab in a ring row
# the plan's cost model: an SM's share of the H100's 3.35 TB/s at ~1.75 GHz
# in bytes a clock; the warps an SM holds at the registers a lane the
# kernel takes; the shared memory an SM gives its blocks
DW_SM_BYTES_PER_CLOCK = 14.5
DW_SM_WARPS = 12
DW_SM_SMEM = 233472


def dw_row_instructions(k: int) -> int:
    """A tap warp's instructions an input row: the FMAs, the row's loads and
    unpacking, an output's bias, SiLU, store and pool sum."""
    cols = DW_COLS[k]
    return 2 * k * k * cols + 3 * (cols + 2 * (k // 2)) + 14 * cols + 20


@dataclass(frozen=True)
class DWPlan:
    """Kernel 10's launch for (B, H, W, C, k). A work item is one image, one
    slab of SLAB channels, a column strip of ``strip_w`` output columns and
    a segment of ``seg_rows`` output rows; ``warps`` tap warps take
    DW_COLS[k] columns each (``strip_w`` = their columns), a ring of
    ``stages`` input rows feeds them, and a persistent grid of ``grid``
    blocks (as many as the SMs hold at once, at most the items) takes
    items i, i + grid, ..."""

    b: int
    h: int
    w: int
    c: int
    k: int
    strip_w: int
    seg_rows: int
    warps: int
    stages: int
    grid: int

    @property
    def band_w(self) -> int:  # input columns a strip reads: its halo too
        return self.strip_w + 2 * (self.k // 2)

    @property
    def strips(self) -> int:
        return -(-self.w // self.strip_w)

    @property
    def segments(self) -> int:
        return -(-self.h // self.seg_rows)

    @property
    def slabs(self) -> int:
        return -(-self.c // SLAB)

    @property
    def parts(self) -> int:  # pool partials an (image, slab): one an item
        return self.strips * self.segments

    @property
    def items(self) -> int:
        return self.b * self.slabs * self.parts

    @property
    def smem(self) -> int:
        return dw_smem_bytes(self.band_w, self.stages)


def dw_smem_bytes(band_w: int, stages: int) -> int:
    """Shared memory of a kernel-10 block, as the source lays it out: 128
    bytes of alignment, the ring of input rows, the tap warps' pool sums and
    two mbarriers a stage of the most the source allows."""
    return 128 + stages * band_w * DW_PIXEL_BYTES + DW_MAX_WARPS * SLAB * 4 + 16 * DW_MAX_STAGES


@functools.lru_cache(maxsize=None)
def dw_plan(b: int, h: int, w: int, c: int, k: int, n_sm: int) -> DWPlan:
    """Kernel 10's launch on a card of ``n_sm`` SMs. Of the strips (a
    multiple of DW_COLS[k] columns, at most DW_MAX_WARPS warps of them) and
    the segments, it takes the one with the least estimated time: a block
    walks its items' input rows one after another, so the time is its
    share of the items (the grid is as many blocks as the SMs hold at once,
    by warps and shared memory, at most the items) x an item's rows (its
    output rows and the 2p halo rows) x a row's time, plus a fixed cost an
    item. A row's time is the larger of its bytes (the band row in, the
    strip's outputs) over the SM's share of the card's rate and its tap
    warps' instructions over the SM's four schedulers (at half the rate
    while the SM holds fewer than eight tap warps), times the blocks
    sharing the SM. The ring takes DW_MAX_STAGES rows, or fewer where a
    block of that many would keep a second block off the SM. Raises ValueError for a k or a
    shape it has no plan for."""
    if k not in KSIZES or min(b, h, w, c) <= 0 or n_sm <= 0:
        raise ValueError(f"dw_plan: no plan for B={b}, H={h}, W={w}, C={c}, k={k}, {n_sm} SMs")
    p, cols = k // 2, DW_COLS[k]
    slabs = -(-c // SLAB)
    seg_options = sorted({-(-h // n) for n in range(1, h + 1)})
    best, best_key = None, None
    for strip_w in sorted({-(-(-(-w // n)) // cols) * cols for n in range(1, -(-w // cols) + 1)}):
        warps = strip_w // cols
        if warps > DW_MAX_WARPS:
            continue
        band = strip_w + 2 * p
        by_warps = max(1, DW_SM_WARPS // (warps + 1))
        stages = DW_MAX_STAGES
        smem = functools.partial(dw_smem_bytes, band)
        while stages > 2 and by_warps * (smem(stages) + 1024) > DW_SM_SMEM:
            stages -= 1
        if smem(stages) > SMEM_LIMIT:
            continue
        per_sm = min(by_warps, DW_SM_SMEM // (smem(stages) + 1024))
        strips = -(-w // strip_w)
        row_bytes = (band + strip_w) * DW_PIXEL_BYTES
        for seg_rows in seg_options:
            items = b * slabs * strips * -(-h // seg_rows)
            grid = min(items, n_sm * per_sm)
            sharing = -(-grid // n_sm)  # blocks on the busiest SM
            rate = 4.0 if sharing * warps >= 8 else 2.0  # instructions a clock an SM issues
            row = sharing * max(row_bytes / DW_SM_BYTES_PER_CLOCK,
                                warps * dw_row_instructions(k) / rate)
            share = -(-items // grid)  # items of the busiest block
            key = (share * ((seg_rows + 2 * p) * row + 300), items)
            if best_key is None or key < best_key:
                best_key = key
                best = DWPlan(b, h, w, c, k, strip_w, seg_rows, warps, stages, grid)
    if best is None:
        raise ValueError(f"dw_plan: no block of W={w}, k={k} fits {SMEM_LIMIT} bytes")
    return best


def dw_pool_scratch(plan: DWPlan) -> tuple[int, int, int] | None:
    """The shape of kernel 10's pool-partial scratch: one fp32 partial an
    item; None when an item covers an image's slab and writes the pool."""
    return None if plan.parts == 1 else (plan.parts, plan.b, plan.c)


@dataclass(frozen=True)
class PackedMBConv:
    """A block's expand and depthwise convs as the kernel reads them."""

    we: torch.Tensor  # (Cin, M) model dtype
    be: torch.Tensor  # (M,) fp32
    wd: torch.Tensor  # (k*k, M) model dtype
    bd: torch.Tensor  # (M,) fp32
    ksize: int


@torch.no_grad()
def pack_mbconv(expand_weight, expand_bias, dw_weight, dw_bias) -> PackedMBConv:
    """(M, Cin, 1, 1), (M,), (M, 1, k, k), (M,) conv tensors -> PackedMBConv."""
    m, k = dw_weight.shape[0], dw_weight.shape[-1]
    return PackedMBConv(
        expand_weight.reshape(m, -1).t().contiguous(), expand_bias.float().contiguous(),
        dw_weight.reshape(m, k * k).t().contiguous(), dw_bias.float().contiguous(), k,
    )


def _taps(wd: torch.Tensor, ksize: int) -> torch.Tensor:
    """Any (k, k, ...) form of the depthwise weight -> (k*k, M)."""
    return wd.reshape(ksize * ksize, -1)


def expand_plain(x: torch.Tensor, we: torch.Tensor, be: torch.Tensor) -> torch.Tensor:
    """fp32 ``silu(x @ we + be)`` of (B, H, W, Cin) x, before its rounding:
    the products of x and the weight in x's dtype, summed in fp32."""
    e = torch.matmul(x.float(), we.to(x.dtype).float()) + be.float()
    return F.silu(e)


def depthwise_silu_plain(e: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                         ksize: int) -> torch.Tensor:
    """fp32 ``silu(dw(e) + bd)`` of (B, H, W, M) e with the weight rounded to
    e's dtype: SAME zero padding, stride 1, an fp32 convolution."""
    m = e.shape[-1]
    weight = _taps(wd, ksize).to(e.dtype).float().t().reshape(m, 1, ksize, ksize)
    z = F.conv2d(e.float().permute(0, 3, 1, 2), weight, padding=ksize // 2, groups=m)
    return F.silu(z + bd.float()[:, None, None]).permute(0, 2, 3, 1)


def mbconv_expand_dw_pool_plain(x, we, be, wd, bd, ksize: int):
    """Plain PyTorch version of kernel 8: (y (B, H, W, M) in x's dtype,
    pool (B, M) fp32)."""
    y = depthwise_silu_plain(expand_plain(x, we, be).to(x.dtype), wd, bd, ksize)
    return y.to(x.dtype), y.sum((1, 2))


def mbconv_by_plan(x, we, be, wd, bd, ksize: int, plan: MBConvPlan | None = None):
    """Kernel 8 computed the way its CUDA kernel orders it, in PyTorch: for
    each block of ``plan`` (image, strip, segment; the slabs split only the
    channels), the band's rows expanded a group at a time into a ring of
    RING_GROUPS groups (rounded to x's dtype, zero outside the image), the
    output rows of group s - 2 from the ring at step s, each output's taps in
    the TPU kernel's order, the pool as each depthwise warp's sums over its
    items, added in warp order, then over the (strip, segment) partials in
    order. fp32 arithmetic; returns (y in x's dtype, pool fp32)."""
    b, h, w, cin = x.shape
    m, k, p = we.shape[1], ksize, ksize // 2
    plan = plan or mbconv_plan(h, w, cin, m, k)
    g, bw = plan.group_rows, plan.band_w
    taps = _taps(wd, k).to(x.dtype).float()
    wef, bef, bdf = we.to(x.dtype).float(), be.float(), bd.float()
    y = torch.zeros((b, h, w, m), dtype=torch.float32)
    parts = torch.zeros((plan.partials, b, m), dtype=torch.float32)
    runs = -(-plan.strip_w // RUN)
    for bi in range(b):
        for unit in range(plan.partials):
            strip, seg = divmod(unit, plan.segments)
            w0, r0 = strip * plan.strip_w, seg * plan.seg_groups * g
            n_groups = min(plan.seg_groups, -(-(h - r0) // g))
            ring = torch.zeros((RING_GROUPS, g, bw, m), dtype=torch.float32)
            psum = torch.zeros((DW_WARPS, m), dtype=torch.float32)
            for s in range(n_groups + 2):
                if s <= n_groups:  # expand band group s: rows r0 - p + s g ...
                    band = torch.zeros((g, bw, cin), dtype=torch.float32)
                    rows = range(r0 - p + s * g, r0 - p + (s + 1) * g)
                    for i, r in enumerate(rows):
                        c_lo, c_hi = max(w0 - p, 0), min(w0 - p + bw, w)
                        if 0 <= r < h and c_lo < c_hi:
                            band[i, c_lo - (w0 - p):c_hi - (w0 - p)] = x[bi, r, c_lo:c_hi].float()
                    e = F.silu(band @ wef + bef)
                    inside = torch.zeros((g, bw, 1), dtype=torch.bool)
                    for i, r in enumerate(rows):
                        if 0 <= r < h:
                            lo, hi = max(0, p - w0), min(bw, w - w0 + p)
                            inside[i, lo:hi] = True
                    ring[s % RING_GROUPS] = torch.where(inside, e, 0.0).to(x.dtype).float()
                d = s - 2
                if d < 0:
                    continue
                for item in range(g * runs):
                    o, c0 = item // runs, (item % runs) * RUN
                    ro = d * g + o
                    if r0 + ro >= h:
                        break
                    cols = [c for c in range(c0, c0 + RUN) if c < plan.strip_w and w0 + c < w]
                    acc = torch.zeros((len(cols), m), dtype=torch.float32)
                    for i in range(k):
                        br = ro + i
                        row = ring[(br // g) % RING_GROUPS, br % g]
                        for j in range(k):
                            acc = acc + row[[c + j for c in cols]] * taps[i * k + j]
                    out = F.silu(acc + bdf)
                    y[bi, r0 + ro, [w0 + c for c in cols]] = out
                    psum[item % DW_WARPS] += out.sum(0)  # in item order per warp
            block = torch.zeros(m, dtype=torch.float32)
            for warp in range(DW_WARPS):
                block = block + psum[warp]
            parts[unit, bi] = block
    pool = parts[0].clone()
    for unit in range(1, plan.partials):
        pool = pool + parts[unit]
    return y.to(x.dtype), pool


def mbconv_expand_dw_pool_rows_plain(x, we, be, wd, bd, ksize: int, top: int, bottom: int):
    """Plain PyTorch version of kernel 8's row-window form: rows [top, H -
    bottom) of kernel 8's plain version on x (B, H, W, Cin), and the pool
    of those rows alone: (y (B, H - top - bottom, W, M) in x's dtype, pool
    (B, M) fp32)."""
    e = expand_plain(x, we, be).to(x.dtype)
    y = depthwise_silu_plain(e, wd, bd, ksize)[:, top:x.shape[1] - bottom]
    return y.to(x.dtype), y.sum((1, 2))


def mbconv_bs_expand_dw_pool_plain(x_t, we, be, wd, bd, ksize: int):
    """Plain PyTorch version of kernel 9: kernel 8's on (H, W, B, Cin),
    giving (y (H, W, B, M), pool (B, M) fp32)."""
    y, pool = mbconv_expand_dw_pool_plain(x_t.permute(2, 0, 1, 3), we, be, wd, bd, ksize)
    return y.permute(1, 2, 0, 3).contiguous(), pool


def dw_conv_silu_pool_plain(x, w, b, ksize: int, with_pool: bool = True):
    """Plain PyTorch version of kernel 10: (y (B, H, W, C) in x's dtype,
    pool (B, C) fp32 or None)."""
    y = depthwise_silu_plain(x, w, b, ksize)
    return y.to(x.dtype), (y.sum((1, 2)) if with_pool else None)


def check_mbconv_inputs(x, we, be, wd, bd, ksize: int, expand: bool) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments: x
    (4-D, channels last and contiguous), we (Cin, M) when ``expand``."""
    if x.dim() != 4:
        raise ValueError(f"mbconv kernel takes a 4-D x, got {tuple(x.shape)}")
    cin = x.shape[3]
    m = we.shape[-1] if expand else cin
    tensors = [x, wd, bd] + ([we, be] if expand else [])
    if x.dtype != torch.bfloat16 or wd.dtype != torch.bfloat16 \
            or (expand and we.dtype != torch.bfloat16):
        raise ValueError(f"mbconv kernel takes bf16 x and weights, got {x.dtype}, "
                         f"{wd.dtype}{f' and {we.dtype}' if expand else ''}")
    if bd.dtype != torch.float32 or (expand and be.dtype != torch.float32):
        raise ValueError("mbconv kernel takes fp32 biases")
    if ksize not in KSIZES:
        raise ValueError(f"mbconv kernel takes k in {KSIZES}, got {ksize}")
    if cin % CHANNEL_ALIGN or m % CHANNEL_ALIGN or not cin or not m:
        raise ValueError(f"mbconv kernel needs Cin and M multiples of {CHANNEL_ALIGN}, "
                         f"got Cin={cin}, M={m}")
    if expand and we.shape != (cin, m):
        raise ValueError(f"mbconv kernel takes we as (Cin, M) = {(cin, m)}, got {tuple(we.shape)}")
    taps = tuple(wd.shape[:2]) == (ksize, ksize) or tuple(wd.shape) == (ksize * ksize, m)
    if not taps or wd.numel() != ksize * ksize * m:
        raise ValueError(f"mbconv kernel takes wd as ({ksize}, {ksize}, ..., {m}) or "
                         f"({ksize * ksize}, {m}), got {tuple(wd.shape)}")
    if bd.shape != (m,) or (expand and be.shape != (m,)):
        raise ValueError(f"mbconv kernel takes biases of ({m},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mbconv kernel needs contiguous x, weights and biases")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"mbconv kernel inputs lie on several devices: {devices}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mbconv kernel needs 16-byte aligned inputs")


def _launch(x, we, be, wd, bd, ksize: int, batch_minor: bool, rows: tuple[int, int] | None = None):
    """Launch kernel 8 on x (B, H, W, Cin), or (H, W, B, Cin) with
    ``batch_minor``; with ``rows`` (top, bottom), the row-window form on
    NHWC x: y and the pool of rows [top, H - bottom)."""
    check_mbconv_inputs(x, we, be, wd, bd, ksize, expand=True)
    if batch_minor:
        h, w, b, cin = x.shape
    else:
        b, h, w, cin = x.shape
    m = we.shape[1]
    lo, hi = (0, h) if rows is None else (rows[0], h - rows[1])
    if not 0 <= lo <= hi <= h:
        raise ValueError(f"mbconv kernel: no window of rows [{lo}, {hi}) in {h} rows")
    y = torch.empty((b, hi - lo, w, m) if rows is not None else (*x.shape[:3], m),
                    dtype=x.dtype, device=x.device)
    # element strides of an image, a row and a column, for x and for y
    strides = [(c, w * b * c, b * c) if batch_minor else (r * w * c, w * c, c)
               for c, r in ((cin, h), (m, hi - lo))]
    plan = mbconv_plan(hi - lo, w, cin, m, ksize)
    scratch = pool_scratch(plan, b)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count \
        if x.device.type == "cuda" else PLAN_SMS
    partial = None if scratch is None else torch.empty(scratch, dtype=torch.float32,
                                                       device=x.device)
    pool = torch.empty((b, m), dtype=torch.float32, device=x.device)
    entry, window = (_ENTRY, ()) if rows is None else (_ROWS_ENTRY, (lo, hi))
    rc = getattr(load_library(), entry)(
        x.data_ptr(), we.data_ptr(), be.data_ptr(), wd.data_ptr(), bd.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), pool.data_ptr(), b, h, w, cin, m, ksize,
        *strides[0], *strides[1], 1, plan.strip_w, plan.group_rows, plan.seg_groups,
        plan.grid(b, sms), plan.stages, plan.smem, *window,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(entry, rc)
    return y, pool


def _launch_dw(x, wd, bd, ksize: int, with_pool: bool, plan: DWPlan | None = None):
    """Launch kernel 10 on x (B, H, W, C) by ``plan`` (``dw_plan`` on the
    card's SMs when None). An empty x (B, H or W of 0) has no work items:
    it launches nothing and gets an empty y and a zero pool."""
    check_mbconv_inputs(x, None, None, wd, bd, ksize, expand=False)
    b, h, w, c = x.shape
    if x.numel() == 0:
        pool = torch.zeros((b, c), dtype=torch.float32, device=x.device) if with_pool else None
        return torch.empty_like(x), pool
    if plan is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count \
            if x.device.type == "cuda" else PLAN_SMS
        plan = dw_plan(b, h, w, c, ksize, sms)
    y = torch.empty_like(x)
    partial = pool = None
    if with_pool:
        scratch = dw_pool_scratch(plan)
        if scratch is not None:
            partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
        pool = torch.empty((b, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(load_library(), _DW_ENTRY)(
        x.data_ptr(), wd.data_ptr(), bd.data_ptr(), y.data_ptr(), ptr(partial), ptr(pool), b, h,
        w, c, ksize, int(with_pool), plan.strip_w, plan.seg_rows, plan.warps, plan.stages,
        plan.grid, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_DW_ENTRY, rc)
    return y, pool


def _route(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """True for a CUDA launch, False for the plain version on the CPU."""
    check_no_grad(name, x, *tensors)
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    return True


def mbconv_expand_dw_pool(x, we, be, wd, bd, ksize: int):
    """Kernel 8. x (B, H, W, Cin) bf16, we (Cin, M) bf16, be (M,) fp32, wd
    (k, k, 1, M) bf16, bd (M,) fp32 -> (y (B, H, W, M) bf16, pool (B, M)
    fp32): ``silu(dw(silu(x @ we + be)) + bd)``, SAME, stride 1, and its
    spatial sum. While ``torch.export`` traces, the custom op
    ``objcavit::mbconv_head``."""
    if torch.compiler.is_exporting():
        check_no_grad("mbconv_expand_dw_pool", x, we, be, wd, bd)
        from objcavit_torch.kernels import ops
        return ops.mbconv_head(x, we, be, wd, bd, ksize)
    if not _route("mbconv_expand_dw_pool", x, we, be, wd, bd):
        return mbconv_expand_dw_pool_plain(x, we, be, wd, bd, ksize)
    return mbconv_expand_dw_pool_cuda(x, we, be, wd, bd, ksize)


def mbconv_expand_dw_pool_cuda(x, we, be, wd, bd, ksize: int):
    """Kernel 8's launch on CUDA tensors: its checks, its plan, the kernel,
    the count."""
    out = _launch(x, we, be, wd, bd, ksize, batch_minor=False)
    mbconv_expand_dw_pool.launches += 1
    return out


def mbconv_expand_dw_pool_rows(x, we, be, wd, bd, ksize: int, top: int, bottom: int):
    """Kernel 8's row-window form. x (B, H, W, Cin) bf16 holds an image's
    band with ``top`` rows above it and ``bottom`` below it (the halo rows
    that lie in the image; past the tensor the expanded rows are zero, the
    image's padding); the rest as kernel 8 -> (y (B, H - top - bottom, W, M)
    bf16, pool (B, M) fp32): kernel 8's y on the band's rows, and their
    sum."""
    if not _route("mbconv_expand_dw_pool_rows", x, we, be, wd, bd):
        return mbconv_expand_dw_pool_rows_plain(x, we, be, wd, bd, ksize, top, bottom)
    return mbconv_expand_dw_pool_rows_cuda(x, we, be, wd, bd, ksize, top, bottom)


def mbconv_expand_dw_pool_rows_cuda(x, we, be, wd, bd, ksize: int, top: int, bottom: int):
    """The row-window form's launch on CUDA tensors: its checks, its plan,
    the kernel, the count."""
    out = _launch(x, we, be, wd, bd, ksize, batch_minor=False, rows=(top, bottom))
    mbconv_expand_dw_pool_rows.launches += 1
    return out


def mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, ksize: int):
    """Kernel 9. Kernel 8 on x_t (H, W, B, Cin) -> (y (H, W, B, M), pool
    (B, M) fp32)."""
    if not _route("mbconv_bs_expand_dw_pool", x_t, we, be, wd, bd):
        return mbconv_bs_expand_dw_pool_plain(x_t, we, be, wd, bd, ksize)
    out = _launch(x_t, we, be, wd, bd, ksize, batch_minor=True)
    mbconv_bs_expand_dw_pool.launches += 1
    return out


def dw_conv_silu_pool(x, w, b, ksize: int, with_pool: bool = True):
    """Kernel 10. x (B, H, W, C) bf16, w (k, k, 1, C) bf16, b (C,) fp32 ->
    (y (B, H, W, C) bf16, pool (B, C) fp32, or None without ``with_pool``):
    ``silu(dw(x) + b)``, SAME, stride 1."""
    if not _route("dw_conv_silu_pool", x, w, b):
        return dw_conv_silu_pool_plain(x, w, b, ksize, with_pool)
    out = _launch_dw(x, w, b, ksize, with_pool)
    if x.numel():  # an empty x launches nothing
        dw_conv_silu_pool.launches += 1
    return out


mbconv_expand_dw_pool.launches = 0
mbconv_expand_dw_pool_rows.launches = 0
mbconv_bs_expand_dw_pool.launches = 0
dw_conv_silu_pool.launches = 0
