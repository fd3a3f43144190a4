"""Kernels 7-10 and the encoder's fused routes against the JAX package, on the CPU.

* Kernels 8, 9, 10 and 7: the port's wrappers, which run their plain
  versions on CPU tensors, against the Pallas kernels in interpret mode, at
  the JAX tests' own shapes (tests/test_mbconv_pallas.py,
  test_mbconv_bs.py, test_dw_pallas.py, test_se_project_pallas.py) and
  tolerances for fp32; bf16 within one bf16 ulp (both sides sum the same
  bf16-exact products in fp32 and round at the same points).
* The encoder: efficientnet-tiny, folded, fp32, on each route, against
  JAX's encoder with ``mbconv_pallas.INTERPRET`` and
  ``se_project_pallas.INTERPRET`` monkeypatched, at 64x96 (at JAX's own
  32x48 no block has a tile plan for kernel 8).
* The slice: the tiny GraphBins of tests/test_torch_fused.py, folded, fp32,
  with ``encoder_impl="kernel"`` against JAX's GraphBins with kernel 7 on
  (it has no switch for kernel 8; its blocks' unfused math is what kernel 8
  computes).
* B5's routes, counted without a forward; the default route; the wrappers'
  and the blocks' refusals; the error checks ``chip_smoke.py`` applies.
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objcavit_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from objcavit_tpu.ops import mbconv_pallas as jax_mp
from objcavit_tpu.ops import se_project_pallas as jax_sp
from objcavit_tpu.ops.dw_pallas import dw_conv_silu_pool as jax_dw_conv_silu_pool
from objcavit_tpu.ops.mbconv_bs import mbconv_bs_expand_dw_pool as jax_mbconv_bs
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm

import objcavit_torch.models.common as common
from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.kernels import se_project as kse
from objcavit_torch.models.efficientnet import EfficientNetEncoder
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.utils.benchkit import build_flagship_model
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm
from objcavit_torch.utils.mbconv_ab import DW_CASES, MBCONV_SHAPES
from objcavit_torch.utils.kernel_io import (
    mbconv_head_errors,
    record_encoder_kernel_io,
    se_project_errors,
)
from tests.test_torch_fused import DIMS, ENC, N_OBJ, graphbins_variables, jax_graphbins

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5  # one bf16 ulp


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _mbconv_case(rng, b, h, w, cin, m, k, be_scale=0.3):
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (0.2 * rng.standard_normal((cin, m))).astype(np.float32),
            (be_scale * rng.standard_normal(m)).astype(np.float32),
            (0.2 * rng.standard_normal((k, k, 1, m))).astype(np.float32),
            (0.3 * rng.standard_normal(m)).astype(np.float32))


# ----------------------------------------------------------------- kernel 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((2, 8, 10, 6, 24), 3), ((2, 8, 10, 6, 24), 5),
                                     ((1, 12, 16, 4, 16), 3), ((1, 12, 16, 4, 16), 5),
                                     ((1, 30, 8, 8, 32), 3)])
def test_kernel8_matches_pallas(shape, k, dtype):
    """JAX's tolerances in fp32 (y 1e-4, pool 1e-3). bf16: the expanded band
    is rounded at the same point on both sides, y within one bf16 ulp, the
    pool (fp32) within 1e-3."""
    x, we, be, wd, bd = _mbconv_case(np.random.default_rng(sum(shape) + k), *shape, k)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_pool = jax_mp.mbconv_expand_dw_pool(
        jnp.asarray(x, jdt), jnp.asarray(we, jdt), jnp.asarray(be), jnp.asarray(wd, jdt),
        jnp.asarray(bd), ksize=k, interpret=True)
    y, pool = kmb.mbconv_expand_dw_pool(_t(x, tdt), _t(we, tdt), _t(be), _t(wd, tdt), _t(bd), k)
    assert y.dtype == tdt and pool.dtype == torch.float32
    tol = (1e-4, 1e-4) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    _close(y, want_y, *tol)
    _close(pool, want_pool, 1e-3, 1e-3)


def _jax_unfused(x, we, be, wd, bd, k):
    """tests/test_mbconv_pallas.py's reference: JAX's unfused convs, which pin
    the Pallas kernel, for a shape it has no tile plan for (one pixel)."""
    e = jax.nn.silu(jax.lax.conv_general_dilated(
        x, we[None, None], (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")) + be)
    e = e.astype(x.dtype)
    y = jax.nn.silu(jax.lax.conv_general_dilated(
        e.astype(jnp.float32), wd.astype(x.dtype).astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=e.shape[-1]) + bd)
    return y.astype(x.dtype), jnp.sum(y, axis=(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,plan_edit", [
    ((2, 8, 10, 8, 24), 3, {}),  # k 3: two strips, segments of one group
    ((2, 8, 10, 8, 24), 5, {}),  # k 5
    ((1, 30, 8, 8, 32), 3, {"group_rows": 4, "seg_groups": 8}),  # H 30 over groups of 4
    ((1, 12, 40, 8, 16), 5, {}),  # W 40 over five strips
    ((1, 12, 16, 8, 80), 5, {"seg_groups": 3}),  # M 80: a ragged second slab; one segment
    ((1, 1, 1, 8, 8), 3, {}),  # one pixel
], ids=["k3", "k5", "H-ragged-groups", "W-strips", "M-ragged-slab", "one-pixel"])
def test_kernel8_decomposition_matches_pallas(shape, k, plan_edit, dtype):
    """``mbconv_by_plan``, kernel 8 as the CUDA kernel orders it (strips,
    segments and a ring of expanded row groups as ``mbconv_plan`` cuts them,
    or with the edits named, the pool's partials in the kernel's order),
    against the Pallas kernel in interpret mode at
    test_kernel8_matches_pallas's tolerances; one pixel, which the Pallas
    kernel has no tile plan for, against the unfused JAX convs that pin it."""
    b, h, w, cin, m = shape
    plan = dataclasses.replace(kmb.mbconv_plan(h, w, cin, m, k), **plan_edit)
    if plan_edit.get("group_rows"):
        assert h % plan.group_rows and plan.segments == 1
    if w == 40:
        assert plan.strips > 1
    if m == 80:
        assert m % kmb.SLAB and plan.slabs == 2 and plan.segments == 1
    x, we, be, wd, bd = _mbconv_case(np.random.default_rng(sum(shape) * k), *shape, k)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(we, jdt), jnp.asarray(be), jnp.asarray(wd, jdt),
             jnp.asarray(bd))
    if h * w == 1:
        want_y, want_pool = _jax_unfused(*jargs, k)
    else:
        want_y, want_pool = jax_mp.mbconv_expand_dw_pool(*jargs, ksize=k, interpret=True)
    y, pool = kmb.mbconv_by_plan(_t(x, tdt), _t(we, tdt), _t(be), _t(wd, tdt), _t(bd), k, plan)
    tol = (1e-4, 1e-4) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    _close(y, want_y, *tol)
    _close(pool, want_pool, 1e-3, 1e-3)


# B5's eight stride-1 shapes (H, W, Cin, M, k) and the card tests' kernel-8
# and kernel-9 shapes
PLAN_SHAPES = ([(h, w, cin, m, k) for h, w, k, cin, m, _ in MBCONV_SHAPES]
               + [(120, 160, 40, 240, 3), (15, 20, 304, 1824, 5), (17, 23, 24, 48, 5),
                  (9, 33, 512, 96, 3), (10, 10, 16, 56, 5), (1, 1, 8, 8, 3), (12, 50, 16, 64, 5),
                  (15, 20, 176, 1056, 5), (1, 37, 24, 96, 5), (12, 17, 40, 240, 3),
                  (7, 9, 24, 48, 5)])


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[str(s) for s in PLAN_SHAPES])
def test_mbconv_plan(shape, monkeypatch):
    """The plan fits the card (shared memory, wgmma's row tiles, TMA's box),
    its work items cover every (image, pixel, channel) once, its grid is one
    block an SM or fewer, and the wrapper launches it with the scratch it
    sizes."""
    h, w, cin, m, k = shape
    plan = kmb.mbconv_plan(h, w, cin, m, k)
    p = k // 2
    assert plan.smem == kmb.smem_bytes(k, plan.band_w, plan.group_rows, plan.kchunks, plan.stages)
    assert plan.smem <= 232448 and plan.stages in (2, 4)
    assert plan.mtiles <= kmb.MAX_MTILES and plan.group_rows >= 2 * p and plan.band_w <= 256
    cover = torch.zeros((h, w, m), dtype=torch.int32)
    for slab in range(plan.slabs):
        for unit in range(plan.partials):
            strip, seg = divmod(unit, plan.segments)
            r0 = seg * plan.seg_groups * plan.group_rows
            rows = slice(r0, min(h, r0 + plan.seg_groups * plan.group_rows))
            cols = slice(strip * plan.strip_w, min(w, (strip + 1) * plan.strip_w))
            cover[rows, cols, slab * kmb.SLAB:min(m, (slab + 1) * kmb.SLAB)] += 1
    assert bool((cover == 1).all())
    items = plan.slabs * 3 * plan.partials
    assert plan.work_items(3) == items and plan.grid(3, 132) == min(items, 132)

    calls = []

    class FakeLibrary:
        def objcavit_mbconv_head(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kmb, "load_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(
        cuda_stream=0))
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(
        tuple(a[0] if len(a) == 1 else a)) or empty(*a, **kw))
    x = torch.zeros((2, h, w, cin), dtype=torch.bfloat16)
    we = torch.zeros((cin, m), dtype=torch.bfloat16)
    wd = torch.zeros((k * k, m), dtype=torch.bfloat16)
    be, bd = torch.zeros(m), torch.zeros(m)
    kmb._launch(x, we, be, wd, bd, k, batch_minor=False)
    (args,) = calls
    assert args[20:27] == (1, plan.strip_w, plan.group_rows, plan.seg_groups, plan.grid(2),
                           plan.stages, plan.smem)
    scratch = kmb.pool_scratch(plan, 2)
    assert (args[6] is None) == (scratch is None) == (plan.partials == 1)
    assert allocated == [(2, h, w, m)] + ([scratch] if scratch else []) + [(2, m)]


@pytest.mark.parametrize("shape", [(8, 8, 4096, 64, 3), (8, 8, 64, 64, 7), (0, 8, 64, 64, 3)],
                         ids=["weight-slab-too-large", "k7", "no-rows"])
def test_mbconv_plan_raises_on_what_does_not_fit(shape):
    with pytest.raises(ValueError, match="mbconv_plan"):
        kmb.mbconv_plan(*shape)
    assert not kmb.mbconv_eligible(shape[2], shape[3], shape[4], 1) or shape[0] == 0


# ----------------------------------------------------------------- kernel 9


@pytest.mark.parametrize("shape,k", [((8, 8, 10, 6, 24), 3), ((8, 8, 10, 6, 24), 5),
                                     ((16, 12, 16, 4, 16), 3), ((16, 12, 16, 4, 16), 5)])
def test_kernel9_matches_pallas(shape, k):
    """(H, W, B, C) layout; JAX's tolerances (B a multiple of 8 for its plan)."""
    x, we, be, wd, bd = _mbconv_case(np.random.default_rng(sum(shape) * k), *shape, k)
    x_t = x.transpose(1, 2, 0, 3)
    want_y, want_pool = jax_mbconv_bs(*map(jnp.asarray, (x_t, we, be, wd, bd)), ksize=k,
                                      interpret=True)
    y, pool = kmb.mbconv_bs_expand_dw_pool(*map(_t, (x_t, we, be, wd, bd)), k)
    assert y.shape == (*x_t.shape[:3], shape[-1]) and y.is_contiguous()
    _close(y, want_y, 1e-4, 1e-4)
    _close(pool, want_pool, 1e-3, 1e-3)


# ---------------------------------------------------------------- kernel 10


@pytest.mark.parametrize("shape,k,with_pool,dtype", [
    ((2, 10, 12, 128), 3, True, "float32"),
    ((2, 8, 10, 256), 5, True, "float32"),
    ((1, 6, 8, 160), 3, True, "float32"),
    ((1, 6, 8, 128), 3, False, "float32"),
    ((1, 6, 8, 128), 3, True, "bfloat16"),
])
def test_kernel10_matches_pallas(shape, k, with_pool, dtype):
    """JAX's tolerances in fp32 (y 2e-5; pool 2e-4 relative, 2e-3); bf16 y
    within one bf16 ulp."""
    rng = np.random.default_rng(shape[-1] + k)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, k, 1, shape[-1])).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_pool = jax_dw_conv_silu_pool(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                              jnp.asarray(b), ksize=k, with_pool=with_pool,
                                              interpret=True)
    y, pool = kmb.dw_conv_silu_pool(_t(x, tdt), _t(w, tdt), _t(b), k, with_pool)
    _close(y, want_y, *((2e-5, 2e-5) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)))
    if with_pool:
        _close(pool, want_pool, 2e-4, 2e-3)
    else:
        assert pool is None and want_pool is None


DW_PLAN_SHAPES = ([(8, h, w, c, k) for h, w, k, c, _ in DW_CASES]
                  + [(1, 3, 2, 56, 3), (2, 15, 20, 160, 5), (2, 2, 30, 64, 5), (1, 1, 37, 64, 5)])


@pytest.mark.parametrize("with_pool", [True, False], ids=["pool", "no-pool"])
@pytest.mark.parametrize("shape", DW_PLAN_SHAPES, ids=[str(s) for s in DW_PLAN_SHAPES])
def test_dw_plan(shape, with_pool, monkeypatch):
    """Kernel 10's plan covers every (image, pixel, channel) once, by the C
    entry's order of the items (the part innermost, then the slab, then the
    image); its warps take the strip, its ring fits shared memory, its grid
    is at most the items; the wrapper passes it to the C entry, with pool
    scratch where the items do not each cover an image's slab."""
    b, h, w, c, k = shape
    plan = kmb.dw_plan(b, h, w, c, k, kmb.PLAN_SMS)
    cover = np.zeros((b, h, w, plan.slabs * kmb.SLAB), np.int64)
    for i in range(plan.items):
        part, rest = i % plan.parts, i // plan.parts
        img, slab = divmod(rest, plan.slabs)
        strip, seg = divmod(part, plan.segments)
        cover[img, seg * plan.seg_rows:(seg + 1) * plan.seg_rows,
              strip * plan.strip_w:(strip + 1) * plan.strip_w,
              slab * kmb.SLAB:(slab + 1) * kmb.SLAB] += 1
    assert (cover == 1).all()
    cols = kmb.DW_COLS[k]
    assert plan.strip_w == plan.warps * cols and 1 <= plan.warps <= kmb.DW_MAX_WARPS
    assert plan.strip_w - cols < w and 1 <= plan.seg_rows <= h
    assert 2 <= plan.stages <= kmb.DW_MAX_STAGES and plan.smem <= kmb.SMEM_LIMIT
    assert 1 <= plan.grid <= min(plan.items, kmb.DW_SM_WARPS * kmb.PLAN_SMS)

    calls = []

    class FakeLibrary:
        def objcavit_dw_silu_pool(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kmb, "load_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(
        cuda_stream=0))
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(
        tuple(a[0] if len(a) == 1 else a)) or empty(*a, **kw))
    x = torch.zeros((b, h, w, c), dtype=torch.bfloat16)
    y, pool = kmb._launch_dw(x, torch.zeros((k * k, c), dtype=torch.bfloat16), torch.zeros(c), k,
                             with_pool)
    (args,) = calls
    assert args[6:17] == (b, h, w, c, k, int(with_pool), plan.strip_w, plan.seg_rows, plan.warps,
                          plan.stages, plan.grid)
    scratch = kmb.dw_pool_scratch(plan)
    assert (scratch is None) == (plan.parts == 1)
    assert (args[4] is None) == (not with_pool or scratch is None)
    assert (pool is None) == (args[5] is None) == (not with_pool)
    want = [scratch] if with_pool and scratch else []
    assert allocated == want + ([(b, c)] if with_pool else [])
    assert y.shape == x.shape


@pytest.mark.parametrize("shape", [(8, 8, 10, 64, 7), (0, 8, 10, 64, 3), (1, 4, 4, 64, 3, 0)],
                         ids=["k7", "no-images", "no-SMs"])
def test_dw_plan_raises_on_what_it_cannot_plan(shape):
    with pytest.raises(ValueError, match="dw_plan"):
        kmb.dw_plan(*shape[:5], *(shape[5:] or (kmb.PLAN_SMS,)))


@pytest.mark.parametrize("shape,with_pool", [((0, 4, 4, 64), True), ((2, 0, 5, 64), True),
                                             ((2, 3, 0, 64), False)],
                         ids=["no-images", "no-rows", "no-columns-no-pool"])
def test_kernel10_launch_on_an_empty_x_calls_no_entry(shape, with_pool, monkeypatch):
    """An empty x has no work items (``dw_plan`` refuses it): the launch
    calls no C entry and returns an empty y and a zero pool, as the plain
    version does on an empty batch."""
    def no_library():
        raise AssertionError("an empty x reached the C entry")

    monkeypatch.setattr(kmb, "load_library", no_library)
    b, c = shape[0], shape[3]
    x = torch.zeros(shape, dtype=torch.bfloat16)
    y, pool = kmb._launch_dw(x, torch.zeros((9, c), dtype=torch.bfloat16), torch.zeros(c), 3,
                             with_pool)
    assert y.shape == x.shape and y.dtype == x.dtype
    if with_pool:
        assert pool.dtype == torch.float32 and torch.equal(pool, torch.zeros((b, c)))
    else:
        assert pool is None
    if b == 0:
        want_y, want_pool = kmb.dw_conv_silu_pool_plain(
            x, torch.zeros((3, 3, 1, c), dtype=torch.bfloat16), torch.zeros(c), 3, with_pool)
        assert want_y.shape == y.shape and torch.equal(want_pool, pool)


# ----------------------------------------------------------------- kernel 7


# kernel 7's plan at its seven B5 shapes, batch 8 (utils/resize_se_ab.py's
# SE_SHAPES): (H, W, M, O, skip) -> (nt, n_ct, mt, resident, bulk, stages,
# blocks an SM)
SE_PLANS = {
    (240, 320, 48, 24, False): (3, 1, 2, True, True, 2, 2),
    (240, 320, 24, 24, True): (3, 1, 2, True, True, 2, 2),
    (120, 160, 144, 40, False): (5, 1, 2, True, True, 2, 1),
    (60, 80, 240, 64, False): (8, 1, 2, False, False, 2, 3),
    (30, 40, 384, 128, False): (16, 1, 2, False, False, 2, 2),
    (15, 20, 1056, 304, False): (20, 2, 1, False, False, 2, 2),
    (15, 20, 3072, 512, True): (16, 4, 2, False, False, 2, 1),
}


@pytest.mark.parametrize("shape", list(SE_PLANS), ids=[str(s) for s in SE_PLANS])
def test_se_plan(shape):
    """Pinned: column tiles fitted to O (no tile all padding), the bulk
    route (W resident) at the narrow rows of 240x320 and 120x160, W streamed
    where keeping it would cost a block an SM, a ring of 2 stages, the
    shared memory within the card's and no 64 mt-row window touching more
    images than the gate holds."""
    h, w, m, o, with_skip = shape
    plan = kse.se_plan(8 * h * w, h * w, m, o, 8, with_skip)
    assert (plan.nt, plan.n_ct, plan.mt, plan.resident, plan.bulk, plan.stages,
            plan.blocks_per_sm) == SE_PLANS[shape]
    assert plan.bulk == (m <= kse.BULK_MAX_M)
    assert plan.nt in kse.NT_CHOICES and plan.n_ct * 8 * plan.nt >= o
    assert (plan.n_ct - 1) * 8 * plan.nt < o  # the last column tile holds real columns
    assert plan.smem <= kse.SMEM_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= kse.SM_SMEM
    assert plan.resident <= (m * o * 2 <= kse.RESIDENT_MAX and plan.n_ct == 1)
    tm = 64 * plan.mt
    assert plan.tiles == -(-8 * h * w // tm) * plan.n_ct
    spans = {(r0 + tm - 1) // (h * w) - r0 // (h * w) + 1 for r0 in range(0, 8 * h * w, tm)}
    assert max(spans) <= plan.g_imgs


@pytest.mark.parametrize("hw,b", [(1, 3), (5, 40), (25, 2), (300, 8), (63, 4), (64, 4)])
def test_se_plan_gate_box_covers_every_row_tile(hw, b):
    """At small images a row tile crosses many: the gate box holds them all."""
    plan = kse.se_plan(b * hw, hw, 48, 24, b)
    tm = 64 * plan.mt
    for r0 in range(0, b * hw, tm):
        last = min(r0 + tm, b * hw) - 1
        assert last // hw - r0 // hw + 1 <= plan.g_imgs <= b


@pytest.mark.parametrize("b,h,w,m,o,with_skip,dtype", [
    (2, 8, 16, 24, 24, True, "float32"),
    (2, 8, 16, 48, 16, False, "float32"),
    (1, 8, 16, 144, 40, True, "bfloat16"),
    (1, 8, 16, 144, 40, False, "bfloat16"),
])
def test_kernel7_matches_pallas(b, h, w, m, o, with_skip, dtype):
    """fp32 at JAX's 1e-5. bf16: the gate product and the rounding points
    are the same; the fp32 sum in another order may round the project one
    bf16 ulp apart, and the skip add rounds again: two ulps."""
    rng = np.random.default_rng(m + o)
    dw = rng.standard_normal((b, h, w, m)).astype(np.float32)
    gate = rng.uniform(0, 1, (b, m)).astype(np.float32)
    kern = (0.1 * rng.standard_normal((m, o))).astype(np.float32)
    bias = (0.01 * rng.standard_normal(o)).astype(np.float32)
    skip = rng.standard_normal((b, h, w, o)).astype(np.float32) if with_skip else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_sp.se_gate_project(jnp.asarray(dw, jdt), jnp.asarray(gate), jnp.asarray(kern, jdt),
                                  jnp.asarray(bias), None if skip is None else jnp.asarray(skip, jdt),
                                  interpret=True)
    got = kse.se_gate_project(_t(dw, tdt), _t(gate), _t(kern, tdt), _t(bias),
                              None if skip is None else _t(skip, tdt))
    assert got.dtype == tdt
    _close(got, want, *((1e-5, 1e-5) if dtype == "float32" else (2 * BF16_RTOL, 2 * BF16_RTOL)))


# ------------------------------------------------------------ the encoder


def _port_encoder(variables, **switches) -> EfficientNetEncoder:
    prefix = "dense_feature_extractor.encoder.original_model."
    enc = EfficientNetEncoder(ENC, **switches)
    enc.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in
                         state_dict_from_variables(variables, ENC).items() if k.startswith(prefix)})
    return fold_batchnorm(enc.eval())


@pytest.mark.parametrize("switches", [{"fused_mbconv_head": True}, {"se_project": True},
                                      {"fused_mbconv_head": True, "se_project": True}],
                         ids=["mbconv_head", "se_project", "both"])
def test_encoder_routes_match_jax(switches, monkeypatch):
    """Every level, at the tolerance of tests/test_mbconv_pallas.py's encoder
    test (2e-4); JAX's blocks reach its Pallas kernels (counted by wrapping
    them), the port's blocks take the routes listed."""
    variables = graphbins_variables()
    enc_vars = jax_fold_batchnorm({col: tree["dense_feature_extractor"]["encoder"]
                                   for col, tree in variables.items()})
    x = np.random.default_rng(3).standard_normal((2, *DIMS, 3)).astype(np.float32)
    reached = collections.Counter()
    for mod, name, kind in ((jax_mp, "mbconv_expand_dw_pool", "mbconv_head"),
                            (jax_sp, "se_gate_project", "se_project")):
        monkeypatch.setattr(mod, "INTERPRET", switches.get(
            "fused_mbconv_head" if kind == "mbconv_head" else "se_project", False))
        original = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=original, _k=kind, **kw:
                            reached.update([_k]) or _o(*a, **kw))
    jax_enc = JaxEncoder(ENC, fold_bn=True, fused_mbconv_head=switches.get("fused_mbconv_head",
                                                                           False))
    want = jax.jit(lambda v, a: jax_enc.apply(v, a, train=False))(enc_vars, jnp.asarray(x))
    port = _port_encoder(variables, **switches)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=f"encoder level {i}")
    routes = collections.Counter(port.block_routes())
    if switches.get("fused_mbconv_head"):
        assert reached["mbconv_head"] >= 1  # stage 4's 4x6 map has a JAX tile plan
        assert routes["mbconv_head"] == 2  # the two stride-1 MBConv blocks
    if switches.get("se_project"):
        assert reached["se_project"] >= 1
        assert routes["se_project"] == (5 if switches.get("fused_mbconv_head") else 7)


def test_graphbins_kernel_route_matches_jax(monkeypatch):
    """The tiny GraphBins, folded, fp32, on ``encoder_impl="kernel"``: depth
    within the slice tests' 1e-3 of JAX's GraphBins with kernel 7 on."""
    variables = graphbins_variables()
    rng = np.random.default_rng(17)
    img = (0.5 * rng.standard_normal((2, *DIMS, 3))).astype(np.float32)
    feats = rng.standard_normal((2, N_OBJ, 512)).astype(np.float32)
    xywh = np.stack([rng.uniform(0, 96, (2, N_OBJ)), rng.uniform(0, 64, (2, N_OBJ)),
                     rng.uniform(4, 40, (2, N_OBJ)), rng.uniform(4, 40, (2, N_OBJ))],
                    -1).astype(np.float32)
    valid = np.array([[True, True, True, False], [True, False, False, False]])
    monkeypatch.setattr(jax_sp, "INTERPRET", True)
    jmodel = jax_graphbins().clone(fold_bn=True)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        jax_fold_batchnorm(variables), *map(jnp.asarray, (img, feats, xywh, valid)))
    model = GraphBins(encoder_name=ENC, n_bins=16, n_queries=5, encoder_impl="kernel")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_variables(variables, ENC).items()})
    fold_batchnorm(model.eval())
    assert model.encoder_impl == "kernel"
    routes = model.dense_feature_extractor.encoder["original_model"].block_routes()
    assert collections.Counter(routes) == {"mbconv_head": 2, "se_project": 5}
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, feats, xywh, valid)))
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ routes and refusals


@pytest.mark.parametrize("switches,want", [
    ({"fused_mbconv_head": True, "se_project": True}, {"mbconv_head": 32, "se_project": 7}),
    ({"se_project": True}, {"se_project": 39}),
    ({"fused_mbconv_head": True}, {"mbconv_head": 32, "plain": 7}),
    ({}, {"plain": 39}),
], ids=["kernel", "se_project", "mbconv_head", "plain"])
def test_b5_routes(switches, want):
    """B5's 39 blocks: the 32 stride-1 MBConvs take kernel 8, the three
    DepthwiseSeparables and the four stride-2 first blocks kernel 7; no
    block takes a fused route unfolded or in training mode."""
    enc = EfficientNetEncoder("efficientnet-b5", **switches)
    assert collections.Counter(enc.eval().block_routes()) == {"plain": 39}  # not folded
    fold_batchnorm(enc)
    assert collections.Counter(enc.block_routes()) == want
    assert set(enc.train().block_routes()) == {"plain"}


def test_flagship_names_its_encoder_route():
    """The flagship builders pass ``encoder_impl`` down; the default route
    takes neither kernel."""
    for impl, want in (("plain", {"plain": 39}), ("kernel", {"mbconv_head": 32, "se_project": 7})):
        model = build_flagship_model(device="cpu", encoder_impl=impl, dtype=torch.float32)
        assert model.encoder_impl == impl
        enc = model.dense_feature_extractor.encoder["original_model"]
        assert collections.Counter(enc.block_routes()) == want
    with pytest.raises(ValueError, match="encoder_impl"):
        GraphBins(encoder_name=ENC, encoder_impl="pallas")


def test_tiny_bf16_forward_records_each_fused_call():
    """A bf16 forward on the kernel route calls kernels 8 and 7 once per
    block on their routes (their plain versions on the CPU), each output
    within the error check chip_smoke.py applies; the plain route calls
    neither."""
    calls = {}
    for impl in ("plain", "kernel"):
        model = build_flagship_model(device="cpu", encoder_name=ENC, n_bins=16, n_queries=5,
                                     encoder_impl=impl)
        img = torch.from_numpy(np.random.default_rng(2).standard_normal((2, *DIMS, 3))
                               .astype(np.float32))
        objs = (torch.zeros(2, N_OBJ, 512), torch.full((2, N_OBJ, 4), -1.0),
                torch.tensor([[True] + [False] * (N_OBJ - 1)] * 2))
        with torch.no_grad(), record_encoder_kernel_io() as records:
            depth = model(img, *objs)["depth_pred"]
        assert torch.isfinite(depth).all()
        calls[impl] = collections.Counter(r["kind"] for r in records)
        for rec in records:
            if rec["kind"] == "mbconv_head":
                errs = mbconv_head_errors(*rec["args"], *rec["out"], BF16_RTOL, BF16_ATOL, 1e-4)
            else:
                errs = se_project_errors(*rec["args"], rec["out"], BF16_RTOL, BF16_ATOL)
            assert errs["bad"] == 0, errs
    assert calls == {"plain": {}, "kernel": {"mbconv_head": 2, "se_project": 5}}


def test_error_checks_catch_a_wrong_kernel():
    """The checks pass the plain version's own output and fail one with the
    halo ring left at silu(be) (kernel 8), a lost tile of the pool, or a
    project off by 1% (kernel 7)."""
    rng = np.random.default_rng(4)
    x, we, be, wd, bd = (_t(a, torch.bfloat16 if i in (0, 1, 3) else torch.float32) for i, a in
                         enumerate(_mbconv_case(rng, 2, 12, 20, 16, 48, 3, be_scale=3.0)))
    y, pool = kmb.mbconv_expand_dw_pool_plain(x, we, be, wd, bd, 3)
    check = lambda yy, pp: mbconv_head_errors(x, we, be, wd, bd, 3, yy, pp, BF16_RTOL,  # noqa: E731
                                              BF16_ATOL, 1e-4)["bad"]
    assert check(y, pool) == 0
    # the halo left unzeroed: the expand of the zero padding is silu(be)
    x_pad = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    band = F.silu(x_pad @ we.float() + be).to(torch.bfloat16)
    z = F.conv2d(band.float().permute(0, 3, 1, 2), wd.float().reshape(9, 48).t().reshape(48, 1, 3, 3),
                 groups=48)
    bad_y = F.silu(z + bd[:, None, None]).permute(0, 2, 3, 1)
    assert check(bad_y.to(torch.bfloat16), bad_y.sum((1, 2))) > 0
    lost = pool.clone()
    lost[0] -= y[0, :8, :16].float().sum((0, 1))  # one 8x16 tile's share
    assert check(y, lost) > 0

    dw = _t(rng.standard_normal((2, 15, 20, 48)), torch.bfloat16)
    gate = _t(rng.uniform(0, 1, (2, 48)), torch.bfloat16)
    kern = _t(0.1 * rng.standard_normal((48, 24)), torch.bfloat16)
    bias = _t(rng.standard_normal(24))
    skip = _t(rng.standard_normal((2, 15, 20, 24)), torch.bfloat16)
    out = kse.se_gate_project_plain(dw, gate, kern, bias, skip)
    assert se_project_errors(dw, gate, kern, bias, skip, out, BF16_RTOL, BF16_ATOL)["bad"] == 0
    wrong = kse.se_gate_project_plain(dw, gate, kern * 1.01, bias, skip)
    assert se_project_errors(dw, gate, kern, bias, skip, wrong, BF16_RTOL, BF16_ATOL)["bad"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("switch,name", [("fused_mbconv_head", "mbconv_expand_dw_pool"),
                                         ("se_project", "se_gate_project")])
def test_fused_blocks_call_the_plain_version_only_in_fp32(monkeypatch, switch, name, dtype):
    """fp32 is the reference route and calls the plain version; any other
    dtype calls the kernel's wrapper, which launches on bf16 CUDA tensors and
    raises on the rest (on the CPU it runs the plain version)."""
    called = []
    for fn_name in (name, f"{name}_plain"):
        fn = getattr(common, fn_name)
        monkeypatch.setattr(common, fn_name,
                            lambda *a, _fn=fn, _n=fn_name: called.append(_n) or _fn(*a))
    block = fold_batchnorm(common.MBConv(16, 16, 6, 3, 1, **{switch: True}).eval()).to(dtype)
    assert block.route() == switch.replace("fused_", "")
    with torch.no_grad():
        out = block(torch.randn((1, 16, 8, 8)).to(dtype))
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert called == [f"{name}_plain" if dtype == torch.float32 else name]


def test_wrappers_and_blocks_refuse_what_they_cannot_do():
    """Forward-only: the wrappers raise under autograd (on the CPU too), as
    does a block on a fused route; a skip of another dtype raises, as in
    JAX. Packed weights are made once and remade after an in-place edit."""
    x = torch.zeros(1, 4, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        kmb.mbconv_expand_dw_pool(x, torch.zeros(8, 16), torch.zeros(16), torch.zeros(3, 3, 1, 16),
                                  torch.zeros(16), 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        kmb.dw_conv_silu_pool(x, torch.zeros(3, 3, 1, 8), torch.zeros(8), 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        kse.se_gate_project(x, torch.zeros(1, 8), torch.zeros(8, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="skip dtype"):
        kse.se_gate_project(torch.zeros(1, 2, 2, 8), torch.zeros(1, 8), torch.zeros(8, 8),
                            torch.zeros(8), torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16))
    block = fold_batchnorm(common.MBConv(8, 8, 2, 3, 1, fused_mbconv_head=True).eval())
    assert block.route() == "mbconv_head"
    with pytest.raises(RuntimeError, match="forward-only"):
        block(torch.zeros(1, 8, 4, 4))  # grad mode on, the weights require grad
    with torch.no_grad():
        block(torch.zeros(1, 8, 4, 4))
        first = block.packed("head", kmb.pack_mbconv, block.conv_pw.weight, block.conv_pw.bias,
                             block.conv_dw.weight, block.conv_dw.bias)
        block(torch.zeros(1, 8, 4, 4))
        assert block.packed("head", None, block.conv_pw.weight, block.conv_pw.bias,
                            block.conv_dw.weight, block.conv_dw.bias) is first
        block.conv_dw.weight.mul_(2.0)
        again = block.packed("head", kmb.pack_mbconv, block.conv_pw.weight, block.conv_pw.bias,
                             block.conv_dw.weight, block.conv_dw.bias)
    assert again is not first and torch.equal(again.wd, 2.0 * first.wd)
