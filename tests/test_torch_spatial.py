"""Spatial serving's pieces in one process (objcavit_torch.parallel.spatial).

The band plan; the two kernel forms it adds, whose plain versions are held
against the JAX Pallas kernels in interpret mode as the JAX package's own
tests run them: kernel 1's row window (rows [y0, y1) of
``resize_bilinear_pallas`` on the whole input, beside a band of the skip)
and kernel 8's halo form (a band and its halo rows through
``mbconv_expand_dw_pool``: the band's rows of y and the band's share of the
pool); and that outside a split forward every module gives the bits it
gave before. The distributed cases run in tests/test_torch_tp.py's
launches. Each comparison states its tolerance.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from objcavit_tpu.ops import mbconv_pallas as jax_mp
from objcavit_tpu.ops import resize_pallas as rp

from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.common import Conv2d, Conv2dSame, SqueezeExcite, SqueezeExcitation
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.parallel import spatial
from objcavit_torch.parallel.mesh import ProcessGrid
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.utils.benchkit import init_weights_
from objcavit_torch.utils.fold_bn import fold_batchnorm
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (an autouse fixture)

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5  # one bf16 ulp, as tests/test_torch_mbconv.py


@pytest.mark.parametrize("height,n_model,units,reason", [
    (480, 2, (8, 7), None),
    (96, 2, (2, 1), None),
    (128, 4, (1, 1, 1, 1), None),
    (352, 3, (4, 4, 3), None),
    (64, 1, (), "the grid has one model rank"),
    (100, 2, (), "100 rows are not a whole number of 32-row units"),
    (96, 4, (), "96 rows are 3 of 32-row units, fewer than 4 model ranks"),
])
def test_band_plan(height, n_model, units, reason):
    """Units of 32 rows, the first ranks one more where they do not divide;
    each rank's rows at every stride; a plan that does not split says why
    and gives every rank the whole image."""
    plan = spatial.band_plan(height, ProcessGrid(1, n_model, model_index=n_model - 1))
    assert (plan.units, plan.reason, plan.split) == (units, reason, bool(units))
    bands = plan.bands()
    if not units:
        assert bands == [(0, height)] * n_model
        return
    assert bands[0][0] == 0 and bands[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    for stride in (1, 2, 4, 8, 16, 32):
        at = plan.bands(stride)
        assert at == [(lo // stride, hi // stride) for lo, hi in bands]
        rows = at[-1][1] - at[-1][0]
        assert plan.level(rows) == (stride, at)
    if height == 480:
        assert bands == [(0, 256), (256, 480)]


# (B, Hi, Wi, C, Ho, Wo, Cs, windows): a stage the Pallas kernel takes
# (C % 128 == 0) and a ratio that is not 2, cut into three bands of output
# rows, one of them a single row
WINDOW_CASE = (2, 7, 9, 128, 15, 20, 8, [(0, 8), (8, 9), (9, 15)])


def test_kernel1_window_plain_matches_pallas():
    """fp32 through the row-window wrapper on the CPU (its plain version):
    each window's upsample slice against rows [y0, y1) of the Pallas kernel
    on the whole input in interpret mode, at tests/test_resize_pallas.py's
    1e-5; the skip slice is the skip's band, bit for bit; the windows join
    into the whole-image plain version's bits; bf16 alike, the bare form
    too; nothing counted on the CPU."""
    b, hi, wi, c, ho, wo, cs, windows = WINDOW_CASE
    rng = np.random.default_rng(hi)
    x = rng.standard_normal((b, hi, wi, c)).astype(np.float32)
    skip = rng.standard_normal((b, ho, wo, cs)).astype(np.float32)
    assert rp.resize_eligible(hi, wi, c, ho, wo)
    want = np.asarray(rp.resize_bilinear_pallas(jnp.asarray(x), ho, wo, interpret=True))
    before = kresize.resize_bilinear_align_corners_rows.launches
    for dtype in (torch.float32, torch.bfloat16):
        xt, st = torch.from_numpy(x).to(dtype), torch.from_numpy(skip).to(dtype)
        whole = kresize.resize_bilinear_align_corners_plain(xt, ho, wo)
        parts = []
        for y0, y1 in windows:
            got = kresize.resize_bilinear_align_corners_rows(xt, ho, wo, y0, y1, st[:, y0:y1])
            assert got.shape == (b, y1 - y0, wo, c + cs) and got.dtype == dtype
            assert torch.equal(got[..., c:], st[:, y0:y1])
            bare = kresize.resize_bilinear_align_corners_rows(xt, ho, wo, y0, y1)
            assert torch.equal(bare, got[..., :c])
            if dtype == torch.float32:
                np.testing.assert_allclose(got[..., :c].numpy(), want[:, y0:y1], rtol=1e-5,
                                           atol=1e-5)
            parts.append(bare)
        assert torch.equal(torch.cat(parts, 1), whole)
    assert kresize.resize_bilinear_align_corners_rows.launches == before


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("k,dtype", [(3, "float32"), (5, "bfloat16")])
def test_kernel8_halo_form_plain_matches_pallas(k, dtype):
    """A 12-row image cut into bands of 5, 1 and 6 rows, each with the
    k // 2 halo rows that lie in the image, through kernel 8's halo form
    (its plain version on the CPU): the band's rows of y against the Pallas
    kernel's y on the whole image (interpret mode; JAX's 1e-4 in fp32, one
    bf16 ulp in bf16), the band's pool against the sum of the Pallas y's
    band rows (1e-3; in bf16 that y is rounded, so one bf16 ulp of each
    term more), and the bands' pools summing to the Pallas pool (1e-3)."""
    b, h, w, cin, m = 2, 12, 16, 8, 16
    rng = np.random.default_rng(k)
    x, we, be, wd, bd = (rng.standard_normal((b, h, w, cin)).astype(np.float32),
                         (0.2 * rng.standard_normal((cin, m))).astype(np.float32),
                         (0.3 * rng.standard_normal(m)).astype(np.float32),
                         (0.2 * rng.standard_normal((k, k, 1, m))).astype(np.float32),
                         (0.3 * rng.standard_normal(m)).astype(np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_pool = (np.asarray(a, np.float32) for a in jax_mp.mbconv_expand_dw_pool(
        jnp.asarray(x, jdt), jnp.asarray(we, jdt), jnp.asarray(be), jnp.asarray(wd, jdt),
        jnp.asarray(bd), ksize=k, interpret=True))
    p = k // 2
    tol = (1e-4, 1e-4) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    pools, before = [], kmb.mbconv_expand_dw_pool_rows.launches
    for lo, hi in ((0, 5), (5, 6), (6, 12)):
        a, z = max(lo - p, 0), min(hi + p, h)
        y, pool = kmb.mbconv_expand_dw_pool_rows(_t(x[:, a:z], tdt), _t(we, tdt), _t(be),
                                                 _t(wd, tdt), _t(bd), k, lo - a, z - hi)
        assert y.shape == (b, hi - lo, w, m) and y.dtype == tdt and pool.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(), want_y[:, lo:hi], rtol=tol[0], atol=tol[1])
        share = want_y[:, lo:hi].sum((1, 2))
        slack = 1e-3 if dtype == "float32" else 1e-3 + BF16_RTOL * np.abs(
            want_y[:, lo:hi]).sum((1, 2))
        np.testing.assert_array_less(np.abs(pool.numpy() - share), slack + 1e-3 * np.abs(share))
        pools.append(pool)
    np.testing.assert_allclose(sum(pools).numpy(), want_pool, rtol=1e-3, atol=1e-3)
    assert kmb.mbconv_expand_dw_pool_rows.launches == before


def _conv2d_same_before(conv: Conv2dSame, x: torch.Tensor) -> torch.Tensor:
    """Conv2dSame's forward as it was before spatial serving."""
    ih, iw = x.shape[-2:]
    kh, kw = conv.weight.shape[-2:]
    sh, sw = conv.stride
    ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
    pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
    if ph % 2 == 0 and pw % 2 == 0:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, (ph // 2, pw // 2),
                        conv.dilation, conv.groups)
    x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, 0, conv.dilation, conv.groups)


def test_outside_a_split_forward_every_module_gives_the_same_bits():
    """No plan active: ``Conv2d`` is ``nn.Conv2d``, ``Conv2dSame`` its old
    forward, the SE blocks the plain spatial mean, bit for bit; a spatial
    server whose plan does not split (no grid) serves the tiny GraphBins on
    kernels 7 and 8's encoder route and the tiny AdaBins on the plain one
    with the bits of a server that is not spatial, and its plan says why."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 13, 11), generator=gen).contiguous(memory_format=torch.channels_last)
    assert spatial.active() is None
    for k, s, groups in ((3, 1, 1), (3, 2, 8), (5, 2, 8), (1, 1, 1)):
        conv = Conv2d(8, 8, k, s, k // 2, groups=groups)
        assert torch.equal(conv(x), nn.Conv2d.forward(conv, x))
        same = Conv2dSame(8, 8, k, s, groups=groups)
        assert torch.equal(same(x), _conv2d_same_before(same, x))
    se, sev2 = SqueezeExcite(8, 2), SqueezeExcitation(8, 2)
    gate = torch.sigmoid(se.conv_expand(F.silu(se.conv_reduce(x.mean((2, 3), keepdim=True)))))
    assert torch.equal(se(x), x * gate)
    gate = torch.sigmoid(sev2.fc2(F.silu(sev2.fc1(x.mean((2, 3), keepdim=True)))))
    assert torch.equal(sev2(x), x * gate)
    frames = np.random.default_rng(2).integers(0, 256, (1, 64, 96, 3)).astype(np.uint8)
    for model in (GraphBins(encoder_name="efficientnet-tiny", n_bins=16, n_queries=5,
                            encoder_impl="kernel"),
                  AdaBins(encoder_name="efficientnet-tiny", n_bins=16, n_queries=5)):
        model = fold_batchnorm(init_weights_(model, torch.Generator().manual_seed(1)).eval())
        want = DepthPipeline(model, eval_dims=(64, 96), n_obj_max=3)(frames)
        pipe = DepthPipeline(model, eval_dims=(64, 96), n_obj_max=3, spatial=True)
        assert pipe.bands().reason == "the server has no grid"
        assert torch.equal(pipe(frames), want)
