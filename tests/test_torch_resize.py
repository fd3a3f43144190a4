"""Kernel 1's concat form and its tiling, on the CPU.

``resize_bilinear_align_corners_into_concat`` writes the decoder's concat
buffer: the align_corners upsample of x in the first channels and the skip
in the rest. Here its wrapper runs the plain version (the tensors lie on the
CPU), held against the JAX package's resize (its einsum reference and the
Pallas kernel in interpret mode, as tests/test_resize_pallas.py runs it)
concatenated with the skip. ``resize_plan`` (the kernel's slices, strips and
bands) is pinned at the decoder's shapes, and a NumPy twin of the kernel's
loop (its row-slot ring, strips and bands, csrc/resize_bilinear.cu) is held
against the plain version, down-sampling included. The CUDA kernel itself
runs in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.models.decoder import UpSampleWithSkip as JaxUpSampleWithSkip
from objcavit_tpu.ops import resize_pallas as rp
from objcavit_tpu.ops.resize import resize_bilinear as jax_resize_bilinear

from objcavit_torch.kernels import resize as kresize
from objcavit_torch.models.decoder import UpSampleWithSkip
from objcavit_torch.ops.resize import interp_taps
from objcavit_torch.utils.fold_bn import fold_batchnorm

RNG = np.random.default_rng(10)

# (B, Hi, Wi, C, Ho, Wo, Cs): a 2x stage with the B5 decoder's skip width
# 24, a non-2x ratio with Cs = 8, up1's odd 17x22 -> 30x40, and a stage the
# Pallas kernel takes (C % 128 == 0)
CONCAT_SHAPES = [
    (2, 8, 10, 32, 16, 20, 24),
    (1, 7, 9, 16, 12, 20, 8),
    (1, 17, 22, 64, 30, 40, 16),
    (2, 8, 16, 128, 16, 32, 24),
]


@pytest.mark.parametrize("shape", CONCAT_SHAPES)
def test_concat_plain_matches_jax_resize_and_pallas(shape):
    """fp32 through the wrapper on the CPU: the upsample slice at the
    tolerance of tests/test_resize_pallas.py (1e-5), against JAX's einsum
    resize and, where resize_eligible admits the shape, its Pallas kernel;
    the skip slice equal to the skip."""
    b, hi, wi, c, ho, wo, cs = shape
    x = RNG.standard_normal((b, hi, wi, c)).astype(np.float32)
    skip = RNG.standard_normal((b, ho, wo, cs)).astype(np.float32)
    got = kresize.resize_bilinear_align_corners_into_concat(
        torch.from_numpy(x), torch.from_numpy(skip)).numpy()
    assert got.shape == (b, ho, wo, c + cs)
    wants = [jax_resize_bilinear(jnp.asarray(x), ho, wo, align_corners=True)]
    if rp.resize_eligible(hi, wi, c, ho, wo):
        wants.append(rp.resize_bilinear_pallas(jnp.asarray(x), ho, wo, interpret=True))
    assert len(wants) == 1 + (c % 128 == 0)
    for want in wants:
        np.testing.assert_allclose(got, np.concatenate([np.asarray(want), skip], -1),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., c:], skip)


def test_concat_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    x = torch.from_numpy(RNG.standard_normal((2, 5, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    skip = torch.from_numpy(RNG.standard_normal((2, 9, 11, 8)).astype(np.float32)).to(torch.bfloat16)
    before = kresize.resize_bilinear_align_corners.launches
    got = kresize.resize_bilinear_align_corners_into_concat(x, skip)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 11, 24)
    assert torch.equal(got[..., :16], kresize.resize_bilinear_align_corners_plain(x, 9, 11))
    assert torch.equal(got[..., 16:].view(torch.int16), skip.view(torch.int16))
    assert torch.equal(got, kresize.resize_into_concat_plain(x, skip))
    assert kresize.resize_bilinear_align_corners.launches == before


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: (torch.zeros(1, 4, 4, 16), _bf16(1, 8, 8, 8)), "bfloat16"),
        (lambda: (_bf16(1, 4, 4, 16), torch.zeros(1, 8, 8, 8)), "bfloat16 skip"),
        (lambda: (_bf16(2, 4, 4, 16), _bf16(1, 8, 8, 8)), "batch"),
        (lambda: (_bf16(1, 4, 4, 16), _bf16(8, 8, 8)), "NHWC"),
        (lambda: (_bf16(1, 4, 4, 16), _bf16(1, 0, 8, 8)), "non-empty"),
        (lambda: (_bf16(1, 4, 4, 12), _bf16(1, 8, 8, 8)), "C % 8"),
        (lambda: (_bf16(1, 4, 4, 16), _bf16(1, 8, 8, 12)), "Cs % 8"),
        (lambda: (_bf16(1, 4, 4, 16), _bf16(1, 8, 16, 8).transpose(1, 2)), "contiguous"),
    ],
    ids=["fp32", "skip-fp32", "batch", "skip-3-d", "skip-empty", "channels", "skip-channels",
         "skip-strided"],
)
def test_concat_kernel_checks_reject(make, match):
    with pytest.raises(ValueError, match=match):
        kresize.check_concat_inputs(*make())


def test_concat_wrapper_rejects_other_devices():
    x, skip = _bf16(1, 2, 2, 8).to("meta"), _bf16(1, 4, 4, 8).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        kresize.resize_bilinear_align_corners_into_concat(x, skip)
    with pytest.raises(RuntimeError, match="forward-only"):
        kresize.resize_bilinear_align_corners_into_concat(
            _bf16(1, 2, 2, 8).requires_grad_(), _bf16(1, 4, 4, 8))


# (Hi, Wi, C, Ho, Wo, Cs) -> (slice_c, strip_w, strips, cols): the
# flagship's four upsamples at 480x640 with their skips, then KITTI
# 352x1216's; Cs = 0 is the bare form
PLANS = {
    (17, 22, 2048, 30, 40, 176): (256, 20, 2, 12),
    (17, 22, 2048, 30, 40, 0): (256, 20, 2, 12),
    (30, 40, 1024, 60, 80, 64): (256, 27, 3, 15),
    (30, 40, 1024, 60, 80, 0): (256, 27, 3, 15),
    (60, 80, 512, 120, 160, 40): (256, 27, 6, 15),
    (60, 80, 512, 120, 160, 0): (256, 32, 5, 18),
    (120, 160, 256, 240, 320, 24): (256, 27, 12, 15),
    (120, 160, 256, 240, 320, 0): (256, 32, 10, 18),
    (13, 40, 2048, 22, 76, 176): (256, 26, 3, 15),
    (13, 40, 2048, 22, 76, 0): (256, 26, 3, 15),
    (22, 76, 1024, 44, 152, 64): (256, 31, 5, 17),
    (22, 76, 1024, 44, 152, 0): (256, 31, 5, 17),
    (44, 152, 512, 88, 304, 40): (256, 28, 11, 16),
    (44, 152, 512, 88, 304, 0): (256, 31, 10, 17),
    (88, 304, 256, 176, 608, 24): (256, 29, 21, 16),
    (88, 304, 256, 176, 608, 0): (256, 32, 19, 18),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_resize_plan(shape):
    """Pinned at the decoder's shapes: 4-row bands, 256-channel slices, the
    fewest even strips within a block's shared-memory budget (four blocks
    an SM), and no strip reading more input columns than the block holds."""
    hi, wi, c, ho, wo, cs = shape
    plan = kresize.resize_plan(*shape)
    assert (plan.slice_c, plan.strip_w, plan.strips, plan.cols) == PLANS[shape]
    assert plan.band_rows == kresize.BAND_ROWS
    assert plan.smem == kresize.smem_bytes(plan.slice_c, plan.cols, plan.strip_w, c, cs)
    assert plan.smem <= kresize.SMEM_BUDGET and 4 * (plan.smem + 1024) <= 228 * 1024
    lo, hi_tap, _ = interp_taps(wi, wo, True)
    for s in range(plan.strips):
        ox0, ox1 = s * plan.strip_w, min((s + 1) * plan.strip_w, wo)
        assert hi_tap[ox1 - 1] - lo[ox0] + 1 <= plan.cols


def _kernel_twin(x: np.ndarray, skip, plan: kresize.ResizePlan) -> np.ndarray:
    """csrc/resize_bilinear.cu's loop in NumPy: per (image, band, strip)
    block (the slices' blocks do the same on their channels) the input rows
    pass through kresize.SLOTS tagged slots, claimed as the kernel claims
    them (the next row's rows load into slots this row does not read), each
    H-lerped row is made from the slots, the W lerp from it, and the strip's
    skip row copied beside it. Asserts that no slot a row reads was refilled
    and that no strip reads past its shared row."""
    b, hi, wi, c = x.shape
    ho, wo, cs = skip.shape[1:]
    y = np.full((b, ho, wo, c + cs), np.nan, np.float32)
    h_lo, h_hi, h_fr = interp_taps(hi, ho, True)
    w_lo, w_hi, w_fr = interp_taps(wi, wo, True)

    def claim(tag, r, busy):
        if r in tag:
            return tag.index(r), False
        s = min(i for i in range(kresize.SLOTS) if i not in busy)
        tag[s] = r
        return s, True

    for bi in range(b):
        for oy0 in range(0, ho, plan.band_rows):
            oy1 = min(oy0 + plan.band_rows, ho)
            for strip in range(plan.strips):
                ox0 = strip * plan.strip_w
                nox = min(plan.strip_w, wo - ox0)
                ix0 = w_lo[ox0]
                ncol = w_hi[ox0 + nox - 1] - ix0 + 1
                assert ncol <= plan.cols
                raw = np.zeros((kresize.SLOTS, ncol, c), np.float32)
                tag = [-1] * kresize.SLOTS
                s0, new = claim(tag, h_lo[oy0], ())
                if new:
                    raw[s0] = x[bi, h_lo[oy0], ix0:ix0 + ncol]
                s1, new = claim(tag, h_hi[oy0], (s0,))
                if new:
                    raw[s1] = x[bi, h_hi[oy0], ix0:ix0 + ncol]
                lo, hi_ = w_lo[ox0:ox0 + nox] - ix0, w_hi[ox0:ox0 + nox] - ix0
                fx = w_fr[ox0:ox0 + nox, None]
                for oy in range(oy0, oy1):
                    n0, n1 = s0, s1
                    if oy + 1 < oy1:
                        n0, new = claim(tag, h_lo[oy + 1], (s0, s1))
                        assert not new or n0 not in (s0, s1)
                        if new:
                            raw[n0] = x[bi, h_lo[oy + 1], ix0:ix0 + ncol]
                        n1, new = claim(tag, h_hi[oy + 1], (s0, s1, n0))
                        assert not new or n1 not in (s0, s1, n0)
                        if new:
                            raw[n1] = x[bi, h_hi[oy + 1], ix0:ix0 + ncol]
                    # this row's slots still hold its rows
                    assert tag[s0] == h_lo[oy] and tag[s1] == h_hi[oy]
                    np.testing.assert_array_equal(raw[s0], x[bi, h_lo[oy], ix0:ix0 + ncol])
                    np.testing.assert_array_equal(raw[s1], x[bi, h_hi[oy], ix0:ix0 + ncol])
                    fy = h_fr[oy]
                    hrow = raw[s0] * (np.float32(1) - fy) + raw[s1] * fy
                    y[bi, oy, ox0:ox0 + nox, :c] = hrow[lo] * (np.float32(1) - fx) + hrow[hi_] * fx
                    y[bi, oy, ox0:ox0 + nox, c:] = skip[bi, oy, ox0:ox0 + nox]
                    s0, s1 = n0, n1
    return y


@pytest.mark.parametrize("shape", [
    (1, 17, 22, 16, 30, 40, 8),  # up1's ratio
    (2, 5, 7, 8, 19, 30, 8),  # 3-4x up
    (1, 21, 30, 8, 9, 11, 16),  # down in both: rows skip, two fresh slots a step
    (1, 9, 4, 24, 2, 11, 8),  # down in H, up in W
    (1, 1, 1, 8, 3, 5, 8),  # single input pixel: both taps one row
    (1, 6, 300, 64, 13, 500, 8),  # wide: several strips
])
def test_kernel_twin_matches_plain(shape):
    """The kernel's data flow (bands, strips, slots) gives the plain
    version's values, fp32 at 1e-6."""
    b, hi, wi, c, ho, wo, cs = shape
    x = RNG.standard_normal((b, hi, wi, c)).astype(np.float32)
    skip = RNG.standard_normal((b, ho, wo, cs)).astype(np.float32)
    plan = kresize.resize_plan(hi, wi, c, ho, wo, cs)
    if wo >= 500:
        assert plan.strips > 1
    got = _kernel_twin(x, skip, plan)
    want = kresize.resize_into_concat_plain(torch.from_numpy(x), torch.from_numpy(skip)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_upsample_with_skip_bf16_eval_matches_jax():
    """The decoder's up-stage in bf16 eval (BN folded), the port's concat
    route against JAX's UpSampleWithSkip on its Pallas resize (interpret
    mode) and on its einsum resize, same weights. Both JAX routes round the
    resize's H pass to bf16 before the W pass (or use bf16 interpolation
    weights) and feed bf16 convs; the port lerps in fp32 and rounds once.
    The gap is that rounding through two bf16 3x3 convs: measured max
    0.0039 (one bf16 ulp at the outputs' top) and mean 0.00034 on outputs
    of std 0.107, on both JAX routes; the bounds are about five times
    those: max 0.02, mean 0.002."""
    cx, cs, out = 128, 24, 64
    x = RNG.standard_normal((1, 8, 16, cx)).astype(np.float32)
    skip = RNG.standard_normal((1, 16, 32, cs)).astype(np.float32)
    jm = JaxUpSampleWithSkip(out, fold_bn=True, dtype=jnp.bfloat16)
    xb, sb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(skip, jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(0), xb, sb, False)
    params = jax.tree.map(np.asarray, variables["params"])
    wants = [np.asarray(jm.apply(variables, xb, sb, False), np.float32)]
    rp.INTERPRET = True
    try:
        wants.append(np.asarray(jm.apply(variables, xb, sb, False), np.float32))
    finally:
        rp.INTERPRET = False

    port = fold_batchnorm(UpSampleWithSkip(cx + cs, out).eval())
    with torch.no_grad():
        for idx, name in ((0, "conv0"), (3, "conv1")):
            conv = port._net[idx]
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(params[name]["kernel"].transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
        port = port.to(torch.bfloat16)
        got = port(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                   torch.from_numpy(skip).to(torch.bfloat16).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == (1, 16, 32, out)
    for want in wants:
        gap = np.abs(got - want)
        assert gap.max() < 0.02 and gap.mean() < 0.002, (gap.max(), gap.mean())


def _numpy_lerp(x: np.ndarray, ho: int, wo: int, align_corners: bool, dtype) -> np.ndarray:
    """``ops.resize.resize_bilinear``'s arithmetic in NumPy at ``dtype``: the
    host taps, H then W, each ``a (1 - f) + b f`` with ``1 - f`` in fp32 (the
    taps' type)."""
    y = x.astype(dtype)
    for axis, out in ((1, ho), (2, wo)):
        if y.shape[axis] == out:
            continue
        lo, hi, frac = interp_taps(y.shape[axis], out, align_corners)
        shape = [1, 1, 1, 1]
        shape[axis] = out
        f, g = frac.reshape(shape), (np.float32(1.0) - frac).reshape(shape)
        y = np.take(y, lo, axis) * g.astype(dtype) + np.take(y, hi, axis) * f.astype(dtype)
    return y


@pytest.mark.parametrize("align_corners", [True, False], ids=["align-corners", "half-pixel"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 5, 16, 20), (1, 17, 22, 3, 12, 8),
                                   (1, 6, 6, 4, 6, 11)], ids=["up", "down", "w-only"])
def test_resize_bilinear_lerps_in_the_inputs_precision(shape, align_corners):
    """fp64 lerps in fp64: within 1e-15 of a NumPy fp64 lerp on the same
    taps (fp32 would miss by ~1e-7); fp32 gives the NumPy fp32 lerp's bits;
    bf16 is the fp32 lerp of its values, rounded once."""
    from objcavit_torch.ops.resize import resize_bilinear

    b, hi, wi, c, ho, wo = shape
    x = np.random.default_rng(hi * wi + ho).standard_normal((b, hi, wi, c))
    got = resize_bilinear(torch.from_numpy(x), ho, wo, align_corners)
    assert got.dtype == torch.float64
    want = _numpy_lerp(x, ho, wo, align_corners, np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-15)
    x32 = torch.from_numpy(x.astype(np.float32))
    got32 = resize_bilinear(x32, ho, wo, align_corners)
    np.testing.assert_array_equal(got32.numpy(),
                                  _numpy_lerp(x32.numpy(), ho, wo, align_corners, np.float32))
    assert np.abs(got32.numpy() - want).max() > 1e-9  # fp32 is not fp64's result
    x16 = x32.to(torch.bfloat16)
    got16 = resize_bilinear(x16, ho, wo, align_corners)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, resize_bilinear(x16.float(), ho, wo, align_corners).to(torch.bfloat16))
