"""Plain versions of the port's CUDA kernels against the JAX package's Pallas
kernels and references, on the CPU.

The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py);
here their wrappers take the plain path because the tensors lie on the CPU.
The Pallas kernels run as the JAX package's own tests run them: in
interpret mode. Inputs are numpy arrays from seeded RNGs given to both sides.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.ops.bins import bins_head_depth_factored as jax_bins_head_depth_factored
from objcavit_tpu.ops.pallas_bins import (
    fused_conv_bins_depth,
    fused_conv_bins_depth_batched,
)
from objcavit_tpu.ops.resize import _interp_taps
from objcavit_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from objcavit_tpu.ops.resize_pallas import resize_bilinear_pallas

from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import build
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.ops.bins import bins_head_depth_factored
from objcavit_torch.ops.resize import interp_taps, resize_bilinear

RNG = np.random.default_rng(5)

# decoder up-stage geometries of tests/test_resize_pallas.py
PALLAS_SHAPES = [
    (2, 8, 16, 128, 16, 32),
    (1, 15, 16, 128, 30, 40),
    (2, 6, 8, 256, 14, 21),
    (1, 17, 22, 128, 30, 40),
]


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("sizes", [(17, 30), (120, 240), (7, 3), (1, 5), (5, 1), (9, 9)])
def test_interp_taps_equal_jax(sizes, align_corners):
    for got, want in zip(interp_taps(*sizes, align_corners), _interp_taps(*sizes, align_corners)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_plain_resize_matches_jax_einsum_and_pallas(shape):
    """fp32, tolerance of tests/test_resize_pallas.py."""
    b, hi, wi, c, ho, wo = shape
    x = RNG.standard_normal((b, hi, wi, c)).astype(np.float32)
    got = kresize.resize_bilinear_align_corners(torch.from_numpy(x), ho, wo).numpy()
    einsum = jax_resize_bilinear(jnp.asarray(x), ho, wo, align_corners=True)
    pallas = resize_bilinear_pallas(jnp.asarray(x), ho, wo, interpret=True)
    np.testing.assert_allclose(got, np.asarray(einsum), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 480, 640, 3, 384, 352), (1, 7, 9, 4, 16, 5), (1, 8, 8, 2, 8, 3)])
def test_plain_resize_half_pixel_matches_jax(shape):
    """align_corners=False, the serving pipeline's resize to the eval size."""
    b, hi, wi, c, ho, wo = shape
    x = RNG.random((b, hi, wi, c)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), ho, wo, align_corners=False).numpy()
    want = jax_resize_bilinear(jnp.asarray(x), ho, wo, align_corners=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_resize_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    x = torch.from_numpy(RNG.standard_normal((2, 5, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    before = kresize.resize_bilinear_align_corners.launches
    got = kresize.resize_bilinear_align_corners(x, 9, 11)
    want = kresize.resize_bilinear_align_corners_plain(x, 9, 11)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 11, 16)
    assert torch.equal(got, want)
    assert kresize.resize_bilinear_align_corners.launches == before


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: torch.zeros(1, 4, 4, 16), "bfloat16"),
        (lambda: torch.zeros(4, 4, 16, dtype=torch.bfloat16), "NHWC"),
        (lambda: torch.zeros(1, 4, 4, 12, dtype=torch.bfloat16), "C % 8"),
        (lambda: torch.zeros(1, 4, 16, 4, dtype=torch.bfloat16).transpose(2, 3), "contiguous"),
    ],
    ids=["fp32", "3-d", "channels", "strided"],
)
def test_resize_kernel_checks_reject(make, match):
    with pytest.raises(ValueError, match=match):
        kresize.check_resize_inputs(make(), 8, 8)


def test_resize_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA"):
        kresize.resize_bilinear_align_corners(torch.zeros(1, 2, 2, 8, device="meta"), 4, 4)


# -------------------------------------------------------------------- bins


def _bins_inputs(rng, b, h, w, c, kq, k):
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    queries = rng.standard_normal((b, kq, c)).astype(np.float32)
    kern = (0.3 * rng.standard_normal((kq, k))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(k)).astype(np.float32)
    centers = np.sort(rng.uniform(0.001, 10, (b, k))).astype(np.float32)
    return feat, queries, kern, bias, centers


def test_plain_bins_matches_pallas_batched():
    """Shapes and tolerance of tests/test_pallas_bins.py (h*w = 640 spans
    several of the Pallas kernel's tiles)."""
    feat, queries, kern, bias, centers = _bins_inputs(RNG, 2, 8, 80, 32, 16, 24)
    m = np.einsum("bqc,qk->bck", queries, kern)
    with pltpu.force_tpu_interpret_mode():
        want = fused_conv_bins_depth_batched(
            jnp.asarray(feat), jnp.asarray(m), jnp.asarray(bias), jnp.asarray(centers)
        )
    got = kbins.conv_bins_depth_batched(*map(torch.from_numpy, (feat, m, bias, centers)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_plain_bins_with_shared_weight_matches_pallas_unbatched():
    """A (C, K) weight expanded with batch stride 0 is the TPU's
    fused_conv_bins_depth (still to port as this kernel with stride 0)."""
    rng = np.random.default_rng(1)
    b, h, w, c, k = 2, 8, 16, 32, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kern = (0.1 * rng.standard_normal((c, k))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(k)).astype(np.float32)
    centers = rng.uniform(0.1, 10, (b, k)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = fused_conv_bins_depth(*map(jnp.asarray, (x, kern, bias, centers)))
    shared = torch.from_numpy(kern).expand(b, c, k)
    assert shared.stride(0) == 0
    got = kbins.conv_bins_depth_batched_plain(torch.from_numpy(x), shared,
                                              torch.from_numpy(bias), torch.from_numpy(centers))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_bins_head_factored_matches_jax():
    """ops.bins.bins_head_depth_factored against the JAX head in fp32: the
    refolded M_b = Q_b^T W against the JAX CPU path's (feat Q^T) W order."""
    rng = np.random.default_rng(2)
    feat, queries, kern, bias, _ = _bins_inputs(rng, 2, 6, 10, 16, 12, 20)
    widths = rng.random((2, 20)).astype(np.float32) + 0.1
    widths /= widths.sum(1, keepdims=True)
    want_depth, want_edges = jax_bins_head_depth_factored(
        jnp.asarray(widths), jnp.asarray(feat), jnp.asarray(queries),
        jnp.asarray(kern[None, None]), jnp.asarray(bias), 0.001, 10.0, train=False,
    )
    weight = torch.from_numpy(np.ascontiguousarray(kern.T[:, :, None, None]))  # (K, Kq, 1, 1)
    depth, edges = bins_head_depth_factored(
        torch.from_numpy(widths), torch.from_numpy(feat), torch.from_numpy(queries),
        weight, torch.from_numpy(bias), 0.001, 10.0,
    )
    np.testing.assert_allclose(edges.numpy(), np.asarray(want_edges), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth), rtol=1e-4, atol=1e-4)


def test_bins_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((2, 16, 256)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.zeros(256)
    centers = torch.linspace(0.1, 10, 256).expand(2, 256).contiguous()
    before = kbins.conv_bins_depth_batched.launches
    got = kbins.conv_bins_depth_batched(x, w, bias, centers)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5, 1)
    assert torch.equal(got, kbins.conv_bins_depth_batched_plain(x, w, bias, centers))
    assert kbins.conv_bins_depth_batched.launches == before


def _bins_args(b=2, c=16, k=256, xdt=torch.bfloat16, wdt=torch.bfloat16, fdt=torch.float32):
    return [torch.zeros(b, 3, 5, c, dtype=xdt), torch.zeros(b, c, k, dtype=wdt),
            torch.zeros(k, dtype=fdt), torch.zeros(b, k, dtype=fdt)]


def _transposed_x():
    args = _bins_args()
    args[0] = torch.zeros(2, 5, 3, 16, dtype=torch.bfloat16).transpose(1, 2)
    return args


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: _bins_args(xdt=torch.float32), "bf16"),
        (lambda: _bins_args(fdt=torch.bfloat16), "fp32"),
        (lambda: _bins_args(k=128), r"\(B, C, 256\)"),
        (lambda: _bins_args(c=24), "C % 16"),
        (lambda: _bins_args(c=264), "C <= 256"),
        (_transposed_x, "contiguous"),
    ],
    ids=["x-fp32", "bias-bf16", "bins", "channels", "too-wide", "strided"],
)
def test_bins_kernel_checks_reject(make, match):
    with pytest.raises(ValueError, match=match):
        kbins.check_bins_inputs(*make())


def test_bins_kernel_checks_accept_shared_weight():
    args = _bins_args()
    args[1] = torch.zeros(16, 256, dtype=torch.bfloat16).expand(2, 16, 256)
    kbins.check_bins_inputs(*args)


# ------------------------------------------------------------------- build


def test_c_entry_points_match_their_ctypes_signatures():
    """Every bound entry point is exported by a csrc file with as many
    parameters as its ctypes argtypes list (nvcc cannot run here)."""
    sources = "".join(p.read_text() for p in sorted(build.CSRC_DIR.glob("*.cu")))
    for name, argtypes in build.SIGNATURES.items():
        match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", sources)
        assert match, name
        assert len(match.group(1).split(",")) == len(argtypes), name


def test_sources_hash_is_stable_and_covers_flags():
    assert build.sources_hash() == build.sources_hash()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
