"""The port's CUDA kernels on a card (marker ``gpu``; they skip without one).

Run on the card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest sets up JAX, which the port does not
need.) Each kernel is held against its plain PyTorch version on the same
card, with the tolerances chip_smoke.py states.
"""

import pytest
import torch

from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.utils.benchkit import build_flagship_model
from objcavit_torch.utils.kernel_io import plain_outputs, record_kernel_io

pytestmark = pytest.mark.gpu

RESIZE_RTOL, RESIZE_ATOL = 2.0 ** -7, 1e-5  # one bf16 ulp; see chip_smoke.py
BINS_RTOL, BINS_ATOL = 1e-5, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, rtol, atol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), float((got - want).abs().max())


@pytest.mark.parametrize(
    "shape",
    [
        (8, 17, 22, 2048, 30, 40),  # the flagship's four upsamples
        (8, 30, 40, 1024, 60, 80),
        (8, 60, 80, 512, 120, 160),
        (8, 120, 160, 256, 240, 320),
        (2, 1, 1, 8, 3, 5),  # single-pixel input
        (3, 9, 4, 24, 2, 11),  # down in H, up in W
        (1, 5, 7, 16, 5, 7),  # same size: a copy
    ],
)
def test_resize_kernel_matches_plain(cuda, shape):
    b, hi, wi, c, ho, wo = shape
    x = torch.randn((b, hi, wi, c), generator=cuda, device="cuda").to(torch.bfloat16)
    got = kresize.resize_bilinear_align_corners(x, ho, wo)
    _assert_close(got, kresize.resize_bilinear_align_corners_plain(x, ho, wo),
                  RESIZE_RTOL, RESIZE_ATOL)


@pytest.mark.parametrize("shared_weight", [False, True], ids=["per-image-W", "shared-W"])
@pytest.mark.parametrize(
    "shape",
    [(8, 240, 320, 128), (2, 5, 7, 128), (3, 16, 17, 64), (1, 1, 3, 16), (2, 9, 31, 256)],
)
def test_bins_kernel_matches_plain(cuda, shape, shared_weight):
    b, h, w, c = shape
    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=cuda, device="cuda")).to(torch.bfloat16)
    if shared_weight:
        wts = wts[:1].expand(b, c, 256)
    bias = 0.1 * torch.randn(256, generator=cuda, device="cuda")
    centers = torch.sort(10 * torch.rand((b, 256), generator=cuda, device="cuda"), dim=1).values
    got = kbins.conv_bins_depth_batched(x, wts, bias, centers)
    assert got.shape == (b, h, w, 1) and got.dtype == torch.float32
    _assert_close(got, kbins.conv_bins_depth_batched_plain(x, wts, bias, centers),
                  BINS_RTOL, BINS_ATOL)


def test_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(ValueError, match="bfloat16"):
        kresize.resize_bilinear_align_corners(torch.zeros(1, 4, 4, 8, device="cuda"), 8, 8)
    strided = torch.zeros(1, 4, 16, 4, dtype=torch.bfloat16, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kresize.resize_bilinear_align_corners(strided, 8, 8)
    x = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=r"\(B, C, 256\)"):
        kbins.conv_bins_depth_batched(
            x, torch.zeros(1, 8, 128, dtype=torch.bfloat16, device="cuda"),
            torch.zeros(128, device="cuda"), torch.zeros(1, 128, device="cuda"),
        )


def test_launch_counters_count_each_launch(cuda):
    x = torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16, device="cuda")
    r0, b0 = kresize.resize_bilinear_align_corners.launches, kbins.conv_bins_depth_batched.launches
    kresize.resize_bilinear_align_corners(x, 3, 3)
    kresize.resize_bilinear_align_corners_plain(x, 3, 3)
    kbins.conv_bins_depth_batched(
        x, torch.zeros(1, 16, 256, dtype=torch.bfloat16, device="cuda"),
        torch.zeros(256, device="cuda"), torch.zeros(1, 256, device="cuda"),
    )
    assert kresize.resize_bilinear_align_corners.launches == r0 + 1
    assert kbins.conv_bins_depth_batched.launches == b0 + 1


def test_tiny_graphbins_runs_through_both_kernels(cuda):
    """bf16 on the card: 4 resize launches and 1 bins launch per forward,
    each kernel's output matching its plain version on the tensors the
    forward gave it, and ObjCAViT's image features within the 0.02 relative
    L2 bound of chip_smoke.py of the same weights in fp32 on the CPU (plain
    versions)."""
    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny")
    cpu_model = build_flagship_model(dtype=torch.float32, device="cpu",
                                     encoder_name="efficientnet-tiny")
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((2, 384, 352, 3), generator=gen)
    feats = 0.05 * torch.randn((2, 6, 512), generator=gen)
    xywh = 300 * torch.rand((2, 6, 4), generator=gen)
    valid = torch.tensor([[True] * 3 + [False] * 3, [True] + [False] * 5])
    r0, b0 = kresize.resize_bilinear_align_corners.launches, kbins.conv_bins_depth_batched.launches
    with torch.no_grad():
        with record_kernel_io(model) as records:
            got = model(*(t.cuda() for t in (img, feats, xywh, valid)))["depth_pred"]
        with record_kernel_io(cpu_model) as cpu_records:
            cpu_model(img, feats, xywh, valid)
    assert kresize.resize_bilinear_align_corners.launches == r0 + 4
    assert kbins.conv_bins_depth_batched.launches == b0 + 1
    assert got.shape == (2, 192, 176, 1) and torch.isfinite(got).all()
    resize, (depth, plain_depth) = plain_outputs(model, records[0])
    assert len(resize) == 4
    for y, want in resize:
        _assert_close(y, want, RESIZE_RTOL, RESIZE_ATOL)
    _assert_close(depth, plain_depth, BINS_RTOL, BINS_ATOL)
    feat, feat_ref = records[0]["objcavit"][1].float().cpu(), cpu_records[0]["objcavit"][1]
    assert float((feat - feat_ref).norm() / feat_ref.norm()) < 0.02
