"""The port's CUDA kernels on a card (marker ``gpu``; they skip without one).

Run on the card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest sets up JAX, which the port does not
need.) Each kernel is held against its plain PyTorch version on the same
card, with the tolerances chip_smoke.py states.
``test_class_table_through_the_port_imports_no_jax`` is not a card test: it
runs on the CPU, in a subprocess, in the Tier-1 command.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import objcavit_torch.models.common as common
from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import bins_expectation as kexp
from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.kernels import se_project as kse
from objcavit_torch.serving import FusedDepthPipeline
from objcavit_torch.utils.benchkit import (
    build_adabins_model,
    build_adabins_train,
    build_detector,
    build_flagship_model,
    build_flagship_train,
)
from objcavit_torch.utils.fold_bn import fold_batchnorm
from objcavit_torch.utils.resize_se_ab import SE_SHAPES
from objcavit_torch.utils.kernel_io import (
    attention_plain_outputs,
    bins_expectation_plain_outputs,
    detect_head_errors,
    mbconv_head_errors,
    plain_outputs,
    record_attention_io,
    record_bins_expectation_io,
    record_detect_head_io,
    record_encoder_kernel_io,
    record_kernel_io,
    se_project_errors,
    share_edge_grids,
    skip_mismatches,
)

gpu = pytest.mark.gpu

RESIZE_RTOL, RESIZE_ATOL = 2.0 ** -7, 1e-5  # one bf16 ulp; see chip_smoke.py
BINS_RTOL, BINS_ATOL = 1e-5, 1e-5
# kernel 4: see chip_smoke.py
EXP_RTOL, EXP_ATOL = 1e-5, 1e-5
DLOGITS_RTOL, DLOGITS_ATOL_PER_G = 2.0 ** -7, 1e-4
DCENTERS_RTOL, DCENTERS_ATOL_PER_MAX = 1e-4, 1e-5
DETECT_RTOL, DETECT_ATOL = 2.0 ** -7, 1e-5  # kernel 6: one bf16 ulp; see chip_smoke.py
ATTN_RTOL, ATTN_ATOL_PER_MAX = 2.0 ** -7, 1e-4  # kernel 5: see chip_smoke.py
# kernels 7-10: one bf16 ulp plus the fp32 bounds kernel_io's checks add;
# the pool's fp32 sums in another order (see chip_smoke.py)
MB_RTOL, MB_ATOL, POOL_RTOL = 2.0 ** -7, 1e-5, 1e-4


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


@gpu
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


@gpu
@pytest.mark.parametrize(
    "shape",
    [
        (8, 17, 22, 2048, 30, 40, 176),  # the flagship's four upsamples and skips
        (8, 30, 40, 1024, 60, 80, 64),
        (8, 60, 80, 512, 120, 160, 40),
        (8, 120, 160, 256, 240, 320, 24),
        (2, 88, 304, 256, 176, 608, 24),  # KITTI 352x1216's up4: five strips
        (3, 5, 7, 24, 9, 13, 8),  # odd sizes, 8-channel slices
        (1, 21, 30, 16, 9, 11, 16),  # down in both
    ],
)
def test_resize_concat_form_matches_plain(cuda, shape):
    """The upsample slice within one bf16 ulp of the plain version, the skip
    slice bit for bit, two calls bitwise equal, one launch counted a call."""
    b, hi, wi, c, ho, wo, cs = shape
    x = torch.randn((b, hi, wi, c), generator=cuda, device="cuda").to(torch.bfloat16)
    skip = torch.randn((b, ho, wo, cs), generator=cuda, device="cuda").to(torch.bfloat16)
    before = kresize.resize_bilinear_align_corners.launches
    got = kresize.resize_bilinear_align_corners_into_concat(x, skip)
    again = kresize.resize_bilinear_align_corners_into_concat(x, skip)
    torch.cuda.synchronize()
    assert kresize.resize_bilinear_align_corners.launches == before + 2
    assert got.shape == (b, ho, wo, c + cs)
    _assert_close(got[..., :c], kresize.resize_bilinear_align_corners_plain(x, ho, wo),
                  RESIZE_RTOL, RESIZE_ATOL)
    assert torch.equal(got[..., c:].view(torch.int16), skip.view(torch.int16))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@gpu
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


@gpu
@pytest.mark.parametrize("shared_weight", [False, True], ids=["per-image-W", "shared-W"])
@pytest.mark.parametrize(
    "shape",
    [(1, 7, 9, 16), (8, 13, 17, 48), (8, 30, 41, 128), (1, 5, 67, 256), (8, 11, 7, 256),
     (1, 240, 320, 128), (8, 60, 80, 256), (600, 1, 90, 128)],
)
def test_kernel2_hopper_matches_plain(cuda, shape, shared_weight):
    """The persistent TMA + wgmma kernel at C 16-256, B 1 and 8, S not a
    multiple of its 64-pixel unit, one W an image or one for the batch.
    (8, 60, 80, 256) gives each block ~29 units through a ring of two
    stages: with three consumers on it, one could pass a stage's parity
    wait two fills early and read another unit's x. (600, 1, 90, 128) gives
    each block ~9 images of 2 units: a consumer skips images, and must still
    wait for each one's W before handing it back."""
    b, h, w, c = shape
    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=cuda, device="cuda")).to(torch.bfloat16)
    if shared_weight:
        wts = wts[:1].expand(b, c, 256)
    bias = 0.1 * torch.randn(256, generator=cuda, device="cuda")
    centers = torch.sort(10 * torch.rand((b, 256), generator=cuda, device="cuda"), dim=1).values
    got = kbins.conv_bins_depth_batched(x, wts, bias, centers)
    _assert_close(got, kbins.conv_bins_depth_batched_plain(x, wts, bias, centers),
                  BINS_RTOL, BINS_ATOL)


@gpu
@pytest.mark.parametrize("shift", [30.0, 120.0, -200.0, "mixed"])
def test_kernel2_rows_outside_the_fast_fold_take_the_exact_one(cuda, shift):
    """Logits far from 0 (a row's sum of e outside [2^-16, 2^40]) make the
    kernel fold the unit again with each row's max subtracted. 'mixed' puts
    such pixels beside ordinary ones in the same 64-pixel units: channel 0
    of W is 0.5 for every bin, so x's channel 0 (80, -60 or 0 by image row)
    shifts a pixel's logits by +40, -30 or 0 exactly."""
    b, h, w, c = 2, 16, 20, 128
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda")
    wts = 0.1 * torch.randn((b, c, 256), generator=cuda, device="cuda")
    offset = 0.0
    if shift == "mixed":
        wts[:, 0] = 0.5
        x[..., 0] = 0.0
        x[:, ::3, :, 0] = 80.0
        x[:, 1::3, :, 0] = -60.0
    else:
        offset = shift
    x, wts = x.to(torch.bfloat16), wts.to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=cuda, device="cuda") + offset
    centers = torch.sort(10 * torch.rand((b, 256), generator=cuda, device="cuda"), dim=1).values
    got = kbins.conv_bins_depth_batched(x, wts, bias, centers)
    _assert_close(got, kbins.conv_bins_depth_batched_plain(x, wts, bias, centers),
                  BINS_RTOL, BINS_ATOL)


@gpu
@pytest.mark.parametrize("shared_weight", [False, True], ids=["kernel2", "kernel3"])
def test_kernel2_two_calls_give_the_same_bits(cuda, shared_weight):
    b, h, w, c = 8, 240, 320, 128
    x = torch.randn((b, h, w, c), generator=cuda, device="cuda").to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=cuda, device="cuda")).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=cuda, device="cuda")
    centers = torch.sort(10 * torch.rand((b, 256), generator=cuda, device="cuda"), dim=1).values
    if shared_weight:
        first = kbins.conv_bins_depth(x, wts[0], bias, centers)
        second = kbins.conv_bins_depth(x, wts[0], bias, centers)
    else:
        first = kbins.conv_bins_depth_batched(x, wts, bias, centers)
        second = kbins.conv_bins_depth_batched(x, wts, bias, centers)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(ValueError, match="bfloat16"):
        kresize.resize_bilinear_align_corners(torch.zeros(1, 4, 4, 8, device="cuda"), 8, 8)
    strided = torch.zeros(1, 4, 16, 4, dtype=torch.bfloat16, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kresize.resize_bilinear_align_corners(strided, 8, 8)
    x8 = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="batch"):
        kresize.resize_bilinear_align_corners_into_concat(
            x8, torch.zeros(2, 8, 8, 8, dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kresize.resize_bilinear_align_corners_into_concat(x8, strided)
    x = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=r"\(B, C, 256\)"):
        kbins.conv_bins_depth_batched(
            x, torch.zeros(1, 8, 128, dtype=torch.bfloat16, device="cuda"),
            torch.zeros(128, device="cuda"), torch.zeros(1, 128, device="cuda"),
        )


@gpu
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


@gpu
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
    assert skip_mismatches(records[0]) == 0
    _assert_close(depth, plain_depth, BINS_RTOL, BINS_ATOL)
    feat, feat_ref = records[0]["bins_inputs"][1].float().cpu(), cpu_records[0]["bins_inputs"][1]
    assert float((feat - feat_ref).norm() / feat_ref.norm()) < 0.02


@gpu
def test_tiny_decoder_concats_through_kernel1_alone(cuda, monkeypatch):
    """The bf16 decoder at inference: each up-stage's concat buffer comes
    from one launch of kernel 1's concat form (4 a forward), with no
    torch.cat and no plain resize; the fp32 decoder takes the plain route
    and launches nothing. Both match on the same features."""
    import objcavit_torch.models.decoder as decoder_module

    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny")
    ref = build_flagship_model(dtype=torch.float32, device="cuda", encoder_name="efficientnet-tiny")
    img = torch.randn((2, 384, 352, 3), generator=cuda, device="cuda")
    with torch.no_grad():
        feats = model.dense_feature_extractor.encoder["original_model"](img.to(torch.bfloat16))
        cats = []
        real_cat, real_resize = torch.cat, decoder_module.resize_bilinear
        monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1) or real_cat(*a, **k))
        monkeypatch.setattr(decoder_module, "resize_bilinear", None)
        before = kresize.resize_bilinear_align_corners.launches
        got = model.dense_feature_extractor.decoder(list(feats))
        torch.cuda.synchronize()
        assert kresize.resize_bilinear_align_corners.launches == before + 4
        assert cats == []
        monkeypatch.setattr(decoder_module, "resize_bilinear", real_resize)
        before = kresize.resize_bilinear_align_corners.launches
        want = ref.dense_feature_extractor.decoder([f.float() for f in feats])
        assert kresize.resize_bilinear_align_corners.launches == before
        assert len(cats) == 4
    assert float((got.float() - want).norm() / want.norm()) < 0.02


@gpu
def test_kernel3_matches_plain_and_counts_its_launches(cuda):
    """Kernel 3 (one shared W) at the unfactored head's shape."""
    x = torch.randn((8, 240, 320, 128), generator=cuda, device="cuda").to(torch.bfloat16)
    w = (0.1 * torch.randn((128, 256), generator=cuda, device="cuda")).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=cuda, device="cuda")
    centers = torch.sort(10 * torch.rand((8, 256), generator=cuda, device="cuda"), dim=1).values
    k2, k3 = kbins.conv_bins_depth_batched.launches, kbins.conv_bins_depth.launches
    got = kbins.conv_bins_depth(x, w, bias, centers)
    assert (kbins.conv_bins_depth_batched.launches, kbins.conv_bins_depth.launches) == (k2, k3 + 1)
    _assert_close(got, kbins.conv_bins_depth_plain(x, w, bias, centers), BINS_RTOL, BINS_ATOL)


def _assert_backward_close(dl, dc, want_dl, want_dc, g):
    _assert_close(dl, want_dl, DLOGITS_RTOL, DLOGITS_ATOL_PER_G * float(g.abs().max()))
    _assert_close(dc, want_dc, DCENTERS_RTOL, DCENTERS_ATOL_PER_MAX * float(want_dc.abs().max()))


@gpu
@pytest.mark.parametrize("shape", [(8, 208 * 272, 256), (2, 5, 256), (3, 1000, 256), (1, 1, 256)],
                         ids=["train", "tiny", "ragged", "one-row"])
def test_kernel4_forward_and_backward_match_plain(cuda, shape):
    b, s, k = shape
    logits = (2.0 * torch.randn(shape, generator=cuda, device="cuda")).to(torch.bfloat16)
    centers = torch.sort(10 * torch.rand((b, k), generator=cuda, device="cuda"), dim=1).values
    g = torch.randn((b, s), generator=cuda, device="cuda")
    f0, b0 = kexp.bins_expectation_fwd.launches, kexp.bins_expectation_bwd.launches
    depth = kexp.bins_expectation_fwd(logits, centers)
    dl, dc = kexp.bins_expectation_bwd(logits, centers, g)
    assert (kexp.bins_expectation_fwd.launches, kexp.bins_expectation_bwd.launches) == (f0 + 1, b0 + 1)
    assert depth.shape == (b, s) and dl.dtype == torch.bfloat16 and dc.shape == (b, k)
    _assert_close(depth, kexp.bins_expectation_plain(logits, centers), EXP_RTOL, EXP_ATOL)
    _assert_backward_close(dl, dc, *kexp.bins_expectation_bwd_plain(logits, centers, g), g)


@gpu
def test_kernel4_autograd_function_matches_autograd_of_plain(cuda):
    logits = (2.0 * torch.randn((2, 6, 7, 256), generator=cuda, device="cuda")).to(torch.bfloat16)
    centers = torch.sort(10 * torch.rand((2, 256), generator=cuda, device="cuda"), dim=1).values
    g = torch.randn((2, 6, 7, 1), generator=cuda, device="cuda")
    lk, ck = logits.clone().requires_grad_(), centers.clone().requires_grad_()
    (kexp.fused_bins_depth(lk, ck) * g).sum().backward()
    lp, cp = logits.clone().requires_grad_(), centers.clone().requires_grad_()
    (kexp.bins_expectation_plain(lp.reshape(2, 42, 256), cp).reshape(2, 6, 7, 1) * g).sum().backward()
    _assert_backward_close(lk.grad, ck.grad, lp.grad, cp.grad, g)


@gpu
def test_kernel4_wrappers_raise_instead_of_falling_back(cuda):
    centers = torch.zeros(1, 256, device="cuda")
    with pytest.raises(ValueError, match="bf16 logits"):
        kexp.bins_expectation_fwd(torch.zeros(1, 4, 256, device="cuda"), centers)
    with pytest.raises(ValueError, match="K = 256"):
        kexp.bins_expectation_fwd(torch.zeros(1, 4, 128, dtype=torch.bfloat16, device="cuda"),
                                  torch.zeros(1, 128, device="cuda"))
    logits = torch.zeros(1, 4, 256, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="g as contiguous fp32"):
        kexp.bins_expectation_bwd(logits, centers, torch.zeros(1, 4, dtype=torch.bfloat16,
                                                               device="cuda"))
    with pytest.raises(RuntimeError, match="forward-only"):
        kbins.conv_bins_depth(
            torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16, device="cuda", requires_grad=True),
            torch.zeros(16, 256, dtype=torch.bfloat16, device="cuda"),
            torch.zeros(256, device="cuda"), centers)


@gpu
def test_tiny_train_step_runs_through_kernel4_only(cuda):
    """Two bf16 train steps of the tiny model on the card: one kernel-4
    forward and one backward launch a step, no launch of kernels 1-3, finite
    losses, and kernel 4's outputs in the recorded step matching its plain
    versions on the tensors the step gave it."""
    step, batch, objects = build_flagship_train(batch=2, h=384, w=352, n_obj=8, device="cuda",
                                                encoder_name="efficientnet-tiny")
    counters = (kresize.resize_bilinear_align_corners, kbins.conv_bins_depth_batched,
                kbins.conv_bins_depth, kexp.bins_expectation_fwd, kexp.bins_expectation_bwd)
    before = [c.launches for c in counters]
    with record_bins_expectation_io() as records:
        losses = [float(step(batch, objects)) for _ in range(2)]
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 0, 2, 2]
    assert all(torch.isfinite(torch.tensor(losses)))
    pairs = bins_expectation_plain_outputs(records[0])
    _assert_close(*pairs["depth"], EXP_RTOL, EXP_ATOL)
    (dl, want_dl), (dc, want_dc) = pairs["dlogits"], pairs["dcenters"]
    _assert_backward_close(dl, dc, want_dl, want_dc, records[0]["g"])


def _detect_case(gen, b, s, cin, nc, nm=32):
    no = 5 + nc + nm
    flat = torch.randn((b, s, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((3 * no, cin), generator=gen, device="cuda") / cin ** 0.5
    bias = 0.1 * torch.randn(3 * no, generator=gen, device="cuda")
    return flat, kdetect.pack_detect_head(w, bias, nc, nm, torch.bfloat16)


@gpu
@pytest.mark.parametrize("shape", [(8, 4800, 256, 1203), (2, 37, 64, 1203), (1, 1, 128, 130),
                                   (3, 300, 1024, 80), (4, 1000, 512, 1203),
                                   (8, 1672, 512, 1203), (8, 418, 1024, 1203),
                                   (3, 111, 256, 130), (5, 77, 512, 1203)],
                         ids=["nyu-level0", "ragged", "one-row", "coco-classes", "block-rows-64",
                              "kitti-level1", "kitti-level2", "nc-130-ragged-m",
                              "nc-1203-ragged-m"])
def test_kernel6_matches_plain(cuda, shape):
    """One bf16 ulp on y5, coef and the max; the argmax equal off near-ties
    and within the band of the max on them (kernel_io.detect_head_errors)."""
    b, s, cin, nc = shape
    flat, packed = _detect_case(cuda, b, s, cin, nc)
    before = kdetect.fused_detect_head.launches
    out = kdetect.fused_detect_head(flat, packed)
    torch.cuda.synchronize()
    assert kdetect.fused_detect_head.launches == before + 1
    assert [tuple(t.shape) for t in out] == [(b, s, 3, 5), (b, s, 3, 32), (b, s, 3), (b, s, 3)]
    errs = detect_head_errors(flat, packed, out, DETECT_RTOL, DETECT_ATOL)
    assert errs["bad"] == 0, errs


@gpu
@pytest.mark.parametrize("shape,dups", [((8, 4800, 256, 1203), (3, 60, 700, 1100)),
                                        ((3, 111, 512, 130), (3, 129))],
                         ids=["nyu-level0", "nc-130"])
def test_kernel6_breaks_exact_ties_to_the_first_class(cuda, shape, dups):
    """Classes ``dups`` share one weight row and bias, so their logits are
    equal in every row, in different column tiles and, at level 0's size,
    in different blocks (the kernel splits an anchor's tiles over blocks and
    merges them with its 64-bit keys). Wherever they are the clear max, the
    kernel must give the first of them and the plain max."""
    b, s, cin, nc = shape
    no = 5 + nc + 32
    flat = torch.randn((b, s, cin), generator=cuda, device="cuda").to(torch.bfloat16)
    w = torch.randn((3 * no, cin), generator=cuda, device="cuda") / cin ** 0.5
    bias = 0.1 * torch.randn(3 * no, generator=cuda, device="cuda")
    for a in range(3):
        cols = [a * no + 5 + c for c in dups]
        w[cols] = 4.0 * w[cols[0]]
        bias[cols] = 6.0
    packed = kdetect.pack_detect_head(w, bias, nc, 32, torch.bfloat16)
    out = kdetect.fused_detect_head(flat, packed)
    torch.cuda.synchronize()
    errs = detect_head_errors(flat, packed, out, DETECT_RTOL, DETECT_ATOL)
    assert errs["bad"] == 0, errs
    logits = kdetect.class_logits_plain(flat, packed)
    dup = logits[..., dups[0]]
    others = logits.clone()
    others[..., list(dups)] = -float("inf")
    x_abs = flat.reshape(b * s, cin).float().abs()
    slack = cin * 2.0 ** -23 * torch.stack(  # the fp32 accumulation bound, as detect_head_errors
        [x_abs @ packed.wcls[a, dups[0]].float().abs() for a in range(3)], -1).reshape(dup.shape)
    band = DETECT_ATOL + DETECT_RTOL * dup.abs() + slack
    clear = dup > others.amax(-1) + band
    assert clear.float().mean() > 0.5
    assert (out[3][clear] == dups[0]).all()
    assert ((out[2][clear] - dup[clear]).abs() <= band[clear]).all()


@gpu
@pytest.mark.parametrize("shape", [(8, 4800, 256, 1203), (3, 111, 256, 130), (5, 77, 512, 1203)],
                         ids=["nyu-level0", "small-nc130", "small-cin512"])
def test_kernel6_share_edges_match_plain(cuda, shape):
    """Grids in which one block's share starts at a row tile's last unit
    and one ends at a row tile's first unit (``kernel_io.share_edge_grids``), where a
    consumer warpgroup hands feature tiles back at the share's edges."""
    b, s, cin, nc = shape
    flat, packed = _detect_case(cuda, b, s, cin, nc)
    grids = share_edge_grids(b * s, cin, packed.wcls.shape[1])
    assert grids
    for grid in grids:
        out = kdetect._fused_detect_head_on_grid(flat, packed, grid)
        torch.cuda.synchronize()
        errs = detect_head_errors(flat, packed, out, DETECT_RTOL, DETECT_ATOL)
        assert errs["bad"] == 0, (grid, errs)


@gpu
def test_kernel6_wrapper_raises_instead_of_falling_back(cuda):
    flat, packed = _detect_case(cuda, 1, 4, 64, 10)
    with pytest.raises(ValueError, match="bf16"):
        kdetect.fused_detect_head(flat.float(), packed)
    with pytest.raises(ValueError, match="Cin % 64"):
        kdetect.fused_detect_head(flat[..., :48].contiguous(), packed)
    with pytest.raises(ValueError, match="contiguous"):
        kdetect.fused_detect_head(flat.expand(2, 4, 64).transpose(0, 1), packed)
    with pytest.raises(RuntimeError, match="forward-only"):
        kdetect.fused_detect_head(flat.float().requires_grad_().to(torch.bfloat16), packed)


@gpu
def test_tiny_fused_server_runs_through_kernel6(cuda):
    """The fused server on the card with the tiny GraphBins and a 4-class
    bf16 detector, class-max head: 3 kernel-6 launches a request (plus the
    GraphBins kernels), each matching the plain version on its own tensors;
    the automatic gate takes the dense head at 384x352."""
    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny")
    detector = build_detector(4, seed=1, device="cuda", calibrate_shape=(2, 128, 160))
    table = np.random.default_rng(0).standard_normal((5, 512)).astype(np.float32)
    frames = np.random.default_rng(1).integers(0, 256, (2, 384, 352, 3), dtype=np.uint8)
    pipe = FusedDepthPipeline(model, detector, table, eval_dims=(384, 352), class_max_head=True)
    before = kdetect.fused_detect_head.launches
    with record_detect_head_io() as records:
        depth = pipe(frames)
    torch.cuda.synchronize()
    assert kdetect.fused_detect_head.launches == before + 3 and len(records) == 3
    assert depth.shape == (2, 192, 176, 1) and torch.isfinite(depth).all()
    for rec in records:
        assert detect_head_errors(rec["flat"], rec["packed"], rec["out"], DETECT_RTOL,
                                  DETECT_ATOL)["bad"] == 0
    pipe.class_max_head = None
    pipe(frames)
    torch.cuda.synchronize()
    assert kdetect.fused_detect_head.launches == before + 3


def test_class_table_through_the_port_imports_no_jax():
    """Building the class table uses the port's own copies of the JAX
    package's numpy tokenizer and strategy: no module of jax, flax or
    objcavit_tpu is left behind."""
    code = (
        "import sys, torch\n"
        "from objcavit_torch.language.embedding import ClipEmbedder, build_class_table\n"
        "from objcavit_torch.models.clip_text import CLIPTextEncoder\n"
        "clip = CLIPTextEncoder(width=64, heads=4, layers=1).init_weights_(torch.Generator().manual_seed(0))\n"
        "table = build_class_table(['class_0', 'class_1'], 'synset_def_wn',\n"
        "                          ClipEmbedder(clip, batch=4, device='cpu'))\n"
        "assert table.shape == (3, 512), table.shape\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'objcavit_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'objcavit_torch.language.tokenizer' in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


def _attn_inputs(gen, b, sq, sk, mask_kind, h=4, d=32, in_proj=False):
    """bf16 q, k, v (from one chunked (B, S, 3E) projection when
    ``in_proj``, as a self-attention reads them), g, and a mask: 'none',
    'partial' (a different count of valid keys per image), or 'full' (image
    0 entirely masked, the others partial)."""
    if in_proj:
        qkv = torch.randn((b, sq, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.reshape(b, sq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for s in (sq, sk, sk))
    g = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    mask = None
    if mask_kind != "none":
        counts = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None] >= counts[:, None]
        if mask_kind == "full":
            mask[0] = True
    return q, k, v, g, mask


def _assert_attn_close(pairs):
    for name, got, want in pairs:
        _assert_close(got, want, ATTN_RTOL, ATTN_ATOL_PER_MAX * float(want.abs().max()))


@gpu
@pytest.mark.parametrize(
    "case",
    [(8, 300, 300, "partial", True), (8, 221, 221, "full", True), (2, 1200, 1200, "none", True),
     (3, 77, 200, "partial", False), (2, 130, 65, "full", False), (1, 1, 5, "none", False),
     (2, 64, 64, "full", False), (8, 300, 77, "partial", False), (4, 64, 64, "partial", True),
     (4, 65, 65, "partial", True), (2, 512, 512, "full", True), (2, 513, 513, "partial", True),
     (2, 40, 513, "partial", False)],
    ids=["flagship-480x640", "train-416x544", "S1200", "Sq<Sk", "Sq>Sk", "one-query",
         "one-tile", "Sq300-Sk77", "Sk64", "Sk65", "Sk512", "Sk513", "Sq40-Sk513"],
)
def test_kernel5_forward_and_backward_match_plain(cuda, case):
    """Forward and backward wrappers against the plain versions, each
    launch counted once and the backward on the route its shape takes (one
    cluster launch up to 512 keys and queries, the two-kernel route beyond);
    a fully masked row is uniform over its keys."""
    b, sq, sk, mask_kind, in_proj = case
    q, k, v, g, mask = _attn_inputs(cuda, b, sq, sk, mask_kind, in_proj=in_proj)
    bias = kattn.mask_bias(mask)
    f0, b0 = kattn.fused_mha_fwd.launches, kattn.fused_mha_bwd.launches
    c0 = kattn.fused_mha_bwd.cluster_launches
    out, stats = kattn.fused_mha_fwd(q, k, v, bias)
    dq, dk, dv = kattn.fused_mha_bwd(q, k, v, bias, g, stats)
    torch.cuda.synchronize()
    assert (kattn.fused_mha_fwd.launches, kattn.fused_mha_bwd.launches) == (f0 + 1, b0 + 1)
    cluster = kattn.bwd_route(sq, sk) == "cluster"
    assert cluster == (max(sq, sk) <= 512)
    assert kattn.fused_mha_bwd.cluster_launches == c0 + cluster
    want = kattn.mha_fused_bwd_plain(q, k, v, bias, g)
    _assert_attn_close([("out", out, kattn.mha_fused_plain(q, k, v, bias)),
                        *zip(("dq", "dk", "dv"), (dq, dk, dv), want)])
    if mask_kind == "full":
        uniform = v[0].float().mean(0)  # (H, D)
        _assert_close(out[0].float(), uniform.expand(sq, *uniform.shape), 2.0 ** -7, 1e-3)


@gpu
@pytest.mark.parametrize(
    "case",
    [(8, 300, 300, "partial"), (8, 221, 221, "partial"), (2, 1200, 1200, "none"),
     (8, 300, 77, "partial"), (8, 300, 300, "full")],
    ids=["flagship-480x640", "train-416x544", "S1200", "Sq300-Sk77", "fully-masked"],
)
def test_kernel5_forward_with_and_without_residual(cuda, case):
    """chip_smoke.py's ATTN_CASES: the forward without a residual (what a
    served call launches) and with one give the same bits and match the
    plain version; the residual it writes gives the plain backward."""
    b, sq, sk, mask_kind = case
    q, k, v, g, mask = _attn_inputs(cuda, b, sq, sk, mask_kind, in_proj=sq == sk)
    bias = kattn.mask_bias(mask)
    served, none = kattn.fused_mha_fwd(q, k, v, bias, residual=False)
    trained, stats = kattn.fused_mha_fwd(q, k, v, bias)
    grads = kattn.fused_mha_bwd(q, k, v, bias, g, stats)
    torch.cuda.synchronize()
    assert none is None and stats.shape == (2, b * 4, sq)
    assert torch.equal(served, trained)
    _assert_attn_close([("out", served, kattn.mha_fused_plain(q, k, v, bias)),
                        *zip(("dq", "dk", "dv"), grads, kattn.mha_fused_bwd_plain(q, k, v, bias, g))])


@gpu
def test_kernel5_served_forward_writes_no_residual(cuda):
    """Under torch.no_grad(), fused_mha launches the forward without a
    residual; with an input that requires grad, with one."""
    q, k, v, _, mask = _attn_inputs(cuda, 2, 150, 150, "partial", in_proj=True)
    with record_attention_io() as records:
        with torch.no_grad():
            kattn.fused_mha(q, k, v, mask)
        kattn.fused_mha(q.detach().requires_grad_(), k, v, mask)
    assert [r["residual"] for r in records] == [False, True]


@gpu
@pytest.mark.parametrize("case", [(8, 300, 300), (8, 221, 221), (2, 513, 513)],
                         ids=["flagship-480x640", "train-416x544", "two-kernel-Sk513"])
def test_kernel5_backward_is_bitwise_deterministic(cuda, case):
    """Two backward calls on the same inputs give identical dq, dk and dv:
    neither route sums through atomics, so no order depends on timing."""
    b, sq, sk = case
    q, k, v, g, mask = _attn_inputs(cuda, b, sq, sk, "partial", in_proj=True)
    bias = kattn.mask_bias(mask)
    _, stats = kattn.fused_mha_fwd(q, k, v, bias)
    first = kattn.fused_mha_bwd(q, k, v, bias, g, stats)
    second = kattn.fused_mha_bwd(q, k, v, bias, g, stats)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@gpu
@pytest.mark.parametrize("case", [(8, 300, 300), (8, 221, 221)],
                         ids=["flagship-480x640", "train-416x544"])
def test_kernel5_card_holds_every_backward_cluster_at_once(cuda, case):
    """At the model's shapes the card holds all B * H clusters of the
    backward at once (two blocks an SM), so the launch runs in one wave."""
    b, sq, sk = case
    assert kattn.bwd_clusters_resident(b, 4, sq, sk) >= b * 4


@gpu
def test_kernel5_autograd_function_matches_autograd_of_plain(cuda):
    q, k, v, g, mask = _attn_inputs(cuda, 2, 150, 150, "partial", in_proj=True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (kattn.fused_mha(*leaves, mask).float() * g.float()).sum().backward()
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (kattn.mha_fused_plain(*plain, kattn.mask_bias(mask)).float() * g.float()).sum().backward()
    _assert_attn_close([(n, a.grad, b.grad) for n, a, b in zip("qkv", leaves, plain)])


@gpu
def test_kernel5_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(1, 4, 4, 32, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        kattn.fused_mha_fwd(x, x, x)
    y = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dimension"):
        kattn.fused_mha_fwd(y, y, y)
    z = y[..., ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        kattn.fused_mha_fwd(z, z, z)
    b = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="several devices"):
        kattn.fused_mha_fwd(b, b, b, torch.zeros(1, 4))


@gpu
def test_tiny_graphbins_on_the_kernel_route(cuda):
    """All ten attentions of the tiny GraphBins launch kernel 5 in a bf16
    forward, each output matching the plain version on its own inputs."""
    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny",
                                 attn_impl="kernel")
    gen = torch.Generator().manual_seed(1)
    inputs = (torch.randn((2, 384, 352, 3), generator=gen), 0.05 * torch.randn((2, 6, 512)),
              300 * torch.rand((2, 6, 4)), torch.tensor([[True] * 3 + [False] * 3,
                                                          [True] + [False] * 5]))
    before = kattn.fused_mha_fwd.launches
    with torch.no_grad(), record_attention_io() as records:
        depth = model(*(t.cuda() for t in inputs))["depth_pred"]
    torch.cuda.synchronize()
    assert kattn.fused_mha_fwd.launches == before + 10 and len(records) == 10
    assert torch.isfinite(depth).all()
    for rec in records:
        _assert_attn_close(attention_plain_outputs(rec))


@gpu
def test_tiny_adabins_on_the_kernel_route(cuda):
    """The tiny AdaBins: 4 kernel-5 launches a bf16 forward, and 4 forward
    and 4 backward launches (on the cluster route) a train step (with one kernel-4 forward and
    backward), each matching the plain versions on its own tensors."""
    model = build_adabins_model(device="cuda", encoder_name="efficientnet-tiny",
                                attn_impl="kernel")
    f0, b0 = kattn.fused_mha_fwd.launches, kattn.fused_mha_bwd.launches
    c0 = kattn.fused_mha_bwd.cluster_launches
    with torch.no_grad(), record_attention_io() as records:
        model(torch.randn((2, 384, 352, 3), device="cuda"))
    step, batch = build_adabins_train(batch=2, h=384, w=352, device="cuda",
                                      encoder_name="efficientnet-tiny", attn_impl="kernel")
    e0 = kexp.bins_expectation_fwd.launches
    with record_attention_io() as train_records:
        loss = step(batch, None)
    torch.cuda.synchronize()
    assert kattn.fused_mha_fwd.launches == f0 + 8 and kattn.fused_mha_bwd.launches == b0 + 4
    assert kattn.fused_mha_bwd.cluster_launches == c0 + 4  # 132 tokens: the cluster route
    assert kexp.bins_expectation_fwd.launches == e0 + 1 and torch.isfinite(loss)
    assert [r["kind"] for r in train_records].count("bwd") == 4
    for rec in records + train_records:
        _assert_attn_close(attention_plain_outputs(rec))


def _mbconv_inputs(gen, b, h, w, cin, m, k, be_scale=3.0, batch_minor=False):
    """bf16 x (NHWC, or (H, W, B, C)) and weights, fp32 biases; a large be
    makes silu(be) far from zero, so a halo left unzeroed shows."""
    shape = (h, w, b, cin) if batch_minor else (b, h, w, cin)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    we = (torch.randn((cin, m), generator=gen, device="cuda") / cin ** 0.5).to(torch.bfloat16)
    be = be_scale * torch.randn(m, generator=gen, device="cuda")
    wd = (0.3 * torch.randn((k, k, 1, m), generator=gen, device="cuda")).to(torch.bfloat16)
    bd = 0.3 * torch.randn(m, generator=gen, device="cuda")
    return x, we, be, wd, bd


def _assert_mbconv_ok(x, we, be, wd, bd, k, y, pool):
    errs = mbconv_head_errors(x, we, be, wd, bd, k, y, pool, MB_RTOL, MB_ATOL, POOL_RTOL)
    assert errs["bad"] == 0, errs


@gpu
@pytest.mark.parametrize("shape", [
    (8, 120, 160, 40, 240, 3),  # B5 stage 1: four strips, partials added by a second launch
    (2, 15, 20, 304, 1824, 5),  # B5 stage 5: 29 slabs, blocks that change slab
    (2, 17, 23, 24, 48, 5),  # Cin 24: one K chunk zero-filled past Cin; ragged strips
    (3, 9, 33, 512, 96, 3),  # Cin 512: 8 K chunks a stage
    (1, 10, 10, 16, 56, 5),  # M 56: one ragged slab
    (1, 1, 1, 8, 8, 3),  # one pixel: every tap but the centre is halo
    (1, 12, 50, 16, 64, 5),  # W 50: seven strips, a boundary every 8 columns
    (2, 15, 20, 176, 1056, 5),  # M 1056: 17 slabs, the last ragged
    (2, 1, 37, 24, 96, 5),  # H 1: every band row but one outside the image
    (8, 30, 40, 176, 1056, 5),  # B5 stage 4: about three items a block, one pipeline
])
def test_kernel8_matches_plain(cuda, shape):
    b, h, w, cin, m, k = shape
    args = _mbconv_inputs(cuda, b, h, w, cin, m, k)
    y, pool = kmb.mbconv_expand_dw_pool(*args, k)
    torch.cuda.synchronize()
    assert y.shape == (b, h, w, m) and y.dtype == torch.bfloat16 and pool.shape == (b, m)
    _assert_mbconv_ok(*args, k, y, pool)


@gpu
@pytest.mark.parametrize("shape", [(8, 120, 160, 40, 240, 3), (8, 30, 40, 128, 768, 3)],
                         ids=["stage1-pool-partials", "stage3-pool-direct"])
def test_kernel8_is_bitwise_deterministic(cuda, shape):
    """Two calls on the same inputs give identical y and pool: the pool's
    sums run in a fixed order, with no atomics (partials added by a second
    kernel at stage 1, written by the block that covers the image at stage
    3)."""
    b, h, w, cin, m, k = shape
    args = _mbconv_inputs(cuda, b, h, w, cin, m, k)
    first = kmb.mbconv_expand_dw_pool(*args, k)
    second = kmb.mbconv_expand_dw_pool(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@gpu
@pytest.mark.parametrize("shape", [(12, 17, 4, 40, 240, 3), (7, 9, 3, 24, 48, 5)])
def test_kernel9_matches_plain(cuda, shape):
    h, w, b, cin, m, k = shape
    x_t, we, be, wd, bd = _mbconv_inputs(cuda, b, h, w, cin, m, k, batch_minor=True)
    y_t, pool = kmb.mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, k)
    torch.cuda.synchronize()
    assert y_t.shape == (h, w, b, m)
    _assert_mbconv_ok(x_t.permute(2, 0, 1, 3), we, be, wd, bd, k, y_t.permute(2, 0, 1, 3), pool)


@gpu
@pytest.mark.parametrize("shape,k,with_pool", [((8, 30, 40, 768), 3, True),
                                               ((2, 15, 20, 160), 5, True),
                                               ((2, 15, 20, 160), 5, False),
                                               ((1, 3, 2, 56), 3, True),
                                               ((2, 9, 21, 240), 3, True),
                                               ((8, 15, 20, 1824), 5, False),
                                               ((8, 15, 20, 1824), 5, True),
                                               ((2, 7, 300, 64), 3, True),
                                               ((2, 6, 130, 72), 5, True),
                                               ((2, 1, 37, 64), 5, True),
                                               ((3, 1, 9, 8), 3, True),
                                               ((2, 2, 30, 64), 5, True)],
                         ids=["stage3", "k5", "k5-no-pool", "c56", "c240-slab-tail",
                              "stage5-1824", "stage5-1824-pool", "wider-than-a-strip",
                              "k5-wider-than-a-strip", "h1", "h1-c8", "h-below-k"])
def test_kernel10_matches_plain(cuda, shape, k, with_pool):
    b, h, w, c = shape
    x, _, _, wd, bd = _mbconv_inputs(cuda, b, h, w, c, c, k)
    y, pool = kmb.dw_conv_silu_pool(x, wd, bd, k, with_pool)
    torch.cuda.synchronize()
    assert (pool is None) == (not with_pool)
    _assert_mbconv_ok(x, None, None, wd, bd, k, y, pool)


@gpu
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("edit", [dict(seg_rows=1, stages=2), dict(seg_rows=4, stages=3, grid=1),
                                  dict(narrow=True, stages=5), dict(seg_rows=17, grid=7)],
                         ids=["one-row-segments", "one-block", "narrow-strips", "whole-height"])
def test_kernel10_matches_plain_on_other_plans(cuda, k, edit):
    """Plans the wrapper would not pick, through its launch: one-row
    segments on a ring of 2 (every slot reused each row), one block walking
    every item, strips of one warp, segments of the whole height; each with
    the pool from partials (and, at one strip and segment, directly)."""
    b, h, w, c = 2, 17, 45, 136
    x, _, _, wd, bd = _mbconv_inputs(cuda, b, h, w, c, c, k)
    plan = kmb.dw_plan(b, h, w, c, k, torch.cuda.get_device_properties(0).multi_processor_count)
    edit = dict(edit)
    if edit.pop("narrow", False):
        edit.update(strip_w=kmb.DW_COLS[k], warps=1)
    plan = dataclasses.replace(plan, **edit)
    plan = dataclasses.replace(plan, grid=min(plan.grid, plan.items))
    y, pool = kmb._launch_dw(x, wd.reshape(k * k, c), bd, k, True, plan)
    torch.cuda.synchronize()
    _assert_mbconv_ok(x, None, None, wd, bd, k, y, pool)


@gpu
@pytest.mark.parametrize("shape,with_pool", [((0, 15, 20, 160), True), ((2, 0, 20, 160), True),
                                             ((2, 15, 0, 160), False)],
                         ids=["no-images", "no-rows", "no-columns-no-pool"])
def test_kernel10_empty_x_launches_nothing(cuda, shape, with_pool):
    """An empty x on the card: an empty y, a zero pool on the card, no
    launch counted."""
    b, h, w, c = shape
    x, _, _, wd, bd = _mbconv_inputs(cuda, b, h, w, c, c, 5)
    before = kmb.dw_conv_silu_pool.launches
    y, pool = kmb.dw_conv_silu_pool(x, wd, bd, 5, with_pool)
    torch.cuda.synchronize()
    assert kmb.dw_conv_silu_pool.launches == before
    assert y.shape == x.shape and y.device == x.device
    if with_pool:
        assert pool.device == x.device and torch.equal(pool.cpu(), torch.zeros((b, c)))
    else:
        assert pool is None


@gpu
@pytest.mark.parametrize("shape,k", [((8, 120, 160, 240), 3), ((8, 15, 20, 1824), 5)],
                         ids=["stage1-pool-partials", "stage5-pool-direct"])
def test_kernel10_is_bitwise_deterministic(cuda, shape, k):
    """Two calls on the same inputs give identical y and pool: the pool's
    sums run in a fixed order, with no atomics."""
    b, h, w, c = shape
    x, _, _, wd, bd = _mbconv_inputs(cuda, b, h, w, c, c, k)
    first = kmb.dw_conv_silu_pool(x, wd, bd, k)
    second = kmb.dw_conv_silu_pool(x, wd, bd, k)
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int16), second[0].view(torch.int16))
    assert torch.equal(first[1], second[1])


@gpu
@pytest.mark.parametrize("shape,with_skip", [
    ((2, 15, 20, 48, 24), True),  # H*W = 300: 128-row tiles cross images
    ((3, 7, 11, 24, 24), True),  # M 24: a zero-filled chunk
    ((2, 15, 20, 3072, 512), False),  # B5 stage 6's last block
    ((1, 5, 5, 144, 40), False),  # O 40: a ragged column tile
    ((8, 120, 160, 144, 40), False),  # B5 stage 2's first block
    ((8, 2, 3, 48, 24), True),  # H*W = 6: a 128-row tile crosses 22 images
    ((8, 5, 5, 144, 40), True),  # H*W = 25, three 64-row chunks of M
])
def test_kernel7_matches_plain(cuda, shape, with_skip):
    b, h, w, m, o = shape
    dw = torch.randn((b, h, w, m), generator=cuda, device="cuda").to(torch.bfloat16)
    gate = torch.rand((b, m), generator=cuda, device="cuda").to(torch.bfloat16)
    kern = (torch.randn((m, o), generator=cuda, device="cuda") / m ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(o, generator=cuda, device="cuda")
    skip = (torch.randn((b, h, w, o), generator=cuda, device="cuda").to(torch.bfloat16)
            if with_skip else None)
    out = kse.se_gate_project(dw, gate, kern, bias, skip)
    torch.cuda.synchronize()
    errs = se_project_errors(dw, gate, kern, bias, skip, out, MB_RTOL, MB_ATOL)
    assert errs["bad"] == 0, errs


@gpu
@pytest.mark.parametrize("with_skip", [False, True], ids=["no-skip", "skip"])
@pytest.mark.parametrize("shape", [s[:4] for s in SE_SHAPES], ids=[str(s[:4]) for s in SE_SHAPES])
def test_kernel7_at_the_b5_shapes_is_right_and_deterministic(cuda, shape, with_skip):
    """Kernel 7 at its seven B5 shapes, batch 8, each with and without a
    skip: within the error check of its plain version, and two calls
    bitwise equal (no atomics)."""
    h, w, m, o = shape
    dw = torch.randn((8, h, w, m), generator=cuda, device="cuda").to(torch.bfloat16)
    gate = torch.rand((8, m), generator=cuda, device="cuda").to(torch.bfloat16)
    kern = (torch.randn((m, o), generator=cuda, device="cuda") / m ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(o, generator=cuda, device="cuda")
    skip = (torch.randn((8, h, w, o), generator=cuda, device="cuda").to(torch.bfloat16)
            if with_skip else None)
    out = kse.se_gate_project(dw, gate, kern, bias, skip)
    again = kse.se_gate_project(dw, gate, kern, bias, skip)
    torch.cuda.synchronize()
    errs = se_project_errors(dw, gate, kern, bias, skip, out, MB_RTOL, MB_ATOL)
    assert errs["bad"] == 0, errs
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@gpu
def test_kernels7to10_raise_instead_of_falling_back_and_count_launches(cuda):
    x, we, be, wd, bd = _mbconv_inputs(cuda, 1, 4, 4, 8, 16, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kmb.mbconv_expand_dw_pool(x.transpose(1, 2), we, be, wd, bd, 3)
    with pytest.raises(ValueError, match="bf16"):
        kmb.mbconv_expand_dw_pool(x.float(), we, be, wd, bd, 3)
    with pytest.raises(ValueError, match="fp32 biases"):
        kmb.mbconv_expand_dw_pool(x, we, be.bfloat16(), wd, bd, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        kmb.dw_conv_silu_pool(x[..., :6].contiguous(), wd[..., :6].contiguous(), bd[:6], 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        kmb.mbconv_bs_expand_dw_pool(x, we.requires_grad_(), be, wd, bd, 3)
    we.requires_grad_(False)
    dw = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16, device="cuda")
    gate = torch.zeros((1, 16), dtype=torch.bfloat16, device="cuda")
    kern = torch.zeros((16, 8), dtype=torch.bfloat16, device="cuda")
    bias = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        kse.se_gate_project(dw.transpose(1, 2), gate, kern, bias)
    with pytest.raises(ValueError, match="bf16"):
        kse.se_gate_project(dw, gate.float(), kern, bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        kse.se_gate_project(dw, gate, kern.requires_grad_(), bias)
    kern.requires_grad_(False)
    counters = (kmb.mbconv_expand_dw_pool, kmb.mbconv_bs_expand_dw_pool, kmb.dw_conv_silu_pool,
                kse.se_gate_project)
    before = [f.launches for f in counters]
    kmb.mbconv_expand_dw_pool(x, we, be, wd, bd, 3)
    kmb.mbconv_expand_dw_pool_plain(x, we, be, wd, bd, 3)
    kmb.mbconv_bs_expand_dw_pool(x, we, be, wd, bd, 3)
    kmb.dw_conv_silu_pool(x, wd[..., :8].contiguous(), bd[:8], 3, with_pool=False)
    kse.se_gate_project(dw, gate, kern, bias)
    kse.se_gate_project_plain(dw, gate, kern, bias)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]


@gpu
@pytest.mark.parametrize("switch", ["fused_mbconv_head", "se_project"])
def test_fused_blocks_in_fp16_raise_on_the_card(cuda, switch):
    """Only fp32 takes the plain versions on the card: a fused block of
    another dtype than bf16 reaches the kernel's wrapper, which raises."""
    block = fold_batchnorm(common.MBConv(16, 16, 6, 3, 1, **{switch: True}).eval())
    block = block.to(device="cuda", dtype=torch.float16, memory_format=torch.channels_last)
    x = torch.randn((1, 16, 8, 8), generator=cuda, device="cuda").half()
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        block(x.contiguous(memory_format=torch.channels_last))


@gpu
def test_tiny_graphbins_on_the_encoder_kernel_route(cuda):
    """The tiny GraphBins in bf16 on ``encoder_impl="kernel"``: 2 kernel-8
    and 5 kernel-7 launches a forward, each output within the error check on
    its own tensors; the plain route launches neither."""
    gen = torch.Generator().manual_seed(3)
    inputs = (torch.randn((2, 384, 352, 3), generator=gen), 0.05 * torch.randn((2, 6, 512)),
              300 * torch.rand((2, 6, 4)), torch.tensor([[True] * 3 + [False] * 3,
                                                          [True] + [False] * 5]))
    for impl, want in (("plain", (0, 0)), ("kernel", (2, 5))):
        model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny",
                                     encoder_impl=impl)
        before = (kmb.mbconv_expand_dw_pool.launches, kse.se_gate_project.launches)
        with torch.no_grad(), record_encoder_kernel_io() as records:
            depth = model(*(t.cuda() for t in inputs))["depth_pred"]
        torch.cuda.synchronize()
        after = (kmb.mbconv_expand_dw_pool.launches, kse.se_gate_project.launches)
        assert tuple(a - b for a, b in zip(after, before)) == want
        assert torch.isfinite(depth).all() and len(records) == sum(want)
        for rec in records:
            if rec["kind"] == "mbconv_head":
                _assert_mbconv_ok(*rec["args"], *rec["out"])
            else:
                errs = se_project_errors(*rec["args"], rec["out"], MB_RTOL, MB_ATOL)
                assert errs["bad"] == 0, errs


@gpu
def test_bf16_eval_step_launches_kernels_1_and_2_and_fp32_none(cuda):
    """The flip-TTA eval step (batch 1, so a 2-image forward) on the tiny
    GraphBins with BN unfolded, as validate runs it: in bf16, 4 concat-form
    kernel-1 launches and 1 kernel-2 launch, each output matching its plain
    version on its own tensors; in fp32 no launch. The two depths agree
    within 0.02 relative L2 (chip_smoke.py's feature bound)."""
    from objcavit_torch.losses import LossWrapper
    from objcavit_torch.metrics import MetricsPreprocessConfig, metrics_init
    from objcavit_torch.models.graphbins import GraphBins
    from objcavit_torch.training.steps import make_eval_step
    from objcavit_torch.utils.benchkit import init_weights_

    model = init_weights_(GraphBins(encoder_name="efficientnet-tiny"),
                          torch.Generator().manual_seed(0))
    model.to("cuda", memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(4)
    batch = {"image": torch.randn((1, 384, 352, 3), generator=gen),
             "depth": 0.01 + 9 * torch.rand((1, 384, 352, 1), generator=gen),
             "sample_valid": torch.tensor([True])}
    objects = {"features": torch.zeros((1, 6, 512)), "xywh": torch.full((1, 6, 4), -1.0),
               "valid": torch.tensor([[True] + [False] * 5])}
    batch, objects = ({k: v.cuda() for k, v in d.items()} for d in (batch, objects))
    depths = {}
    for dtype, launches in ((torch.bfloat16, (4, 4, 1)), (torch.float32, (0, 0, 0))):
        step = make_eval_step(model, LossWrapper(["silog"], [1.0]),
                              MetricsPreprocessConfig(0.001, 10.0), flip_tta=True,
                              compute_dtype=dtype)
        resize_fn, bins_fn = kresize.resize_bilinear_align_corners, kbins.conv_bins_depth_batched
        before = (resize_fn.launches, resize_fn.concat_launches, bins_fn.launches)
        with record_kernel_io(model) as records:
            state, loss, depths[dtype] = step(batch, objects, objects, metrics_init("cuda"))
        torch.cuda.synchronize()
        after = (resize_fn.launches, resize_fn.concat_launches, bins_fn.launches)
        assert tuple(a - b for a, b in zip(after, before)) == launches
        assert torch.isfinite(loss) and float(state["abs_rel/count"]) > 0
        if dtype == torch.bfloat16:
            assert records[0]["depth"].shape[0] == 2  # the image and its mirror
            resize, (depth, plain_depth) = plain_outputs(model, records[0])
            for y, want in resize:
                _assert_close(y, want, RESIZE_RTOL, RESIZE_ATOL)
            assert skip_mismatches(records[0]) == 0
            _assert_close(depth, plain_depth, BINS_RTOL, BINS_ATOL)
    got, want = depths[torch.bfloat16], depths[torch.float32]
    assert float((got - want).norm() / want.norm()) < 0.02
