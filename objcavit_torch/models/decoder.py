"""U-Net decoder and DenseFeatureExtractor (reference DenseFeatureExtractor.py).

Port of ``objcavit_tpu/models/decoder.py``, with the reference's module
names (``conv2``, ``up1..up4._net.{0,1,3,4}``, ``conv3``):

* ``conv2`` is the reference's 1x1 conv with padding=1, which grows the
  bottleneck by a ring of pure bias on every side.
* Each up-stage resizes to its skip with align_corners=True, concatenates
  the skip, then runs 2x [3x3 conv -> BN (eps 1e-5) -> LeakyReLU(0.01)]. The
  JAX package split that conv along its input channels to keep the concat out
  of TPU memory; here it is the concat and one conv.
* ``do_final_upscale`` adds a fifth stage, ``final_upscale``, whose skip is
  the input image itself (3 channels), so the features come out at the
  image's full resolution instead of half of it.
* In bf16, outside training, the upsample and the concat are one launch of
  CUDA kernel 1's concat form (``kernels/resize.py::
  resize_bilinear_align_corners_into_concat``): it writes the upsample and
  the skip into the one buffer the conv reads, which keeps the concat's
  extra read and write out of memory on the card, as the JAX package's
  split conv did on the TPU. Its wrapper runs the plain version (resize,
  then ``torch.cat``) on a CPU tensor. The kernel has no backward, so a
  module in training mode takes the differentiable plain route, as the JAX
  package gates its Pallas resize on ``not train``
  (``objcavit_tpu/models/decoder.py:91-98``). An fp32 model takes the plain
  route on any device, as the JAX package gates that kernel on bf16: on the
  card that is the reference route, which launches no kernel. The concat
  form takes a skip of a multiple of 8 channels only
  (``kernels/resize.py::concat_takes_skip``); the final upsample's skip is
  the 3-channel image, so there kernel 1's bare form writes the upsample
  and ``torch.cat`` appends the image, where the JAX package runs its
  Pallas resize too (C = 128 passes its ``resize_eligible``) before its
  split conv.

Spatial serving (``parallel/spatial.py``): in a split forward each rank
holds its band of every skip. The bottleneck is gathered over the model
group and ``conv2`` runs on the whole of it (its ring of bias belongs to
the image's edges); each later stage's input is gathered before its
upsample, since an align-corners output row reads input rows across the
whole image. Each upsample then writes the band's output rows alone, beside
the skip's band: kernel 1's row-window form in bf16
(``kernels/resize.py::resize_bilinear_align_corners_rows``, in its concat
layout where the concat form takes the skip), its plain version in fp32.
The 3x3 convs take their 1-row halos (``models/common.py::Conv2d``).

The up-stages' BatchNorms are ``models/common.py::BatchNorm2d``: over the
global batch in a process group. Modules take and return NHWC tensors;
inside, they are NCHW views in ``torch.channels_last`` memory, which is the
same memory.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from objcavit_torch.kernels.resize import (
    concat_takes_skip,
    resize_bilinear_align_corners,
    resize_bilinear_align_corners_into_concat,
    resize_bilinear_align_corners_rows,
    resize_rows_plain,
)
from objcavit_torch.models.common import BatchNorm2d, Conv2d
from objcavit_torch.models.efficientnet import EfficientNetEncoder, encoder_spec
from objcavit_torch.ops.resize import resize_bilinear
from objcavit_torch.parallel import spatial
from objcavit_torch.utils.profiling import annotate

DECODER_BN_EPS = 1e-5
ENCODER_IMPLS = ("plain", "kernel")


def upsample_concat(x: torch.Tensor, skip: torch.Tensor, train: bool) -> torch.Tensor:
    """NCHW channels_last x and skip -> cat([x upsampled to skip's size with
    align_corners=True, skip], channels), NCHW channels_last."""
    x_nhwc, (ho, wo) = x.permute(0, 2, 3, 1), skip.shape[2:]
    if spatial.active() is not None:
        return upsample_concat_rows(x_nhwc, skip, train)
    if x.dtype == torch.bfloat16 and not train:
        if concat_takes_skip(skip.shape[1]):
            return resize_bilinear_align_corners_into_concat(
                x_nhwc, skip.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        up = resize_bilinear_align_corners(x_nhwc, ho, wo)
    else:
        up = resize_bilinear(x_nhwc, ho, wo, align_corners=True)
    return torch.cat([up.permute(0, 3, 1, 2), skip], dim=1)


def upsample_concat_rows(x_nhwc: torch.Tensor, skip: torch.Tensor, train: bool) -> torch.Tensor:
    """``upsample_concat`` in a split forward: the whole low-resolution x
    (NHWC), this rank's band of the skip (NCHW channels_last) -> the band's
    rows of the concat, NCHW channels_last."""
    y0, y1, ho = spatial.band_window(skip.shape[2])
    wo = skip.shape[3]
    skip_nhwc = skip.permute(0, 2, 3, 1)
    if x_nhwc.dtype == torch.bfloat16 and not train:
        if concat_takes_skip(skip.shape[1]):
            return resize_bilinear_align_corners_rows(x_nhwc, ho, wo, y0, y1,
                                                      skip_nhwc).permute(0, 3, 1, 2)
        up = resize_bilinear_align_corners_rows(x_nhwc, ho, wo, y0, y1)
    else:
        up = resize_rows_plain(x_nhwc, ho, wo, y0, y1)
    return torch.cat([up.permute(0, 3, 1, 2), skip], dim=1)


class UpSampleWithSkip(nn.Module):
    bn_folds = (("_net.0", "_net.1"), ("_net.3", "_net.4"))

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self._net = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, 1, 1),
            BatchNorm2d(out_channels, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01),
            Conv2d(out_channels, out_channels, 3, 1, 1),
            BatchNorm2d(out_channels, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """x, skip: NCHW channels_last."""
        return self._net(upsample_concat(x, skip, self.training))


class Decoder(nn.Module):
    """[skip0 .. skip3, bottleneck] (NHWC) and the image -> (B, H/2, W/2,
    128) features, or (B, H, W, 128) with ``do_final_upscale``."""

    def __init__(self, encoder_name: str, num_classes: int = 128, do_final_upscale: bool = False):
        super().__init__()
        self.do_final_upscale = do_final_upscale
        spec = encoder_spec(encoder_name)
        f = spec.head_channels
        s0, s1, s2, s3, _ = spec.skip_channels
        self.conv2 = nn.Conv2d(f, f, 1, 1, 1)
        self.up1 = UpSampleWithSkip(f + s3, f // 2)
        self.up2 = UpSampleWithSkip(f // 2 + s2, f // 4)
        self.up3 = UpSampleWithSkip(f // 4 + s1, f // 8)
        self.up4 = UpSampleWithSkip(f // 8 + s0, f // 16)
        if do_final_upscale:  # its skip is the RGB image
            self.final_upscale = UpSampleWithSkip(f // 16 + 3, f // 16)
        self.conv3 = Conv2d(f // 16, num_classes, 3, 1, 1)

    def stages(self) -> list[UpSampleWithSkip]:
        """The up-stages in order: up1..up4, then final_upscale if built."""
        names = ["up1", "up2", "up3", "up4"] + ["final_upscale"] * self.do_final_upscale
        return [getattr(self, n) for n in names]

    def forward(self, features: list[torch.Tensor],
                image: torch.Tensor | None = None) -> torch.Tensor:
        """``image`` (B, H, W, 3) NHWC is the final upsample's skip; only a
        decoder with ``do_final_upscale`` needs it."""
        skips = list(features[3::-1])
        if self.do_final_upscale:
            if image is None:
                raise ValueError("a decoder with do_final_upscale takes the image as its last skip")
            skips.append(image)
        skips = [t.permute(0, 3, 1, 2) for t in skips]
        bottleneck = features[4].permute(0, 3, 1, 2)
        split = spatial.active() is not None
        if split:  # conv2's ring of bias lies on the whole image's edges
            bottleneck = spatial.gather_rows(bottleneck, 2)
        with spatial.suspended() if split else contextlib.nullcontext():
            x = self.conv2(bottleneck)
        for i, (stage, skip) in enumerate(zip(self.stages(), skips)):
            if split and i:
                x = spatial.gather_rows(x, 2)
            x = stage(x, skip)
        return self.conv3(x).permute(0, 2, 3, 1)


class DenseFeatureExtractor(nn.Module):
    """Encoder + U-Net decoder: (B, H, W, 3) -> (B, H/2, W/2, 128), NHWC,
    or (B, H, W, 128) with ``do_final_upscale``.

    The encoder sits at ``encoder.original_model`` as in the reference, which
    wraps a timm model there. ``encoder_impl`` is its route: ``"plain"`` or
    ``"kernel"`` (both of the encoder's fused routes, kernels 7 and 8);
    ``drop_path_rate`` its stochastic depth.
    """

    def __init__(self, encoder_name: str, encoder_impl: str = "plain",
                 do_final_upscale: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        if encoder_impl not in ENCODER_IMPLS:
            raise ValueError(f"encoder_impl must be one of {ENCODER_IMPLS}, got {encoder_impl!r}")
        fused = encoder_impl == "kernel"
        self.encoder = nn.ModuleDict({"original_model": EfficientNetEncoder(
            encoder_name, fused_mbconv_head=fused, se_project=fused,
            drop_path_rate=drop_path_rate)})
        self.decoder = Decoder(encoder_name, do_final_upscale=do_final_upscale)

    def forward(self, image: torch.Tensor, generator=None) -> torch.Tensor:
        """``generator`` feeds the encoder's stochastic depth in training mode."""
        with annotate("model.encoder"):
            features = self.encoder["original_model"](image, generator)
        with annotate("model.decoder"):
            return self.decoder(features, image)
