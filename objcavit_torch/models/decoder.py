"""U-Net decoder and DenseFeatureExtractor (reference DenseFeatureExtractor.py).

Port of ``objcavit_tpu/models/decoder.py``, with the reference's module
names (``conv2``, ``up1..up4._net.{0,1,3,4}``, ``conv3``):

* ``conv2`` is the reference's 1x1 conv with padding=1, which grows the
  bottleneck by a ring of pure bias on every side.
* Each up-stage resizes to its skip with align_corners=True, concatenates
  the skip, then runs 2x [3x3 conv -> BN (eps 1e-5) -> LeakyReLU(0.01)]. The
  JAX package split that conv along its input channels to keep the concat out
  of TPU memory; here it is the concat and one conv.
* In bf16 the upsample is CUDA kernel 1 (``kernels/resize.py``), whose
  wrapper runs the plain version on a CPU tensor. An fp32 model runs the
  plain version on any device, as the JAX package gates its Pallas resize
  on bf16: on the card that is the reference route, which launches no
  kernel.

Modules take and return NHWC tensors; inside, they are NCHW views in
``torch.channels_last`` memory, which is the same memory.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from objcavit_torch.kernels.resize import resize_bilinear_align_corners
from objcavit_torch.models.efficientnet import EfficientNetEncoder, encoder_spec
from objcavit_torch.ops.resize import resize_bilinear

DECODER_BN_EPS = 1e-5


def upsample_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW channels_last -> (out_h, out_w), align_corners=True bilinear."""
    x_nhwc = x.permute(0, 2, 3, 1)
    if x.dtype == torch.bfloat16:
        y = resize_bilinear_align_corners(x_nhwc, out_h, out_w)
    else:
        y = resize_bilinear(x_nhwc, out_h, out_w, align_corners=True)
    return y.permute(0, 3, 1, 2)


class UpSampleWithSkip(nn.Module):
    bn_folds = (("_net.0", "_net.1"), ("_net.3", "_net.4"))

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1),
            nn.BatchNorm2d(out_channels, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1),
            nn.BatchNorm2d(out_channels, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """x, skip: NCHW channels_last."""
        up = upsample_align_corners(x, skip.shape[2], skip.shape[3])
        return self._net(torch.cat([up, skip], dim=1))


class Decoder(nn.Module):
    """[skip0 .. skip3, bottleneck] (NHWC) -> (B, H/2, W/2, 128) features."""

    def __init__(self, encoder_name: str, num_classes: int = 128):
        super().__init__()
        spec = encoder_spec(encoder_name)
        f = spec.head_channels
        s0, s1, s2, s3, _ = spec.skip_channels
        self.conv2 = nn.Conv2d(f, f, 1, 1, 1)
        self.up1 = UpSampleWithSkip(f + s3, f // 2)
        self.up2 = UpSampleWithSkip(f // 2 + s2, f // 4)
        self.up3 = UpSampleWithSkip(f // 4 + s1, f // 8)
        self.up4 = UpSampleWithSkip(f // 8 + s0, f // 16)
        self.conv3 = nn.Conv2d(f // 16, num_classes, 3, 1, 1)

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        skip0, skip1, skip2, skip3, bottleneck = (t.permute(0, 3, 1, 2) for t in features)
        x = self.conv2(bottleneck)
        x = self.up1(x, skip3)
        x = self.up2(x, skip2)
        x = self.up3(x, skip1)
        x = self.up4(x, skip0)
        return self.conv3(x).permute(0, 2, 3, 1)


class DenseFeatureExtractor(nn.Module):
    """Encoder + U-Net decoder: (B, H, W, 3) -> (B, H/2, W/2, 128), NHWC.

    The encoder sits at ``encoder.original_model`` as in the reference, which
    wraps a timm model there.
    """

    def __init__(self, encoder_name: str):
        super().__init__()
        self.encoder = nn.ModuleDict({"original_model": EfficientNetEncoder(encoder_name)})
        self.decoder = Decoder(encoder_name)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder["original_model"](image))
