"""EfficientNet B-series encoders as skip-feature pyramids.

Port of ``objcavit_tpu/models/efficientnet.py`` for the ``tf_efficientnet_*``
B-series (depthwise-separable stage 0, MBConv stages, TF-SAME padding), in
gen-efficientnet's layout: ``conv_stem``, ``bn1``, ``blocks.i.j.*``,
``conv_head``. The reference strips ``bn2``/``act2`` after ``conv_head``, so
the head is a bare 1x1 conv. The V2 encoders (fused blocks, torchvision
layout) wait for ROADMAP A.5.

b5 returns block0 (24ch, /2), block1 (40, /4), block2 (64, /8),
block4 (176, /16) and conv_head (2048, /32).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from objcavit_torch.models.common import (
    BN_EPS,
    Conv2dSame,
    DepthwiseSeparable,
    MBConv,
    conv_bn_act,
)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    stem_channels: int
    head_channels: int
    # per stage: (block_type, out_ch, depth, kernel, stride, expand)
    stages: tuple
    skip_stages: tuple  # indices (into stages) of the 4 skip features
    skip_channels: tuple  # channels of the 4 skips + bottleneck, low-res first


def _round_channels(c: float) -> int:
    """EfficientNet channel rounding: nearest multiple of 8, >= 0.9x."""
    new_c = max(8, int(c + 4) // 8 * 8)
    if new_c < 0.9 * c:
        new_c += 8
    return new_c


def _b_spec(width: float, depth: float) -> EncoderSpec:
    base_ch = [16, 24, 40, 80, 112, 192, 320]
    base_d = [1, 2, 2, 3, 3, 4, 1]
    kernels = [3, 3, 5, 3, 5, 5, 3]
    strides = [1, 2, 2, 2, 1, 2, 1]
    expands = [1, 6, 6, 6, 6, 6, 6]
    stages = tuple(
        (
            "ds" if i == 0 else "mb",
            _round_channels(base_ch[i] * width),
            int(math.ceil(base_d[i] * depth)),
            kernels[i],
            strides[i],
            expands[i],
        )
        for i in range(7)
    )
    head = _round_channels(1280 * width) if width > 1.0 else 1280
    return EncoderSpec(
        stem_channels=_round_channels(32 * width),
        head_channels=head,
        stages=stages,
        skip_stages=(0, 1, 2, 4),
        skip_channels=(stages[0][1], stages[1][1], stages[2][1], stages[4][1], head),
    )


ENCODER_SPECS = {
    "efficientnet-b5": _b_spec(1.6, 2.2),
    "efficientnet-b1": _b_spec(1.0, 1.1),
    # test-only: the b-series topology and skip contract, one tiny block per
    # stage
    "efficientnet-tiny": EncoderSpec(
        stem_channels=8,
        head_channels=64,
        stages=(
            ("ds", 8, 1, 3, 1, 1),
            ("mb", 16, 1, 3, 2, 2),
            ("mb", 16, 1, 3, 2, 2),
            ("mb", 24, 1, 3, 2, 2),
            ("mb", 24, 1, 3, 1, 2),
            ("mb", 32, 1, 3, 2, 2),
            ("mb", 32, 1, 3, 1, 2),
        ),
        skip_stages=(0, 1, 2, 4),
        skip_channels=(8, 16, 16, 24, 64),
    ),
}


def encoder_spec(encoder_name: str) -> EncoderSpec:
    if encoder_name not in ENCODER_SPECS:
        raise NotImplementedError(
            f"encoder {encoder_name!r} is not ported yet (the V2 encoders are "
            f"ROADMAP A.5); ported: {sorted(ENCODER_SPECS)}"
        )
    return ENCODER_SPECS[encoder_name]


class EfficientNetEncoder(nn.Module):
    """NHWC image -> [skip0 (/2), skip1 (/4), skip2 (/8), skip3 (/16),
    bottleneck (/32)], each NHWC."""

    bn_folds = (("conv_stem", "bn1"),)

    def __init__(self, encoder_name: str):
        super().__init__()
        spec = encoder_spec(encoder_name)
        self.skip_stages = spec.skip_stages
        self.conv_stem = Conv2dSame(3, spec.stem_channels, 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(spec.stem_channels, eps=BN_EPS)
        stages = []
        in_ch = spec.stem_channels
        for btype, out_ch, depth, kernel, stride, expand in spec.stages:
            blocks = []
            for bi in range(depth):
                s = stride if bi == 0 else 1
                if btype == "ds":
                    blocks.append(DepthwiseSeparable(in_ch, out_ch, kernel, s))
                else:
                    blocks.append(MBConv(in_ch, out_ch, expand, kernel, s))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(in_ch, spec.head_channels, 1, bias=False)

    def forward(self, image: torch.Tensor) -> list[torch.Tensor]:
        x = conv_bn_act(self.conv_stem, self.bn1, image.permute(0, 3, 1, 2))
        skips = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in self.skip_stages:
                skips.append(x.permute(0, 2, 3, 1))
        return skips + [self.conv_head(x).permute(0, 2, 3, 1)]
