"""EfficientNet encoders (B-series and V2) as skip-feature pyramids.

Port of ``objcavit_tpu/models/efficientnet.py``. Two layouts, chosen by
the spec's ``pad_style``:

* ``"tf"``: the ``tf_efficientnet_*`` B-series (depthwise-separable stage
  0, MBConv stages, TF-SAME padding) in gen-efficientnet's layout:
  ``conv_stem``, ``bn1``, ``blocks.i.j.*``, ``conv_head``. The reference
  strips ``bn2``/``act2`` after ``conv_head``, so the head is a bare 1x1
  conv. b5 returns block0 (24ch, /2), block1 (40, /4), block2 (64, /8),
  block4 (176, /16) and conv_head (2048, /32).
* ``"torch"``: torchvision's ``efficientnet_v2_{s,m}`` (FusedMBConv then
  MBConv stages, symmetric padding) in its layout: ``features.0.{0,1}`` the
  stem CNA (3x3 stride 2, BN, SiLU), ``features.{s+1}.{b}.block...`` stage
  s, and ``features.{n_stages+1}.{0,1}`` the head CNA, whose BN and SiLU
  the reference keeps. JAX's spec says so in ``head_bn_act``, which is
  true exactly where ``pad_style`` is "torch"; the port reads
  ``pad_style`` alone. v2-m returns stage0 (24, /2), stage1 (48, /4),
  stage2 (80, /8), stage4 (176, /16) and the head (1280, /32); v2-s 24,
  48, 64, 160, 1280.

``fused_mbconv_head`` and ``se_project`` are the JAX package's two switches
(its constructor flag and ``se_project_pallas.ENABLE``), passed to every
block: kernel 8's and kernel 7's routes of a folded encoder at inference
(``models/common.py``). ``block_routes()`` lists the route each block takes
now. At B5 with both on, 32 stride-1 MBConv blocks take kernel 8 and the
three DepthwiseSeparable blocks and four stride-2 first blocks take kernel
7; with ``se_project`` alone all 39 blocks take kernel 7. A V2 block never
takes kernel 8 (JAX takes it under TF padding only): every MBConv block
takes kernel 7 (44 at v2-m, 30 at v2-s) and every FusedMBConv block stays
plain convs.

``drop_path_rate`` is stochastic depth, as in JAX: block i of n (counted
over every stage) gets the rate ``drop_path_rate * i / n`` and, in training
mode, scales its residual branch by a keep mask drawn from the generator
the forward is given (``models/common.py::drop_path``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from objcavit_torch.models.common import (
    BN_EPS,
    BatchNorm2d,
    Conv2dSame,
    ConvNormAct,
    DepthwiseSeparable,
    FusedMBConv,
    MBConv,
    MBConvV2,
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
    pad_style: str = "tf"  # 'tf' (tf_efficientnet_*) | 'torch' (torchvision v2)


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


_V2_S_STAGES = (
    ("fused", 24, 2, 3, 1, 1),
    ("fused", 48, 4, 3, 2, 4),
    ("fused", 64, 4, 3, 2, 4),
    ("mb", 128, 6, 3, 2, 4),
    ("mb", 160, 9, 3, 1, 6),
    ("mb", 256, 15, 3, 2, 6),
)
_V2_M_STAGES = (
    ("fused", 24, 3, 3, 1, 1),
    ("fused", 48, 5, 3, 2, 4),
    ("fused", 80, 5, 3, 2, 4),
    ("mb", 160, 7, 3, 2, 4),
    ("mb", 176, 14, 3, 1, 6),
    ("mb", 304, 18, 3, 2, 6),
    ("mb", 512, 5, 3, 1, 6),
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
    # test-only: the v2 topology (fused and mb stages, torch padding, the
    # head's BN and SiLU) at tiny widths
    "efficientnet-v2-tiny": EncoderSpec(
        stem_channels=8,
        head_channels=64,
        stages=(
            ("fused", 8, 1, 3, 1, 1),
            ("fused", 16, 2, 3, 2, 4),
            ("fused", 16, 1, 3, 2, 4),
            ("mb", 24, 1, 3, 2, 4),
            ("mb", 24, 2, 3, 1, 6),
            ("mb", 32, 1, 3, 2, 6),
        ),
        skip_stages=(0, 1, 2, 4),
        skip_channels=(8, 16, 16, 24, 64),
        pad_style="torch",
    ),
    "efficientnet-v2-s": EncoderSpec(
        stem_channels=24,
        head_channels=1280,
        stages=_V2_S_STAGES,
        skip_stages=(0, 1, 2, 4),
        skip_channels=(24, 48, 64, 160, 1280),
        pad_style="torch",
    ),
    "efficientnet-v2-m": EncoderSpec(
        stem_channels=24,
        head_channels=1280,
        stages=_V2_M_STAGES,
        skip_stages=(0, 1, 2, 4),
        skip_channels=(24, 48, 80, 176, 1280),
        pad_style="torch",
    ),
}


def encoder_spec(encoder_name: str) -> EncoderSpec:
    if encoder_name not in ENCODER_SPECS:
        raise NotImplementedError(
            f"unknown encoder {encoder_name!r}; ported: {sorted(ENCODER_SPECS)}")
    return ENCODER_SPECS[encoder_name]


class EfficientNetEncoder(nn.Module):
    """NHWC image -> [skip0 (/2), skip1 (/4), skip2 (/8), skip3 (/16),
    bottleneck (/32)], each NHWC, in the layout of the spec's family (see
    the module note)."""

    def __init__(self, encoder_name: str, fused_mbconv_head: bool = False,
                 se_project: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        spec = encoder_spec(encoder_name)
        self.skip_stages = spec.skip_stages
        self.pad_style = spec.pad_style
        stages = []
        in_ch = spec.stem_channels
        total_blocks = sum(stage[2] for stage in spec.stages)
        block_idx = 0
        for btype, out_ch, depth, kernel, stride, expand in spec.stages:
            blocks = []
            for bi in range(depth):
                s = stride if bi == 0 else 1
                dpr = drop_path_rate * block_idx / max(total_blocks, 1)
                if btype == "ds":
                    blocks.append(DepthwiseSeparable(in_ch, out_ch, kernel, s,
                                                     se_project=se_project, drop_path_rate=dpr))
                elif btype == "fused":
                    blocks.append(FusedMBConv(in_ch, out_ch, expand, kernel, s,
                                              drop_path_rate=dpr))
                elif spec.pad_style == "torch":
                    blocks.append(MBConvV2(in_ch, out_ch, expand, kernel, s,
                                           se_project=se_project, drop_path_rate=dpr))
                else:
                    blocks.append(MBConv(in_ch, out_ch, expand, kernel, s,
                                         fused_mbconv_head=fused_mbconv_head,
                                         se_project=se_project, drop_path_rate=dpr))
                in_ch = out_ch
                block_idx += 1
            stages.append(nn.Sequential(*blocks))
        if self.pad_style == "torch":
            n = len(stages)
            self.features = nn.Sequential(ConvNormAct(3, spec.stem_channels, 3, 2), *stages,
                                          ConvNormAct(in_ch, spec.head_channels, 1))
            self.bn_folds = (("features.0.0", "features.0.1"),
                             (f"features.{n + 1}.0", f"features.{n + 1}.1"))
        else:
            self.conv_stem = Conv2dSame(3, spec.stem_channels, 3, 2, bias=False)
            self.bn1 = BatchNorm2d(spec.stem_channels, eps=BN_EPS)
            self.blocks = nn.Sequential(*stages)
            self.conv_head = nn.Conv2d(in_ch, spec.head_channels, 1, bias=False)
            self.bn_folds = (("conv_stem", "bn1"),)

    def stages(self) -> nn.Sequential:
        return self.features[1:-1] if self.pad_style == "torch" else self.blocks

    def block_routes(self) -> list[str]:
        """Each block's route, in order: 'plain', 'mbconv_head' (kernel 8) or
        'se_project' (kernel 7)."""
        return [block.route() for stage in self.stages() for block in stage]

    def forward(self, image: torch.Tensor, generator=None) -> list[torch.Tensor]:
        """``generator`` feeds the blocks' stochastic depth in training mode."""
        x = image.permute(0, 3, 1, 2)
        if self.pad_style == "torch":
            x, head = self.features[0](x), self.features[-1]
        else:
            x, head = conv_bn_act(self.conv_stem, self.bn1, x), self.conv_head
        skips = []
        for si, stage in enumerate(self.stages()):
            for block in stage:
                x = block(x, generator)
            if si in self.skip_stages:
                skips.append(x.permute(0, 2, 3, 1))
        return skips + [head(x).permute(0, 2, 3, 1)]
