"""Shared building blocks: TF-SAME conv, conv/BN/act, SE, MBConv family.

Port of ``objcavit_tpu/models/common.py``. Attribute names are the reference
gen-efficientnet names (``conv_pw``, ``bn1``, ``conv_dw``, ``se.conv_reduce``,
...), so a reference state dict loads with a plain ``load_state_dict``.
These blocks run inside the encoder on NCHW tensors in
``torch.channels_last`` memory (the memory of the NHWC tensors the public
modules take). BN eps is 1e-3 and the activation SiLU, as in the
``tf_efficientnet_*`` encoders.

Not ported: ``SpaceToDepthConv`` (an exact rewrite of the stride-2 stem for
the TPU's layout; the plain strided conv with the same weights stands here),
and ``FusedMBConv`` (EfficientNet-V2, ROADMAP A.5).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3


class Conv2dSame(nn.Conv2d):
    """Conv2d with TensorFlow's SAME padding, asymmetric where it must be
    (more padding after than before), as the ``tf_efficientnet_*`` weights
    were trained with. Symmetric cases pass their padding to the conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        if ph % 2 == 0 and pw % 2 == 0:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph // 2, pw // 2), self.dilation, self.groups)
        x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def conv_bn_act(conv: nn.Module, bn: nn.Module, x: torch.Tensor, act: bool = True):
    """ConvBnAct: conv -> BN -> SiLU. Kept a function over the block's own
    attributes so the parameters keep the reference's flat names; after
    ``utils.fold_bn.fold_batchnorm`` the BN is an ``nn.Identity``."""
    x = bn(conv(x))
    return F.silu(x) if act else x


class PatchEmbedConv(nn.Conv2d):
    """Non-overlapping patch embedding: a plain Conv2d with kernel == stride."""

    def __init__(self, in_channels: int, features: int, patch_size: int):
        super().__init__(in_channels, features, patch_size, patch_size)


class SqueezeExcite(nn.Module):
    """EfficientNet SE: spatial mean, 1x1 reduce, SiLU, 1x1 expand, sigmoid gate."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, se_channels, 1)
        self.conv_expand = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """EfficientNet stage-0 block: dw conv -> BN -> SiLU -> SE -> pw -> BN (+x)."""

    bn_folds = (("conv_dw", "bn1"), ("conv_pw", "bn2"))

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 se_ratio: float = 0.25):
        super().__init__()
        self.conv_dw = Conv2dSame(in_ch, in_ch, kernel_size, stride, groups=in_ch, bias=False)
        self.bn1 = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * se_ratio)))
        self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.has_residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_bn_act(self.conv_dw, self.bn1, x)
        h = self.se(h)
        h = conv_bn_act(self.conv_pw, self.bn2, h, act=False)
        return h + x if self.has_residual else h


class MBConv(nn.Module):
    """EfficientNet inverted residual: 1x1 expand -> dw -> SE -> 1x1 project (+x)."""

    bn_folds = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float,
                 kernel_size: int, stride: int, se_ratio: float = 0.25):
        super().__init__()
        mid = int(in_ch * expand_ratio)
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv_dw = Conv2dSame(mid, mid, kernel_size, stride, groups=mid, bias=False)
        self.bn2 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.has_residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_bn_act(self.conv_pw, self.bn1, x)
        h = conv_bn_act(self.conv_dw, self.bn2, h)
        h = self.se(h)
        h = conv_bn_act(self.conv_pwl, self.bn3, h, act=False)
        return h + x if self.has_residual else h
