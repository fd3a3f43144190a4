"""Shared building blocks: TF-SAME conv, conv/BN/act, SE, MBConv family.

Port of ``objcavit_tpu/models/common.py``. The B-series blocks
(``DepthwiseSeparable``, ``MBConv``) take the reference gen-efficientnet
names (``conv_pw``, ``bn1``, ``conv_dw``, ``se.conv_reduce``, ...) and
TF-SAME padding (``Conv2dSame``); the EfficientNet-V2 blocks
(``FusedMBConv``, ``MBConvV2``) take torchvision's (``block.{i}.{0,1}``,
``block.2.fc1``) and its symmetric ``k // 2`` padding (JAX's
``pad_style="torch"``, ``conv_padding``), which differs from TF SAME at
stride 2 on an even input. So a reference state dict of either family
loads with a plain ``load_state_dict``.
These blocks run inside the encoder on NCHW tensors in
``torch.channels_last`` memory (the memory of the NHWC tensors the public
modules take). BN eps is 1e-3 and the activation SiLU, as in both
families. In training mode each ``BatchNorm2d`` (``nn.BatchNorm2d``, over
the global batch in a process group)
normalises with the batch statistics and updates its running mean and its
unbiased running variance with momentum 0.1, which is what the JAX
package's ``_TorchBN`` copies (``objcavit_tpu/models/common.py:165-213``).

Two fused routes, off by default, take the JAX package's switches as
block constructor arguments that the encoder passes (``fused_mbconv_head``,
``se_project``) and mirror its branches (``objcavit_tpu/models/common.py:
387-428, 474-525, 565-570``). A block takes one only when its BNs are
folded and it is not training (``route``):

* ``"mbconv_head"``: a B-series MBConv with ``fused_mbconv_head``, an
  expansion and SE, stride 1 and widths the kernel takes runs expand, SiLU,
  depthwise, SiLU and the SE pool as kernel 8 (``kernels/mbconv.py``); the
  SE block takes the pool (``pooled``), and the project stays a cuDNN conv.
  JAX takes it only under TF padding, so a V2 block never does;
* ``"se_project"``: any other MBConv (a V2 one included), or a
  DepthwiseSeparable, with ``se_project`` runs the SE gate multiply, the
  project conv, its bias and the skip as kernel 7 (``kernels/se_project.py``)
  on the SE block's gate.

A ``FusedMBConv`` has no SE and no fused route: its convs stay cuDNN convs,
as they are plain convs in JAX.

An fp32 block takes the kernels' plain versions, the reference route; any
other dtype calls the kernels' wrappers, which launch on bf16 CUDA tensors,
raise on other CUDA tensors and run the plain versions on CPU tensors. The
routes have no backward: under autograd
a block on one raises. The kernels' weight layouts are made once per set of
weights (``FusedRoutes``).

Stochastic depth (``drop_path``, JAX's ``drop_path``): in training mode
a block that adds its skip (stride 1 and in == out) scales its residual
branch by a per-sample Bernoulli keep mask over the keep rate, drawn from
the generator the forward is given (the train step's, which also feeds the
dropout). The encoder sets each block's rate (``drop_path_rate``). A block
in eval mode, or at rate 0, draws nothing, so the fused routes (eval only)
are untouched.

Spatial serving (``parallel/spatial.py``): inside a split forward every
conv taller than one row (``Conv2d``, ``Conv2dSame``) takes its halo rows
from the model ranks above and below it under the plan, its height padding
taken from the whole image, and the SE means (``SqueezeExcite``,
``SqueezeExcitation``, kernel 8's pool) are the whole image's: the band's
sum, summed over the model group, over the image's H x W. Kernel 7's gate
then comes from that mean. Kernel 8 takes its band with its ``k // 2``
halo rows as one tensor and writes and pools the band's rows alone
(``kernels/mbconv.py::mbconv_expand_dw_pool_rows``). Outside a split
forward the modules run as they do without it.

Not ported: ``SpaceToDepthConv`` (an exact rewrite of the stride-2 stem for
the TPU's layout; the plain strided conv with the same weights stands here).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.mbconv import (
    mbconv_eligible,
    mbconv_expand_dw_pool,
    mbconv_expand_dw_pool_plain,
    mbconv_expand_dw_pool_rows,
    mbconv_expand_dw_pool_rows_plain,
    pack_mbconv,
)
from objcavit_torch.kernels.se_project import (
    pack_project,
    se_gate_project,
    se_gate_project_plain,
    se_project_eligible,
)
from objcavit_torch.parallel import spatial
from objcavit_torch.parallel.collectives import batch_norm as global_batch_norm
from objcavit_torch.parallel.collectives import rand_rows
from objcavit_torch.parallel.mesh import current_grid
from objcavit_torch.utils.fold_bn import FoldedBatchNorm

BN_EPS = 1e-3


def keep_mask(x: torch.Tensor, keep: float, generator: torch.Generator | None) -> torch.Tensor:
    """(B, 1, ..., 1) in x's dtype: 1 where a sample keeps its residual
    branch, with probability ``keep`` (``jax.random.bernoulli``'s rule,
    uniform < keep), drawn from ``generator`` (the default one if None); in
    a process group, this rank's rows of the global batch's draw."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return (rand_rows(shape, generator, x.device) < keep).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              mask_or_generator: torch.Tensor | torch.Generator | None = None) -> torch.Tensor:
    """Stochastic depth on a residual branch, JAX's arithmetic: x * mask /
    keep with a per-sample keep mask in x's dtype, given or drawn from the
    generator (``keep_mask``), and keep rounded to x's dtype as JAX's weak
    type is. The identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = (mask_or_generator.to(x.dtype) if isinstance(mask_or_generator, torch.Tensor)
            else keep_mask(x, keep, mask_or_generator))
    return x * mask / torch.tensor(keep, dtype=x.dtype, device=x.device)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``, whose training mode over more than one data rank
    (a process group, or a grid's data axis) normalises with the global batch's statistics
    (``parallel/collectives.py::batch_norm``), as the JAX package's sharded
    step does; elsewhere it is ``nn.BatchNorm2d`` itself."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and current_grid().n_data > 1:
            return global_batch_norm(self, x)
        return super().forward(x)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The spatial mean of NCHW ``x``, (B, C, 1, 1): the whole image's in a
    split forward (``parallel/spatial.py::mean_hw``)."""
    if spatial.active() is not None:
        return spatial.mean_hw(x)
    return x.mean((2, 3), keepdim=True)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``, which in a split forward (``parallel/spatial.py``)
    takes its halo rows for a height of more than one row."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.active() is None:
            return super().forward(x)
        ph, pw = self.padding
        return spatial.conv2d(x, self.weight, self.bias, self.stride, self.dilation, self.groups,
                              ph, (pw, pw))


class Conv2dSame(nn.Conv2d):
    """Conv2d with TensorFlow's SAME padding, asymmetric where it must be
    (more padding after than before), as the ``tf_efficientnet_*`` weights
    were trained with. Symmetric cases pass their padding to the conv. In a
    split forward the height's padding is the whole image's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        split = spatial.active() is not None
        if split:
            ih = spatial.whole_rows(ih)
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        if split:
            return spatial.conv2d(x, self.weight, self.bias, self.stride, self.dilation,
                                  self.groups, ph // 2, (pw // 2, pw - pw // 2))
        if ph % 2 == 0 and pw % 2 == 0:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph // 2, pw // 2), self.dilation, self.groups)
        x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def conv_bn_act(conv: nn.Module, bn: nn.Module, x: torch.Tensor, act: bool = True):
    """ConvBnAct: conv -> BN -> SiLU. Kept a function over the block's own
    attributes so the parameters keep the reference's flat names; after
    ``utils.fold_bn.fold_batchnorm`` the BN is a ``FoldedBatchNorm``, an
    identity that raises in training mode."""
    x = bn(conv(x))
    return F.silu(x) if act else x


class PatchEmbedConv(nn.Conv2d):
    """Non-overlapping patch embedding: a plain Conv2d with kernel == stride."""

    def __init__(self, in_channels: int, features: int, patch_size: int):
        super().__init__(in_channels, features, patch_size, patch_size)


class SqueezeExcite(nn.Module):
    """EfficientNet SE: spatial mean, 1x1 reduce, SiLU, 1x1 expand, sigmoid gate.

    ``pooled`` (B, C, 1, 1) stands for the spatial mean (kernel 8 gives it);
    ``gate_only`` returns the (B, C, 1, 1) gate instead of ``x * gate``."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, se_channels, 1)
        self.conv_expand = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor, pooled: torch.Tensor | None = None,
                gate_only: bool = False) -> torch.Tensor:
        s = spatial_mean(x) if pooled is None else pooled
        gate = torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))
        return gate if gate_only else x * gate


class ConvNormAct(nn.Sequential):
    """torchvision's Conv2dNormActivation, JAX's ``ConvBnAct`` under
    ``pad_style="torch"``: ``0`` a conv without bias and with symmetric
    ``k // 2`` padding, ``1`` a BN, ``2`` a SiLU where ``act``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [Conv2d(in_ch, out_ch, kernel_size, stride, kernel_size // 2, groups=groups,
                         bias=False),
                  BatchNorm2d(out_ch, eps=BN_EPS)]
        super().__init__(*layers, *([nn.SiLU()] if act else []))


class SqueezeExcitation(nn.Module):
    """torchvision's SE (``fc1``, ``fc2``): ``SqueezeExcite``'s function
    under V2's names."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, se_channels, 1)
        self.fc2 = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor, gate_only: bool = False) -> torch.Tensor:
        gate = torch.sigmoid(self.fc2(F.silu(self.fc1(spatial_mean(x)))))
        return gate if gate_only else x * gate


class Residual:
    """What every block with a skip shares: the skip added at stride 1 and
    in == out (``has_residual``), behind stochastic depth at the block's
    ``drop_path_rate`` in training mode."""

    def add_skip(self, h: torch.Tensor, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.has_residual:
            return h
        return drop_path(h, self.drop_path_rate, self.training, generator) + x


class FusedRoutes(Residual):
    """What the MBConvs and DepthwiseSeparable share for the fused routes: the
    route of the moment, and the weights in a kernel's layout (``packed``),
    made once per set of weights: rebuilt when a tensor is replaced, moved,
    cast or changed in place. While ``torch.export`` traces, the weights are
    the program's inputs, so the packing is traced into it, uncached."""

    def packed(self, name: str, pack, *tensors: torch.Tensor):
        if torch.compiler.is_exporting():
            return pack(*tensors)
        # a cast or a move makes a new tensor, an in-place edit a new version
        key = [(t.data_ptr(), t._version) for t in tensors]
        packs = self.__dict__.setdefault("_packs", {})
        hit = packs.get(name)
        if hit is None or hit[0] != key:
            hit = packs[name] = (key, pack(*tensors))
        return hit[1]

    def route(self) -> str:
        """The route this block takes now: ``fused_route`` (chosen from the
        switches and the widths when the block was built) when its BNs are
        folded and it is not training, else 'plain'."""
        if self.training or not all(type(self.get_submodule(bn)) is FoldedBatchNorm
                                    for _, bn in self.bn_folds):
            return "plain"
        return self.fused_route

    def check_fused_route(self, x: torch.Tensor) -> None:
        """Raise if autograd would need a gradient through a fused route
        (its kernels and packed weights have none)."""
        if torch.is_grad_enabled():
            check_no_grad(f"{type(self).__name__}'s fused route", x, *self.parameters())


def se_project_epilogue(block, se: nn.Module, h: torch.Tensor, skip: torch.Tensor | None,
                        conv: nn.Conv2d) -> torch.Tensor:
    """Kernel 7's route: the SE block ``se``'s gate, then (h * gate) @ W + b
    (+ skip) in one pass; NCHW channels_last in and out."""
    block.check_fused_route(h)
    gate = se(h, gate_only=True).reshape(h.shape[0], h.shape[1])
    kernel, bias = block.packed("project", pack_project, conv.weight, conv.bias)
    fn = se_gate_project_plain if h.dtype == torch.float32 else se_gate_project
    nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))  # noqa: E731
    return fn(nhwc(h), gate, kernel, bias, nhwc(skip)).permute(0, 3, 1, 2)


class DepthwiseSeparable(FusedRoutes, nn.Module):
    """EfficientNet stage-0 block: dw conv -> BN -> SiLU -> SE -> pw -> BN (+x).

    ``se_project``: kernel 7's route (see the module note)."""

    bn_folds = (("conv_dw", "bn1"), ("conv_pw", "bn2"))

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 se_ratio: float = 0.25, se_project: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.conv_dw = Conv2dSame(in_ch, in_ch, kernel_size, stride, groups=in_ch, bias=False)
        self.bn1 = BatchNorm2d(in_ch, eps=BN_EPS)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * se_ratio)))
        self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.has_residual = stride == 1 and in_ch == out_ch
        self.fused_route = ("se_project" if se_project and se_project_eligible(in_ch, out_ch)
                            else "plain")

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = conv_bn_act(self.conv_dw, self.bn1, x)
        if self.route() == "se_project":
            return se_project_epilogue(self, self.se, h, x if self.has_residual else None,
                                       self.conv_pw)
        h = self.se(h)
        return self.add_skip(conv_bn_act(self.conv_pw, self.bn2, h, act=False), x, generator)


class MBConv(FusedRoutes, nn.Module):
    """EfficientNet inverted residual: 1x1 expand -> dw -> SE -> 1x1 project (+x).

    ``fused_mbconv_head``: kernel 8's route; ``se_project``: kernel 7's (see
    the module note)."""

    bn_folds = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float,
                 kernel_size: int, stride: int, se_ratio: float = 0.25,
                 fused_mbconv_head: bool = False, se_project: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        mid = int(in_ch * expand_ratio)
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid, eps=BN_EPS)
        self.conv_dw = Conv2dSame(mid, mid, kernel_size, stride, groups=mid, bias=False)
        self.bn2 = BatchNorm2d(mid, eps=BN_EPS)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.has_residual = stride == 1 and in_ch == out_ch
        if (fused_mbconv_head and expand_ratio != 1 and se_ratio > 0
                and mbconv_eligible(in_ch, mid, kernel_size, stride)):
            self.fused_route = "mbconv_head"
        elif se_project and se_project_eligible(mid, out_ch):
            self.fused_route = "se_project"
        else:
            self.fused_route = "plain"

    def expand_dw_pool(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Kernel 8's route: (y NCHW channels_last, pool (B, M) fp32). In a
        split forward, the band with its ``k // 2`` halo rows (none past the
        image) through the kernel's row-window form: y and the pool of the
        band's rows."""
        self.check_fused_route(x)
        p = self.packed("head", pack_mbconv, self.conv_pw.weight, self.conv_pw.bias,
                        self.conv_dw.weight, self.conv_dw.bias)
        if spatial.active() is not None:
            xh, top, bottom = spatial.halo(x, p.ksize // 2, p.ksize // 2, pad=False)
            fn = (mbconv_expand_dw_pool_rows_plain if x.dtype == torch.float32
                  else mbconv_expand_dw_pool_rows)
            y, pool = fn(xh.permute(0, 2, 3, 1), p.we, p.be, p.wd, p.bd, p.ksize, top, bottom)
            return y.permute(0, 3, 1, 2), pool
        fn = mbconv_expand_dw_pool_plain if x.dtype == torch.float32 else mbconv_expand_dw_pool
        y, pool = fn(x.permute(0, 2, 3, 1), p.we, p.be, p.wd, p.bd, p.ksize)
        return y.permute(0, 3, 1, 2), pool

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        route = self.route()
        if route == "mbconv_head":
            h, pool = self.expand_dw_pool(x)
            rows = x.shape[2]
            if spatial.active() is not None:
                pool, rows = spatial.band_sum(pool), spatial.whole_rows(rows)
            pooled = (pool / (rows * x.shape[3])).to(x.dtype)[:, :, None, None]
            h = self.se(h, pooled=pooled)
        else:
            h = conv_bn_act(self.conv_pw, self.bn1, x)
            h = conv_bn_act(self.conv_dw, self.bn2, h)
            if route == "se_project":
                return se_project_epilogue(self, self.se, h, x if self.has_residual else None,
                                           self.conv_pwl)
            h = self.se(h)
        return self.add_skip(conv_bn_act(self.conv_pwl, self.bn3, h, act=False), x, generator)


class FusedMBConv(Residual, nn.Module):
    """EfficientNet-V2 fused block, JAX's ``FusedMBConv``: a k x k expand
    CNA (``block.0``) then a 1x1 project conv and BN without activation
    (``block.1``); at expand 1 the k x k CNA alone, its SiLU kept (+x at
    stride 1 and in == out). No SE, no fused route: JAX runs it as plain
    convs."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float, kernel_size: int,
                 stride: int, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        if expand_ratio != 1:
            mid = int(in_ch * expand_ratio)
            self.block = nn.Sequential(ConvNormAct(in_ch, mid, kernel_size, stride),
                                       ConvNormAct(mid, out_ch, 1, act=False))
        else:
            self.block = nn.Sequential(ConvNormAct(in_ch, out_ch, kernel_size, stride))
        self.bn_folds = tuple((f"block.{i}.0", f"block.{i}.1") for i in range(len(self.block)))
        self.has_residual = stride == 1 and in_ch == out_ch

    def route(self) -> str:
        return "plain"

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.add_skip(self.block(x), x, generator)


class MBConvV2(FusedRoutes, nn.Module):
    """EfficientNet-V2 inverted residual in torchvision's layout: ``block.0``
    1x1 expand CNA, ``block.1`` depthwise CNA, ``block.2`` SE (squeeze
    ``max(1, in_ch // 4)``), ``block.3`` 1x1 project conv and BN (+x at
    stride 1 and in == out). Every V2 MBConv stage expands.

    ``se_project``: kernel 7's route (see the module note); there is no
    kernel-8 route, as in JAX under torch padding."""

    bn_folds = (("block.0.0", "block.0.1"), ("block.1.0", "block.1.1"),
                ("block.3.0", "block.3.1"))

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float, kernel_size: int,
                 stride: int, se_ratio: float = 0.25, se_project: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        mid = int(in_ch * expand_ratio)
        self.block = nn.Sequential(
            ConvNormAct(in_ch, mid, 1),
            ConvNormAct(mid, mid, kernel_size, stride, groups=mid),
            SqueezeExcitation(mid, max(1, int(in_ch * se_ratio))),
            ConvNormAct(mid, out_ch, 1, act=False),
        )
        self.has_residual = stride == 1 and in_ch == out_ch
        self.fused_route = ("se_project" if se_project and se_project_eligible(mid, out_ch)
                            else "plain")

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        expand, dw, se, project = self.block
        h = dw(expand(x))
        if self.route() == "se_project":
            return se_project_epilogue(self, se, h, x if self.has_residual else None, project[0])
        return self.add_skip(project(se(h)), x, generator)
