"""Fold inference-time BatchNorm into the preceding conv, in place.

Port of ``objcavit_tpu/utils/fold_bn.py``. At eval,
``BN(conv(x)) = conv(x) * s + t`` with per-channel ``s = gamma / sqrt(var +
eps)`` and ``t = beta - mean * s``: the conv's weight is scaled by ``s`` and
its bias becomes ``t`` (plus ``bias * s`` where the conv had a bias, as the
decoder's convs do). Each BN becomes a ``FoldedBatchNorm``, an identity that
raises in training mode: a folded model has no BatchNorm left to train, as
the JAX package asserts (``assert not (self.fold_bn and train)``). Folding is done in
fp32 with each BN's own eps (1e-3 in the encoder, 1e-5 in the decoder), so
the folded model matches the unfolded one to fp32 rounding; cast to bf16
afterwards.

A module lists its (conv, BN) attribute pairs in ``bn_folds``; dotted names
reach into a Sequential (the decoder's ``_net.0`` / ``_net.1``). A module
with a ``merge_branches_`` method (YOLOv7's ``RepConv``) folds itself: its
BN'd branches become one biased conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class FoldedBatchNorm(nn.Identity):
    """Stands where a BN was folded into its conv: the identity at eval."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError(
                "BatchNorm was folded into the conv for inference; a folded model cannot train"
            )
        return x


def _set_submodule(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, module)


@torch.no_grad()
def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> None:
    """Rewrite ``conv`` in place so that ``conv(x) == bn(conv_before(x))`` at eval."""
    if conv.weight.dtype != torch.float32:
        raise ValueError(f"fold in fp32, before casting: got {conv.weight.dtype}")
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    bias = bn.bias - bn.running_mean * s
    if conv.bias is not None:
        bias = bias + conv.bias * s
    conv.weight.mul_(s.view(-1, 1, 1, 1))
    conv.bias = nn.Parameter(bias)


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every BN listed in a module's ``bn_folds`` and merge every
    module's branches that ``merge_branches_`` merges; returns ``model``."""
    for module in list(model.modules()):
        merge = getattr(module, "merge_branches_", None)
        if merge is not None:
            merge()
        for conv_name, bn_name in getattr(module, "bn_folds", ()):
            bn = module.get_submodule(bn_name)
            if isinstance(bn, nn.Identity):  # folded already
                continue
            fold_conv_bn(module.get_submodule(conv_name), bn)
            _set_submodule(module, bn_name, FoldedBatchNorm().train(bn.training))
    return model
