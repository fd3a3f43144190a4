"""The flagship model: GraphBins-B5, learned_bbox_wh, bf16, BN folded.

Port of ``objcavit_tpu/utils/benchkit.py::flagship_kwargs`` and
``build_flagship``. Weights are random, drawn from a seeded CPU
``torch.Generator`` (so every device gets the same model), then BN is folded
in fp32, and the model is cast and moved.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.layers import MultiHeadAttention
from objcavit_torch.utils.fold_bn import fold_batchnorm


def flagship_kwargs() -> dict:
    return dict(
        encoder_name="efficientnet-b5", n_bins=256, min_depth=0.001,
        max_depth=10.0, pos_strategy="learned_bbox_wh",
    )


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter and BN statistic from ``generator``, with
    PyTorch's default distributions (the JAX package's initialisers mirror
    them): conv/linear weights and biases U(+-1/sqrt(fan_in)); attention
    in_proj xavier-uniform with zero biases; norms at identity.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
    # after the loop: out_proj is an nn.Linear visited above
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            e = m.embed_dim
            bound = math.sqrt(6.0 / (e + 3 * e))
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
            m.out_proj.bias.zero_()
    return model


def build_flagship_model(dtype=torch.bfloat16, seed: int = 0, device=None,
                         **overrides) -> GraphBins:
    """Random-weight GraphBins (flagship kwargs, updated by ``overrides``) in
    eval mode with BN folded, on ``device`` (default: the card if there is
    one)."""
    model = GraphBins(**{**flagship_kwargs(), **overrides})
    init_weights_(model, torch.Generator().manual_seed(seed))
    fold_batchnorm(model.eval())
    model.cast(dtype)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return model.to(device, memory_format=torch.channels_last)


def build_flagship(batch: int, h: int = 480, w: int = 640, n_obj: int = 300,
                   seed: int = 0, dtype=torch.bfloat16, device=None):
    """Flagship model plus one batch of inputs made with numpy from ``seed``.

    Returns (model, (img, feats, xywh, valid)); ``model(*inputs)`` is the
    eval forward, ``{'depth_pred', 'bin_edges'}``.
    """
    model = build_flagship_model(dtype=dtype, seed=seed, device=device)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    inputs = (
        rng.standard_normal((batch, h, w, 3)).astype(np.float32),
        rng.standard_normal((batch, n_obj, 512)).astype(np.float32),
        rng.uniform(0, 600, (batch, n_obj, 4)).astype(np.float32),
        rng.uniform(size=(batch, n_obj)) < 0.5,
    )
    return model, tuple(torch.as_tensor(a, device=dev) for a in inputs)
