"""The flagship model, GraphBins-B5 (learned_bbox_wh, 256 bins), and
AdaBins-B5, the paper's baseline.

Port of ``objcavit_tpu/utils/benchkit.py::flagship_kwargs`` and
``build_flagship`` (the eval forward: bf16, BN folded), and of the train
step that ``bench.py`` times (``build_flagship_train``); ``adabins_kwargs``,
``build_adabins_model`` and ``build_adabins_train`` do the same for AdaBins-B5
with the values of ``params/nyu_adabins_enet-b5.yaml`` (256 bins, NYU's
0.001-10 m). Weights are random, drawn from a seeded CPU
``torch.Generator``, so every device gets the same model; for serving, BN is
then folded in fp32 and the model cast and moved. Every builder takes
``attn_impl`` ("plain" or "kernel", kernel 5) where the model has
attention, and builds on the card unless given another ``device``; the
flagship's eval builder takes ``encoder_impl`` ("plain" or "kernel",
kernels 7 and 8 in the encoder). Each builder's ``overrides`` take the
models' other options: ``do_final_upscale=True`` builds the final-upscale
models (AdaBins-B5's is ``params/nyu_efficientnet-b5_final_upscale_1.yaml``'s;
its servers hold 1000 slots at 480x640, its GraphBins train step 884 at
416x544) and ``drop_path_rate`` the encoder's stochastic depth.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.graphbins import BinsDepthModel, GraphBins
from objcavit_torch.models.layers import MultiHeadAttention, PatchTransformerEncoder
from objcavit_torch.models.objcavit import GridRandomPositionalEmbeddings
from objcavit_torch.serving import default_capacity
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import TrainStep, make_train_step
from objcavit_torch.utils.device import card_device
from objcavit_torch.utils.fold_bn import fold_batchnorm

# the train step of bench.py (``train_ms_per_step_bs8_416x544``)
TRAIN_LR, TRAIN_WD, TRAIN_CLIP, TRAIN_TOTAL_STEPS = 3.57e-4, 0.1, 0.1, 100
TRAIN_LOSSES = (("silog", "bins_chamfer"), (1.0, 0.1))


def flagship_kwargs(attn_impl: str = "plain", encoder_impl: str = "plain") -> dict:
    return dict(
        encoder_name="efficientnet-b5", n_bins=256, min_depth=0.001,
        max_depth=10.0, pos_strategy="learned_bbox_wh", attn_impl=attn_impl,
        encoder_impl=encoder_impl,
    )


def adabins_kwargs(attn_impl: str = "plain") -> dict:
    """AdaBins-B5 on NYU, as ``params/nyu_adabins_enet-b5.yaml`` sets it."""
    return dict(encoder_name="efficientnet-b5", n_bins=256, min_depth=0.001, max_depth=10.0,
                attn_impl=attn_impl)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter and BN statistic from ``generator``, with
    PyTorch's default distributions (the JAX package's initialisers mirror
    them): conv/linear weights and biases U(+-1/sqrt(fan_in)); attention
    in_proj xavier-uniform with zero biases; norms at identity; miniViT's
    positional table and ObjCAViT's grid table U[0, 1), as ``torch.rand``.
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
        elif isinstance(m, (PatchTransformerEncoder, GridRandomPositionalEmbeddings)):
            m.positional_encodings.uniform_(0.0, 1.0, generator=generator)
    return model


def _eval_model(model: BinsDepthModel, dtype, seed: int, device) -> BinsDepthModel:
    """Random weights from ``seed``, eval mode, BN folded, cast, on ``device``."""
    init_weights_(model, torch.Generator().manual_seed(seed))
    fold_batchnorm(model.eval())
    model.cast(dtype)
    return model.to(device, memory_format=torch.channels_last)


def build_flagship_model(dtype=torch.bfloat16, seed: int = 0, device="cuda",
                         attn_impl: str = "plain", encoder_impl: str = "plain",
                         **overrides) -> GraphBins:
    """Random-weight GraphBins (flagship kwargs, updated by ``overrides``:
    ObjCAViT's ``pos_strategy``, ``no_obj_sa``, ``use_2_saca``,
    ``dims_train`` and ``dims_test`` among them) in eval mode with BN
    folded, on ``device``."""
    device = card_device(device)
    return _eval_model(GraphBins(**{**flagship_kwargs(attn_impl, encoder_impl), **overrides}),
                       dtype, seed, device)


def build_adabins_model(dtype=torch.bfloat16, seed: int = 0, device="cuda",
                        attn_impl: str = "plain", **overrides) -> AdaBins:
    """Random-weight AdaBins-B5 (``adabins_kwargs``, updated by
    ``overrides``) in eval mode with BN folded, on ``device``."""
    device = card_device(device)
    return _eval_model(AdaBins(**{**adabins_kwargs(attn_impl), **overrides}), dtype, seed, device)


@torch.no_grad()
def calibrate_batchnorm_(model: nn.Module, images: torch.Tensor, **forward_kwargs) -> nn.Module:
    """Set every BN's running statistics from its own input in one
    eval-mode forward of ``images``: the per-channel mean, and the variance
    averaged over the layer's channels. A pre-hook sets them just before
    the BN runs, so each BN normalises what the eval-mode layers before it
    really give. Returns the model in eval mode. Random conv weights shrink
    the activations layer by layer; calibrated, each layer's output has
    unit variance on average, as a trained network's roughly has, so a
    random detector's logits spread like real ones. A per-channel variance
    would blow up channels that are near-constant on the calibration frames
    (by up to 1/sqrt(eps) ~ 30x a layer), and through ~100 layers turn bf16
    rounding into O(1) errors."""

    def set_stats(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.fill_(float(x.var((0, 2, 3), unbiased=False).mean()))

    handles = [m.register_forward_pre_hook(set_stats) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        model.eval()(images, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    return model


# BN affines of the random detector: pre-activations ~N(1, 0.25) keep SiLU
# near its linear range, so perturbations do not grow layer by layer. At
# the default (1, 0) the random network is chaotic: on the CPU its bf16 and
# fp32 heads differ by rel L2 0.35-0.50, at (0.5, 1.0) by 0.013-0.016.
DETECTOR_BN_AFFINE = (0.5, 1.0)


def build_detector(num_classes: int = 1203, dtype=torch.bfloat16, seed: int = 1, device="cuda",
                   calibrate_shape: tuple[int, int, int] = (4, 256, 320)):
    """Random-weight YOLOv7-seg for the fused server, eval mode, BN folded
    and RepConvs merged, cast to ``dtype`` (detect convs fp32), channels_last
    on ``device``. Weights come from ``seed``: the body's convs as
    ``init_weights_``, the detect convs N(0, 1/Cin) with zero biases (the
    JAX package's lecun-normal and zeros), every BN's affine
    ``DETECTOR_BN_AFFINE``; the BN statistics are calibrated on uniform
    random frames of ``calibrate_shape`` (B, H, W)."""
    from objcavit_torch.models.yolov7 import Yolov7Seg

    device = card_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(Yolov7Seg(num_classes=num_classes), gen)
    with torch.no_grad():
        for d in model.detects():
            d.weight.normal_(0.0, d.weight.shape[1] ** -0.5, generator=gen)
            d.bias.zero_()
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(DETECTOR_BN_AFFINE[0])
                m.bias.fill_(DETECTOR_BN_AFFINE[1])
    model.to(device, memory_format=torch.channels_last)
    frames = torch.rand((*calibrate_shape, 3), generator=gen).to(device)
    calibrate_batchnorm_(model, frames, with_proto=True)
    fold_batchnorm(model)
    return model.cast(dtype).to(memory_format=torch.channels_last)


def load_detector(checkpoint: str, dtype=torch.bfloat16, device="cuda"):
    """The YOLOv7-seg release ``checkpoint`` (``utils/torch_import.py``) as
    ``build_detector`` gives a detector: eval mode, BN folded, cast to
    ``dtype`` (detect convs fp32), channels_last on ``device``."""
    from objcavit_torch.models.yolov7 import Yolov7Seg
    from objcavit_torch.utils.torch_import import load_yolov7_weights

    model = load_yolov7_weights(checkpoint, Yolov7Seg()).eval().to(card_device(device))
    return fold_batchnorm(model).cast(dtype).to(memory_format=torch.channels_last)


def build_flagship(batch: int, h: int = 480, w: int = 640, n_obj: int = 300,
                   seed: int = 0, dtype=torch.bfloat16, device="cuda", attn_impl: str = "plain"):
    """Flagship model plus one batch of inputs made with numpy from ``seed``.

    Returns (model, (img, feats, xywh, valid)); ``model(*inputs)`` is the
    eval forward, ``{'depth_pred', 'bin_edges'}``.
    """
    model = build_flagship_model(dtype=dtype, seed=seed, device=device, attn_impl=attn_impl)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    inputs = (
        rng.standard_normal((batch, h, w, 3)).astype(np.float32),
        rng.standard_normal((batch, n_obj, 512)).astype(np.float32),
        rng.uniform(0, 600, (batch, n_obj, 4)).astype(np.float32),
        rng.uniform(size=(batch, n_obj)) < 0.5,
    )
    return model, tuple(torch.as_tensor(a, device=dev) for a in inputs)


def build_flagship_train(batch: int = 8, h: int = 416, w: int = 544, n_obj: int | None = None,
                         seed: int = 0, device="cuda", attn_impl: str = "plain", **overrides):
    """The flagship train step of ``bench.py``, with a batch and objects made
    with numpy from ``seed``.

    GraphBins-B5 (flagship kwargs, updated by ``overrides``) with fp32
    parameters, BN unfolded and in training mode, transformer dropout 0.1;
    bf16 compute; device-side augmentation; silog + 0.1 bins chamfer; AdamW
    at lr 3.57e-4 and wd 0.1 under the per-step OneCycle schedule over 100
    steps; gradients clipped at 0.1. ``n_obj`` slots, by default
    min(max_det 1000, the image's tokens): 221 at 416x544, 884 with
    ``do_final_upscale``.

    Returns (step, batch, objects): ``step(batch, objects)`` runs one step
    and returns its loss.
    """
    device = card_device(device)
    model = GraphBins(**{**flagship_kwargs(attn_impl), **overrides})
    if n_obj is None:
        n_obj = default_capacity(model, (h, w))
    step, batch_t, rng = _train_step(model, batch, h, w, seed, device)
    objects_np = {
        "features": (0.02 * rng.standard_normal((batch, n_obj, 512))).astype(np.float32),
        "xywh": rng.uniform(0, 400, (batch, n_obj, 4)).astype(np.float32),
        "valid": np.ones((batch, n_obj), bool),
    }
    return step, batch_t, {k: torch.as_tensor(v, device=device) for k, v in objects_np.items()}


def build_adabins_train(batch: int = 8, h: int = 416, w: int = 544, seed: int = 0,
                        device="cuda", attn_impl: str = "plain", **overrides):
    """AdaBins-B5's train step (``adabins_kwargs``, updated by
    ``overrides``), with the flagship step's recipe and a batch made with
    numpy from ``seed``. Returns (step, batch); ``step(batch, None)`` runs
    one step (AdaBins takes no objects) and returns its loss."""
    device = card_device(device)
    step, batch_t, _ = _train_step(AdaBins(**{**adabins_kwargs(attn_impl), **overrides}), batch,
                                   h, w, seed, device)
    return step, batch_t


def _train_step(model: BinsDepthModel, batch: int, h: int, w: int, seed: int,
                device: torch.device):
    """``bench.py``'s step over ``model`` (random weights from ``seed``, fp32
    parameters, training mode, on ``device``) and one batch of images and
    depths made with numpy from ``seed``, and that numpy generator."""
    init_weights_(model, torch.Generator().manual_seed(seed))
    model.to(device, memory_format=torch.channels_last).train()
    optimizer, scheduler = build_optimizer(model, TRAIN_LR, TRAIN_WD,
                                           TRAIN_TOTAL_STEPS)
    step: TrainStep = make_train_step(
        model, optimizer, scheduler, LossWrapper(*TRAIN_LOSSES), min_depth=model.min_depth,
        augment_on_device=True, gradient_clip_val=TRAIN_CLIP, compute_dtype=torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    rng = np.random.default_rng(seed)
    batch_np = {
        "image": rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(0.01, 9.0, (batch, h, w, 1)).astype(np.float32),
    }
    return step, {k: torch.as_tensor(v, device=device) for k, v in batch_np.items()}, rng
