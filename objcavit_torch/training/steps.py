"""The model factory, the train loss and the train step.

Port of ``objcavit_tpu/training/steps.py``: ``build_model`` (GraphBins or
AdaBins), ``make_train_loss_fn``, ``make_train_step``,
``make_bn_refresh_step`` (the SWA BN refresh) and ``make_eval_step``. AdaBins is called
on the image alone, as JAX's ``is_graphbins=False`` route calls it; its
steps take ``objects=None``. One step is device-side
augmentation -> forward in training mode -> loss -> backward -> gradient
clipping -> AdamW -> scheduler, with BatchNorm's running statistics updated
in place by the forward. The JAX package compiles that into one XLA program;
PyTorch runs it eagerly, so the step is an object (``TrainStep``) whose parts
a profiler can time one by one.

Mixed precision as in the JAX package: the parameters and the optimizer
state stay fp32, and with ``compute_dtype=torch.bfloat16`` the forward reads
every parameter cast to bf16 at use (``GraphBins.params_in`` through
``torch.func.functional_call``), except ``conv_out`` and the BatchNorm
affines. Gradients come back to the fp32 parameters in fp32.

The train state of the JAX package (``training/state.py``) is the model
(parameters and BN statistics), the optimizer and the scheduler here.

In a process group (``objcavit_torch.parallel``) each rank runs the step on
its rows of the global batch; the BatchNorms, the losses and the random
draws span the global batch and the gradients are averaged over the ranks
before the clipping (``parallel/collectives.py``), so the step is the one
the JAX package's sharded step takes. Under a process grid
(``parallel/mesh.py``) all of that runs over the data axis, and a model
split over the model axis (``parallel/tp.py::tp_shard_model``) clips by the
whole model's gradient norm (``parallel/tp.py::clip_grad_norm_``); AdamW and
the schedules are elementwise and run on each rank's slices.

The eval step runs flip-TTA as one forward on the 2B batch of the images and
their mirrors, as the JAX package does (the reference runs two forwards,
GraphBinsLM.py:159-183), in eval mode under ``torch.inference_mode``. BN
applies its running statistics, unfolded, as JAX's eval does; in bf16 the
parameters are read through ``params_in`` as in training, so the decoder
takes kernel 1's concat form and the bins head kernel 2. In fp32 no kernel
runs.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from objcavit_torch.data.augment import augment_batch
from objcavit_torch.losses import LossWrapper
from objcavit_torch.metrics import MetricsPreprocessConfig, metrics_preprocess, metrics_update
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.graphbins import N_QUERIES, BinsDepthModel, GraphBins
from objcavit_torch.parallel.collectives import GradientReducer
from objcavit_torch.parallel.tp import clip_grad_norm_
from objcavit_torch.serving import image_seq_len


def build_model(args: Any, attn_impl: str = "plain") -> BinsDepthModel:
    """GraphBins or AdaBins from a reference-format config tree (attribute
    and item access, as ``objcavit_torch.config.Config`` gives); fp32
    parameters, attention on the route ``attn_impl``. ``conv_out`` reads
    min(128, tokens - 1) queries at the smaller of the train and test
    sizes, the width the JAX package's lazily shaped ``conv_out`` takes
    there (128 at every params file's size). GraphBins takes ObjCAViT's
    options from ``objcavit`` and the dataset's ``dimensions_train`` and
    ``dimensions_test``, as the JAX package's ``build_model`` does. Both
    take ``do_final_upscale`` (whose tokens, at full resolution, size
    ``conv_out``'s queries) and ``drop_path_rate`` (0 where absent, the
    value the JAX package's ``build_model`` always leaves; no params file
    sets it). Another model name raises ``ValueError``, as in JAX."""
    name = args.model.name
    if name not in ("graphbins", "adabins"):
        raise ValueError(f"unrecognised model: {name}")
    mcfg = args[name]
    dcfg = args[args.basic.dataset]
    final_upscale = bool(mcfg.get("do_final_upscale"))
    n_queries = min([N_QUERIES] + [image_seq_len(*dcfg[k], final_upscale) - 1
                                   for k in ("dimensions_train", "dimensions_test") if k in dcfg])
    common = dict(encoder_name=mcfg.encoder_name, n_bins=mcfg.n_bins,
                  min_depth=dcfg.min_depth, max_depth=dcfg.max_depth, n_queries=n_queries,
                  do_final_upscale=final_upscale,
                  drop_path_rate=float(mcfg.get("drop_path_rate") or 0.0), attn_impl=attn_impl)
    if name == "adabins":
        return AdaBins(**common)
    ocfg = mcfg.objcavit
    return GraphBins(embedding_dim=ocfg.embedding_dim, obj_feature_dim=512,
                     pos_strategy=ocfg.positional_embedding_strategy,
                     no_obj_sa=bool(ocfg.get("no_obj_sa")),
                     use_2_saca=bool(ocfg.get("use_2_saca")),
                     # the full-resolution sizes, which size grid_random's table
                     dims_train=tuple(dcfg.dimensions_train),
                     dims_test=tuple(dcfg.dimensions_test), **common)


def make_train_loss_fn(model: BinsDepthModel, loss_wrapper: LossWrapper, min_depth: float,
                       augment_on_device: bool,
                       compute_dtype: torch.dtype = torch.float32) -> Callable:
    """fn(batch, objects, generator) -> scalar loss, the model in training
    mode. ``batch`` holds 'image' (B, H, W, 3) in [0, 1] (normalised already
    when ``augment_on_device`` is False) and 'depth' (B, H, W, 1);
    ``objects`` 'features', 'xywh' and 'valid' for GraphBins, None for
    AdaBins. The augmentation's draws come from ``generator`` first, then
    the dropout's."""

    def loss_fn(batch, objects, generator=None):
        model.train()
        image, depth_gt = batch["image"], batch["depth"]
        if augment_on_device:
            image, depth_gt = augment_batch(generator, image, depth_gt)
        inputs = (image,)
        if model.takes_objects:
            inputs += (objects["features"], objects["xywh"], objects["valid"])
        out = torch.func.functional_call(
            model, model.params_in(compute_dtype), inputs, {"generator": generator}
        )
        depth_mask = depth_gt > min_depth  # the train mask: min only
        return loss_wrapper(out["depth_pred"], depth_gt, depth_mask, out["bin_edges"])

    return loss_fn


class TrainStep:
    """``step(batch, objects) -> loss``: one optimisation step, in place.

    ``loss``, ``loss.backward()`` and ``update`` are its three parts, in
    order. ``scheduler`` may be None (the constant-LR path); ``last_lr`` is
    the LR of the latest update where a scheduler sets it (the reference's
    ``lr-AdamW`` scalar), else None. ``grad_reducer`` (a
    ``parallel.collectives.GradientReducer``, in a process group) makes the
    gradients the global batch's at the start of ``update``, before the
    clipping.
    """

    def __init__(self, model: BinsDepthModel, optimizer: torch.optim.Optimizer, scheduler,
                 loss_fn: Callable, gradient_clip_val: float = 0.0,
                 generator: torch.Generator | None = None, grad_reducer=None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_fn = loss_fn
        self.gradient_clip_val = gradient_clip_val
        self.generator = generator
        self.grad_reducer = grad_reducer
        self.last_lr: float | None = None

    def loss(self, batch, objects) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        return self.loss_fn(batch, objects, self.generator)

    def update(self) -> None:
        if self.grad_reducer is not None:
            self.grad_reducer()
        if self.gradient_clip_val > 0:
            clip_grad_norm_(self.model, self.gradient_clip_val)
        if self.scheduler is not None:
            self.last_lr = float(self.optimizer.param_groups[0]["lr"])
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def __call__(self, batch, objects) -> torch.Tensor:
        loss = self.loss(batch, objects)
        loss.backward()
        self.update()
        return loss.detach()


def make_train_step(model: BinsDepthModel, optimizer: torch.optim.Optimizer, scheduler,
                    loss_wrapper: LossWrapper, min_depth: float, augment_on_device: bool,
                    gradient_clip_val: float = 0.0,
                    compute_dtype: torch.dtype = torch.float32,
                    generator: torch.Generator | None = None) -> TrainStep:
    """The train step over ``model`` (fp32 parameters) with ``optimizer`` and
    ``scheduler`` from ``training/optim.py::build_optimizer``. Made in a
    process group, it averages the gradients over the group's data axis
    (``GradientReducer``; the whole group without a grid): with the losses
    and BatchNorms over the global batch, the step is the single-process
    step on the global batch. Every rank draws from ``generator`` seeded
    alike."""
    loss_fn = make_train_loss_fn(model, loss_wrapper, min_depth, augment_on_device,
                                 compute_dtype)
    reducer = GradientReducer(model.parameters()) if dist.is_initialized() else None
    return TrainStep(model, optimizer, scheduler, loss_fn, gradient_clip_val, generator, reducer)


def make_bn_refresh_step(model: BinsDepthModel, augment_on_device: bool,
                         compute_dtype: torch.dtype = torch.float32) -> Callable:
    """fn(batch, objects, generator): one forward of a train step without
    its gradients, for the SWA BN refresh (``objcavit_tpu/training/
    steps.py::make_bn_refresh_step``): training mode, the device
    augmentation and the dropout drawn from ``generator`` as the train step
    draws them. Inside ``cumulative_bn_stats`` the BatchNorms average each
    batch's statistics (the unbiased variance, as the train step's) with
    equal weights, as ``torch.optim.swa_utils.update_bn`` does."""

    @torch.no_grad()
    def refresh_step(batch, objects, generator=None):
        model.train()
        image = batch["image"]
        if augment_on_device:
            image, _ = augment_batch(generator, image, batch["depth"])
        inputs = (image,)
        if model.takes_objects:
            inputs += (objects["features"], objects["xywh"], objects["valid"])
        torch.func.functional_call(model, model.params_in(compute_dtype), inputs,
                                   {"generator": generator})

    return refresh_step


@contextlib.contextmanager
def cumulative_bn_stats(model: torch.nn.Module):
    """While open, every BatchNorm of ``model`` keeps the cumulative average
    of the batches it sees (momentum None and its count zeroed, as
    ``update_bn`` sets them: the first batch replaces the old statistics);
    the momenta come back on exit, and so do the statistics' counts of a BN
    that saw no batch. Yields the number of BatchNorms."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.num_batches_tracked.zero_()
        m.momentum = None
    try:
        yield len(bns)
    finally:
        for m, (momentum, count) in zip(bns, saved):
            m.momentum = momentum
            if int(m.num_batches_tracked) == 0:
                m.num_batches_tracked.copy_(count)


def make_eval_step(model: BinsDepthModel, loss_wrapper: LossWrapper,
                   mp_cfg: MetricsPreprocessConfig, flip_tta: bool,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """fn(batch, objects, objects_mirror, metric_state) -> (metric_state,
    loss, depth_pred) over ``model`` in eval mode.

    ``batch`` holds 'image' (B, H, W, 3) normalised, 'depth' (B, H, W, 1)
    and 'sample_valid' (B,); ``objects`` and ``objects_mirror`` the slots of
    the images and of their mirrors (None for AdaBins). With ``flip_tta``
    each half of the 2B forward is clamped to [min_depth, max_depth] before
    the two are averaged. Padded samples count in neither the loss nor the
    metrics.
    """

    def forward(params, image, objects):
        inputs = (image,)
        if model.takes_objects:
            inputs += (objects["features"], objects["xywh"], objects["valid"])
        return torch.func.functional_call(model, params, inputs)

    @torch.inference_mode()
    def eval_step(batch, objects, objects_mirror, metric_state):
        model.eval()
        params = model.params_in(compute_dtype)
        image, depth_gt = batch["image"], batch["depth"]
        b = image.shape[0]
        lo, hi = mp_cfg.min_depth, mp_cfg.max_depth
        if flip_tta:
            objects2 = None
            if model.takes_objects:
                objects2 = {k: torch.cat([objects[k], objects_mirror[k]]) for k in objects}
            out = forward(params, torch.cat([image, image.flip(2)]), objects2)
            pred = out["depth_pred"][:b].clamp(lo, hi)
            pred_mirror = out["depth_pred"][b:].flip(2).clamp(lo, hi)
            depth_pred = 0.5 * (pred + pred_mirror)
            bin_edges = out["bin_edges"][:b]
        else:
            out = forward(params, image, objects)
            depth_pred = out["depth_pred"].clamp(lo, hi)
            bin_edges = out["bin_edges"]

        sample_valid = batch["sample_valid"][:, None, None, None]
        depth_mask = (depth_gt > lo) & (depth_gt <= hi) & sample_valid
        loss = loss_wrapper(depth_pred, depth_gt, depth_mask, bin_edges)
        pred_m, mask_m = metrics_preprocess(depth_pred, depth_gt, mp_cfg)
        metric_state = metrics_update(metric_state, pred_m, depth_gt, mask_m & sample_valid)
        return metric_state, loss, depth_pred

    return eval_step
