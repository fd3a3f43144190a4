"""Trainer: the fit, validate and predict flows of the reference's main.py.

Port of ``objcavit_tpu/training/loop.py``:

* ``fit`` (a run without ``-v`` or ``-i``): a new ``{run_dir}/{name}/
  version_N`` with ``hparams.yaml``, or with ``resume`` (or
  ``basic.auto_resume``) the newest one holding ``checkpoints/last.ckpt``,
  whose model, AdamW moments and step come back, the schedule rebuilt for
  this run's ``max_epochs`` and started at that step; else a warm start
  from ``basic.from_checkpoint`` (parameters and BN statistics). Each epoch
  trains on the shuffled train split (seed 42, no mirror pass), averages the
  weights from epoch ``int(0.8 max_epochs)`` on where ``optimizer.use_swa``
  (Lightning's SWA, main.py:41-43; the average persisted each epoch), and
  every ``validate_every`` epochs validates at ``basic.batch_size`` with
  flip-TTA (the reference's val loaders, GraphBinsLM.py:510-528), saving
  ``last.ckpt`` and ``best.ckpt`` by abs_rel. After the last epoch an SWA
  run takes the averaged weights, refreshes the BN statistics on a train
  epoch (``update_bn``'s semantics) and saves ``last.ckpt``. TensorBoard,
  where ``torch.utils.tensorboard`` imports: ``train/loss`` and ``lr-AdamW``
  at step % 50 == 1, ``metrics/*``, ``metrics_ra/*``, and the
  ``train/samples`` and ``val/samples`` figures, which never stop training;
* ``validate`` (``-v``): batch size 1, flip-TTA, each half clamped, the
  Garg/Eigen crops, both metric families, ``validation_output.txt`` in the
  reference's format (main.py:81-88);
* ``predict`` (``-i``): no TTA, per-image metrics (reset each image),
  ``prediction_metrics.csv`` with the reference's columns, and each image's
  files (GraphBinsLM.py:285-428);
* ``--debug``: one epoch of one step, one validation batch.

Without a checkpoint the model keeps a fresh init from an explicit
``torch.Generator`` (the JAX package inits from ``PRNGKey(0)``). A resumed
run restarts its random numbers (the generator, the loader's order), as
JAX's does; it saves no generator state. The object provider runs in the
loader's prefetch thread on the host batch.

In a process group (``cli`` under the OBJCAVIT_* env,
``parallel/distributed.py``) each process trains on its rows of the global
batch of ``basic.batch_size`` and the step is the global batch's
(``training/steps.py``). Rank 0 makes the version dir, the others join it
through a broadcast of its path, and every rank checks that it sees it: a
rank that does not (no shared filesystem under ``paths.run_dir``) fails on
every rank with that message. Rank 0 alone writes ``hparams.yaml``, the
checkpoints, the SWA average and TensorBoard; the train and val figures
are skipped, as in the JAX package. The in-fit validation evaluates each
rank's rows and sums every batch over the ranks (``metrics_update``), so
every rank holds the single-process metrics and takes the same ``best``
decision. ``fit`` returns on every rank after rank 0's last save. ``-v``
and ``-i`` (batch size 1) raise the loader's ValueError with more than one
process, as JAX's do.
"""

from __future__ import annotations

import csv
import itertools
import logging
import os
import time

import numpy as np
import torch

from objcavit_torch.config import Config
from objcavit_torch.data.dataset import make_dataset
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.losses import LossWrapper
from objcavit_torch.parallel.collectives import all_ranks_true, barrier, broadcast_from_main
from objcavit_torch.parallel.distributed import (
    is_main_process,
    process_count,
    process_index,
    rank_device,
)
from objcavit_torch.metrics import (
    METRIC_NAMES,
    MetricsPreprocessConfig,
    metrics_compute,
    metrics_init,
)
from objcavit_torch.training.checkpoint import CheckpointManager, restore_checkpoint
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.providers import ZerosObjectProvider, mirror_objects
from objcavit_torch.training.steps import (
    build_model,
    cumulative_bn_stats,
    make_bn_refresh_step,
    make_eval_step,
    make_train_step,
)
from objcavit_torch.utils.torch_import import load_torch_checkpoint

logger = logging.getLogger(__name__)

FRESH_INIT_SEED = 0  # the fresh init's generator when no checkpoint is found
TRAIN_SEED = 42  # the train loader's order and samples, and the step's generator
BN_REFRESH_SEED = 77  # the SWA BN refresh's augmentation and dropout
LOG_EVERY = 50  # train/loss and lr-AdamW at step % LOG_EVERY == 1


def _versions(base: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(base)
            if d.startswith("version_") and d.split("_")[1].isdigit()]


def _next_version_dir(base: str) -> str:
    """A new ``base/version_N``, N one past the largest there."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"version_{max(_versions(base), default=-1) + 1}")
    os.makedirs(path, exist_ok=True)
    return path


def _find_resume_dir(base: str) -> str | None:
    """The newest ``base/version_N`` holding ``checkpoints/last.ckpt``."""
    if not os.path.isdir(base):
        return None
    for n in sorted(_versions(base), reverse=True):
        cand = os.path.join(base, f"version_{n}")
        if os.path.exists(os.path.join(cand, "checkpoints", "last.ckpt")):
            return cand
    return None


def _tb_writer(run_dir: str):
    """A TensorBoard writer on ``run_dir``, or None where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        logger.warning("no TensorBoard writer (%s): the run logs no scalars or figures", e)
        return None
    return SummaryWriter(run_dir)


class Trainer:
    def __init__(self, args: Config, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "plain", device="cuda"):
        """``dtype`` is the compute dtype (the parameters stay fp32);
        ``attn_impl`` ObjCAViT's attention route ('plain', JAX's 'xla', or
        'kernel'); ``device`` the card unless the caller asks for the CPU (in
        a process group, card ``rank % count``: ``rank_device``)."""
        self.args = args
        self.dtype = dtype
        self.device = rank_device(device)
        self.is_main = is_main_process()
        self.debug = bool(args.get("debug"))
        self.dataset_cfg = args[args.basic.dataset]
        self.augment_on_device = not bool(args.basic.get("use_adabins_dataloader"))
        self.model = build_model(args, attn_impl=attn_impl).to(
            self.device, memory_format=torch.channels_last)
        self.loss = LossWrapper.from_args(args)
        self.mp_cfg = MetricsPreprocessConfig(
            min_depth=self.dataset_cfg.min_depth,
            max_depth=self.dataset_cfg.max_depth,
            garg_crop=bool(self.dataset_cfg.get("garg_crop")),
            eigen_crop=bool(self.dataset_cfg.get("eigen_crop")),
            dataset=args.basic.dataset,
        )
        # the slot count: None sizes it per batch, min(max_det, the image's
        # tokens); args.objects_max (not a reference key) pins it
        n = args.get("objects_max")
        self.n_obj_max = None if n is None else int(n)
        # num_workers == 0 (--debug): load synchronously, as the reference
        self.sync_loading = int(args.hardware.get("num_workers", 0) or 0) == 0
        self.provider = self._build_provider()

    def _build_provider(self):
        """The JAX trainer's table: 'control_obj_zeros_512' -> the zeros
        provider; 'clip' -> YOLOv7-seg + CLIP, whose missing assets raise
        unless --debug or allow_random_detector asks for random towers. A
        configured file that fails to load raises too (JAX's trainer falls
        back to stub detections on any failure: ROADMAP §C)."""
        if not self.model.takes_objects:
            return None
        args = self.args
        strat = args[args.model.name].objcavit.language_embedding_strategy
        max_det = int(args.yolov7seg.get("max_det", 1000)) if "yolov7seg" in args else 1000
        if strat == "control_obj_zeros_512":
            return ZerosObjectProvider(self.n_obj_max, max_det=max_det,
                                       final_upscale=self.model.do_final_upscale)
        if strat == "clip":
            from objcavit_torch.language.provider import YoloClipObjectProvider

            allow_random = self.debug or bool(args.get("allow_random_detector"))
            return YoloClipObjectProvider.from_args(args, self.n_obj_max, allow_random,
                                                    self.device)
        raise ValueError(f"unknown language strategy {strat}")

    def _host_hook(self, batch_np: dict, mirror: bool = True) -> dict:
        """The provider's slots for a host batch, and (``mirror``) those of
        the mirrored images for flip-TTA: re-detected where the provider
        asks for it (``recompute_on_mirror``), else ``mirror_objects``."""
        objects = self.provider(batch_np["image"])
        annot = objects.pop("_annot", None)
        out = {"objects": objects}
        if mirror:
            if getattr(self.provider, "recompute_on_mirror", False):
                mirrored = self.provider(batch_np["image"][:, :, ::-1].copy())
                mirrored.pop("_annot", None)
            else:
                mirrored = mirror_objects(objects, batch_np["image"].shape[2])
            out["objects_mirror"] = mirrored
        if annot is not None:
            out["_annot"] = annot
        return out

    def _train_hook(self, batch_np: dict) -> dict:
        return self._host_hook(batch_np, mirror=False)

    def _eval_loader(self, mirror: bool) -> DeviceLoader:
        """The -v/-i protocol's loader: batch size 1 (main.py:58); the
        config's batch size stays as it is for a later fit."""
        hook = None
        if self.provider is not None:
            hook = self._host_hook if mirror else self._train_hook
        return DeviceLoader(make_dataset(self.args, "online_eval"), 1, self.device,
                            host_hook=hook, synchronous=self.sync_loading)

    def fit(self, resume: bool | None = None):
        """Train, as the module docstring says; -> (the trained model, the
        last validation's metrics)."""
        args = self.args
        if resume is None:
            resume = bool(args.basic.get("auto_resume"))
        run_dir, resume_dir = self._run_dir(os.path.join(args.paths.run_dir, args.basic.name),
                                            resume)
        ckpt = CheckpointManager(run_dir, writes=self.is_main)
        ckpt.save_hparams(args)
        logger.info("run dir: %s%s", run_dir, " (resuming)" if resume_dir else "")

        bs = int(args.basic.batch_size)
        has_objects = self.provider is not None
        train_loader = DeviceLoader(make_dataset(args, "train"), bs, self.device, shuffle=True,
                                    seed=TRAIN_SEED,
                                    host_hook=self._train_hook if has_objects else None,
                                    synchronous=self.sync_loading)
        val_loader = DeviceLoader(make_dataset(args, "online_eval"), bs, self.device,
                                  host_hook=self._host_hook if has_objects else None,
                                  synchronous=self.sync_loading)
        max_epochs = 1 if self.debug else int(args.basic.max_epochs)
        steps_per_epoch = 1 if self.debug else len(train_loader)
        # use_swa: absent -> OneCycle; True -> OneCycle + SWA; False -> constant LR
        use_swa = args.optimizer.get("use_swa")
        use_swa = None if use_swa is None else bool(use_swa)
        swa_start_epoch = int(0.8 * max_epochs)  # Lightning's swa_epoch_start

        # JAX initialises its model on the first train batch (loop.py:171-187),
        # an order and a batch drawn from the loader's stream; drawing it here
        # too (the host hook draws nothing from it) keeps the two runs on the
        # same batches
        next(train_loader.host_batches())
        self._fresh_init()
        logger.info("model initialised: %.1fM params",
                    sum(p.numel() for p in self.model.parameters()) / 1e6)
        step, start_epoch, resumed = 0, 0, None
        if resume_dir:
            # the model, its BN statistics and the step now, AdamW's moments
            # once the optimizer is built at that step
            resumed = load_torch_checkpoint(
                os.path.join(resume_dir, "checkpoints", "last.ckpt"), self.model)
            step = int(resumed["global_step"])
            start_epoch = min(step // max(steps_per_epoch, 1), max_epochs)
            logger.info("resumed the full train state at step %d (epoch %d)", step, start_epoch)
        else:
            warm = args.basic.get("from_checkpoint")
            if warm and os.path.exists(warm):  # main.py:26-28: parameters and BN statistics
                restore_checkpoint(warm, self.model)
                logger.info("warm-started from %s", warm)
        optimizer, scheduler = build_optimizer(
            self.model, float(args.optimizer.lr), float(args.optimizer.wd),
            max_epochs * steps_per_epoch, float(args.optimizer.get("div_factor", 25)),
            float(args.optimizer.get("final_div_factor", 100)), use_swa,
            args[args.model.name].get("slow_encoder"),
            swa_start_step=swa_start_epoch * steps_per_epoch,
            swa_anneal_steps=10 * steps_per_epoch,  # Lightning's annealing_epochs=10
            start_step=step)
        if resumed is not None:
            # the moments and step counts; the groups' LR and betas stay this
            # run's schedule's, as JAX rebuilds its schedule from the config
            optimizer.load_state_dict({"state": resumed["optimizer_states"][0]["state"],
                                       "param_groups": optimizer.state_dict()["param_groups"]})
            del resumed
        train_step = make_train_step(
            self.model, optimizer, scheduler, self.loss, self.dataset_cfg.min_depth,
            self.augment_on_device, float(args.optimizer.get("gradient_clip_val", 0) or 0),
            self.dtype, torch.Generator(self.device).manual_seed(TRAIN_SEED))
        eval_step = make_eval_step(self.model, self.loss, self.mp_cfg, flip_tta=True,
                                   compute_dtype=self.dtype)

        swa_params, swa_count = None, 0
        if use_swa and resume_dir:
            restored = ckpt.restore_swa(max_step=step)
            if restored is not None:
                swa_params = {k: v.to(self.device) for k, v in restored[0].items()}
                swa_count = restored[1]
                logger.info("resumed SWA average (count=%d)", swa_count)
        writer = _tb_writer(run_dir) if self.is_main else None
        # the figures read the whole batch, which spans the ranks in a group
        figures = writer is not None and process_count() == 1
        last_metrics, last_train_batch = {}, None
        try:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.time()
                for batch, _meta in itertools.islice(train_loader, steps_per_epoch):
                    loss = train_step(batch, batch.get("objects"))
                    step += 1
                    if step % LOG_EVERY == 1 or self.debug:
                        value = float(loss)
                        logger.info("epoch %d step %d loss %.4f", epoch, step, value)
                        if writer is not None:
                            writer.add_scalar("train/loss", value, step)
                            # Lightning's LearningRateMonitor tag (main.py:33)
                            if train_step.last_lr is not None:
                                writer.add_scalar("lr-AdamW", train_step.last_lr, step)
                    last_train_batch = batch
                if use_swa and epoch >= swa_start_epoch:
                    swa_count += 1
                    swa_params = _running_average(swa_params, self.model, swa_count)
                    # the step lets a resume drop an average ahead of last.ckpt
                    ckpt.save_swa(swa_params, swa_count, step)
                if figures and last_train_batch is not None:
                    self._log_train_figure(writer, last_train_batch, step)
                if (epoch + 1) % int(args.basic.get("validate_every", 1)) == 0:
                    last_metrics, last_batch = self._run_eval(
                        eval_step, val_loader, limit=1 if self.debug else None,
                        keep_last_batch=True)
                    logger.info("epoch %d val: abs_rel %.4f rmse %.4f (%.1fs)", epoch,
                                last_metrics["abs_rel"], last_metrics["rmse"], time.time() - t0)
                    if writer is not None:
                        for k, v in last_metrics.items():
                            writer.add_scalar(f"{'metrics_ra' if k.endswith('_ra') else 'metrics'}"
                                              f"/{k}", v, step)
                    if figures:
                        self._log_sample_figure(writer, "val/samples", last_batch, step)
                    ckpt.save(self.model, optimizer, scheduler, step,
                              abs_rel=last_metrics["abs_rel"])
            if use_swa and swa_params is not None:
                with torch.no_grad():
                    for name, p in self.model.named_parameters():
                        p.copy_(swa_params[name])
                self._refresh_swa_batch_stats(train_loader, steps_per_epoch)
                ckpt.save(self.model, optimizer, scheduler, step, abs_rel=None)
        finally:
            if writer is not None:
                writer.close()
        barrier()  # every rank returns after rank 0's last save
        self.last_metrics = last_metrics
        return self.model, last_metrics

    def _run_dir(self, run_base: str, resume: bool) -> tuple[str, str | None]:
        """-> (the run's version dir, the same dir if it resumes a run else
        None): rank 0's choice, on every rank, once every rank sees it."""
        chosen = None
        if self.is_main:
            resume_dir = _find_resume_dir(run_base) if resume else None
            chosen = (resume_dir or _next_version_dir(run_base), resume_dir)
        run_dir, resume_dir = broadcast_from_main(chosen, self.device)
        seen = os.path.isdir(run_dir)
        if not all_ranks_true(seen, self.device):
            who = f"rank {process_index()}" if not seen else "another rank"
            raise RuntimeError(
                f"{who} cannot see rank 0's run dir {run_dir}: the processes of one run "
                f"need paths.run_dir on a filesystem they share")
        return run_dir, resume_dir

    def _refresh_swa_batch_stats(self, loader: DeviceLoader, max_batches: int) -> None:
        """The BN statistics of the averaged weights: the equal-weight
        average of each train batch's, over up to ``max_batches``. A padded
        final batch is skipped, decided on the host from the loader's sizes:
        its wrapped samples would count twice (BN statistics cannot be
        masked)."""
        refresh = make_bn_refresh_step(self.model, self.augment_on_device, self.dtype)
        generator = torch.Generator(self.device).manual_seed(BN_REFRESH_SEED)
        full_batches = len(loader.dataset) // loader.batch_size
        k = 0
        with cumulative_bn_stats(self.model) as n_bn:
            if n_bn == 0:
                return
            for i, (batch, _meta) in enumerate(itertools.islice(loader, max_batches)):
                if i >= full_batches:
                    continue
                refresh(batch, batch.get("objects"), generator)
                k += 1
        logger.info("SWA: refreshed batch_stats over %d train batches", k)

    def _run_eval(self, eval_step, loader, limit: int | None = None,
                  keep_last_batch: bool = False):
        """-> the metrics over ``loader`` (up to ``limit`` batches), and with
        ``keep_last_batch`` also (the last batch, its depth, its meta)."""
        metric_state = metrics_init(self.device)
        last = None
        # islice stops before the loader makes a batch past the limit
        for batch, meta in itertools.islice(loader, limit):
            metric_state, _loss, pred = eval_step(batch, batch.get("objects"),
                                                  batch.get("objects_mirror"), metric_state)
            if keep_last_batch:
                last = (batch, pred, meta)
        metrics = {k: float(v) for k, v in metrics_compute(metric_state).items()}
        return (metrics, last) if keep_last_batch else metrics

    def _log_train_figure(self, writer, batch: dict, step: int) -> None:
        """The train/samples figure: a forward without TTA in eval mode on the
        epoch's last train batch (GraphBinsLM.py:149-151)."""
        try:
            inputs = (batch["image"],)
            if self.model.takes_objects:
                objects = batch["objects"]
                inputs += (objects["features"], objects["xywh"], objects["valid"])
            self.model.eval()
            with torch.inference_mode():
                out = torch.func.functional_call(self.model, self.model.params_in(self.dtype),
                                                 inputs)
            self._log_sample_figure(writer, "train/samples", (batch, out["depth_pred"], None),
                                    step)
        except Exception:  # a figure must never stop training
            logger.warning("train figure logging failed", exc_info=True)

    def _log_sample_figure(self, writer, tag: str, last_batch, step: int) -> None:
        """The RGB / GT / prediction (+ detections) grid (FigureBuilder.py:64-125)."""
        if last_batch is None:
            return
        try:
            from objcavit_torch.utils.figures import build_batch_figure

            batch, depth_pred, meta = last_batch
            dets = self._annotated_images(batch, meta)
            fig = build_batch_figure(batch["image"].float().cpu().numpy(),
                                     batch["depth"].float().cpu().numpy(),
                                     depth_pred.float().cpu().numpy(),
                                     num_samples=min(4, int(batch["image"].shape[0])),
                                     detections=dets)
            writer.add_image(tag, fig, step, dataformats="HWC")
        except Exception:  # a figure must never stop training
            logger.warning("figure logging failed", exc_info=True)

    def validate(self) -> dict[str, float]:
        """-v: restore the checkpoint, evaluate with flip-TTA, write
        validation_output.txt."""
        args = self.args
        loader = self._eval_loader(mirror=True)
        self._restore_for_eval()
        eval_step = make_eval_step(self.model, self.loss, self.mp_cfg, flip_tta=True,
                                   compute_dtype=self.dtype)
        metrics = self._run_eval(eval_step, loader, limit=1 if self.debug else None)
        out_dir = args.get("val_output_dir", ".")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "validation_output.txt"), "w") as f:
            f.write(args.basic.name)
            f.write(str([metrics]))
            f.write(metrics_log_str(metrics))
        print(metrics_log_str(metrics))
        return metrics

    def predict(self) -> list[dict]:
        """-i: a forward per image without TTA; the metrics CSV and each
        image's files."""
        from objcavit_torch.utils.figures import save_prediction_images

        args = self.args
        loader = self._eval_loader(mirror=False)
        self._restore_for_eval()
        eval_step = make_eval_step(self.model, self.loss, self.mp_cfg, flip_tta=False,
                                   compute_dtype=self.dtype)
        out_dir = args.get("predict_output_dir", "./predict_output")
        os.makedirs(out_dir, exist_ok=True)
        if self.provider is not None:
            # predict saves {i}_dets.png where a detector ran (GraphBinsLM.py:359-362)
            self.provider.keep_annotations = True
        rows = []
        for i, (batch, meta) in enumerate(itertools.islice(loader, 1 if self.debug else None)):
            objects = batch.get("objects")
            metric_state, loss, depth_pred = eval_step(batch, objects, objects,
                                                       metrics_init(self.device))
            m = {k: float(v) for k, v in metrics_compute(metric_state).items()}
            rows.append({
                "batch_idx": i,
                "image_filename": meta["image_path"][0],
                "depth_gt_filename": meta["depth_path"][0],
                **{k: m[k] for k in METRIC_NAMES},
                **{f"{k}_ra": m[f"{k}_ra"] for k in METRIC_NAMES},
                "loss": float(loss),
            })
            dets = self._annotated_images(batch, meta)
            save_prediction_images(
                out_dir, i, batch["image"][0].cpu().numpy(), batch["depth"][0].cpu().numpy(),
                depth_pred[0].cpu().numpy(), self.dataset_cfg.min_depth,
                detections_image=dets[0] if dets is not None else None)
        with open(os.path.join(out_dir, "prediction_metrics.csv"), "w", newline="") as f:
            if rows:
                writer = csv.DictWriter(f, fieldnames=[""] + list(rows[0].keys()))
                writer.writeheader()
                for i, row in enumerate(rows):
                    writer.writerow({"": i, **row})
        logger.info("predictions saved to %s", out_dir)
        return rows

    def _restore_for_eval(self) -> None:
        path = self.args.basic.get("val_checkpoint")
        if path and os.path.exists(path):
            restore_checkpoint(path, self.model)
            logger.info("restored checkpoint: %s", path)
            return
        logger.warning("no checkpoint restored (path=%s); using a fresh init from seed %d",
                       path, FRESH_INIT_SEED)
        self._fresh_init()

    def _fresh_init(self) -> None:
        """The model's weights from ``FRESH_INIT_SEED``, drawn on the CPU so
        every device gets the same ones."""
        from objcavit_torch.utils.benchkit import init_weights_

        init_weights_(self.model.cpu(), torch.Generator().manual_seed(FRESH_INIT_SEED))
        self.model.to(self.device, memory_format=torch.channels_last)

    def _annotated_images(self, batch: dict, meta: dict) -> np.ndarray | None:
        """(B, H, W, 3) annotated images from the kept detections, or None."""
        annots = (meta or {}).get("_annot")
        if not annots:
            return None
        from objcavit_torch.data.preprocess import imagenet_unnormalize
        from objcavit_torch.utils.annotate import annotate_image

        images = batch["image"].cpu().numpy()
        return np.stack([
            annotate_image(np.clip(imagenet_unnormalize(images[i]), 0, 1), a["xywh"],
                           a["classes"], a["valid"], masks=a.get("masks"), names=a.get("names"))
            for i, a in enumerate(annots)
        ])


def _running_average(avg: dict[str, torch.Tensor] | None, model: torch.nn.Module,
                     count: int) -> dict[str, torch.Tensor]:
    """The parameters' running average after ``count`` epochs (the first
    its copy): avg + (new - avg) / count."""
    with torch.no_grad():
        if avg is None:
            return {n: p.detach().clone() for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            avg[n].add_((p - avg[n]) / count)
    return avg


def metrics_log_str(m: dict) -> str:
    """The two-family dump of main.py:84-88, character for character."""
    return (
        f"\nabs_rel, sq_rel, rms, rmsl, log10, d1, d2, d3:  \n"
        f"{m['abs_rel']}, {m['sq_rel']}, {m['rmse']}, {m['rmse_log']}, "
        f"{m['log10']}, {m['acc_1']}, {m['acc_2']}, {m['acc_3']}  \n ==#==  \n"
        f"abs_rel_ra, sq_rel_ra, rms_ra, rmsl_ra, log10_ra, d1_ra, d2_ra, d3_ra:  \n"
        f"{m['abs_rel_ra']}, {m['sq_rel_ra']}, {m['rmse_ra']}, {m['rmse_log_ra']}, "
        f"{m['log10_ra']}, {m['acc_1_ra']}, {m['acc_2_ra']}, {m['acc_3_ra']}"
    )
