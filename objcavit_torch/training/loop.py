"""Trainer: the validate and predict flows of the reference's main.py.

Port of ``objcavit_tpu/training/loop.py``'s eval half:

* ``validate`` (``-v``): batch size 1, flip-TTA, each half clamped, the
  Garg/Eigen crops, both metric families, ``validation_output.txt`` in the
  reference's format (main.py:81-88);
* ``predict`` (``-i``): no TTA, per-image metrics (reset each image),
  ``prediction_metrics.csv`` with the reference's columns, and each image's
  files (GraphBinsLM.py:285-428);
* ``--debug``: one batch.

The checkpoint is ``basic.val_checkpoint`` (a reference ``.ckpt`` or one the
port saved); without one the model keeps a fresh init from an explicit
``torch.Generator`` (the JAX package falls back to a fresh init too). The
object provider runs in the loader's prefetch thread on the host batch.
``fit`` (training, SWA, resume, TensorBoard) is ROADMAP A.3d and raises.
"""

from __future__ import annotations

import csv
import itertools
import logging
import os

import numpy as np
import torch

from objcavit_torch.config import Config
from objcavit_torch.data.dataset import make_dataset
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.errors import MissingAssetError
from objcavit_torch.losses import LossWrapper
from objcavit_torch.metrics import (
    METRIC_NAMES,
    MetricsPreprocessConfig,
    metrics_compute,
    metrics_init,
)
from objcavit_torch.training.checkpoint import restore_checkpoint
from objcavit_torch.training.providers import (
    StubObjectProvider,
    ZerosObjectProvider,
    mirror_objects,
)
from objcavit_torch.training.steps import build_model, make_eval_step
from objcavit_torch.utils.device import card_device

logger = logging.getLogger(__name__)

FRESH_INIT_SEED = 0  # the fresh init's generator when no checkpoint is found


class Trainer:
    def __init__(self, args: Config, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "plain", device="cuda"):
        """``dtype`` is the compute dtype (the parameters stay fp32);
        ``attn_impl`` ObjCAViT's attention route ('plain', JAX's 'xla', or
        'kernel'); ``device`` the card unless the caller asks for the CPU."""
        self.args = args
        self.dtype = dtype
        self.device = card_device(device)
        self.debug = bool(args.get("debug"))
        self.dataset_cfg = args[args.basic.dataset]
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
        provider; 'clip' -> YOLOv7-seg + CLIP, which fails fast on missing
        assets unless --debug or allow_random_detector; any other failure
        to build it there falls back to stub detections, with a warning."""
        if not self.model.takes_objects:
            return None
        args = self.args
        strat = args[args.model.name].objcavit.language_embedding_strategy
        max_det = int(args.yolov7seg.get("max_det", 1000)) if "yolov7seg" in args else 1000
        if strat == "control_obj_zeros_512":
            return ZerosObjectProvider(self.n_obj_max, max_det=max_det)
        if strat == "clip":
            from objcavit_torch.language.provider import YoloClipObjectProvider

            allow_random = self.debug or bool(args.get("allow_random_detector"))
            try:
                return YoloClipObjectProvider.from_args(args, self.n_obj_max, allow_random,
                                                        self.device)
            except NotImplementedError:
                raise
            except Exception as e:
                if isinstance(e, MissingAssetError) and not allow_random:
                    raise
                logger.warning("CLIP/YOLO provider unavailable (%s); using stub detections", e,
                               exc_info=True)
                return StubObjectProvider(self.n_obj_max, max_det=max_det)
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

    def _eval_loader(self, mirror: bool) -> DeviceLoader:
        """The -v/-i protocol's loader: batch size 1 (main.py:58)."""
        self.args.basic.batch_size = 1
        hook = None
        if self.provider is not None:
            hook = self._host_hook if mirror else (lambda b: self._host_hook(b, mirror=False))
        return DeviceLoader(make_dataset(self.args, "online_eval"), 1, self.device,
                            host_hook=hook, synchronous=self.sync_loading)

    def fit(self, resume: bool | None = None):
        raise NotImplementedError("Trainer.fit (training, SWA, auto-resume, TensorBoard) is not "
                                  "ported yet (ROADMAP A.3d); the port runs -v and -i")

    def _run_eval(self, eval_step, loader, limit: int | None = None) -> dict[str, float]:
        metric_state = metrics_init(self.device)
        # islice stops before the loader makes a batch past the limit
        for batch, _meta in itertools.islice(loader, limit):
            metric_state, _loss, _pred = eval_step(batch, batch.get("objects"),
                                                   batch.get("objects_mirror"), metric_state)
        return {k: float(v) for k, v in metrics_compute(metric_state).items()}

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
        from objcavit_torch.utils.benchkit import init_weights_

        logger.warning("no checkpoint restored (path=%s); using a fresh init from seed %d",
                       path, FRESH_INIT_SEED)
        # drawn on the CPU, so every device gets the same weights
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
