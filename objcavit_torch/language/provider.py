"""Detection + language object provider: YOLOv7-seg -> phrases -> CLIP.

Port of ``objcavit_tpu/language/provider.py::YoloClipObjectProvider``. It
produces the padded ``{'features', 'xywh', 'valid'}`` slots GraphBins
consumes, so ``serving.DepthPipeline(provider=...)`` serves real
detections and the trainer's eval runs the reference's object path: the
detector (``models/yolov7.py::Yolov7SegDetector``) gives padded
detections, phrases are built on the host by ``ObjectLanguageStrategy``
(the port's copy of the JAX package's), and the embedder's phrase cache
embeds them. As in the reference, detections are consumed lowest
confidence first (Yolov7Wrapper.py:120-123 iterates reversed()); an image
without detections gets the sentinel: slot 0 valid, xywh = -1, the '<UNK>'
embedding. The flip-TTA pass re-detects the mirrored image
(``recompute_on_mirror``), as the reference re-runs its whole forward
(GraphBinsLM.py:173). With ``keep_annotations`` each call also returns
'_annot', the per-image detections and masks for figures.

``from_args`` builds it from a config tree as the JAX trainer does: a
missing YOLOv7-seg checkpoint, CLIP checkpoint or BPE merges file raises
``MissingAssetError`` unless ``allow_random`` (``--debug`` or
``allow_random_detector: true``), which builds a tower whose file is
missing with random weights from a seed instead. A file that exists loads
through ``utils/torch_import.py`` (the detector's BN folded and its
RepConvs merged for inference).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from objcavit_torch.errors import MissingAssetError
from objcavit_torch.language.embedding import OBJ_FEATURE_DIM, ClipEmbedder
from objcavit_torch.language.strategy import ObjectLanguageStrategy
from objcavit_torch.serving import MAX_DET
from objcavit_torch.training.providers import _SlotSizing

logger = logging.getLogger(__name__)

# the random towers of a debug run: the detector's and the text tower's seeds
DETECTOR_SEED, CLIP_SEED = 1, 0


class YoloClipObjectProvider(_SlotSizing):
    # the mirror pass re-runs the detector on the flipped image
    recompute_on_mirror = True

    def __init__(self, detector, embedder, strategy: str = "synset_def_wn",
                 n_max: int | None = None, max_det: int = MAX_DET,
                 keep_annotations: bool = False, final_upscale: bool = False):
        super().__init__(n_max, OBJ_FEATURE_DIM, max_det, final_upscale)
        self.detector = detector
        self.embedder = embedder
        self.strategy = ObjectLanguageStrategy(strategy)
        self.keep_annotations = keep_annotations

    @classmethod
    def from_args(cls, args, n_max: int | None = None, allow_random: bool = False,
                  device="cuda") -> "YoloClipObjectProvider":
        """The provider of a 'clip' config, on ``device``. Without
        ``allow_random`` a missing asset raises, checked in the JAX
        package's order: the CLIP checkpoint, the BPE file, the detector's
        checkpoint."""
        from objcavit_torch.models.yolov7 import Yolov7SegDetector
        from objcavit_torch.utils.benchkit import build_detector, load_detector
        from objcavit_torch.utils.torch_import import (
            clip_text_from_state_dict,
            load_clip_text_weights,
        )

        mcfg = args[args.model.name]
        ycfg = args.yolov7seg
        clip_ckpt = args.get("clip_checkpoint") or os.environ.get("CLIP_CKPT_PATH")
        bpe_path = args.get("clip_bpe_path") or os.environ.get("CLIP_BPE_PATH")
        yolo_ckpt = mcfg.get("yolov7_chkpt")
        for what, path, key in (
                ("CLIP checkpoint", clip_ckpt, "clip_checkpoint or CLIP_CKPT_PATH"),
                ("CLIP BPE merges file", bpe_path, "clip_bpe_path or CLIP_BPE_PATH"),
                ("YOLOv7-seg checkpoint", yolo_ckpt, f"{args.model.name}.yolov7_chkpt")):
            if not allow_random and not (path and os.path.exists(path)):
                raise MissingAssetError(
                    f"{what} {path!r} not found (set {key}). Random weights give noise "
                    "detections and embeddings; ask for them explicitly with --debug or "
                    "allow_random_detector: true.")
        if yolo_ckpt and os.path.exists(yolo_ckpt):
            model = load_detector(yolo_ckpt, torch.float32, device)
            logger.info("YOLOv7-seg weights loaded from %s", yolo_ckpt)
        else:
            logger.warning("no YOLOv7-seg checkpoint (%s): the detector runs with RANDOM "
                           "weights from seed %d (detections are noise)", yolo_ckpt,
                           DETECTOR_SEED)
            model = build_detector(dtype=torch.float32, seed=DETECTOR_SEED, device=device)
        clip_model = None
        if clip_ckpt and os.path.exists(clip_ckpt):
            clip_model = clip_text_from_state_dict(load_clip_text_weights(clip_ckpt))
            logger.info("CLIP text tower loaded from %s", clip_ckpt)
        else:
            logger.warning("no CLIP checkpoint (%s): the text tower runs with RANDOM weights "
                           "from seed %d (embeddings are noise)", clip_ckpt, CLIP_SEED)
        max_det = int(ycfg.get("max_det", MAX_DET))
        detector = Yolov7SegDetector(
            model, conf_thres=ycfg.conf_thres, iou_thres=ycfg.iou_thres, max_det=max_det,
            agnostic=bool(ycfg.get("agnostic_nms")), pre_topk=ycfg.get("pre_topk"))
        embedder = ClipEmbedder(clip_model, bpe_path, device=device, seed=CLIP_SEED)
        return cls(detector, embedder, mcfg.objcavit.obj_language_strategy, n_max, max_det,
                   final_upscale=bool(mcfg.get("do_final_upscale")))

    def __call__(self, images_normed: np.ndarray) -> dict:
        b = images_normed.shape[0]
        n_max = self.slots(images_normed)
        det = self.detector(images_normed, max_det=n_max)
        feats = np.zeros((b, n_max, self.obj_dim), np.float32)
        xywh = np.full((b, n_max, 4), -1.0, np.float32)
        valid = np.zeros((b, n_max), bool)
        for i in range(b):
            n = int(det["valid"][i].sum())
            if n == 0:
                valid[i, 0] = True
                feats[i, 0] = self.embedder.embed(["<UNK>"])[0]
                continue
            order = np.argsort(det["scores"][i][:n])  # lowest confidence first
            names = [det["names"][i][j] for j in order]
            boxes = det["xywh"][i][order]
            feats[i, :n] = self.embedder.embed(self.strategy.phrases_for_image(names, boxes))
            xywh[i, :n] = boxes
            valid[i, :n] = True
        out = {"features": feats, "xywh": xywh, "valid": valid}
        if self.keep_annotations:
            out["_annot"] = self._annotations(images_normed, det)
        return out

    @torch.inference_mode()
    def _annotations(self, images_normed: np.ndarray, det: dict) -> list[dict]:
        """Per-image detections with their masks from the prototypes
        (Yolov7Wrapper.py:107), host-side, for figures."""
        from objcavit_torch.ops.masks import process_masks
        from objcavit_torch.ops.nms import xywh_to_xyxy

        hw = images_normed.shape[1:3]
        proto = det["proto"]
        annots = []
        for i in range(images_normed.shape[0]):
            dev = proto.device
            masks = process_masks(
                proto[i], torch.as_tensor(det["coeffs"][i], device=dev),
                xywh_to_xyxy(torch.as_tensor(det["xywh"][i], device=dev)),
                torch.as_tensor(det["valid"][i], device=dev), hw)
            annots.append({k: det[k][i] for k in ("xywh", "classes", "scores", "valid", "names")}
                          | {"masks": masks.cpu().numpy()})
        return annots
