"""Detection + language object provider: YOLOv7-seg -> phrases -> CLIP.

Port of ``objcavit_tpu/language/provider.py::YoloClipObjectProvider``. It
produces the padded ``{'features', 'xywh', 'valid'}`` slots GraphBins
consumes, so ``serving.DepthPipeline(provider=...)`` serves real
detections: the detector (``models/yolov7.py::Yolov7SegDetector``) gives
padded detections, phrases are built on the host by
``ObjectLanguageStrategy`` (the port's copy of the JAX package's), and
the embedder's phrase cache embeds them. As in the reference, detections
are consumed lowest confidence first (Yolov7Wrapper.py:120-123 iterates
reversed()); an image without detections gets the sentinel: slot 0 valid,
xywh = -1, the '<UNK>' embedding.
"""

from __future__ import annotations

import numpy as np

from objcavit_torch.language.embedding import OBJ_FEATURE_DIM
from objcavit_torch.language.strategy import ObjectLanguageStrategy
from objcavit_torch.serving import MAX_DET
from objcavit_torch.training.providers import _SlotSizing


class YoloClipObjectProvider(_SlotSizing):
    def __init__(self, detector, embedder, strategy: str = "synset_def_wn",
                 n_max: int | None = None, max_det: int = MAX_DET):
        super().__init__(n_max, OBJ_FEATURE_DIM, max_det)
        self.detector = detector
        self.embedder = embedder
        self.strategy = ObjectLanguageStrategy(strategy)

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
        return {"features": feats, "xywh": xywh, "valid": valid}
