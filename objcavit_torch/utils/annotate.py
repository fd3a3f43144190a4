"""Detection annotation: boxes and instance masks drawn on images.

The port's copy of ``objcavit_tpu/utils/annotate.py`` (numpy only), the
host-side stand-in for the reference's yolov7 Annotator/plot_masks
(Yolov7Wrapper.py:101-146). It runs only when predict mode saves figures.
"""

from __future__ import annotations

import numpy as np

# a fixed colour table (RGB in [0, 1])
_COLORS = np.array(
    [
        (0.90, 0.30, 0.25), (0.25, 0.60, 0.95), (0.35, 0.80, 0.40),
        (0.95, 0.75, 0.20), (0.70, 0.40, 0.90), (0.25, 0.85, 0.85),
        (0.95, 0.50, 0.65), (0.60, 0.60, 0.60), (0.55, 0.35, 0.20),
        (0.45, 0.90, 0.65),
    ],
    dtype=np.float32,
)


def class_color(cls_id: int) -> np.ndarray:
    return _COLORS[int(cls_id) % len(_COLORS)]


def annotate_image(image01: np.ndarray, xywh: np.ndarray, classes: np.ndarray,
                   valid: np.ndarray, masks: np.ndarray | None = None,
                   names: list[str] | None = None, line_width: int = 2,
                   mask_alpha: float = 0.45) -> np.ndarray:
    """An annotated copy of ``image01`` ((H, W, 3) in [0, 1]): each valid
    detection's mask ((N, H, W) in [0, 1]) blended in its class colour and
    its centre-xywh box outlined. ``names`` is accepted for the JAX
    package's signature and not drawn, as there."""
    img = np.array(image01, dtype=np.float32, copy=True)
    h, w = img.shape[:2]
    for i in np.flatnonzero(np.asarray(valid)):
        color = class_color(classes[i])
        if masks is not None:
            m = (masks[i] > 0.5)[..., None].astype(np.float32)
            img = img * (1 - m * mask_alpha) + m * mask_alpha * color
        cx, cy, bw, bh = xywh[i]
        x1 = int(np.clip(cx - bw / 2, 0, w - 1))
        x2 = int(np.clip(cx + bw / 2, 0, w - 1))
        y1 = int(np.clip(cy - bh / 2, 0, h - 1))
        y2 = int(np.clip(cy + bh / 2, 0, h - 1))
        t = line_width
        img[y1:y1 + t, x1:x2 + 1] = color
        img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
        img[y1:y2 + 1, x1:x1 + t] = color
        img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color
    return np.clip(img, 0.0, 1.0)
