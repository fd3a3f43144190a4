"""Does the random-weight detector give an image the same detections in a
batch of 8 as alone? On one card, TF32 on (PyTorch's default for cuDNN's
convolutions) and off.

    python -m objcavit_torch.utils.detector_batch

The clip provider's detector (``benchkit.build_detector``: fp32, seed 1,
the params files' ``conf_thres`` 0.25 and ``iou_thres`` 0.45) runs on 8
uniform random frames at 480x640 (numpy seed 0), normalised as the eval
data is, once as one batch and once an image at a time, keeping 300
detections (the eval path's slots). For each image: whether its boxes are bitwise equal, the
widest box gap in pixels (the slots are ordered by score, so a reordering
shows as a gap of the image's size) and the widest gap of the sorted
scores; beside them the median gap between adjacent scores of the first
image. Prints one JSON line for each TF32 setting, and the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from objcavit_torch.models.yolov7 import Yolov7SegDetector
from objcavit_torch.utils.benchkit import build_detector

IMAGES, DIMS, SLOTS = 8, (480, 640), 300
NORM_MEAN, NORM_STD = 0.45, 0.22  # roughly ImageNet's, for uniform frames


def batch_gaps(detector: Yolov7SegDetector, images: np.ndarray) -> dict:
    """The per-image gaps between the batch's detections and each image's own."""
    full = detector(images, max_det=SLOTS)
    rows = []
    for i in range(images.shape[0]):
        one = detector(images[i:i + 1], max_det=SLOTS)
        rows.append({
            "bitwise_equal": bool(np.array_equal(full["xywh"][i], one["xywh"][0])),
            "box_gap_px": float(np.abs(full["xywh"][i] - one["xywh"][0]).max()),
            "score_gap": float(np.abs(np.sort(full["scores"][i]) - np.sort(one["scores"][0])).max())})
    scores = np.sort(full["scores"][0][full["valid"][0]])
    return {"images": rows, "median_adjacent_score_gap": float(np.median(np.diff(scores)))}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("detector_batch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    detector = Yolov7SegDetector(build_detector(dtype=torch.float32, seed=1, device="cuda"),
                                 conf_thres=0.25, iou_thres=0.45, max_det=SLOTS)
    rng = np.random.default_rng(0)
    images = ((rng.random((IMAGES, *DIMS, 3)) - NORM_MEAN) / NORM_STD).astype(np.float32)
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        print(json.dumps({"tf32": tf32, **batch_gaps(detector, images)}), flush=True)


if __name__ == "__main__":
    main()
