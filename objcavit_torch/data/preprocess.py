"""Host-side eval preprocessing (numpy), the eval half of
``objcavit_tpu/data/preprocess.py``.

Both reference pipelines agree at eval time: /255 and depth / its factor,
the KITTI benchmark crop where configured, ImageNet normalisation. The train
samplers come with the train half of the data layer.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def imagenet_normalize(image: np.ndarray) -> np.ndarray:
    return (image - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_unnormalize(image: np.ndarray) -> np.ndarray:
    return image * IMAGENET_STD + IMAGENET_MEAN


def kb_crop(image: np.ndarray, depth: np.ndarray | None):
    """The KITTI benchmark crop to 352x1216 (Preprocess.py:91-111)."""
    h, w = image.shape[:2]
    top = int(h - 352)
    left = int((w - 1216) / 2)
    image = image[top:top + 352, left:left + 1216]
    if depth is not None:
        depth = depth[top:top + 352, left:left + 1216]
    return image, depth


def eval_sample(image_u8: np.ndarray, depth_raw: np.ndarray | None, do_kb_crop: bool,
                image_norm_factor: float, depth_norm_factor: float,
                normalize: bool) -> tuple[np.ndarray, np.ndarray | None]:
    """HWC uint8 image and raw depth -> (HWC fp32 image, HW1 fp32 depth in
    metres, or None)."""
    image = image_u8.astype(np.float32) / image_norm_factor
    depth = None
    if depth_raw is not None:
        depth = (depth_raw if depth_raw.ndim == 3 else depth_raw[:, :, None]).astype(
            np.float32) / depth_norm_factor
    if do_kb_crop:
        image, depth = kb_crop(image, depth)
    if normalize:
        image = imagenet_normalize(image)
    return image.astype(np.float32), depth
