"""Predict mode's per-image files (the reference's predict_step plotting,
GraphBinsLM.py:343-372; ``objcavit_tpu/utils/figures.py::
save_prediction_images``).

The file names are the JAX package's: ``{i}_im.png``, ``{i}_dets.png`` (when
detections were kept), ``{i}_depth_gt.png``, ``{i}_depth_pred.png``,
``{i}_depth_gt_raw.npy`` and ``{i}_depth_pred_raw.npy``. The PNGs are
written with PIL, which the card's machine has (matplotlib it has not): each
is the array itself at its own size, without matplotlib's axes and margins,
the depths colour-mapped with an 'inferno_r' polynomial fit over
[min_depth, the GT's max], GT pixels below the range (and nan) in white as
the JAX package draws them.

``build_batch_figure`` is the TensorBoard grid of ``fit`` (FigureBuilder.py:
64-125; ``objcavit_tpu/utils/figures.py::build_batch_figure``): a row an
image of RGB, GT depth, predicted depth (and the detections where a live
detector kept them), as one uint8 (H, W, 3) array for ``add_image``, each
panel at the image's size.
"""

from __future__ import annotations

import os

import numpy as np

from objcavit_torch.data.preprocess import imagenet_unnormalize

# 'inferno' as a degree-6 polynomial per channel in t in [0, 1] (a least
# squares fit to matplotlib's table, within 0.034 of it in every channel)
_INFERNO = np.array([
    [0.0002189403691192265, 0.001651004631001012, -0.01948089843709184],
    [0.1065134194856116, 0.5639564367884091, 3.932712388889277],
    [11.60249308247187, -3.972853965665698, -15.9423941062914],
    [-41.70399613139459, 17.43639888205313, 44.35414519872813],
    [77.162935699427, -33.40235894210092, -81.80730925738993],
    [-71.31942824499214, 32.62606426397723, 73.20951985803202],
    [25.13112622477341, -12.24266895238567, -23.07032500287172],
])


def depth_colors(depth: np.ndarray, vmin: float, vmax: float, under_white: bool) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) in [0, 1] on 'inferno_r' (near is bright)."""
    t = np.clip((depth - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    t = (1.0 - np.nan_to_num(t))[..., None]
    rgb = np.zeros(depth.shape + (3,))
    for c in _INFERNO[::-1]:
        rgb = rgb * t + c
    rgb = np.clip(rgb, 0.0, 1.0)
    if under_white:
        rgb[~(depth >= vmin)] = 1.0
    return rgb


def _save_png(path: str, rgb01: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(_panel(rgb01, rgb01.shape[:2])).save(path)


def save_prediction_images(out_dir: str, idx: int, image_normed: np.ndarray,
                           depth_gt: np.ndarray, depth_pred: np.ndarray, min_depth: float,
                           detections_image: np.ndarray | None = None) -> None:
    """image_normed (H, W, 3) ImageNet-normalised, depth_gt (H, W, 1),
    depth_pred (h, w, 1), detections_image (H, W, 3) in [0, 1] or None."""
    vmax = float(depth_gt.max())
    _save_png(os.path.join(out_dir, f"{idx}_im.png"), imagenet_unnormalize(image_normed))
    if detections_image is not None:
        _save_png(os.path.join(out_dir, f"{idx}_dets.png"), detections_image)
    _save_png(os.path.join(out_dir, f"{idx}_depth_gt.png"),
              depth_colors(depth_gt[..., 0], min_depth, vmax, under_white=True))
    _save_png(os.path.join(out_dir, f"{idx}_depth_pred.png"),
              depth_colors(depth_pred[..., 0], min_depth, vmax, under_white=False))
    np.save(os.path.join(out_dir, f"{idx}_depth_gt_raw.npy"), depth_gt)
    np.save(os.path.join(out_dir, f"{idx}_depth_pred_raw.npy"), depth_pred)


def _panel(rgb01: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(np.round(np.clip(rgb01, 0, 1) * 255).astype(np.uint8))
    if img.size != (hw[1], hw[0]):
        img = img.resize((hw[1], hw[0]), Image.NEAREST)
    return np.asarray(img)


def build_batch_figure(images_normed: np.ndarray, depth_gt: np.ndarray, depth_pred: np.ndarray,
                       num_samples: int = 4,
                       detections: np.ndarray | None = None) -> np.ndarray:
    """images_normed (B, H, W, 3), depth_gt (B, H, W, 1), depth_pred (B, h,
    w, 1), detections (B, H, W, 3) in [0, 1] or None -> the (n H, cols W, 3)
    uint8 grid; depths on 'inferno_r' over [0, the image's GT max], as JAX's."""
    n = min(num_samples, images_normed.shape[0])
    hw = images_normed.shape[1:3]
    rows = []
    for i in range(n):
        vmax = float(depth_gt[i].max())
        panels = [np.clip(imagenet_unnormalize(images_normed[i]), 0, 1),
                  depth_colors(depth_gt[i, ..., 0], 0.0, vmax, under_white=True),
                  depth_colors(depth_pred[i, ..., 0], 0.0, vmax, under_white=False)]
        if detections is not None:
            panels.append(detections[i])
        rows.append(np.concatenate([_panel(p, hw) for p in panels], axis=1))
    return np.concatenate(rows, axis=0)
