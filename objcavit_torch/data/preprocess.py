"""Host-side per-sample preprocessing (numpy, PIL), both reference pipelines.

Port of ``objcavit_tpu/data/preprocess.py``. Two train pipelines exist in
the reference, chosen by ``basic.use_adabins_dataloader``:

* "old_dl" (datasets/dataloader.py:116-270, the BTS/AdaBins lineage):
  kb-crop, the NYU boundary crop (43, 45, 608, 472), a PIL random rotate,
  /255 and depth / its factor, a random crop, then flip, gamma, brightness,
  per-channel colour and ImageNet normalisation on the host;
* "new" (modules/Preprocess.py): /255 and depth / its factor, kb-crop, the
  NYU crop (45, 43, 427, 565), a random rotate (bilinear image, nearest
  depth, one angle), a random crop; flip, gamma, planckian and the
  normalisation run on the card per batch (``augment.py``).

Each draws from the loader's one ``np.random.Generator`` in the JAX
package's order. Where the JAX package calls its C++ core, so does the port
(``native.py``, built from ``csrc/preprocess.cpp``): the old_dl sampler's
tail and the new sampler's rotations. The old_dl sampler is split as JAX's
is: stage A (``old_dl_stage_a``: crops, PIL rotate, scaling) and the
stage-B draws (``old_dl_draw_aug``), so ``DepthDataset.get_batch`` can make
every draw first, decode and rotate in threads, and assemble the batch in
one pass of the core. The numpy versions of the core's entry points stay
here as their plain versions (``rotate_bilinear``, ``rotate_nearest``,
``augment_normalize``, ``assemble_batch``: the JAX package's numpy
branches); only the tests and ``chip_smoke.py`` call them. At eval both
pipelines agree: /255 and depth / its factor, the KITTI benchmark crop
where configured, ImageNet normalisation.
"""

from __future__ import annotations

import numpy as np

from objcavit_torch.data import native

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


def _pil_rotate(arr: np.ndarray, angle: float, nearest: bool) -> np.ndarray:
    """PIL's Image.rotate on raw-valued arrays, no value rescaling."""
    from PIL import Image

    resample = Image.NEAREST if nearest else Image.BILINEAR
    if arr.ndim == 3 and arr.shape[2] == 1:
        img = Image.fromarray(arr[:, :, 0].astype(np.float32), mode="F")
        return np.asarray(img.rotate(angle, resample=resample), dtype=np.float32)[:, :, None]
    img = Image.fromarray(arr.astype(np.uint8))
    return np.asarray(img.rotate(angle, resample=resample), dtype=np.float32)


def random_crop(image, depth, height, width, rng: np.random.Generator):
    if image.shape[0] < height or image.shape[1] < width:
        raise ValueError(f"crop {height}x{width} larger than the image {image.shape[:2]}")
    x = rng.integers(0, image.shape[1] - width + 1)
    y = rng.integers(0, image.shape[0] - height + 1)
    return image[y:y + height, x:x + width], depth[y:y + height, x:x + width]


def augment_normalize(img: np.ndarray, flip: bool, do_augment: bool, gamma: float,
                      brightness: float, color3: np.ndarray,
                      do_normalize: bool = True) -> np.ndarray:
    """The plain version of ``native.augment_normalize`` (the JAX package's
    numpy branch): on an (H, W, 3) [0, 1] image, flip, then gamma,
    brightness and colour clipped to [0, 1], then (``do_normalize``)
    ImageNet normalisation."""
    img = np.ascontiguousarray(img, np.float32).copy()
    if flip:
        img = img[:, ::-1].copy()
    if do_augment:
        img = np.clip((np.maximum(img, 0) ** gamma) * brightness * color3[None, None, :], 0, 1)
    return imagenet_normalize(img) if do_normalize else img


def assemble_batch(images: list, depths: list, crops_yx: np.ndarray, flips: np.ndarray,
                   do_augments: np.ndarray, gammas: np.ndarray, brightnesses: np.ndarray,
                   colors3: np.ndarray, out_h: int, out_w: int,
                   do_normalize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of ``native.assemble_batch`` (the JAX package's
    per-sample loop): each sample cropped, through ``augment_normalize``,
    its depth flipped with it, then stacked."""
    outs_i, outs_d = [], []
    for i in range(len(images)):
        y, x = int(crops_yx[i, 0]), int(crops_yx[i, 1])
        img = images[i][y:y + out_h, x:x + out_w]
        dep = depths[i][y:y + out_h, x:x + out_w]
        outs_i.append(augment_normalize(img, bool(flips[i]), bool(do_augments[i]),
                                        float(gammas[i]), float(brightnesses[i]), colors3[i],
                                        do_normalize))
        outs_d.append(dep[:, ::-1].copy() if flips[i] else dep)
    return np.stack(outs_i), np.stack(outs_d)


def old_dl_stage_a(image_u8: np.ndarray, depth_raw: np.ndarray, dataset: str, do_kb_crop: bool,
                   do_random_rotate: bool, degree: float, depth_norm_factor: float,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The legacy train pipeline's stage A, a sample before its crop
    (dataloader.py:116-165): the angle's draw, then ``old_dl_stage_a_apply``.
    Stage B (the crop, flip, gamma, colour, normalisation and the stack)
    runs per sample in ``old_dl_train_sample`` or as one pass of the core
    (``native.assemble_batch``)."""
    angle = (rng.random() - 0.5) * 2 * degree if do_random_rotate else None
    return old_dl_stage_a_apply(image_u8, depth_raw, dataset, do_kb_crop, angle,
                                depth_norm_factor)


def old_dl_stage_a_apply(image_u8: np.ndarray, depth_raw: np.ndarray, dataset: str,
                         do_kb_crop: bool, angle: float | None,
                         depth_norm_factor: float) -> tuple[np.ndarray, np.ndarray]:
    """Stage A with its angle drawn (it draws nothing, so decode and rotate
    can run in threads while the draws stay serial): the kb crop, the NYU
    boundary crop, PIL's rotate, /255 and depth / its factor."""
    image = image_u8
    depth = depth_raw if depth_raw.ndim == 3 else depth_raw[:, :, None]
    if do_kb_crop:
        image, depth = kb_crop(image, depth)
    if dataset == "nyu":
        # the blank-boundary crop (dataloader.py:149-151), PIL box (43, 45, 608, 472)
        image, depth = image[45:472, 43:608], depth[45:472, 43:608]
    if angle is not None:
        image = _pil_rotate(image, angle, nearest=False)
        depth = _pil_rotate(depth, angle, nearest=True)
    # the reference scales after the PIL ops (dataloader.py:158-165)
    return image.astype(np.float32) / 255.0, depth.astype(np.float32) / depth_norm_factor


def old_dl_stage_a_static_shape(dataset: str, do_kb_crop: bool) -> tuple[int, int] | None:
    """Stage A's (H, W) where it does not depend on the frame: (352, 1216)
    after the kb crop, (427, 565) after NYU's boundary crop of a 480x640
    frame; else None (``get_batch`` then runs stage A serially)."""
    if do_kb_crop:
        return (352, 1216)
    if dataset == "nyu":
        return (427, 565)
    return None


def old_dl_draw_aug(dataset: str, image_shape: tuple, train_dims: tuple,
                    rng: np.random.Generator) -> dict:
    """Stage B's draws, in the per-sample order (crop x, crop y, flip,
    do_augment, gamma, brightness, colours), so a batch assembled from them
    is the per-sample path's bit for bit."""
    h, w = train_dims
    x = int(rng.integers(0, image_shape[1] - w + 1))
    y = int(rng.integers(0, image_shape[0] - h + 1))
    flip = rng.random() > 0.5
    do_augment = rng.random() > 0.5
    gamma = float(rng.uniform(0.9, 1.1))
    brightness = float(rng.uniform(0.75, 1.25) if dataset == "nyu" else rng.uniform(0.9, 1.1))
    colors = rng.uniform(0.9, 1.1, size=3).astype(np.float32)
    return {"crop_yx": (y, x), "flip": flip, "do_augment": do_augment, "gamma": gamma,
            "brightness": brightness, "colors": colors}


def old_dl_train_sample(image_u8: np.ndarray, depth_raw: np.ndarray, dataset: str,
                        do_kb_crop: bool, do_random_rotate: bool, degree: float,
                        train_dims: tuple, depth_norm_factor: float,
                        rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The legacy AdaBins/BTS train pipeline (dataloader.py:116-270): HWC
    uint8 image and raw depth -> the ImageNet-normalised image and the depth
    in metres, HWC fp32 at ``train_dims``. Draws, in the JAX package's
    order: the angle, crop x, crop y, flip, do_augment, gamma, brightness,
    colours. The tail runs in the core (``native.augment_normalize``)."""
    image, depth = old_dl_stage_a(image_u8, depth_raw, dataset, do_kb_crop, do_random_rotate,
                                  degree, depth_norm_factor, rng)
    aug = old_dl_draw_aug(dataset, image.shape, train_dims, rng)
    (y, x), (h, w) = aug["crop_yx"], train_dims
    image, depth = image[y:y + h, x:x + w], depth[y:y + h, x:x + w]
    # flip, gamma, brightness, colour, normalise (dataloader.py:239-284)
    image = native.augment_normalize(image, aug["flip"], aug["do_augment"], aug["gamma"],
                                     aug["brightness"], aug["colors"])
    if aug["flip"]:
        depth = depth[:, ::-1].copy()
    return image.astype(np.float32), depth.astype(np.float32)


def new_train_sample(image_u8: np.ndarray, depth_raw: np.ndarray, dataset: str,
                     do_kb_crop: bool, do_random_rotate: bool, degree: float,
                     train_dims: tuple, image_norm_factor: float, depth_norm_factor: float,
                     rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The new pipeline's host part (modules/Preprocess.py, train mode): the
    [0, 1] image and the depth in metres at ``train_dims``; the card
    augments and normalises the batch."""
    image = image_u8.astype(np.float32) / image_norm_factor
    depth = (depth_raw if depth_raw.ndim == 3 else depth_raw[:, :, None]).astype(
        np.float32) / depth_norm_factor
    if do_kb_crop:
        image, depth = kb_crop(image, depth)
    if dataset == "nyu":
        # torchvision crop(top=45, left=43, height=427, width=565)
        image, depth = image[45:45 + 427, 43:43 + 565], depth[45:45 + 427, 43:43 + 565]
    if do_random_rotate:
        angle = rng.uniform(-degree, degree)
        image = native.rotate_bilinear(image, angle)
        depth = native.rotate_nearest(depth, angle)
    image, depth = random_crop(image, depth, train_dims[0], train_dims[1], rng)
    return image.astype(np.float32), depth.astype(np.float32)


def _rotation_grid(h: int, w: int, angle_deg: float):
    """Kornia-style rotation sampling grid about the image centre: output
    pixel p samples the input at R^-1 (p - c) + c."""
    a = np.deg2rad(angle_deg)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cos_a, sin_a = np.cos(a), np.sin(a)
    x0, y0 = xs - cx, ys - cy
    return -sin_a * x0 + cos_a * y0 + cy, cos_a * x0 + sin_a * y0 + cx


def rotate_bilinear(img: np.ndarray, angle: float) -> np.ndarray:
    """The plain version of ``native.rotate_bilinear``: (H, W, C) fp32
    rotated about its centre, bilinear, zero fill."""
    h, w = img.shape[:2]
    sy, sx = _rotation_grid(h, w, angle)
    y0, x0 = np.floor(sy).astype(np.int64), np.floor(sx).astype(np.int64)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]

    def tap(yy, xx):
        inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        return img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)] * inb

    out = (tap(y0, x0) * (1 - fy) * (1 - fx) + tap(y0, x0 + 1) * (1 - fy) * fx
           + tap(y0 + 1, x0) * fy * (1 - fx) + tap(y0 + 1, x0 + 1) * fy * fx)
    return out.astype(np.float32)


def rotate_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """The plain version of ``native.rotate_nearest``: (H, W, C) fp32
    rotated about its centre, nearest, zero fill."""
    h, w = img.shape[:2]
    sy, sx = _rotation_grid(h, w, angle)
    yy, xx = np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64)
    inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
    return (img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)] * inb).astype(np.float32)
