"""Object providers: the fixed-shape object slots GraphBins consumes.

Port of ``objcavit_tpu/training/providers.py`` (numpy only; the JAX
package's ``objcavit_tpu.training`` imports jax when imported). A provider
maps a batch of normalised images (numpy NHWC) to padded slots
``{'features' (B, N, 512), 'xywh' (B, N, 4), 'valid' (B, N)}``:

* ``ZerosObjectProvider``: the 'control_obj_zeros_512' ablation without a
  detector: the no-detection sentinel (slot 0 valid, xywh = -1, zero
  features) for every image;
* ``StubObjectProvider``: deterministic pseudo-detections, for tests and
  runs without detector weights; the same draws as the JAX package's;
* ``mirror_objects``: the slots of the horizontally flipped image, for the
  eval's flip-TTA.

The slot count is ``n_max`` or, when None, min(max_det, the image sequence
length of the batch's own size). A detector behind the zeros provider and
``final_upscale`` wait for later slices (ROADMAP A.4, A.5).
"""

from __future__ import annotations

import numpy as np

from objcavit_torch.serving import MAX_DET, image_seq_len


class _SlotSizing:
    def __init__(self, n_max: int | None, obj_dim: int, max_det: int):
        self.n_max = n_max
        self.obj_dim = obj_dim
        self.max_det = int(max_det)

    def slots(self, images: np.ndarray) -> int:
        if self.n_max is not None:
            return int(self.n_max)
        h, w = images.shape[1:3]
        return min(self.max_det, image_seq_len(h, w))


class ZerosObjectProvider(_SlotSizing):
    """Zero language features and the sentinel box in every image."""

    def __init__(self, n_max: int | None = 32, obj_dim: int = 512, max_det: int = MAX_DET):
        super().__init__(n_max, obj_dim, max_det)

    def __call__(self, images_normed: np.ndarray) -> dict:
        b = images_normed.shape[0]
        n_max = self.slots(images_normed)
        valid = np.zeros((b, n_max), bool)
        valid[:, 0] = True  # the <UNK> sentinel slot
        return {
            "features": np.zeros((b, n_max, self.obj_dim), np.float32),
            "xywh": np.full((b, n_max, 4), -1.0, np.float32),
            "valid": valid,
        }


class StubObjectProvider(_SlotSizing):
    """Deterministic pseudo-detections: call i draws from seed + i."""

    def __init__(self, n_max: int | None = 32, obj_dim: int = 512, seed: int = 0,
                 max_det: int = MAX_DET):
        super().__init__(n_max, obj_dim, max_det)
        self.seed = seed
        self._count = 0

    def __call__(self, images_normed: np.ndarray) -> dict:
        b, h, w = images_normed.shape[:3]
        n_max = self.slots(images_normed)
        rng = np.random.default_rng(self.seed + self._count)
        self._count += 1
        # stub counts grow with capacity, so large slot counts exercise the
        # object-rich front-pad, not just the first 32 slots
        n_obj = rng.integers(0, min(n_max, 32 + n_max // 8), size=b)
        xywh = np.full((b, n_max, 4), -1.0, np.float32)
        valid = np.zeros((b, n_max), bool)
        feats = np.zeros((b, n_max, self.obj_dim), np.float32)
        for i in range(b):
            n = int(n_obj[i])
            if n == 0:
                valid[i, 0] = True  # UNK sentinel
                feats[i, 0] = rng.standard_normal(self.obj_dim) * 0.02
                continue
            cx = rng.uniform(0, w, n)
            cy = rng.uniform(0, h, n)
            bw = rng.uniform(8, w / 2, n)
            bh = rng.uniform(8, h / 2, n)
            xywh[i, :n] = np.stack([cx, cy, bw, bh], axis=1)
            valid[i, :n] = True
            feats[i, :n] = rng.standard_normal((n, self.obj_dim)) * 0.02
        return {"features": feats, "xywh": xywh, "valid": valid}


def mirror_objects(objects: dict, image_width: int) -> dict:
    """The slots of the horizontally flipped image: a valid slot's centre x
    becomes W - x (as the JAX package mirrors it, not W - 1 - x); padded
    slots (x = -1) stay as they are."""
    xywh = objects["xywh"].copy()
    real = objects["valid"] & (xywh[..., 0] >= 0)
    xywh[..., 0] = np.where(real, image_width - xywh[..., 0], xywh[..., 0])
    return {**objects, "xywh": xywh}
