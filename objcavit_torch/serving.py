"""Serving: uint8 frames in, depth maps out, through GraphBins.

Port of ``objcavit_tpu/serving.py::DepthPipeline`` and
``build_flagship_pipeline``. One request runs on the model's device:

    uint8 (B, H, W, 3) -> /255 -> resize to the eval size if it differs
    (bilinear, half-pixel) -> ImageNet normalise -> GraphBins -> depth
    (B, h/2, w/2, 1) in metres -> optionally resized back to (H, W)

Objects come from ``provider`` (called with the normalised eval-size images
as numpy, returning numpy ``features``/``xywh``/``valid`` slots) or, without
one, the no-detection sentinel: slot 0 valid with xywh = -1 and a zero
feature (the 'control_obj_zeros_512' ablation).
The port has no mesh and no spatial sharding: one process drives one card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from objcavit_torch.ops.resize import resize_bilinear

# ImageNet statistics (objcavit_tpu/data/preprocess.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MAX_DET = 1000  # yolov7seg.max_det of the reference's params files


def image_seq_len(h: int, w: int, patch: int = 16) -> int:
    """ObjCAViT's image-token count for an (h, w) input: half-resolution
    dense features cut into 16-pixel patches (objcavit_tpu/training/steps.py)."""
    return math.ceil(math.ceil(h / 2) / patch) * math.ceil(math.ceil(w / 2) / patch)


class DepthPipeline:
    """Batched depth-map server around a GraphBins model."""

    def __init__(self, model, eval_dims: tuple[int, int] = (480, 640),
                 n_obj_max: int | None = None, output_at_input_res: bool = False,
                 provider=None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.eval_dims = tuple(eval_dims)
        # detection capacity: min(max_det, image sequence length), 300 at 480x640
        self.n_obj_max = (
            min(MAX_DET, image_seq_len(*self.eval_dims)) if n_obj_max is None else n_obj_max
        )
        self.output_at_input_res = output_at_input_res
        self.provider = provider
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)
        self._sentinels: dict[int, tuple] = {}

    def _sentinel_objects(self, b: int):
        if b not in self._sentinels:
            n, dev = self.n_obj_max, self.device
            feats = torch.zeros((b, n, self.model.obj_feature_dim), device=dev)
            xywh = torch.full((b, n, 4), -1.0, device=dev)
            valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
            valid[:, 0] = True
            self._sentinels[b] = (feats, xywh, valid)
        return self._sentinels[b]

    @torch.inference_mode()
    def __call__(self, frames_u8) -> torch.Tensor:
        """frames_u8: (B, H, W, 3) uint8 (numpy or tensor) -> (B, h, w, 1)
        fp32 depth in metres on the model's device."""
        frames = torch.as_tensor(frames_u8).to(self.device)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[3] != 3:
            raise ValueError(
                f"frames must be uint8 (B, H, W, 3), got {frames.dtype} {tuple(frames.shape)}"
            )
        b, in_h, in_w, _ = frames.shape
        x = frames.float() / 255.0
        x = resize_bilinear(x, *self.eval_dims, align_corners=False)
        x = (x - self.mean) / self.std
        if self.provider is not None:
            objs = self.provider(x.cpu().numpy())
            feats, xywh, valid = (
                torch.as_tensor(np.asarray(objs[k]), device=self.device)
                for k in ("features", "xywh", "valid")
            )
        else:
            feats, xywh, valid = self._sentinel_objects(b)
        depth = self.model(x, feats, xywh, valid)["depth_pred"]
        if self.output_at_input_res:
            depth = resize_bilinear(depth, in_h, in_w, align_corners=True)
        return depth


def build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=(480, 640), seed: int = 0,
                            device=None) -> DepthPipeline:
    """Flagship GraphBins-B5 pipeline, BN folded, with random weights from
    ``seed``."""
    from objcavit_torch.utils.benchkit import build_flagship_model

    model = build_flagship_model(dtype=dtype, seed=seed, device=device)
    return DepthPipeline(model, eval_dims=eval_dims)
