"""GraphBins, the full ObjCAViT depth model (reference modules/GraphBins.py).

Port of ``objcavit_tpu/models/graphbins.py`` for inference: image ->
DenseFeatureExtractor -> ObjCAViT (objects supplied as padded slots) ->
factored bins head -> depth. Returns ``{'depth_pred', 'bin_edges'}``.

``conv_out.0`` has the reference's (n_bins, 128, 1, 1) shape, so the image
must give at least 129 patch tokens (the regression token and 128 queries).
The bins head reads ``conv_out`` in fp32, as the JAX bins head reads its
fp32 parameters; ``cast`` keeps it so.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.objcavit import ObjCAViT
from objcavit_torch.ops.bins import bins_head_depth_factored

N_QUERIES = 128


class GraphBins(nn.Module):
    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 embedding_dim: int = 128, obj_feature_dim: int = 512,
                 pos_strategy: str = "learned_bbox_wh"):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.obj_feature_dim = obj_feature_dim
        self.dense_feature_extractor = DenseFeatureExtractor(encoder_name)
        self.objcavit = ObjCAViT(
            im_feature_dim=128, obj_feature_dim=obj_feature_dim,
            n_query_channels=N_QUERIES, patch_size=16, dim_out=n_bins,
            embed_dim=embedding_dim, pos_strategy=pos_strategy,
        )
        # the reference's Sequential(conv, Softmax); the bins head fuses both
        self.conv_out = nn.Sequential(nn.Conv2d(N_QUERIES, n_bins, 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.objcavit.obj_embedding_layer.weight.dtype

    def cast(self, dtype: torch.dtype) -> "GraphBins":
        """Cast to ``dtype``, keeping ``conv_out`` in fp32."""
        self.to(dtype)
        self.conv_out.float()
        return self

    def forward(self, image, object_features, object_xywh, object_valid):
        """image (B, H, W, 3) ImageNet-normalised NHWC; objects as padded
        slots (B, N, F), (B, N, 4), (B, N) bool."""
        dense = self.dense_feature_extractor(image.to(self.dtype))
        widths, feat, queries = self.objcavit(dense, object_features, object_xywh, object_valid)
        conv = self.conv_out[0]
        depth, edges = bins_head_depth_factored(
            widths, feat, queries, conv.weight, conv.bias, self.min_depth, self.max_depth
        )
        return {"depth_pred": depth, "bin_edges": edges}
