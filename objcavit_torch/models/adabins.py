"""AdaBins, the paper's baseline (reference modules/AdaBins.py).

Port of ``objcavit_tpu/models/adabins.py``: image -> DenseFeatureExtractor
(GraphBins' own) -> miniViT (``adaptive_bins_layer``: bin widths and
factored range maps) -> the factored bins head with ``conv_out`` -> depth.
Returns ``{'depth_pred', 'bin_edges'}``, as GraphBins does, with the same
``cast``, ``params_in`` and train/eval semantics (``BinsDepthModel``); the
forward takes the image alone. ``attn_impl`` is miniViT's attention route,
``"plain"`` or ``"kernel"`` (kernel 5); ``encoder_impl`` the encoder's, as
GraphBins'. ``do_final_upscale`` (a fifth
decoder upsample to full resolution) is not ported yet (ROADMAP A.5).
"""

from __future__ import annotations

import torch.nn as nn

from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.graphbins import N_QUERIES, BinsDepthModel
from objcavit_torch.models.minivit import MiniViT

MAX_SEQ_LEN = 500  # miniViT's positional table without do_final_upscale


class AdaBins(BinsDepthModel):
    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 do_final_upscale: bool = False, dropout_rate: float = 0.1,
                 n_queries: int = N_QUERIES, attn_impl: str = "plain",
                 encoder_impl: str = "plain"):
        super().__init__()
        if do_final_upscale:
            raise NotImplementedError("do_final_upscale is not ported yet (ROADMAP A.5)")
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.attn_impl = attn_impl
        self.encoder_impl = encoder_impl
        self.dense_feature_extractor = DenseFeatureExtractor(encoder_name, encoder_impl)
        self.adaptive_bins_layer = MiniViT(
            in_channels=128, n_query_channels=n_queries, patch_size=16, dim_out=n_bins,
            embed_dim=128, norm="linear", max_seq_len=MAX_SEQ_LEN, dropout_rate=dropout_rate,
            attn_impl=attn_impl,
        )
        self.conv_out = nn.Sequential(nn.Conv2d(n_queries, n_bins, 1))

    @property
    def transformer_head(self) -> MiniViT:
        return self.adaptive_bins_layer

    def forward(self, image, generator=None):
        """image (B, H, W, 3) ImageNet-normalised NHWC; ``generator`` feeds
        the dropout in training mode."""
        dense = self.dense_feature_extractor(image.to(self.dtype))
        widths, feat, queries = self.adaptive_bins_layer(dense, generator)
        return self.bins_head(widths, feat, queries)
