"""AdaBins, the paper's baseline (reference modules/AdaBins.py).

Port of ``objcavit_tpu/models/adabins.py``: image -> DenseFeatureExtractor
(GraphBins' own) -> miniViT (``adaptive_bins_layer``: bin widths and
factored range maps) -> the factored bins head with ``conv_out`` -> depth.
Returns ``{'depth_pred', 'bin_edges'}``, as GraphBins does, with the same
``cast``, ``params_in`` and train/eval semantics (``BinsDepthModel``); the
forward takes the image alone. ``attn_impl`` is miniViT's attention route,
``"plain"`` or ``"kernel"`` (kernel 5); ``encoder_impl`` the encoder's, as
GraphBins'. ``do_final_upscale`` adds the decoder's fifth upsample, to the
image's full resolution, which quadruples miniViT's tokens: its positional
table grows from 500 rows to 1200, as in JAX (1200 tokens at 480x640).
``drop_path_rate`` is the encoder's stochastic depth.
"""

from __future__ import annotations

import torch.nn as nn

from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.graphbins import N_QUERIES, BinsDepthModel
from objcavit_torch.models.minivit import MiniViT
from objcavit_torch.utils.profiling import annotate

MAX_SEQ_LEN = 500  # miniViT's positional table without do_final_upscale
MAX_SEQ_LEN_FINAL_UPSCALE = 1200  # miniViT's positional table with do_final_upscale


class AdaBins(BinsDepthModel):
    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 do_final_upscale: bool = False, drop_path_rate: float = 0.0,
                 dropout_rate: float = 0.1, n_queries: int = N_QUERIES,
                 attn_impl: str = "plain", encoder_impl: str = "plain"):
        super().__init__()
        self.do_final_upscale = do_final_upscale
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.attn_impl = attn_impl
        self.encoder_impl = encoder_impl
        self.dense_feature_extractor = DenseFeatureExtractor(
            encoder_name, encoder_impl, do_final_upscale, drop_path_rate)
        self.adaptive_bins_layer = MiniViT(
            in_channels=128, n_query_channels=n_queries, patch_size=16, dim_out=n_bins,
            embed_dim=128, norm="linear",
            max_seq_len=MAX_SEQ_LEN_FINAL_UPSCALE if do_final_upscale else MAX_SEQ_LEN,
            dropout_rate=dropout_rate, attn_impl=attn_impl,
        )
        self.conv_out = nn.Sequential(nn.Conv2d(n_queries, n_bins, 1))

    @property
    def transformer_head(self) -> MiniViT:
        return self.adaptive_bins_layer

    def forward(self, image, generator=None):
        """image (B, H, W, 3) ImageNet-normalised NHWC; ``generator`` feeds
        the dropout and the stochastic depth in training mode."""
        dense = self.dense_feature_extractor(image.to(self.dtype), generator)
        with annotate("model.attention"):
            widths, feat, queries = self.adaptive_bins_layer(dense, generator)
        with annotate("model.bins_head"):
            return self.bins_head(widths, feat, queries)
