"""miniViT, AdaBins' adaptive-bins head (reference modules/miniViT.py).

Port of ``objcavit_tpu/models/minivit.py``, with the reference's module
names: ``patch_transformer`` (a ``PatchTransformerEncoder``), ``conv3x3``
and ``regressor``. Token 0 of the patch transformer regresses the bin
widths, tokens 1..K are the queries of the range-attention maps against a
3x3 conv of the input features. Widths are normalised by ``norm``:
``"linear"`` (ReLU + 0.1, then sum 1; AdaBins' own), ``"softmax"``, or
else a sigmoid then sum 1, as in JAX. The maps stay factored as (feat,
queries) for the bins head. ``attn_impl`` is the route of the four
self-attentions, ``"plain"`` or ``"kernel"`` (kernel 5). In a split
forward (``parallel/spatial.py``) the transformer reads the gathered
tokens, ``conv3x3`` takes its 1-row halo and the features stay the band's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from objcavit_torch.models.common import Conv2d
from objcavit_torch.models.layers import BinRegressor, PatchTransformerEncoder


class MiniViT(nn.Module):
    def __init__(self, in_channels: int = 128, n_query_channels: int = 128,
                 patch_size: int = 16, dim_out: int = 256, embed_dim: int = 128,
                 num_heads: int = 4, norm: str = "linear", max_seq_len: int = 500,
                 dropout_rate: float = 0.1, attn_impl: str = "plain"):
        super().__init__()
        self.n_query_channels = n_query_channels
        self.norm = norm
        self.patch_transformer = PatchTransformerEncoder(
            in_channels, patch_size, embed_dim, num_heads, max_seq_len, dropout_rate, attn_impl)
        self.conv3x3 = Conv2d(in_channels, embed_dim, 3, 1, 1)
        self.regressor = BinRegressor(embed_dim, dim_out)

    def forward(self, x, generator=None):
        """x (B, H, W, C) NHWC -> (bin widths (B, dim_out) summing to 1,
        feat (B, H, W, E) NHWC, queries (B, n_query_channels, E))."""
        tgt = self.patch_transformer(x, generator)
        if tgt.shape[1] < self.n_query_channels + 1:
            raise ValueError(f"{tgt.shape[1]} patch tokens cannot give the regression token "
                             f"and {self.n_query_channels} queries")
        feat = self.conv3x3(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        queries = tgt[:, 1:self.n_query_channels + 1, :]
        y = self.regressor(tgt[:, 0, :])
        if self.norm == "linear":
            y = torch.relu(y) + 0.1
        elif self.norm == "softmax":
            return torch.softmax(y, dim=1), feat, queries
        else:
            y = torch.sigmoid(y)
        return y / y.sum(dim=1, keepdim=True), feat, queries
