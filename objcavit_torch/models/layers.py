"""Transformer blocks with torch-module naming (reference layers.py).

Port of ``objcavit_tpu/models/layers.py``:

* ``MultiHeadAttention``: ``nn.MultiheadAttention``'s parameters
  (``in_proj_weight`` (3E, E), ``in_proj_bias``, ``out_proj``) over
  ``ops.attention.mha_core``; batch-first (B, S, E).
* ``TransformerEncoderLayer``: post-LN (eps 1e-5), ReLU FFN of width 1024;
  dropout is the identity at eval and is left out.
* ``TransformerEncoder``: ``layers.{i}``.
* ``BinRegressor``: E -> 256 -> 256 -> dim_out with LeakyReLU, as the
  reference's Sequential (``regressor.{0,2,4}``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from objcavit_torch.ops.attention import mha_core


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query, key, value, key_padding_mask=None):
        e, h = self.embed_dim, self.num_heads
        if query is key and key is value:
            q, k, v = F.linear(query, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        else:
            wq, wk, wv = self.in_proj_weight.chunk(3)
            bq, bk, bv = self.in_proj_bias.chunk(3)
            q, k, v = F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv)
        q, k, v = (t.reshape(*t.shape[:-1], h, e // h) for t in (q, k, v))
        out = mha_core(q, k, v, key_padding_mask)
        return self.out_proj(out.reshape(*out.shape[:-2], e))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 1024):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, key_padding_mask=None):
        x = self.norm1(x + self.self_attn(x, x, x, key_padding_mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, dim_feedforward)
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x


class BinRegressor(nn.Sequential):
    def __init__(self, embed_dim: int, dim_out: int):
        super().__init__(
            nn.Linear(embed_dim, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, dim_out),
        )
