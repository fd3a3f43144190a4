"""Transformer blocks with torch-module naming (reference layers.py).

Port of ``objcavit_tpu/models/layers.py``:

* ``MultiHeadAttention``: ``nn.MultiheadAttention``'s parameters
  (``in_proj_weight`` (3E, E), ``in_proj_bias``, ``out_proj``) over
  ``ops.attention.mha_core``; batch-first (B, S, E). Its ``attn_impl``
  picks the attention route, ``"plain"`` or ``"kernel"`` (kernel 5); the
  blocks below pass theirs down.
* ``TransformerEncoderLayer``: post-LN (eps 1e-5), ReLU FFN of width 1024,
  and dropout (rate 0.1 by default) in training mode at the JAX package's
  three places (``objcavit_tpu/models/layers.py:85, 90, 92``): after
  self-attention, after the ReLU, after ``linear2``. It draws from the
  ``torch.Generator`` passed to ``forward``.
* ``TransformerEncoder``: ``layers.{i}``.

Split over a process grid's model axis (``parallel/tp.py::tp_shard_model``
sets a block's ``tp``, its grid), an attention holds its rank's heads and an
FFN its rank's columns of ``linear1`` and rows of ``linear2``: the block's
input passes through ``copy_to_model``, its output product through
``reduce_from_model`` (Megatron's f and g, ``parallel/collectives.py``), and
the output bias is added once, after the reduce. The dropout after the ReLU
takes this model rank's columns of the global draw, so the masks are one
process's.
* ``PatchTransformerEncoder``: miniViT's patch embedding conv
  (``embedding_convPxP``, kernel = stride), the learned
  ``positional_encodings`` (max_seq_len, E) table sliced to the token
  count, and the 4-layer ``transformer_encoder``. In a split forward
  (``parallel/spatial.py``) the embedding runs on the band, whose rows are
  whole patch rows, and the tokens are gathered over the model group in
  row order before the table: the encoder sees the whole image's.
* ``pixelwise_dot_product``: the range-attention maps of the bins head's
  training route.
* ``BinRegressor``: E -> 256 -> 256 -> dim_out with LeakyReLU, as the
  reference's Sequential (``regressor.{0,2,4}``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from objcavit_torch.models.common import PatchEmbedConv
from objcavit_torch.ops.attention import mha_core
from objcavit_torch.parallel import spatial
from objcavit_torch.parallel.collectives import copy_to_model, rand_rows, reduce_from_model


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None,
            block: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``generator`` (the default
    generator if None), with flax ``nn.Dropout``'s semantics: the identity
    outside training or at rate 0, zeros at rate 1. x is batch-first; in a
    process group the mask is this rank's rows of the global batch's
    (``parallel/collectives.py::rand_rows``), and with ``block`` (i, n) x's
    last dim is block i of n of the global draw's."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = rand_rows(x.shape, generator, x.device, block=block) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, attn_impl: str = "plain"):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.tp = None  # the grid whose model axis splits the heads
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query, key, value, key_padding_mask=None):
        e = self.in_proj_weight.shape[0] // 3  # this rank's heads' width
        h = self.num_heads * e // self.embed_dim
        if self.tp is not None:
            copies = {}  # one copy a distinct input keeps ``query is key``
            for t in (query, key, value):
                if id(t) not in copies:
                    copies[id(t)] = copy_to_model(t, self.tp.model_group)
            query, key, value = (copies[id(t)] for t in (query, key, value))
        if query is key and key is value:
            q, k, v = F.linear(query, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        else:
            wq, wk, wv = self.in_proj_weight.chunk(3)
            bq, bk, bv = self.in_proj_bias.chunk(3)
            q, k, v = F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv)
        q, k, v = (t.reshape(*t.shape[:-1], h, e // h) for t in (q, k, v))
        out = mha_core(q, k, v, key_padding_mask, impl=self.attn_impl)
        out = out.reshape(*out.shape[:-2], e)
        if self.tp is None:
            return self.out_proj(out)
        out = reduce_from_model(F.linear(out, self.out_proj.weight), self.tp.model_group)
        return out + self.out_proj.bias


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 1024,
                 dropout_rate: float = 0.1, attn_impl: str = "plain"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, attn_impl)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.tp = None  # the grid whose model axis splits the FFN

    def forward(self, x, key_padding_mask=None, generator=None):
        def drop(t, block=None):
            return dropout(t, self.dropout_rate, self.training, generator, block)

        x = self.norm1(x + drop(self.self_attn(x, x, x, key_padding_mask)))
        if self.tp is None:
            h = drop(F.relu(self.linear1(x)))
            return self.norm2(x + drop(self.linear2(h)))
        group = self.tp.model_group
        h = drop(F.relu(self.linear1(copy_to_model(x, group))),
                 (self.tp.model_index, self.tp.n_model))
        y = reduce_from_model(F.linear(h, self.linear2.weight), group) + self.linear2.bias
        return self.norm2(x + drop(y))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 1024, dropout_rate: float = 0.1,
                 attn_impl: str = "plain"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, dim_feedforward, dropout_rate, attn_impl)
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None, generator=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask, generator)
        return x


class PatchTransformerEncoder(nn.Module):
    """Patch embedding + learned positional table + 4-layer encoder; (B, S, E) out."""

    def __init__(self, in_channels: int, patch_size: int = 10, embed_dim: int = 128,
                 num_heads: int = 4, max_seq_len: int = 500, dropout_rate: float = 0.1,
                 attn_impl: str = "plain"):
        super().__init__()
        self.embedding_convPxP = PatchEmbedConv(in_channels, embed_dim, patch_size)
        self.positional_encodings = nn.Parameter(torch.rand(max_seq_len, embed_dim))
        self.transformer_encoder = TransformerEncoder(4, embed_dim, num_heads, 1024,
                                                      dropout_rate, attn_impl)

    def forward(self, x, generator=None):
        """x (B, H, W, C) NHWC -> (B, (H // p) (W // p), E)."""
        emb = self.embedding_convPxP(x.permute(0, 3, 1, 2))
        if spatial.active() is not None:
            emb = spatial.gather_rows(emb, 2)
        emb = emb.flatten(2).transpose(1, 2)
        s = emb.shape[1]
        if s > self.positional_encodings.shape[0]:
            raise ValueError(f"{s} patch tokens exceed max_seq_len "
                             f"{self.positional_encodings.shape[0]}")
        emb = emb + self.positional_encodings[:s].to(emb.dtype)[None]
        return self.transformer_encoder(emb, generator=generator)


def pixelwise_dot_product(x: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x (B, K, C) -> (B, H, W, K) range-attention maps."""
    return torch.einsum("bhwc,bkc->bhwk", x, queries)


class BinRegressor(nn.Sequential):
    def __init__(self, embed_dim: int, dim_out: int):
        super().__init__(
            nn.Linear(embed_dim, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, dim_out),
        )
