"""ObjCAViT: image-object self/cross-attention bin predictor.

Port of ``objcavit_tpu/models/objcavit.py`` for the ``learned_bbox_wh``
positional strategy (the other strategies wait for ROADMAP A.5), with the
reference's module names. ``attn_impl`` ("plain" or "kernel") is the
route of all ten attentions (JAX's ``attn_impl``). Ragged per-image
detections arrive as padded (B, N) slots with a validity mask (True = real
object); the no-detection sentinel is slot 0 with xywh = -1 and valid =
True (``serving.py``).

Reference quirks kept exactly (they change the numbers):

* ``SelfAttnCrossAttn`` front-pads the batch-ragged objects (length
  n_b = the batch's largest valid count) to the image sequence length with
  0.0001 while extending the key-padding mask at the END, so the object
  block starts at S - n_b, which depends on the data. Reproduced for any
  count up to S with a gather.
* Invalid object slots hold 0.0001, not 0.
* Positional MLP inputs are cast to the model dtype first (bf16 rounds pixel
  coordinates), as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from objcavit_torch.models.common import PatchEmbedConv
from objcavit_torch.models.layers import (
    BinRegressor,
    MultiHeadAttention,
    TransformerEncoder,
)

PAD_VALUE = 0.0001


class LearnedPositionalMLP(nn.Sequential):
    """xywh -> E coordinate MLP; Linear layers at Sequential indices 0,2,4,6,8."""

    def __init__(self, embed_dim: int, in_dim: int = 4):
        layers = []
        for width in (32, 64, 128, 256):
            layers += [nn.Linear(in_dim, width), nn.LeakyReLU(0.01)]
            in_dim = width
        super().__init__(*layers, nn.Linear(in_dim, embed_dim))


class SelfAttnCrossAttn(nn.Module):
    """Image SA x4 + object SA x4 + bidirectional cross-attention."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, dim_feedforward: int = 1024,
                 dropout_rate: float = 0.1, attn_impl: str = "plain"):
        super().__init__()
        self.image_transformer_encoder = TransformerEncoder(
            4, embed_dim, num_heads, dim_feedforward, dropout_rate, attn_impl)
        self.obj_transformer_encoder = TransformerEncoder(
            4, embed_dim, num_heads, dim_feedforward, dropout_rate, attn_impl)
        self.cross_attn_obj_im = MultiHeadAttention(embed_dim, num_heads, attn_impl)
        self.cross_attn_im_obj = MultiHeadAttention(embed_dim, num_heads, attn_impl)

    def forward(self, image_emb, obj_emb, obj_pad_mask, generator=None):
        """image_emb (B,S,E); obj_emb (B,N,E); obj_pad_mask (B,N) True = padding.
        The cross-attention has no dropout, as in the JAX package."""
        b, s, _ = image_emb.shape
        n = obj_emb.shape[1]
        if n > s:
            raise ValueError(f"{n} object slots exceed the image sequence length {s}")
        attended_image = self.image_transformer_encoder(image_emb, generator=generator)
        attended_obj = self.obj_transformer_encoder(obj_emb, obj_pad_mask, generator)

        # place attended_obj[k] at position S - n_b + k, 0.0001 before it;
        # slots k >= n_b (never materialised by the ragged reference) fall off
        n_b = (~obj_pad_mask).sum(dim=1).max()
        src = torch.arange(s, device=image_emb.device) - (s - n_b)
        index = src.clamp(0, n - 1).view(1, s, 1).expand(b, s, attended_obj.shape[2])
        gathered = torch.gather(attended_obj, 1, index)
        keep = ((src >= 0) & (src < n)).view(1, s, 1)
        obj_padded = torch.where(keep, gathered, torch.full_like(gathered, PAD_VALUE))
        # positions < n keep the slot mask, positions >= n are masked
        key_padding = torch.cat(
            [obj_pad_mask, torch.ones((b, s - n), dtype=torch.bool, device=obj_pad_mask.device)],
            dim=1,
        )
        final_image = self.cross_attn_obj_im(
            attended_image, obj_padded, attended_image, key_padding_mask=key_padding
        )
        final_obj = self.cross_attn_im_obj(obj_padded, attended_image, obj_padded)
        return final_image, final_obj


class ObjCAViT(nn.Module):
    def __init__(self, im_feature_dim: int = 128, obj_feature_dim: int = 512,
                 n_query_channels: int = 128, patch_size: int = 16,
                 dim_out: int = 256, embed_dim: int = 128, num_heads: int = 4,
                 pos_strategy: str = "learned_bbox_wh", dropout_rate: float = 0.1,
                 attn_impl: str = "plain"):
        super().__init__()
        if pos_strategy != "learned_bbox_wh":
            raise NotImplementedError(
                f"pos_strategy {pos_strategy!r} is not ported yet (ROADMAP A.5); "
                "ported: 'learned_bbox_wh'"
            )
        self.patch_size = patch_size
        self.n_query_channels = n_query_channels
        self.positional_encoder = LearnedPositionalMLP(embed_dim)
        self.image_embedding_convPxP = PatchEmbedConv(im_feature_dim, embed_dim, patch_size)
        self.obj_embedding_layer = nn.Linear(obj_feature_dim, embed_dim)
        self.saca_1 = SelfAttnCrossAttn(embed_dim, num_heads, 1024, dropout_rate, attn_impl)
        self.conv3x3 = nn.Conv2d(im_feature_dim, embed_dim, 3, 1, 1)
        self.regressor = BinRegressor(embed_dim, dim_out)

    def forward(self, image_features, object_features, object_xywh, object_valid,
                generator=None):
        """image_features (B, fh, fw, C) NHWC; object_features (B, N, F);
        object_xywh (B, N, 4) full-resolution pixels; object_valid (B, N) bool;
        ``generator`` feeds the transformers' dropout in training mode.

        Returns (bin widths (B, dim_out) normalised to sum 1, feat (B, fh, fw, E)
        NHWC, queries (B, n_query_channels, E)): the range-attention maps stay
        factored as (feat, queries) for the bins head.
        """
        dtype = image_features.dtype
        b, fh, fw, _ = image_features.shape
        p = self.patch_size
        if fh % p or fw % p:
            raise ValueError(f"feature size {fh}x{fw} must divide the patch size {p}")

        obj_pos = self.positional_encoder(object_xywh.to(dtype))
        obj_emb = self.obj_embedding_layer(object_features.to(dtype)) + obj_pos
        obj_emb = torch.where(object_valid[..., None], obj_emb, torch.full_like(obj_emb, PAD_VALUE))

        feat_nchw = image_features.permute(0, 3, 1, 2)
        gh, gw = fh // p, fw // p
        s = gh * gw
        if s < self.n_query_channels + 1:
            raise ValueError(
                f"{s} image tokens cannot give the regression token and "
                f"{self.n_query_channels} queries"
            )
        img_emb = self.image_embedding_convPxP(feat_nchw).permute(0, 2, 3, 1).reshape(b, s, -1)
        # patch centres in feature pixels, plus the patch size as w and h
        dev = image_features.device
        ww = torch.arange(gw, dtype=torch.float32, device=dev) * p + p // 2
        hh = torch.arange(gh, dtype=torch.float32, device=dev) * p + p // 2
        patch_coords = torch.stack(
            [ww.expand(gh, gw).reshape(-1), hh[:, None].expand(gh, gw).reshape(-1),
             torch.full((s,), float(p), device=dev), torch.full((s,), float(p), device=dev)],
            dim=-1,
        )
        img_emb = img_emb + self.positional_encoder(patch_coords.to(dtype))[None]

        img_emb, _ = self.saca_1(img_emb, obj_emb, ~object_valid, generator)
        regression_head = img_emb[:, 0, :]
        queries = img_emb[:, 1 : self.n_query_channels + 1, :]
        feat = self.conv3x3(feat_nchw).permute(0, 2, 3, 1)

        y = torch.relu(self.regressor(regression_head)) + 0.1
        y = y / y.sum(dim=1, keepdim=True)
        return y, feat, queries
