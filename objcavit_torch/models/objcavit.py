"""ObjCAViT: image-object self/cross-attention bin predictor.

Port of ``objcavit_tpu/models/objcavit.py`` with the reference's module
names, for its four positional strategies (``learned``,
``learned_bbox_wh``, ``grid_random``, ``grid_random_roi_align``) and its
``no_obj_sa`` and ``use_2_saca`` options. ``attn_impl`` ("plain" or
"kernel") is the route of every attention (JAX's ``attn_impl``). Ragged
per-image detections arrive as padded (B, N) slots with a validity mask
(True = real object); the no-detection sentinel is slot 0 with xywh = -1
and valid = True (``serving.py``).

Reference quirks kept exactly (they change the numbers):

* ``SelfAttnCrossAttn`` front-pads the batch-ragged objects (length
  n_b = the batch's largest valid count) to the image sequence length with
  0.0001 while extending the key-padding mask at the END, so the object
  block starts at S - n_b, which depends on the data. Reproduced for any
  count up to S with a gather; in a process group n_b is the global
  batch's (``parallel/collectives.py::global_max``), as in the JAX
  package's sharded step. Under ``use_2_saca`` the second SACA takes
  the first one's (B, S, E) objects with an all-valid mask: n_b = S and the
  gather is the identity.
* Invalid object slots hold 0.0001, not 0.
* The ``learned*`` MLPs take their coordinates cast to the model dtype first
  (bf16 rounds pixel coordinates), as the JAX package does.
* ``grid_random``'s table has one row per 16-pixel patch of the larger of
  the FULL-resolution ``dims_train`` and ``dims_test``; a call reads its
  first ceil(fh/16) ceil(fw/16) rows as a (gh, gw) grid of the
  half-resolution features, so the same rows land on other cells at
  416x544 than at 480x640. In "img" centre mode only patches 0 and 1 are
  normalised (by gh and by gw: the reference indexes ``[:, 0]`` of a
  (B, S, 2) tensor); every other patch samples out of range and reads 0.
  In "obj" mode x is normalised by the image's height and y by its width.

Spatial serving (``parallel/spatial.py``): in a split forward the image
features are this rank's band of rows, a whole number of patch rows. The
patch embedding runs on the band and the tokens are gathered over the
model group in row order; the patch coordinates and every position are the
whole image's (the level's rows from the plan), so SACA and the regressor
see one process's tokens (a model ``tp_shard_model`` split sees them on
every model rank alike, as its split attention expects). ``conv3x3`` takes
its 1-row halo and ``feat`` stays the band's, for the bins head. Every
positional strategy and option reads coordinates only, so each runs on
bands.

The grid strategies give fp32 embeddings (a table in the model dtype times
fp32 weights), as JAX's do. JAX adds them to the model-dtype embeddings in
fp32 and its projections cast the sum to the model dtype, so q, k and v
see the sum rounded once; the port rounds the sum to the model dtype where
it is made, which gives the projections the same values. The one place the
two differ is the first residual of each transformer's layer 0, which JAX
sums in fp32 and the port in the model dtype (ROADMAP §C).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from objcavit_torch.models.common import Conv2d, PatchEmbedConv
from objcavit_torch.models.layers import (
    BinRegressor,
    MultiHeadAttention,
    TransformerEncoder,
)
from objcavit_torch.ops.grid_sample import grid_sample_bilinear
from objcavit_torch.ops.roi_align import ps_roi_align_1x1
from objcavit_torch.parallel import spatial
from objcavit_torch.parallel.collectives import global_max

PAD_VALUE = 0.0001
FEATURE_STRIDE = 2  # image pixels per pixel of the dense features ObjCAViT reads
POS_STRATEGIES = ("grid_random", "grid_random_roi_align", "learned", "learned_bbox_wh")


class LearnedPositionalMLP(nn.Sequential):
    """Coordinate MLP, (x, y) or xywh -> E; Linear layers at Sequential
    indices 0,2,4,6,8."""

    def __init__(self, embed_dim: int, in_dim: int = 4):
        layers = []
        for width in (32, 64, 128, 256):
            layers += [nn.Linear(in_dim, width), nn.LeakyReLU(0.01)]
            in_dim = width
        super().__init__(*layers, nn.Linear(in_dim, embed_dim))


class GridRandomPositionalEmbeddings(nn.Module):
    """A learned per-patch embedding grid, sampled at points ("centre") or
    averaged over boxes ("roi_align")."""

    def __init__(self, embed_dim: int, patch_size: int, mode: str,
                 dims_train: tuple[int, int], dims_test: tuple[int, int]):
        super().__init__()
        self.patch_size = patch_size
        self.mode = mode
        rows = max(math.ceil(h / patch_size) * math.ceil(w / patch_size)
                   for h, w in (dims_train, dims_test))
        self.positional_encodings = nn.Parameter(torch.rand(rows, embed_dim))

    def forward(self, coords, feat_shape: tuple[int, int], input_coord_space: str) -> torch.Tensor:
        """coords (B, P, 2) centres or (B, P, 4) xywh (roi_align), in the
        feature pixels of patches ("img") or the image's pixels ("obj");
        feat_shape (fh, fw) of the dense features. Returns (B, P, E) in at
        least fp32."""
        fh, fw = feat_shape
        p = self.patch_size
        gh, gw = math.ceil(fh / p), math.ceil(fw / p)
        table = self.positional_encodings
        if gh * gw > table.shape[0]:
            raise ValueError(f"a {gh}x{gw} grid exceeds the table's {table.shape[0]} rows")
        grid = table[: gh * gw].reshape(gh, gw, -1)

        if self.mode == "centre":
            c = coords.to(torch.promote_types(coords.dtype, torch.float32))
            if input_coord_space == "img":
                # the reference's [:, 0] indexing: patch 0 over gh, patch 1 over gw
                c = c.clone()
                c[:, 0] = c[:, 0] / gh * 2.0 - 1.0
                if c.shape[1] > 1:
                    c[:, 1] = c[:, 1] / gw * 2.0 - 1.0
            else:  # "obj": x over the image height, y over its width
                c = torch.stack([c[..., 0] / (fh * FEATURE_STRIDE) * 2.0 - 1.0,
                                 c[..., 1] / (fw * FEATURE_STRIDE) * 2.0 - 1.0], dim=-1)
            return grid_sample_bilinear(grid, c)

        half_w, half_h = coords[..., 2] / 2.0, coords[..., 3] / 2.0
        xyxy = torch.stack([coords[..., 0] - half_w, coords[..., 1] - half_h,
                            coords[..., 0] + half_w, coords[..., 1] + half_h], dim=-1)
        xyxy = xyxy.clamp(min=0.0)
        if input_coord_space == "img":  # a patch box is one grid cell
            return ps_roi_align_1x1(grid, xyxy, 1.0 / p, max_samples=2)
        return ps_roi_align_1x1(grid, xyxy, 1.0 / (p * FEATURE_STRIDE), max_samples=40)


class SelfAttnCrossAttn(nn.Module):
    """Image SA x4 + object SA x4 (none under ``no_obj_sa``: the object
    embeddings go straight to the front-pad) + bidirectional cross-attention."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, dim_feedforward: int = 1024,
                 dropout_rate: float = 0.1, attn_impl: str = "plain", no_obj_sa: bool = False):
        super().__init__()
        self.no_obj_sa = no_obj_sa
        self.image_transformer_encoder = TransformerEncoder(
            4, embed_dim, num_heads, dim_feedforward, dropout_rate, attn_impl)
        if not no_obj_sa:
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
        if self.no_obj_sa:
            attended_obj = obj_emb
        else:
            attended_obj = self.obj_transformer_encoder(obj_emb, obj_pad_mask, generator)

        # place attended_obj[k] at position S - n_b + k, 0.0001 before it;
        # slots k >= n_b (never materialised by the ragged reference) fall off
        n_b = global_max((~obj_pad_mask).sum(dim=1).max())
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
                 pos_strategy: str = "learned_bbox_wh", no_obj_sa: bool = False,
                 use_2_saca: bool = False, dims_train: tuple[int, int] = (416, 544),
                 dims_test: tuple[int, int] = (480, 640), dropout_rate: float = 0.1,
                 attn_impl: str = "plain"):
        super().__init__()
        if pos_strategy not in POS_STRATEGIES:
            raise ValueError(f"pos_strategy must be one of {POS_STRATEGIES}, got {pos_strategy!r}")
        self.pos_strategy = pos_strategy
        self.use_2_saca = use_2_saca
        self.patch_size = patch_size
        self.n_query_channels = n_query_channels
        if pos_strategy.startswith("grid_random"):
            mode = "centre" if pos_strategy == "grid_random" else "roi_align"
            self.positional_encoder = GridRandomPositionalEmbeddings(
                embed_dim, patch_size, mode, tuple(dims_train), tuple(dims_test))
        else:
            in_dim = 4 if pos_strategy == "learned_bbox_wh" else 2
            self.positional_encoder = LearnedPositionalMLP(embed_dim, in_dim)
        self.image_embedding_convPxP = PatchEmbedConv(im_feature_dim, embed_dim, patch_size)
        self.obj_embedding_layer = nn.Linear(obj_feature_dim, embed_dim)
        self.saca_1 = SelfAttnCrossAttn(embed_dim, num_heads, 1024, dropout_rate, attn_impl,
                                        no_obj_sa)
        if use_2_saca:
            self.saca_2 = SelfAttnCrossAttn(embed_dim, num_heads, 1024, dropout_rate, attn_impl,
                                            no_obj_sa)
        self.conv3x3 = Conv2d(im_feature_dim, embed_dim, 3, 1, 1)
        self.regressor = BinRegressor(embed_dim, dim_out)

    def positions(self, xywh, feat_shape: tuple[int, int], space: str, dtype) -> torch.Tensor:
        """The positional embedding of (B, P, 4) fp32 xywh in ``space``
        ("img": patches in feature pixels; "obj": objects in image pixels):
        (x, y) alone for ``learned`` and ``grid_random``. The MLPs read the
        coordinates in ``dtype`` and return it; the grids return fp32."""
        wh = self.pos_strategy in ("learned_bbox_wh", "grid_random_roi_align")
        coords = xywh if wh else xywh[..., :2]
        if isinstance(self.positional_encoder, LearnedPositionalMLP):
            return self.positional_encoder(coords.to(dtype))
        return self.positional_encoder(coords, feat_shape, space)

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
        split = spatial.active() is not None
        if split:  # a band of the features: the image's rows at this level
            fh = spatial.whole_rows(fh)
        p = self.patch_size
        if fh % p or fw % p:
            raise ValueError(f"feature size {fh}x{fw} must divide the patch size {p}")

        obj_pos = self.positions(object_xywh.float(), (fh, fw), "obj", dtype)
        obj_emb = self.obj_embedding_layer(object_features.to(dtype)) + obj_pos
        obj_emb = torch.where(object_valid[..., None], obj_emb, torch.full_like(obj_emb, PAD_VALUE))
        obj_emb = obj_emb.to(dtype)  # the grids' fp32 sum, rounded once

        feat_nchw = image_features.permute(0, 3, 1, 2)
        gh, gw = fh // p, fw // p
        s = gh * gw
        if s < self.n_query_channels + 1:
            raise ValueError(
                f"{s} image tokens cannot give the regression token and "
                f"{self.n_query_channels} queries"
            )
        img_emb = self.image_embedding_convPxP(feat_nchw)
        if split:
            img_emb = spatial.gather_rows(img_emb, 2)
        img_emb = img_emb.permute(0, 2, 3, 1).reshape(b, s, -1)
        # patch centres in feature pixels, plus the patch size as w and h;
        # one image's worth, the same for every image
        dev = image_features.device
        ww = torch.arange(gw, dtype=torch.float32, device=dev) * p + p // 2
        hh = torch.arange(gh, dtype=torch.float32, device=dev) * p + p // 2
        patch_coords = torch.stack(
            [ww.expand(gh, gw).reshape(-1), hh[:, None].expand(gh, gw).reshape(-1),
             torch.full((s,), float(p), device=dev), torch.full((s,), float(p), device=dev)],
            dim=-1,
        )
        img_pos = self.positions(patch_coords[None], (fh, fw), "img", dtype)
        img_emb = (img_emb + img_pos).to(dtype)

        img_emb, obj_out = self.saca_1(img_emb, obj_emb, ~object_valid, generator)
        if self.use_2_saca:
            # the first SACA's (B, S, E) objects, every one valid
            all_valid = torch.zeros(obj_out.shape[:2], dtype=torch.bool, device=dev)
            img_emb, _ = self.saca_2(img_emb, obj_out, all_valid, generator)
        regression_head = img_emb[:, 0, :]
        queries = img_emb[:, 1 : self.n_query_channels + 1, :]
        feat = self.conv3x3(feat_nchw).permute(0, 2, 3, 1)

        y = torch.relu(self.regressor(regression_head)) + 0.1
        y = y / y.sum(dim=1, keepdim=True)
        return y, feat, queries
