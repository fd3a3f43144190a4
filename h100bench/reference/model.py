"""Plain PyTorch GraphBins and AdaBins (B-series EfficientNet encoders), the
benchmark's reference for correctness.

A frozen, standalone copy of the measured model's mathematics on its plain
routes, written from the published architecture (ObjCAViT, arXiv:2211.17232;
AdaBins, arXiv:2011.14141) and the reference implementation's module names,
so the parameter names and shapes are those of the program's state dict.
It imports nothing of the program. Every tensor is fp32 (the caller sets
TF32 off), BatchNorm stays unfolded, attention is an explicit softmax, the
bins head computes the range maps, the 1x1 ``conv_out`` logits and their
softmax expectation in the published order, and the bilinear upsamples are
``F.interpolate``'s. Dropout draws ``torch.rand`` of each tensor's shape
from the generator it is given, in forward order, as the measured train step
does, so a replay with the same seed draws the same masks.

Reference quirks kept (they change the numbers): ``conv2`` is a 1x1 conv
with padding 1; ObjCAViT front-pads the objects to the image sequence with
0.0001 and extends the key-padding mask at the end; its image-to-object
cross-attention takes the image tokens as its values; widths are ReLU + 0.1
then normalised. Only the ``learned`` and ``learned_bbox_wh`` positional
strategies are written; another raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
DECODER_BN_EPS = 1e-5
PAD_VALUE = 0.0001
N_QUERIES = 128
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------- encoder

@dataclasses.dataclass(frozen=True)
class Spec:
    stem: int
    head: int
    stages: tuple  # (kind, out, depth, kernel, stride, expand)


def _round_channels(c: float) -> int:
    new_c = max(8, int(c + 4) // 8 * 8)
    if new_c < 0.9 * c:
        new_c += 8
    return new_c


def b_spec(width: float, depth: float) -> Spec:
    base_ch = [16, 24, 40, 80, 112, 192, 320]
    base_d = [1, 2, 2, 3, 3, 4, 1]
    kernels = [3, 3, 5, 3, 5, 5, 3]
    strides = [1, 2, 2, 2, 1, 2, 1]
    expands = [1, 6, 6, 6, 6, 6, 6]
    stages = tuple(("ds" if i == 0 else "mb", _round_channels(base_ch[i] * width),
                    int(math.ceil(base_d[i] * depth)), kernels[i], strides[i], expands[i])
                   for i in range(7))
    return Spec(_round_channels(32 * width), _round_channels(1280 * width) if width > 1 else 1280,
                stages)


SPECS = {
    "efficientnet-b5": b_spec(1.6, 2.2),
    # the test size: one small block a stage, the B-series topology
    "efficientnet-tiny": Spec(8, 64, (("ds", 8, 1, 3, 1, 1), ("mb", 16, 1, 3, 2, 2),
                                      ("mb", 16, 1, 3, 2, 2), ("mb", 24, 1, 3, 2, 2),
                                      ("mb", 24, 1, 3, 1, 2), ("mb", 32, 1, 3, 2, 2),
                                      ("mb", 32, 1, 3, 1, 2))),
}
SKIP_STAGES = (0, 1, 2, 4)


class Conv2dSame(nn.Conv2d):
    """TensorFlow SAME padding: more after than before where it is odd."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, se_channels, 1)
        self.conv_expand = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))


class DepthwiseSeparable(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin, bias=False)
        self.bn1 = nn.BatchNorm2d(cin, eps=BN_EPS)
        self.se = SqueezeExcite(cin, max(1, int(cin * 0.25)))
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: int, k: int, stride: int):
        super().__init__()
        mid = int(cin * expand)
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid, bias=False)
        self.bn2 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class Encoder(nn.Module):
    """NCHW image -> [the four skips, the bottleneck], NCHW."""

    def __init__(self, name: str):
        super().__init__()
        spec = SPECS[name]
        self.conv_stem = Conv2dSame(3, spec.stem, 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(spec.stem, eps=BN_EPS)
        stages, cin = [], spec.stem
        for kind, cout, depth, k, stride, expand in spec.stages:
            blocks = []
            for i in range(depth):
                s = stride if i == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, s) if kind == "ds"
                              else MBConv(cin, cout, expand, k, s))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(cin, spec.head, 1, bias=False)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        skips = []
        for i, stage in enumerate(self.blocks):
            x = stage(x)
            if i in SKIP_STAGES:
                skips.append(x)
        return skips + [self.conv_head(x)]


# ---------------------------------------------------------------- decoder

class UpSampleWithSkip(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1), nn.BatchNorm2d(cout, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.BatchNorm2d(cout, eps=DECODER_BN_EPS),
            nn.LeakyReLU(0.01))

    def forward(self, x, skip):
        up = F.interpolate(x, size=skip.shape[2:], mode="bilinear", align_corners=True)
        return self._net(torch.cat([up, skip], dim=1))


class Decoder(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        spec = SPECS[name]
        f = spec.head
        s0, s1, s2, s3 = (spec.stages[i][1] for i in SKIP_STAGES)
        self.conv2 = nn.Conv2d(f, f, 1, 1, 1)
        self.up1 = UpSampleWithSkip(f + s3, f // 2)
        self.up2 = UpSampleWithSkip(f // 2 + s2, f // 4)
        self.up3 = UpSampleWithSkip(f // 4 + s1, f // 8)
        self.up4 = UpSampleWithSkip(f // 8 + s0, f // 16)
        self.conv3 = nn.Conv2d(f // 16, 128, 3, 1, 1)

    def forward(self, feats):
        x = self.conv2(feats[4])
        for up, skip in zip((self.up1, self.up2, self.up3, self.up4), feats[3::-1]):
            x = up(x, skip)
        return self.conv3(x)


class DenseFeatureExtractor(nn.Module):
    """NHWC image -> NCHW features at half resolution, 128 channels."""

    def __init__(self, name: str):
        super().__init__()
        self.encoder = nn.ModuleDict({"original_model": Encoder(name)})
        self.decoder = Decoder(name)

    def forward(self, image):
        return self.decoder(self.encoder["original_model"](image.permute(0, 3, 1, 2)))


# ---------------------------------------------------------------- transformers

def dropout(x, rate: float, training: bool, generator):
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    def __init__(self, e: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = nn.Linear(e, e)

    def forward(self, query, key, value, key_padding_mask=None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q, k, v = F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv)
        b, sq, e = q.shape
        d = e // self.heads
        q, k, v = (t.reshape(b, -1, self.heads, d) for t in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.reshape(b, sq, e))


class TransformerEncoderLayer(nn.Module):
    """Post-LN, ReLU FFN of 1024, dropout after attention, ReLU and linear2."""

    def __init__(self, e: int, heads: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = MultiHeadAttention(e, heads)
        self.linear1 = nn.Linear(e, 1024)
        self.linear2 = nn.Linear(1024, e)
        self.norm1 = nn.LayerNorm(e, eps=1e-5)
        self.norm2 = nn.LayerNorm(e, eps=1e-5)

    def forward(self, x, mask=None, generator=None):
        def drop(t):
            return dropout(t, self.rate, self.training, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, x, mask)))
        h = drop(F.relu(self.linear1(x)))
        return self.norm2(x + drop(self.linear2(h)))


class TransformerEncoder(nn.Module):
    def __init__(self, e: int, heads: int, rate: float):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(e, heads, rate) for _ in range(4))

    def forward(self, x, mask=None, generator=None):
        for layer in self.layers:
            x = layer(x, mask, generator)
        return x


class BinRegressor(nn.Sequential):
    def __init__(self, e: int, out: int):
        super().__init__(nn.Linear(e, 256), nn.LeakyReLU(0.01), nn.Linear(256, 256),
                         nn.LeakyReLU(0.01), nn.Linear(256, out))


def normalised_widths(y):
    y = torch.relu(y) + 0.1
    return y / y.sum(dim=1, keepdim=True)


class LearnedPositionalMLP(nn.Sequential):
    def __init__(self, e: int, in_dim: int):
        layers = []
        for width in (32, 64, 128, 256):
            layers += [nn.Linear(in_dim, width), nn.LeakyReLU(0.01)]
            in_dim = width
        super().__init__(*layers, nn.Linear(in_dim, e))


class SelfAttnCrossAttn(nn.Module):
    def __init__(self, e: int, heads: int, rate: float):
        super().__init__()
        self.image_transformer_encoder = TransformerEncoder(e, heads, rate)
        self.obj_transformer_encoder = TransformerEncoder(e, heads, rate)
        self.cross_attn_obj_im = MultiHeadAttention(e, heads)
        self.cross_attn_im_obj = MultiHeadAttention(e, heads)

    def forward(self, image_emb, obj_emb, obj_pad_mask, generator=None):
        b, s, e = image_emb.shape
        n = obj_emb.shape[1]
        attended_image = self.image_transformer_encoder(image_emb, generator=generator)
        attended_obj = self.obj_transformer_encoder(obj_emb, obj_pad_mask, generator)
        # the batch's largest valid count n_b: object k sits at S - n_b + k
        n_b = (~obj_pad_mask).sum(dim=1).max()
        src = torch.arange(s, device=image_emb.device) - (s - n_b)
        index = src.clamp(0, n - 1).view(1, s, 1).expand(b, s, e)
        keep = ((src >= 0) & (src < n)).view(1, s, 1)
        padded = torch.where(keep, torch.gather(attended_obj, 1, index),
                             torch.full((b, s, e), PAD_VALUE, dtype=image_emb.dtype,
                                        device=image_emb.device))
        mask = torch.cat([obj_pad_mask, torch.ones((b, s - n), dtype=torch.bool,
                                                   device=obj_pad_mask.device)], dim=1)
        return self.cross_attn_obj_im(attended_image, padded, attended_image,
                                      key_padding_mask=mask)


class ObjCAViT(nn.Module):
    def __init__(self, n_queries: int, n_bins: int, pos_strategy: str, e: int = 128,
                 heads: int = 4, rate: float = 0.1, patch: int = 16, obj_dim: int = 512):
        super().__init__()
        if pos_strategy not in ("learned", "learned_bbox_wh"):
            raise ValueError(f"the reference has no positional strategy {pos_strategy!r}")
        self.wh = pos_strategy == "learned_bbox_wh"
        self.patch = patch
        self.n_queries = n_queries
        self.positional_encoder = LearnedPositionalMLP(e, 4 if self.wh else 2)
        self.image_embedding_convPxP = nn.Conv2d(128, e, patch, patch)
        self.obj_embedding_layer = nn.Linear(obj_dim, e)
        self.saca_1 = SelfAttnCrossAttn(e, heads, rate)
        self.conv3x3 = nn.Conv2d(128, e, 3, 1, 1)
        self.regressor = BinRegressor(e, n_bins)

    def positions(self, xywh):
        return self.positional_encoder(xywh if self.wh else xywh[..., :2])

    def forward(self, feat, obj_features, obj_xywh, obj_valid, generator=None):
        """feat NCHW (B, 128, fh, fw) -> (widths, feat NHWC, queries)."""
        b, _, fh, fw = feat.shape
        p = self.patch
        obj = self.obj_embedding_layer(obj_features) + self.positions(obj_xywh)
        obj = torch.where(obj_valid[..., None], obj, torch.full_like(obj, PAD_VALUE))
        gh, gw = fh // p, fw // p
        img = self.image_embedding_convPxP(feat).permute(0, 2, 3, 1).reshape(b, gh * gw, -1)
        dev = feat.device
        xs = (torch.arange(gw, device=dev) * p + p // 2).float().expand(gh, gw).reshape(-1)
        ys = (torch.arange(gh, device=dev) * p + p // 2).float()[:, None].expand(gh, gw)
        size = torch.full((gh * gw,), float(p), device=dev)
        coords = torch.stack([xs, ys.reshape(-1), size, size], dim=-1)
        img = img + self.positions(coords[None].to(img.dtype))
        img = self.saca_1(img, obj, ~obj_valid, generator)
        queries = img[:, 1:self.n_queries + 1]
        widths = normalised_widths(self.regressor(img[:, 0]))
        return widths, self.conv3x3(feat).permute(0, 2, 3, 1), queries


class PatchTransformerEncoder(nn.Module):
    def __init__(self, e: int, heads: int, max_seq_len: int, rate: float, patch: int = 16):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(128, e, patch, patch)
        self.positional_encodings = nn.Parameter(torch.zeros(max_seq_len, e))
        self.transformer_encoder = TransformerEncoder(e, heads, rate)

    def forward(self, x, generator=None):
        emb = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        emb = emb + self.positional_encodings[:emb.shape[1]][None]
        return self.transformer_encoder(emb, generator=generator)


class MiniViT(nn.Module):
    def __init__(self, n_queries: int, n_bins: int, e: int = 128, heads: int = 4,
                 max_seq_len: int = 500, rate: float = 0.1):
        super().__init__()
        self.n_queries = n_queries
        self.patch_transformer = PatchTransformerEncoder(e, heads, max_seq_len, rate)
        self.conv3x3 = nn.Conv2d(128, e, 3, 1, 1)
        self.regressor = BinRegressor(e, n_bins)

    def forward(self, feat, generator=None):
        tgt = self.patch_transformer(feat, generator)
        queries = tgt[:, 1:self.n_queries + 1]
        widths = normalised_widths(self.regressor(tgt[:, 0]))
        return widths, self.conv3x3(feat).permute(0, 2, 3, 1), queries


# ---------------------------------------------------------------- the models

def bins_depth(widths, feat, queries, conv_out: nn.Conv2d, min_depth: float, max_depth: float):
    """The adaptive-bins head in the published order: range maps, the 1x1
    conv's logits, softmax over the bins, expectation over their centres,
    in fp32 whatever the model's dtype. -> (depth (B, H, W, 1), edges
    (B, K + 1))."""
    widths, feat, queries = widths.float(), feat.float(), queries.float()
    first = torch.full((widths.shape[0], 1), min_depth, device=widths.device)
    edges = torch.cumsum(torch.cat([first, (max_depth - min_depth) * widths], dim=1), dim=1)
    centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
    range_maps = torch.einsum("bhwc,bkc->bhwk", feat, queries)
    k = conv_out.weight.shape[0]
    logits = F.linear(range_maps, conv_out.weight.reshape(k, -1).float(), conv_out.bias.float())
    depth = (torch.softmax(logits, dim=-1) * centers[:, None, None, :]).sum(-1, keepdim=True)
    return depth, edges


class GraphBins(nn.Module):
    takes_objects = True

    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 pos_strategy: str = "learned_bbox_wh", embedding_dim: int = 128,
                 obj_feature_dim: int = 512, n_queries: int = N_QUERIES,
                 dropout_rate: float = 0.1, **_):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.dense_feature_extractor = DenseFeatureExtractor(encoder_name)
        self.objcavit = ObjCAViT(n_queries, n_bins, pos_strategy, embedding_dim,
                                 rate=dropout_rate, obj_dim=obj_feature_dim)
        self.conv_out = nn.Sequential(nn.Conv2d(n_queries, n_bins, 1))

    def forward(self, image, obj_features, obj_xywh, obj_valid, generator=None):
        feat = self.dense_feature_extractor(image)
        widths, feat, queries = self.objcavit(feat, obj_features, obj_xywh, obj_valid, generator)
        return bins_depth(widths, feat, queries, self.conv_out[0], self.min_depth, self.max_depth)


class AdaBins(nn.Module):
    takes_objects = False

    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0, n_queries: int = N_QUERIES,
                 dropout_rate: float = 0.1, **_):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.dense_feature_extractor = DenseFeatureExtractor(encoder_name)
        self.adaptive_bins_layer = MiniViT(n_queries, n_bins, rate=dropout_rate)
        self.conv_out = nn.Sequential(nn.Conv2d(n_queries, n_bins, 1))

    def forward(self, image, generator=None):
        feat = self.dense_feature_extractor(image)
        widths, feat, queries = self.adaptive_bins_layer(feat, generator)
        return bins_depth(widths, feat, queries, self.conv_out[0], self.min_depth, self.max_depth)


MODELS = {"graphbins": GraphBins, "adabins": AdaBins}


def build(model: str, kwargs: dict) -> nn.Module:
    return MODELS[model](**kwargs)


FOLDS = {Encoder: (("conv_stem", "bn1"),),
         DepthwiseSeparable: (("conv_dw", "bn1"), ("conv_pw", "bn2")),
         MBConv: (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3")),
         UpSampleWithSkip: (("_net.0", "_net.1"), ("_net.3", "_net.4"))}


@torch.no_grad()
def fold_batchnorm_(model: nn.Module) -> nn.Module:
    """Fold every eval BatchNorm into the conv before it, in fp32: conv(x) *
    s + t with s = gamma / sqrt(var + eps), t = beta - mean * s (plus the
    conv's bias times s); the BN becomes the identity."""
    for module in list(model.modules()):
        for conv_name, bn_name in FOLDS.get(type(module), ()):
            conv, bn = module.get_submodule(conv_name), module.get_submodule(bn_name)
            s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            bias = bn.bias - bn.running_mean * s
            if conv.bias is not None:
                bias = bias + conv.bias * s
            conv.weight.mul_(s.view(-1, 1, 1, 1))
            conv.bias = nn.Parameter(bias)
            parent, _, leaf = bn_name.rpartition(".")
            setattr(module.get_submodule(parent) if parent else module, leaf, nn.Identity())
    return model


def normalise(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> ImageNet-normalised fp32 NHWC."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    std = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std


def sentinel_objects(b: int, slots: int, dim: int, device):
    """The no-detection sentinel: slot 0 valid at xywh -1 with a zero
    feature, every other slot padding."""
    valid = torch.zeros((b, slots), dtype=torch.bool, device=device)
    valid[:, 0] = True
    return (torch.zeros((b, slots, dim), device=device),
            torch.full((b, slots, 4), -1.0, device=device), valid)
