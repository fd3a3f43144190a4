"""YOLOv7-seg (u7 branch) instance-segmentation detector, PyTorch.

Port of ``objcavit_tpu/models/yolov7.py``. Public functions take NHWC; the
convolutions run on NCHW tensors in ``torch.channels_last`` memory. Module
names are the JAX package's (``body.elan1.cv3.conv``, ``body.rep3.rbr_dense_bn``,
``proto.cv1``, ``detect0`` ...), so ``utils/convert.py::
yolov7_state_dict_from_variables`` maps its variables one to one.

  backbone: stem convs -> E-ELAN stages (P2..P5) with MP downsamples
  neck:     SPPCSPC -> PAN up/down path with ELAN-W blocks -> RepConv
  heads:    3 levels x 3 anchors of 5 + nc + nm outputs (1x1 convs
            ``detect{i}``), and the Proto net (nm masks at /4)

Box decode follows yolov7: xy = (2 sig - 0.5 + grid) * stride, wh =
(2 sig)^2 * anchor. ``Yolov7Seg.forward`` has the JAX package's three head
modes (dense, ``class_max``, ``topk_positions``) and ``with_proto`` to skip
the Proto net, which the fused server never reads (XLA removes it from the
JAX program; eager PyTorch would run it).

Not ported: ``_s2d_stem_pair`` (an exact space-to-depth rewrite of the stem
for the TPU's layout); the plain ``s0``/``s1`` convs run with the same
weights.

The detect convs keep fp32 parameters, as the JAX package keeps its params
fp32 and casts at use: the dense and sparse heads read them cast to the
model dtype; the class-max head reads them repacked for kernel 6 (the weight
in the model dtype, the bias in fp32). Both are made once per set of
weights and cached.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from objcavit_torch.kernels.detect_head import (
    fused_detect_head,
    fused_detect_head_plain,
    pack_detect_head,
)
from objcavit_torch.ops.nms import batched_nms, stable_topk, xywh_to_xyxy, xyxy_to_xywh
from objcavit_torch.serving import IMAGENET_MEAN, IMAGENET_STD

# anchors per level (P3/8, P4/16, P5/32), yolov7 defaults
ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
# above this many anchors the detector takes the class-max head (kernel 6).
# The JAX package's threshold (a TPU v5e measurement), kept on the H100: on
# an NVIDIA H100 80GB HBM3 at 700 W, `profile_stages --fused` timed the two
# head routes in turns at NYU 480x640 (18,900 anchors) and KITTI 352x1216
# (26,334) with the wgmma kernel 6, and each route's request time and served
# rate fell within the other's spread (PERF.md §5)
CLASS_MAX_MIN_ANCHORS = 20000


def n_anchors(h: int, w: int) -> int:
    """Anchors of the detector grid at an (h, w) input."""
    return 3 * sum((h // st) * (w // st) for st in STRIDES)


class Conv(nn.Module):
    """yolov7 Conv: conv -> BN (eps 1e-3) -> SiLU."""

    bn_folds = (("conv", "bn"),)

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


def _cat(*xs):
    return torch.cat(xs, dim=1)


class ELAN(nn.Module):
    """Backbone E-ELAN: 2 parallel 1x1s; one side runs 4 3x3s; concat 4 taps."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.cv1, self.cv2 = Conv(cin, mid), Conv(cin, mid)
        self.cv3, self.cv4 = Conv(mid, mid, 3), Conv(mid, mid, 3)
        self.cv5, self.cv6 = Conv(mid, mid, 3), Conv(mid, mid, 3)
        self.cv7 = Conv(4 * mid, out)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        c = self.cv4(self.cv3(b))
        d = self.cv6(self.cv5(c))
        return self.cv7(_cat(d, c, b, a))


class ELANW(nn.Module):
    """Head ELAN-W: like ELAN but taps every 3x3 (6-way concat)."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.cv1, self.cv2 = Conv(cin, mid), Conv(cin, mid)
        self.cv3 = Conv(mid, mid // 2, 3)
        self.cv4, self.cv5, self.cv6 = (Conv(mid // 2, mid // 2, 3) for _ in range(3))
        self.cv7 = Conv(4 * (mid // 2) + 2 * mid, out)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        c1 = self.cv3(b)
        c2 = self.cv4(c1)
        c3 = self.cv5(c2)
        c4 = self.cv6(c3)
        return self.cv7(_cat(c4, c3, c2, c1, b, a))


class MPDown(nn.Module):
    """yolov7 downsample: maxpool+1x1 || 1x1+3x3s2, concat (keeps channels)."""

    def __init__(self, cin: int, out_half: int):
        super().__init__()
        self.cv1, self.cv2 = Conv(cin, out_half), Conv(cin, out_half)
        self.cv3 = Conv(out_half, out_half, 3, 2)

    def forward(self, x):
        a = self.cv1(F.max_pool2d(x, 2, 2))
        b = self.cv3(self.cv2(x))
        return _cat(b, a)


class SPPCSPC(nn.Module):
    """Spatial-pyramid-pooling CSP block (yolov7 head entry): max-pools
    5/9/13 at stride 1 with 'same' (-inf) padding."""

    def __init__(self, cin: int, out: int):
        super().__init__()
        self.cv1, self.cv3, self.cv4 = Conv(cin, out), Conv(out, out, 3), Conv(out, out)
        self.cv5, self.cv6 = Conv(4 * out, out), Conv(out, out, 3)
        self.cv2, self.cv7 = Conv(cin, out), Conv(2 * out, out)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [x1] + [F.max_pool2d(x1, k, 1, k // 2) for k in (5, 9, 13)]
        y1 = self.cv6(self.cv5(_cat(*pools)))
        return self.cv7(_cat(y1, self.cv2(x)))


class RepConv(nn.Module):
    """RepVGG-style conv: 3x3 + 1x1 (+ identity BN when cin == cout), SiLU.

    ``merge_branches_`` (called by ``utils.fold_bn.fold_batchnorm``) collapses
    the branches into one biased 3x3 conv, ``merged_conv``: exact at
    inference; the merged form refuses training mode.
    """

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.rbr_dense_conv = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.rbr_dense_bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.rbr_1x1_conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.rbr_1x1_bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.rbr_identity_bn = nn.BatchNorm2d(cout, eps=BN_EPS) if cin == cout else None
        self.merged_conv = None

    def forward(self, x):
        if self.merged_conv is not None:
            if self.training:
                raise RuntimeError("RepConv's branches were merged for inference; it cannot train")
            return F.silu(self.merged_conv(x))
        out = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1_bn(self.rbr_1x1_conv(x))
        if self.rbr_identity_bn is not None:
            out = out + self.rbr_identity_bn(x)
        return F.silu(out)

    @torch.no_grad()
    def merge_branches_(self) -> None:
        """Fold each branch's BN and sum the branches into ``merged_conv``:
        the 1x1 kernel padded to the centre tap, the identity BN as a
        centred diagonal."""
        if self.merged_conv is not None:
            return
        dense = self.rbr_dense_conv.weight
        if dense.dtype != torch.float32:
            raise ValueError(f"merge in fp32, before casting: got {dense.dtype}")

        def scale_shift(bn):
            s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            return s, bn.bias - bn.running_mean * s

        s3, t3 = scale_shift(self.rbr_dense_bn)
        s1, t1 = scale_shift(self.rbr_1x1_bn)
        kernel = dense * s3.view(-1, 1, 1, 1) + F.pad(
            self.rbr_1x1_conv.weight * s1.view(-1, 1, 1, 1), [1, 1, 1, 1])
        bias = t3 + t1
        if self.rbr_identity_bn is not None:
            si, ti = scale_shift(self.rbr_identity_bn)
            idx = torch.arange(kernel.shape[0], device=kernel.device)
            kernel[idx, idx, 1, 1] += si
            bias = bias + ti
        merged = nn.Conv2d(dense.shape[1], dense.shape[0], 3, 1, 1, bias=True).to(dense.device)
        merged.weight.copy_(kernel)
        merged.bias.copy_(bias)
        merged.train(self.training)
        self.merged_conv = merged
        del self.rbr_dense_conv, self.rbr_dense_bn, self.rbr_1x1_conv, self.rbr_1x1_bn
        self.rbr_identity_bn = None


def upsample_nearest2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Proto(nn.Module):
    """Mask prototype net: conv3x3 -> 2x nearest upsample -> conv3x3 -> 1x1 (nm)."""

    def __init__(self, cin: int, mid: int = 256, nm: int = 32):
        super().__init__()
        self.cv1, self.cv2, self.cv3 = Conv(cin, mid, 3), Conv(mid, mid, 3), Conv(mid, nm)

    def forward(self, x):
        return self.cv3(self.cv2(upsample_nearest2x(self.cv1(x))))


class Yolov7SegBackboneNeck(nn.Module):
    """Image (NCHW) -> the three detect features (P3/8 256, P4/16 512, P5/32 1024)."""

    def __init__(self):
        super().__init__()
        self.s0, self.s1 = Conv(3, 32, 3), Conv(32, 64, 3, 2)          # /2
        self.s2, self.s3 = Conv(64, 64, 3), Conv(64, 128, 3, 2)        # /4
        self.elan1 = ELAN(128, 64, 256)
        self.mp1, self.elan2 = MPDown(256, 128), ELAN(256, 128, 512)   # P3 /8
        self.mp2, self.elan3 = MPDown(512, 256), ELAN(512, 256, 1024)  # P4 /16
        self.mp3, self.elan4 = MPDown(1024, 512), ELAN(1024, 256, 1024)  # P5 /32
        self.sppcspc = SPPCSPC(1024, 512)
        self.up4_conv, self.lat4 = Conv(512, 256), Conv(1024, 256)
        self.elanw4 = ELANW(512, 256, 256)
        self.up3_conv, self.lat3 = Conv(256, 128), Conv(512, 128)
        self.elanw3 = ELANW(256, 128, 128)
        self.down4, self.elanw4b = MPDown(128, 128), ELANW(512, 256, 256)
        self.down5, self.elanw5b = MPDown(256, 256), ELANW(1024, 512, 512)
        self.rep3, self.rep4, self.rep5 = RepConv(128, 256), RepConv(256, 512), RepConv(512, 1024)

    def forward(self, x):
        x = self.s3(self.s2(self.s1(self.s0(x))))
        p2 = self.elan1(x)
        p3 = self.elan2(self.mp1(p2))
        p4 = self.elan3(self.mp2(p3))
        p5 = self.elan4(self.mp3(p4))
        t5 = self.sppcspc(p5)
        u4 = upsample_nearest2x(self.up4_conv(t5))
        t4 = self.elanw4(_cat(self.lat4(p4), u4))
        u3 = upsample_nearest2x(self.up3_conv(t4))
        t3 = self.elanw3(_cat(self.lat3(p3), u3))
        t4b = self.elanw4b(_cat(self.down4(t3), t4))
        t5b = self.elanw5b(_cat(self.down5(t4b), t5))
        return self.rep3(t3), self.rep4(t4b), self.rep5(t5b)


class Yolov7Seg(nn.Module):
    """Full detector: raw per-level predictions + prototypes."""

    def __init__(self, num_classes: int = 1203, nm: int = 32):
        super().__init__()
        self.num_classes = num_classes
        self.nm = nm
        self.no = 5 + num_classes + nm
        self.body = Yolov7SegBackboneNeck()
        self.proto = Proto(256, 256, nm)
        self.detect0 = nn.Conv2d(256, 3 * self.no, 1)
        self.detect1 = nn.Conv2d(512, 3 * self.no, 1)
        self.detect2 = nn.Conv2d(1024, 3 * self.no, 1)
        self._heads_key = None
        self._heads: list[dict] = []

    @property
    def dtype(self) -> torch.dtype:
        return self.body.s0.conv.weight.dtype

    def cast(self, dtype: torch.dtype) -> "Yolov7Seg":
        """Cast to ``dtype``, keeping the detect convs in fp32."""
        self.to(dtype)
        for d in self.detects():
            d.float()
        return self

    def detects(self) -> list[nn.Conv2d]:
        return [self.detect0, self.detect1, self.detect2]

    @torch.no_grad()
    def head_weights(self) -> list[dict]:
        """Per level, in the model dtype: 'w' (3 no, Cin) and 'b' (3 no,) for
        the dense head, their box/objectness rows ('w5', 'b5') and the other
        rows ('wr', 'br') for the sparse head, and 'packed' for kernel 6.
        Made once per set of weights: rebuilt when a detect conv's tensors
        are replaced, moved or changed in place; while ``torch.export``
        traces, made in the program from its weight inputs, uncached."""
        dtype = self.dtype
        exporting = torch.compiler.is_exporting()
        key = None if exporting else (dtype,) + tuple(
            (p.data_ptr(), p._version) for d in self.detects() for p in (d.weight, d.bias))
        if not exporting and key == self._heads_key:
            return self._heads
        no = self.no
        sel5 = [a * no + c for a in range(3) for c in range(5)]
        rest = [a * no + c for a in range(3) for c in range(5, no)]
        heads = []
        for d in self.detects():
            w = d.weight.reshape(d.weight.shape[0], -1)
            wt, b = w.to(dtype).contiguous(), d.bias.to(dtype)
            heads.append({
                "w": wt, "b": b, "w5": wt[sel5], "b5": b[sel5], "wr": wt[rest], "br": b[rest],
                "packed": pack_detect_head(w, d.bias, self.num_classes, self.nm, dtype),
            })
        if not exporting:
            self._heads, self._heads_key = heads, key
        return heads

    def forward(self, image: torch.Tensor, topk_positions: int | None = None,
                class_max: bool = False, with_proto: bool = True):
        """image (B, H, W, 3) NHWC in [0, 1], H and W multiples of 32.

        Dense head (default): returns ([3 x (B, h, w, 3, no)], proto).
        ``class_max=True``: the dense head's 1x1 conv and each anchor's class
        max/argmax in one kernel (kernel 6 for bf16 on the card, its plain
        version otherwise); returns ([3 x {'y5', 'coef', 'cls_max',
        'cls_arg', 'hw'}], proto); decode with ``decode_best_classmax``.
        ``topk_positions=k``: box+obj on the full grid, the class and
        coefficient columns only on the top-k positions per level by
        objectness; returns ([3 x {'y5', 'rest', 'pos_idx', 'hw'}], proto);
        decode with ``decode_best_sparse``.
        proto is (B, H/4, W/4, nm) NHWC, or None with ``with_proto=False``.
        """
        x = image.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory: channels_last
        feats = self.body(x)
        proto = self.proto(feats[0]).permute(0, 2, 3, 1) if with_proto else None
        no = self.no
        preds = []
        for o, head in zip(feats, self.head_weights()):
            n, cin, h, w = o.shape
            flat = o.permute(0, 2, 3, 1).reshape(n, h * w, cin)
            if class_max:
                fn = (fused_detect_head if flat.dtype == torch.bfloat16
                      else fused_detect_head_plain)
                y5, coef, cmax, carg = fn(flat.contiguous(), head["packed"])
                preds.append({"y5": y5, "coef": coef, "cls_max": cmax, "cls_arg": carg,
                              "hw": (h, w)})
                continue
            if topk_positions is None:
                p = torch.addmm(head["b"], flat.reshape(n * h * w, cin), head["w"].T)
                preds.append(p.reshape(n, h, w, 3, no))
                continue
            k = min(topk_positions, h * w)
            y5 = (flat @ head["w5"].T + head["b5"]).reshape(n, h * w, 3, 5)
            pos_score = y5[..., 4].float().amax(-1)
            _, pos_idx = stable_topk(pos_score, k)
            feat = torch.gather(flat, 1, pos_idx[..., None].expand(n, k, cin))
            rest = (feat @ head["wr"].T + head["br"]).reshape(n, k, 3, no - 5)
            y5_sel = torch.gather(y5.reshape(n, h * w, 15), 1,
                                  pos_idx[..., None].expand(n, k, 15)).reshape(n, k, 3, 5)
            preds.append({"y5": y5_sel, "rest": rest, "pos_idx": pos_idx, "hw": (h, w)})
        return preds, proto


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) xy cell coordinates in fp32."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _anchors(i: int, device) -> torch.Tensor:
    return torch.tensor(ANCHORS[i], dtype=torch.float32, device=device)


def decode_predictions(preds: Sequence[torch.Tensor], num_classes: int, nm: int = 32):
    """Raw dense head outputs -> flat (B, A, ...) boxes (xywh), objectness,
    class probabilities and coefficients (position-major, anchor-minor)."""
    boxes, obj, cls, coef = [], [], [], []
    for i, (p, stride) in enumerate(zip(preds, STRIDES)):
        n, h, w, _, _ = p.shape
        sig = torch.sigmoid(p[..., :5 + num_classes])
        xy = (sig[..., 0:2] * 2.0 - 0.5 + _grid(h, w, p.device)[None, :, :, None]) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * _anchors(i, p.device)[None, None, None]
        boxes.append(torch.cat([xy, wh], -1).reshape(n, -1, 4))
        obj.append(sig[..., 4].reshape(n, -1))
        cls.append(sig[..., 5:5 + num_classes].reshape(n, -1, num_classes))
        coef.append(p[..., 5 + num_classes:].reshape(n, -1, nm))
    return tuple(torch.cat(t, 1) for t in (boxes, obj, cls, coef))


def decode_best(preds: Sequence[torch.Tensor], num_classes: int, nm: int = 32):
    """Dense head -> (boxes (B, A, 4) xywh, best_score (B, A) fp32,
    best_class (B, A), coeffs (B, A, nm)); best_score = sig(obj) *
    sig(max class logit), in fp32. The (B, A, nc) sigmoids are never made:
    sigmoid is monotonic, so the max logit gives the max probability."""
    boxes, best, best_cls, coef = [], [], [], []
    for i, (p, stride) in enumerate(zip(preds, STRIDES)):
        n, h, w, _, _ = p.shape
        sig5 = torch.sigmoid(p[..., :5])
        xy = (sig5[..., 0:2] * 2.0 - 0.5 + _grid(h, w, p.device)[None, :, :, None]) * stride
        wh = (sig5[..., 2:4] * 2.0) ** 2 * _anchors(i, p.device)[None, None, None]
        m, a = p[..., 5:5 + num_classes].max(-1)
        score = sig5[..., 4] * torch.sigmoid(m.float())
        boxes.append(torch.cat([xy, wh], -1).reshape(n, -1, 4))
        best.append(score.reshape(n, -1))
        best_cls.append(a.reshape(n, -1))
        coef.append(p[..., 5 + num_classes:].reshape(n, -1, nm))
    return tuple(torch.cat(t, 1) for t in (boxes, best, best_cls, coef))


def decode_best_sparse(levels: Sequence[dict], num_classes: int, nm: int = 32):
    """``decode_best`` for the ``topk_positions`` head, over the selected
    anchors only."""
    boxes, best, best_cls, coef = [], [], [], []
    for i, (lvl, stride) in enumerate(zip(levels, STRIDES)):
        y5, rest, pos_idx = lvl["y5"], lvl["rest"], lvl["pos_idx"]
        _, w = lvl["hw"]
        n = pos_idx.shape[0]
        sig5 = torch.sigmoid(y5)
        grid = torch.stack([(pos_idx % w).float(), (pos_idx // w).float()], -1)[:, :, None]
        xy = (sig5[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (sig5[..., 2:4] * 2.0) ** 2 * _anchors(i, y5.device)[None, None]
        m, a = rest[..., :num_classes].max(-1)
        score = sig5[..., 4] * torch.sigmoid(m.float())
        boxes.append(torch.cat([xy, wh], -1).reshape(n, -1, 4))
        best.append(score.reshape(n, -1))
        best_cls.append(a.reshape(n, -1))
        coef.append(rest[..., num_classes:].reshape(n, -1, nm))
    return tuple(torch.cat(t, 1) for t in (boxes, best, best_cls, coef))


def decode_best_classmax(levels: Sequence[dict], num_classes: int, nm: int = 32):
    """``decode_best`` for the ``class_max`` head: the class reduction
    already happened in the head; same flattening order."""
    boxes, best, best_cls, coef = [], [], [], []
    for i, (lvl, stride) in enumerate(zip(levels, STRIDES)):
        y5 = lvl["y5"]
        h, w = lvl["hw"]
        n = y5.shape[0]
        sig5 = torch.sigmoid(y5)
        grid = _grid(h, w, y5.device).reshape(-1, 1, 2)
        xy = (sig5[..., 0:2] * 2.0 - 0.5 + grid[None]) * stride
        wh = (sig5[..., 2:4] * 2.0) ** 2 * _anchors(i, y5.device)[None, None]
        score = sig5[..., 4] * torch.sigmoid(lvl["cls_max"])
        boxes.append(torch.cat([xy, wh], -1).reshape(n, -1, 4))
        best.append(score.reshape(n, -1))
        best_cls.append(lvl["cls_arg"].reshape(n, -1).long())
        coef.append(lvl["coef"].reshape(n, -1, nm))
    return tuple(torch.cat(t, 1) for t in (boxes, best, best_cls, coef))


def pool_size(n_anchors_total: int, pre_topk: int | None) -> int:
    """NMS candidate pool: min(1024, A) by default, else min(pre_topk, A)."""
    return min(1024 if pre_topk is None else int(pre_topk), n_anchors_total)


def warn_if_saturated(logger: logging.Logger, n_candidates: np.ndarray, pre_topk: int,
                      what: str) -> bool:
    """Warn when an image had more above-threshold anchors than the pool.
    At ``n_candidates == pre_topk`` every candidate fit, so nothing was
    dropped: the test is ``>`` (the JAX package warns at ``>=``)."""
    saturated = np.asarray(n_candidates) > pre_topk
    if saturated.any():
        logger.warning(
            "%s: NMS candidate pool saturated on %d/%d images (max %d candidates vs "
            "pre_topk=%d); the lowest-confidence candidates were dropped before NMS: "
            "raise pre_topk to keep them", what, int(saturated.sum()), saturated.size,
            int(np.max(n_candidates)), pre_topk,
        )
    return bool(saturated.any())


class Yolov7SegDetector:
    """Frozen detector producing padded fixed-shape detections (host side).

    Port of ``objcavit_tpu/models/yolov7.py::Yolov7SegDetector`` around a
    port ``Yolov7Seg`` with loaded weights. Input is ImageNet-normalised
    NHWC numpy, un-normalised to [0, 1] before detection; output boxes are
    centre-xywh in pixels. Above ``CLASS_MAX_MIN_ANCHORS`` anchors the
    class-max head (kernel 6) runs, as in the JAX package.
    """

    def __init__(self, model: Yolov7Seg, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 1000, agnostic: bool = False,
                 class_names: Sequence[str] | None = None, pre_topk: int | None = None):
        self.model = model.eval()
        self.num_classes = model.num_classes
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.agnostic = agnostic
        self.pre_topk = pre_topk
        self.class_names = list(class_names) if class_names is not None else [
            f"class_{i}.n.01" for i in range(self.num_classes)
        ]
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def __call__(self, images_normed: np.ndarray, max_det: int | None = None) -> dict:
        max_det = self.max_det if max_det is None else int(max_det)
        x = torch.as_tensor(np.asarray(images_normed, np.float32), device=self.device)
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        image01 = x * std + mean
        use_cm = n_anchors(*x.shape[1:3]) > CLASS_MAX_MIN_ANCHORS
        preds, proto = self.model(image01, class_max=use_cm)
        decode = decode_best_classmax if use_cm else decode_best
        boxes, best, best_cls, coef = decode(preds, self.num_classes, self.model.nm)
        pre_topk = pool_size(boxes.shape[1], self.pre_topk)
        out = batched_nms(xywh_to_xyxy(boxes), best, best_cls, self.conf_thres, self.iou_thres,
                          pre_topk=pre_topk, max_det=max_det, agnostic=self.agnostic)
        out["xywh"] = xyxy_to_xywh(out.pop("boxes_xyxy"))
        out["coeffs"] = torch.gather(coef, 1, out["nms_idx"][..., None].expand(-1, -1, coef.shape[2]))
        out = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
               for k, v in out.items()}
        out["pre_topk"] = pre_topk
        out["names"] = [[self.class_names[int(c)] for c in row] for row in out["classes"]]
        out["proto"] = proto
        warn_if_saturated(logging.getLogger(__name__), out["n_candidates"], pre_topk,
                          "detector")
        return out
