"""What GraphBins hands its kernels, and what they give back.

Serving: ``record_kernel_io`` hooks a model (GraphBins or AdaBins) so that
each forward leaves a record of the decoder's upsamples (four, or five with
``do_final_upscale``: the input and
the skip, and the two channel slices of the concat buffer the stage's conv
read: the upsample and the skip, NHWC) and of the bins head (ObjCAViT's or
miniViT's outputs, which are its inputs, and the depth it returned).
``plain_outputs`` runs the plain versions on a record's inputs, so a
kernel's served output can be held against its plain version on the very
tensors the main path gave it, ``skip_mismatches`` counts the skip
slice's elements that differ from the skip, bit for bit, and
``exact_fold_units`` counts the bins head's units that kernel 2 folds
exactly (``bins_operands`` gives its inputs):

    with record_kernel_io(model) as records:
        pipeline(frames)
    resize_pairs, bins_pair = plain_outputs(model, records[0])
    assert skip_mismatches(records[0]) == 0

Training: ``record_bins_expectation_io`` records each call of kernel 4 on
the bins head's training route, forward (logits, centres, depth) and
backward (the depth's gradient, dlogits, dcenters), and
``bins_expectation_plain_outputs`` runs kernel 4's plain forward and
backward on a record's inputs.

Attention: ``record_attention_io`` records each call of kernel 5, forward
(q, k, v, bias, out) and backward (the same inputs, g, dq, dk, dv), from a
served forward or a train step, and ``attention_plain_outputs`` runs kernel
5's plain forward or backward on a record's inputs.

Detection: ``record_detect_head_io`` records each call of kernel 6 from the
detector's class-max head (the level's features, its packed weights and the
four outputs), and ``detect_head_errors`` holds a call's outputs against the
plain version on the same tensors, with a tie-aware check of the argmax.
``share_edge_grids`` picks the grids on which the card test and
chip_smoke.py launch kernel 6 to reach its consumers' feature-tile
hand-back at a block share's edges (from a copy of the kernel's unit split,
``detect_unit_count`` and ``detect_unit_shares``).

Encoder: ``record_encoder_kernel_io`` records each call of kernel 8 (the
fused MBConv head) and kernel 7 (the SE-gate project) from the encoder's
blocks, their arguments and outputs; ``mbconv_head_errors`` and
``se_project_errors`` hold a call's outputs against the plain versions on
the same tensors. Spatial serving: ``record_resize_rows_io`` records each
launch of kernel 1's row-window form and ``resize_rows_errors`` holds it
against its plain version; ``mbconv_head_errors(rows=...)`` holds kernel
8's halo form.

The hooks only read tensors; the step runs as it would without them.
"""

from __future__ import annotations

import contextlib

import torch

import objcavit_torch.kernels.attention as kattn
import objcavit_torch.kernels.detect_head as kdetect
import objcavit_torch.models.common as common
import objcavit_torch.models.yolov7 as yolov7
import objcavit_torch.ops.bins as ops_bins
from objcavit_torch.kernels.bins import UNIT_PIXELS, conv_bins_depth_batched_plain
from objcavit_torch.kernels.bins_expectation import (
    bins_expectation_bwd_plain,
    bins_expectation_plain,
)
from objcavit_torch.kernels.mbconv import depthwise_silu_plain, expand_plain
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.kernels.resize import resize_bilinear_align_corners_plain, resize_rows_plain
from objcavit_torch.kernels.se_project import project_plain
from objcavit_torch.ops.bins import bins_head_operands


@contextlib.contextmanager
def record_kernel_io(model):
    """Yield a list that gets one dict per forward of ``model`` (a GraphBins
    or an AdaBins): ``resize`` [(x, y)] for up1..up4 (and final_upscale),
    ``skips`` [(skip, the concat buffer's skip slice)] for the same stages, ``bins_inputs``
    (widths, feat, queries: ObjCAViT's or miniViT's outputs) and ``depth``."""
    records: list[dict] = []
    current: dict = {"resize": [], "skips": []}

    def on_upsample(module, args):
        current["resize"].append([args[0].permute(0, 2, 3, 1)])
        current["skips"].append([args[1].permute(0, 2, 3, 1)])

    def on_concat(module, args):
        # the stage's conv input is cat([upsampled, skip]) along channels
        pair, skip = current["resize"][-1], current["skips"][-1]
        c = pair[0].shape[3]
        pair.append(args[0][:, :c].permute(0, 2, 3, 1))
        skip.append(args[0][:, c:].permute(0, 2, 3, 1))

    def on_head(module, args, out):
        current["bins_inputs"] = out

    def on_model(module, args, out):
        records.append({**current, "resize": [tuple(p) for p in current["resize"]],
                        "skips": [tuple(p) for p in current["skips"]],
                        "depth": out["depth_pred"]})
        current.update(resize=[], skips=[])

    decoder = model.dense_feature_extractor.decoder
    stages = decoder.stages()
    handles = [s.register_forward_pre_hook(on_upsample) for s in stages]
    handles += [s._net.register_forward_pre_hook(on_concat) for s in stages]
    handles.append(model.transformer_head.register_forward_hook(on_head))
    handles.append(model.register_forward_hook(on_model))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()


# kernel 2's fast fold takes a row whose sum of e over its 256 logits, with
# no max subtracted, lies in this range (csrc/bins_depth.cu kSumLo, kSumHi)
FAST_FOLD_SUMS = (2.0 ** -16, 2.0 ** 40)


@torch.inference_mode()
def bins_operands(model, record: dict):
    """-> kernel 2's inputs in a record's forward: (x, W, bias, centres)."""
    widths, feat, queries = record["bins_inputs"]
    conv = model.conv_out[0]
    m, bias, centers, _ = bins_head_operands(
        widths, queries, conv.weight, conv.bias, model.min_depth, model.max_depth, feat.dtype
    )
    return feat, m, bias, centers


@torch.inference_mode()
def plain_outputs(model, record: dict):
    """-> ([(served, plain)] for each upsample, (served, plain) depth)."""
    resize = [
        (y, resize_bilinear_align_corners_plain(x.contiguous(), y.shape[1], y.shape[2]))
        for x, y in record["resize"]
    ]
    return resize, (record["depth"], conv_bins_depth_batched_plain(*bins_operands(model, record)))


@torch.inference_mode()
def exact_fold_units(x: torch.Tensor, kernels: torch.Tensor,
                     bias: torch.Tensor) -> tuple[int, int]:
    """(units that kernel 2 folds exactly, units) on these inputs. A unit is
    64 rows of x from one image's tile on (the rows past S are the next
    image's, with this image's W; rows past B*S read zeros); it takes the
    exact fold, its products run twice more, when any row's sum of e leaves
    ``FAST_FOLD_SUMS``. Read from the fp32 logits of the plain version, so
    a row at the range's edge may fall the other way in the kernel's own
    exps (ex2.approx)."""
    b, h, w, c = x.shape
    s, flat = h * w, x.reshape(-1, c)
    tiles = -(-s // UNIT_PIXELS)
    lo, hi = FAST_FOLD_SUMS
    exact = 0
    for i in range(b):
        rows = torch.zeros((tiles * UNIT_PIXELS, c), dtype=torch.float32, device=x.device)
        part = flat[i * s:i * s + tiles * UNIT_PIXELS]
        rows[:part.shape[0]] = part.float()
        se = torch.exp(rows @ kernels[i].float() + bias.float()).sum(-1)
        exact += int((~((se >= lo) & (se <= hi))).view(tiles, UNIT_PIXELS).any(1).sum())
    return exact, b * tiles


def skip_mismatches(record: dict) -> int:
    """Elements of the recorded concat buffers' skip slices that are not the
    skip, bit for bit (the concat form copies it)."""
    bits = {2: torch.int16, 4: torch.int32}
    return sum(int((got.view(bits[got.element_size()]) != skip.view(bits[skip.element_size()]))
                   .sum()) for skip, got in record["skips"])


@contextlib.contextmanager
def record_resize_rows_io():
    """Yield a list that gets one dict per launch of kernel 1's row-window
    form (``kernels/resize.py`` calls ``resize_rows_cuda`` through its module
    attribute, which this wraps for the duration): 'args' (x, out_h, out_w,
    y0, y1, skip) and 'out'."""
    real = kresize.resize_rows_cuda
    records: list[dict] = []

    def call(*args):
        out = real(*args)
        records.append({"args": args, "out": out})
        return out

    kresize.resize_rows_cuda = call
    try:
        yield records
    finally:
        kresize.resize_rows_cuda = real


@torch.inference_mode()
def resize_rows_errors(record: dict, rtol: float = 2.0 ** -7, atol: float = 1e-5) -> dict:
    """A row-window launch's output against its plain version on the same
    inputs: the upsample within one bf16 ulp (``rtol`` of the plain value,
    plus ``atol``: both lerp in fp32 in one order and round once, and an
    fp32 value next to a rounding boundary may round the other way), the
    skip slice bit for bit. -> the max abs error and the count
    of values out of tolerance ('bad')."""
    x, out_h, out_w, y0, y1, skip = (list(record["args"]) + [None])[:6]
    got = record["out"]
    want = resize_rows_plain(x, out_h, out_w, y0, y1, skip)
    c = x.shape[3]
    err = (got[..., :c].float() - want[..., :c].float()).abs()
    bad = int((err > atol + rtol * want[..., :c].float().abs()).sum())
    if skip is not None:
        bad += int((got[..., c:].view(torch.int16) != skip.view(torch.int16)).sum())
    return {"y": float(err.max()), "bad": bad + int((~torch.isfinite(got)).sum())}


@contextlib.contextmanager
def record_bins_expectation_io():
    """Yield a list that gets one dict per call of kernel 4 from the bins
    head (``ops.bins`` calls it through its module attribute
    ``fused_bins_depth``, which this wraps for the duration): 'logits' and
    'centers' (B, S, K) and (B, K), 'depth' (B, S), and, once the backward
    has run, 'g' (B, S), 'dlogits' and 'dcenters', read by tensor hooks.
    Nothing but kernel 4 reads the logits or the centres, so their
    gradients are the kernel's outputs."""
    original = ops_bins.fused_bins_depth
    records: list[dict] = []

    def recording(logits, centers):
        b, h, w, k = logits.shape
        rec = {"logits": logits.detach().reshape(b, h * w, k), "centers": centers.detach()}
        depth = original(logits, centers)
        rec["depth"] = depth.detach().reshape(b, h * w)
        if depth.requires_grad:
            def keep(key, shape=None):
                def hook(grad):
                    rec[key] = grad.detach().reshape(shape) if shape else grad.detach()
                return hook

            depth.register_hook(keep("g", (b, h * w)))
            logits.register_hook(keep("dlogits", (b, h * w, k)))
            centers.register_hook(keep("dcenters"))
        records.append(rec)
        return depth

    ops_bins.fused_bins_depth = recording
    try:
        yield records
    finally:
        ops_bins.fused_bins_depth = original


@torch.no_grad()
def bins_expectation_plain_outputs(record: dict) -> dict:
    """-> {'depth', 'dlogits', 'dcenters'}: each a (kernel, plain) pair on
    the record's own inputs."""
    depth = bins_expectation_plain(record["logits"], record["centers"])
    dlogits, dcenters = bins_expectation_bwd_plain(record["logits"], record["centers"], record["g"])
    return {"depth": (record["depth"], depth), "dlogits": (record["dlogits"], dlogits),
            "dcenters": (record["dcenters"], dcenters)}


@contextlib.contextmanager
def record_attention_io():
    """Yield a list that gets one dict per forward or backward of kernel 5's
    ``FusedMHA`` (its ``forward`` and ``backward``, which this wraps for the
    duration): 'kind' ('fwd' or 'bwd'), 'q', 'k', 'v', 'bias', and 'out' and
    'residual' (whether it kept one) for a forward, or 'g', 'dq', 'dk', 'dv'
    for a backward."""
    fwd0, bwd0 = kattn.FusedMHA.forward, kattn.FusedMHA.backward
    records: list[dict] = []

    def forward(ctx, q, k, v, bias, residual):
        out = fwd0(ctx, q, k, v, bias, residual)
        records.append({"kind": "fwd", "q": q.detach(), "k": k.detach(), "v": v.detach(),
                        "bias": bias, "out": out.detach(), "residual": residual})
        return out

    def backward(ctx, g):
        q, k, v, bias, _ = ctx.saved_tensors
        grads = bwd0(ctx, g)
        dq, dk, dv = grads[:3]
        records.append({"kind": "bwd", "q": q.detach(), "k": k.detach(), "v": v.detach(),
                        "bias": bias, "g": g.contiguous(), "dq": dq, "dk": dk, "dv": dv})
        return grads

    kattn.FusedMHA.forward, kattn.FusedMHA.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield records
    finally:
        kattn.FusedMHA.forward, kattn.FusedMHA.backward = staticmethod(fwd0), staticmethod(bwd0)


@torch.no_grad()
def attention_plain_outputs(record: dict) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """[(name, kernel output, plain output)] of one kernel-5 record: 'out'
    for a forward; 'dq', 'dk', 'dv' for a backward."""
    q, k, v, bias = record["q"], record["k"], record["v"], record["bias"]
    if record["kind"] == "fwd":
        return [("out", record["out"], kattn.mha_fused_plain(q, k, v, bias))]
    want = kattn.mha_fused_bwd_plain(q, k, v, bias, record["g"])
    return [(n, record[n], w) for n, w in zip(("dq", "dk", "dv"), want)]


# an output of a kernel-5 backward cancels where its largest entry is under
# one bf16 ulp (2^-8) of the largest term it sums
ATTN_CANCELS_BELOW = 2.0 ** -8


def attention_cancelling_terms(record: dict) -> dict[str, float]:
    """{name: the largest magnitude of the terms it sums} for the outputs
    of a kernel-5 backward record that cancel (see ATTN_CANCELS_BELOW),
    from the plain version's weights P on its tensors: dq = s ds k and
    dk = s ds^T q with ds = P (dP - D), dP = g v^T and D = rowsum(P dP), so
    their terms are s P (|dP| + |D|) |k| and s (P (|dP| + |D|))^T |q|;
    dv = P^T g, so P^T |g|. Where an output cancels (keys or values nearly
    equal over the rows, so ds ~ 0), its own largest entry is no scale for
    its rounding; these are."""
    w, scale = kattn._weights(record["q"], record["k"], record["bias"])
    q, k, v, g = (record[n].to(w.dtype) for n in ("q", "k", "v", "g"))
    dw = torch.einsum("bqhd,bkhd->bhqk", g, v)
    rowsum = (dw * w).sum(-1, keepdim=True)
    ds, a = w * (dw - rowsum), w * (dw.abs() + rowsum.abs())
    sums = {"dq": (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
                   torch.einsum("bhqk,bkhd->bqhd", a, k.abs()) * scale),
            "dk": (torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
                   torch.einsum("bhqk,bqhd->bkhd", a, q.abs()) * scale),
            "dv": (torch.einsum("bhqk,bqhd->bkhd", w, g),
                   torch.einsum("bhqk,bqhd->bkhd", w, g.abs()))}
    largest = {n: (float(out.abs().max()), float(terms.max()))
               for n, (out, terms) in sums.items()}
    return {n: term for n, (entry, term) in largest.items()
            if entry < ATTN_CANCELS_BELOW * term}


@contextlib.contextmanager
def record_detect_head_io():
    """Yield a list that gets one dict per call of kernel 6 from the
    detector (``models/yolov7.py`` calls it through its module attribute
    ``fused_detect_head``, which this wraps for the duration): 'flat',
    'packed' and 'out' (y5, coef, cls_max, cls_arg)."""
    original = yolov7.fused_detect_head
    records: list[dict] = []

    def recording(flat, packed):
        out = original(flat, packed)
        records.append({"flat": flat, "packed": packed, "out": out})
        return out

    yolov7.fused_detect_head = recording
    try:
        yield records
    finally:
        yolov7.fused_detect_head = original


@torch.inference_mode()
def detect_head_errors(flat, packed, out, rtol: float, atol: float) -> dict:
    """Kernel 6's outputs ``out`` against the plain version on ``flat`` and
    ``packed``. Each value may differ by its rounding, ``atol + rtol
    |plain|``, plus the fp32 accumulation bound of a Cin-term sum in another
    order, Cin 2^-23 sum_i |x_i w_i| (two unit roundoffs per add, allowing
    the tensor cores' adds): on a detector's features, whose products reach
    tens, that bound exceeds ``atol`` for values near zero. y5, coef and
    cls_max must lie within that band; cls_arg must equal the plain argmax
    wherever the row's two largest rounded logits differ by more than the
    band ('near_ties' counts the rows where they do not), and elsewhere the
    plain logit at the kernel's index must lie within the band of the plain
    max. Returns the max abs errors and the count of elements out of
    tolerance ('bad')."""
    y5, coef, cls_max, cls_arg = out
    b, s, cin = flat.shape
    nc, nm, na = packed.num_classes, packed.nm, kdetect.N_ANCHORS
    unit = cin * 2.0 ** -23
    x_abs = flat.reshape(b * s, cin).float().abs()
    other_slack = unit * (x_abs @ packed.w5c.float().abs().T)  # (M, 128)
    slack = {"y5": other_slack[:, :na * 5].reshape(y5.shape),
             "coef": other_slack[:, na * 5:na * (5 + nm)].reshape(coef.shape),
             "cls_max": unit * torch.stack([(x_abs @ packed.wcls[a, :nc].float().abs().T).amax(-1)
                                            for a in range(na)], -1).reshape(cls_max.shape)}
    want_y5, want_coef, _, _ = kdetect.fused_detect_head_plain(flat, packed)
    logits = kdetect.class_logits_plain(flat, packed)
    top2 = logits.topk(2, dim=-1).values
    want_max = top2[..., 0]
    band = atol + rtol * want_max.abs() + slack["cls_max"]
    clear = (top2[..., 0] - top2[..., 1]) > band
    at_arg = logits.gather(-1, cls_arg.long().clamp(0, nc - 1)[..., None])[..., 0]
    errs, bad = {}, 0
    for name, got, want in (("y5", y5, want_y5), ("coef", coef, want_coef),
                            ("cls_max", cls_max, want_max)):
        err = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs() + slack[name]
        bad += int((err > bound).sum()) + int((~torch.isfinite(got)).sum())
        errs[name] = float(err.max())
    bad += int((clear & (cls_arg.long() != logits.argmax(-1))).sum())
    bad += int(((want_max - at_arg).abs() > band).sum())
    bad += int(((cls_arg < 0) | (cls_arg >= nc)).sum())
    return {**errs, "near_ties": int((~clear).sum()), "rows": clear.numel(), "bad": bad}


def detect_unit_count(m: int, cin: int, ncp: int) -> tuple[int, int]:
    """(units, units a row tile) of kernel 6's work list for M positions. A
    copy of the C entry's rule in csrc/detect_head.cu (``job.per_row``,
    ``job.units``), not the kernel's own code: each row tile of
    ``block_rows_for(cin, ncp)`` positions has 3 ncp / 128 class tiles and
    the box tile."""
    per_row = kdetect.N_ANCHORS * ncp // kdetect.COL_TILE + 1
    return -(-m // kdetect.block_rows_for(cin, ncp)) * per_row, per_row


def detect_unit_shares(units: int, grid: int) -> list[tuple[int, int]]:
    """A copy of kernel 6's split of the units (csrc/detect_head.cu, the
    block's u0 and u1): block i of min(grid, units) takes [units i //
    blocks, units (i + 1) // blocks)."""
    blocks = min(units, grid)
    return [(units * i // blocks, units * (i + 1) // blocks) for i in range(blocks)]


def share_edge_grids(m: int, cin: int, ncp: int, max_grid: int = 264) -> list[int]:
    """Grids of at most ``max_grid`` blocks in which one block's share starts
    at a row tile's last unit and one block's share ends at a row tile's
    first unit (at least 3 units long): where kernel 6's consumers hand
    feature tiles back at a share's edges. The smallest such grid and the
    largest."""
    units, per_row = detect_unit_count(m, cin, ncp)
    found = []
    for grid in range(2, max_grid + 1):
        shares = detect_unit_shares(units, grid)
        starts = any(u0 % per_row == per_row - 1 and u1 - u0 >= 2 for u0, u1 in shares)
        ends = any((u1 - 1) % per_row == 0 and u1 - u0 >= 3 for u0, u1 in shares)
        if starts and ends:
            found.append(grid)
    return sorted({found[0], found[-1]}) if found else []


@contextlib.contextmanager
def record_encoder_kernel_io():
    """Yield a list that gets one dict per call of kernel 8 or kernel 7 from
    the encoder's blocks (``models/common.py`` calls them through its module
    attributes ``mbconv_expand_dw_pool``, ``mbconv_expand_dw_pool_rows`` and
    ``se_gate_project``, which this wraps for the duration): 'kind'
    ('mbconv_head', 'mbconv_head_rows', kernel 8's row-window form, or
    'se_project'), 'args' (the call's arguments) and 'out' (its outputs)."""
    originals = {"mbconv_head": common.mbconv_expand_dw_pool,
                 "mbconv_head_rows": common.mbconv_expand_dw_pool_rows,
                 "se_project": common.se_gate_project}
    names = {"mbconv_head": "mbconv_expand_dw_pool",
             "mbconv_head_rows": "mbconv_expand_dw_pool_rows", "se_project": "se_gate_project"}
    records: list[dict] = []

    def recording(kind):
        def call(*args):
            out = originals[kind](*args)
            records.append({"kind": kind, "args": args, "out": out})
            return out
        return call

    for kind, name in names.items():
        setattr(common, name, recording(kind))
    try:
        yield records
    finally:
        for kind, name in names.items():
            setattr(common, name, originals[kind])


UNIT = 2.0 ** -23  # fp32 unit roundoff, allowing two for an add on either side


def _dw_abs(t: torch.Tensor, wd: torch.Tensor, ksize: int) -> torch.Tensor:
    """sum_ij |wd_ij| t[. + i, . + j] of NHWC t, with wd rounded to t's dtype."""
    m = t.shape[-1]
    weight = wd.reshape(ksize * ksize, m).to(t.dtype).float().abs().t().reshape(m, 1, ksize, ksize)
    out = torch.nn.functional.conv2d(t.float().permute(0, 3, 1, 2), weight, padding=ksize // 2,
                                     groups=m)
    return out.permute(0, 2, 3, 1)


@torch.inference_mode()
def mbconv_head_errors(x, we, be, wd, bd, ksize: int, y, pool, rtol: float, atol: float,
                       pool_rtol: float, rows: tuple[int, int] | None = None) -> dict:
    """Kernel 8's (or, with ``we`` None, kernel 10's) outputs ``y`` (NHWC, in
    x's dtype) and ``pool`` (or None) against the plain version on the same
    inputs, x NHWC. Each y may differ by its rounding, ``atol + rtol
    |plain|``, plus the bound of its fp32 value: the depthwise sum in
    another order ((k^2 + 2) 2^-23 sum |e w| + |bd|), the expanded band's
    elements that may round to bf16 apart ('flips': those whose fp32 value
    lies within the bound of the expand's sum, Cin 2^-23 sum |x we| + |be|,
    and __expf's error of a rounding boundary, each adding one bf16 ulp
    times its |tap weight|), SiLU's slope (<= 1.1) and __expf's error. The
    pool, the sum of the fp32 y, may differ by the sum of those bounds plus
    ``pool_rtol`` sum |y| (fp32 sums in another order). With ``rows`` (top,
    bottom), kernel 8's row-window form: y and the pool hold x's rows
    [top, H - bottom) alone. Returns the max abs errors, 'flips' and the
    count of values out of tolerance ('bad')."""
    flip_spread = None
    if we is not None:
        e32 = expand_plain(x, we, be)
        cin = x.shape[-1]
        pre = torch.matmul(x.float().abs(), we.to(x.dtype).float().abs()) + be.float().abs()
        dev = 1.1 * UNIT * (cin + 4) * pre + 4 * UNIT * e32.abs()
        e = e32.to(x.dtype)
        flip_spread = (e32 + dev).to(x.dtype).float() - (e32 - dev).to(x.dtype).float()
    else:
        e = x
    y32 = depthwise_silu_plain(e, wd, bd, ksize)
    slack_z = (ksize * ksize + 2) * UNIT * (_dw_abs(e.abs(), wd, ksize) + bd.float().abs())
    if flip_spread is not None:
        slack_z = slack_z + _dw_abs(flip_spread, wd, ksize)
    slack = 1.1 * slack_z + 4 * UNIT * y32.abs()
    if rows is not None:
        window = slice(rows[0], x.shape[1] - rows[1])
        y32, slack = y32[:, window], slack[:, window]
    want = y32.to(x.dtype).float()
    err = (y.float() - want).abs()
    bad = int((err > atol + rtol * want.abs() + slack).sum()) + int((~torch.isfinite(y)).sum())
    out = {"y": float(err.max()), "flips": 0 if flip_spread is None else int((flip_spread > 0).sum())}
    if pool is not None:
        pool_err = (pool - y32.sum((1, 2))).abs()
        bound = atol + pool_rtol * y32.abs().sum((1, 2)) + slack.sum((1, 2))
        bad += int((pool_err > bound).sum()) + int((~torch.isfinite(pool)).sum())
        out["pool"] = float(pool_err.max())
    return {**out, "bad": bad}


@torch.inference_mode()
def se_project_errors(dw_out, gate, kernel, bias, skip, out, rtol: float, atol: float) -> dict:
    """Kernel 7's output ``out`` against the plain version on the same
    inputs. The fp32 project may differ by M 2^-23 sum |gated w| + |bias|
    (its sum in another order); rounded once (one bf16 ulp, ``rtol`` of the
    project) and, with a skip, again after the add (``rtol`` of the
    output), plus ``atol``. Returns the max abs error and the count of
    values out of tolerance ('bad')."""
    h32 = project_plain(dw_out, gate, kernel, bias)
    gated = (dw_out * gate.to(dw_out.dtype)[:, None, None, :]).float().abs()
    slack = (dw_out.shape[-1] + 2) * UNIT * (torch.matmul(gated, kernel.to(dw_out.dtype).float().abs())
                                             + bias.float().abs())
    h = h32.to(dw_out.dtype)
    want = (h + skip if skip is not None else h).float()
    bound = atol + rtol * want.abs() + slack
    if skip is not None:
        bound = bound + rtol * h.float().abs()
    err = (out.float() - want).abs()
    return {"out": float(err.max()),
            "bad": int((err > bound).sum()) + int((~torch.isfinite(out)).sum())}
