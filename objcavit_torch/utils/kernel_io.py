"""What a GraphBins forward hands its two kernels, and what they give back.

``record_kernel_io`` hooks a model so that each forward leaves a record of
the four decoder upsamples (input and output, NHWC) and of the bins head
(ObjCAViT's outputs, which are its inputs, and the depth it returned).
``plain_outputs`` runs the plain versions on a record's inputs, so a
kernel's served output can be held against its plain version on the very
tensors the main path gave it:

    with record_kernel_io(model) as records:
        pipeline(frames)
    resize_pairs, bins_pair = plain_outputs(model, records[0])

The hooks only read tensors; the forward runs as it would without them.
"""

from __future__ import annotations

import contextlib

import torch

from objcavit_torch.kernels.bins import conv_bins_depth_batched_plain
from objcavit_torch.kernels.resize import resize_bilinear_align_corners_plain
from objcavit_torch.ops.bins import bins_head_operands


@contextlib.contextmanager
def record_kernel_io(model):
    """Yield a list that gets one dict per forward of ``model`` (a GraphBins):
    ``resize`` [(x, y)] for up1..up4, ``objcavit`` (widths, feat, queries)
    and ``depth``."""
    records: list[dict] = []
    current: dict = {"resize": []}

    def on_upsample(module, args):
        current["resize"].append([args[0].permute(0, 2, 3, 1)])

    def on_concat(module, args):
        # the stage's conv input is cat([upsampled, skip]) along channels
        pair = current["resize"][-1]
        pair.append(args[0][:, : pair[0].shape[3]].permute(0, 2, 3, 1))

    def on_objcavit(module, args, out):
        current["objcavit"] = out

    def on_model(module, args, out):
        records.append({**current, "resize": [tuple(p) for p in current["resize"]],
                        "depth": out["depth_pred"]})
        current.update(resize=[])

    decoder = model.dense_feature_extractor.decoder
    stages = [getattr(decoder, f"up{i}") for i in range(1, 5)]
    handles = [s.register_forward_pre_hook(on_upsample) for s in stages]
    handles += [s._net.register_forward_pre_hook(on_concat) for s in stages]
    handles.append(model.objcavit.register_forward_hook(on_objcavit))
    handles.append(model.register_forward_hook(on_model))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()


@torch.inference_mode()
def plain_outputs(model, record: dict):
    """-> ([(served, plain)] for each upsample, (served, plain) depth)."""
    resize = [
        (y, resize_bilinear_align_corners_plain(x.contiguous(), y.shape[1], y.shape[2]))
        for x, y in record["resize"]
    ]
    widths, feat, queries = record["objcavit"]
    conv = model.conv_out[0]
    m, bias, centers, _ = bins_head_operands(
        widths, queries, conv.weight, conv.bias, model.min_depth, model.max_depth, feat.dtype
    )
    return resize, (record["depth"], conv_bins_depth_batched_plain(feat, m, bias, centers))
