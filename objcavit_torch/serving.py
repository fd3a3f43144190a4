"""Serving: uint8 frames in, depth maps out, through GraphBins or AdaBins.

Port of ``objcavit_tpu/serving.py``. ``DepthPipeline`` runs one request on
the model's device:

    uint8 (B, H, W, 3) -> /255 -> resize to the eval size if it differs
    (bilinear, half-pixel) -> ImageNet normalise -> GraphBins or AdaBins ->
    depth (B, h/2, w/2, 1) in metres ((B, h, w, 1) with do_final_upscale)
    -> optionally resized back to (H, W)

AdaBins takes the image alone. For GraphBins, objects come from
``provider`` (called with the normalised eval-size images as numpy,
returning numpy ``features``/``xywh``/``valid`` slots, e.g.
``language/provider.py::YoloClipObjectProvider``) or, without one, the
no-detection sentinel: slot 0 valid with xywh = -1 and the ``unk_feature``
(the '<UNK>' embedding of the language strategy; zeros by default, which is
right for the 'control_obj_zeros_512' ablation only).

``FusedDepthPipeline`` keeps the detector on the card too: uint8 frames ->
YOLOv7-seg -> fixed-shape NMS -> a gather from the per-class phrase table
-> GraphBins, with no host round trip but the NMS's convergence checks.
``stream_depth`` keeps one batch on the card while the next is decoded.

``DepthPipeline(grid=...)`` is JAX's ``mesh=``: a process grid
(``parallel/mesh.py``) whose ranks each get the same request, serve their
rows ``[d::n_data]`` of it (d the data index; the whole batch where n_data
does not divide it, as JAX's ``shard_batch`` replicates it), through a
model split over the model axis where the caller split it
(``parallel/tp.py::tp_shard_model``; ``build_flagship_pipeline(grid=...)``
does), and gather the depth over the data axis: every rank returns the
global batch's.

``DepthPipeline(grid=..., spatial=True)`` is JAX's spatial mode (the image
height over the mesh's model axis, ``objcavit_tpu/serving.py:150-176``):
the ranks of one model group serve the same images, each the conv pyramid
on its own band of rows under ``parallel/spatial.py``'s plan
(``pipe.bands(h)`` shows it), exchanging only the rows that cross a band
edge; every rank normalises the whole request (the provider sees it whole)
and feeds the model its band. The depth bands are gathered over the model
group, then the rows over the data group, then resized to the input size
with ``output_at_input_res``. A height the plan does not split (see
``parallel/spatial.py``) is served whole on every model rank, logged once
and shown by the plan. ``FusedDepthPipeline`` and ``serving_export`` have
no spatial mode, as in JAX.

Under a profiler, each layer of a request is a span
(``utils/profiling.py::annotate``): ``serving.request`` around the call,
inside it ``serving.h2d`` (the frames' copy), ``serving.normalise``,
``serving.forward`` (the model, whose stages are ``model.*`` spans) and
``serving.output``; ``stream_depth`` adds ``stream.feed_wait``,
``stream.host_copy`` and ``stream.finish``. Counters, always on:
``serving.batches``, ``serving.images`` and the copied frame bytes,
``serving.h2d_pageable_bytes`` or ``serving.h2d_pinned_bytes``.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from objcavit_torch.ops.resize import resize_bilinear
from objcavit_torch.parallel import spatial as spatial_split
from objcavit_torch.parallel.collectives import gather_data
from objcavit_torch.utils.device import card_device
from objcavit_torch.utils.profiling import annotate, count

# ImageNet statistics (objcavit_tpu/data/preprocess.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MAX_DET = 1000  # yolov7seg.max_det of the reference's params files


def image_seq_len(h: int, w: int, do_final_upscale: bool = False, patch: int = 16) -> int:
    """ObjCAViT's image-token count for an (h, w) input: dense features at
    half resolution (full with ``do_final_upscale``) cut into 16-pixel
    patches (objcavit_tpu/training/steps.py)."""
    fh, fw = (h, w) if do_final_upscale else (math.ceil(h / 2), math.ceil(w / 2))
    return math.ceil(fh / patch) * math.ceil(fw / patch)


def default_capacity(model, eval_dims) -> int:
    """The object-slot count a server gives ``model`` at ``eval_dims``:
    min(max_det, image tokens), 300 at 480x640, or 1000 for a model with
    ``do_final_upscale`` (1200 tokens)."""
    return min(MAX_DET, image_seq_len(*eval_dims, model.do_final_upscale))


class DepthPipeline:
    """Batched depth-map server around a GraphBins or AdaBins model."""

    def __init__(self, model, eval_dims: tuple[int, int] = (480, 640),
                 n_obj_max: int | None = None, output_at_input_res: bool = False,
                 provider=None, unk_feature=None, grid=None, spatial: bool = False):
        self.grid = grid
        self.spatial = spatial
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.eval_dims = tuple(eval_dims)
        # detection capacity: min(max_det, image sequence length), 300 at
        # 480x640 (1000 with do_final_upscale)
        self.n_obj_max = default_capacity(model, self.eval_dims) if n_obj_max is None else n_obj_max
        self.output_at_input_res = output_at_input_res
        self.provider = provider
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)
        # the no-detection sentinel's feature: the reference's <UNK> embedding
        # (ObjCAViT.py:310-315), e.g. embedder.embed(["<UNK>"])[0]
        self.unk_feature = (None if unk_feature is None else
                            torch.as_tensor(np.asarray(unk_feature, np.float32), device=self.device))
        self._sentinels: dict[int, tuple] = {}

    def _sentinel_objects(self, b: int):
        """The no-detection sentinel's (features, xywh, valid) for a batch of
        ``b``, made once (outside inference mode, so ``torch.export`` may
        keep them as constants); while ``torch.export`` traces, a batch not
        made before is made in the program, uncached."""
        hit = self._sentinels.get(b)
        if hit is None:
            n, dev = self.n_obj_max, self.device
            with torch.inference_mode(False):
                feats = torch.zeros((b, n, self.model.obj_feature_dim), device=dev)
                if self.unk_feature is not None:
                    feats[:, 0] = self.unk_feature
                xywh = torch.full((b, n, 4), -1.0, device=dev)
                valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
                valid[:, 0] = True
            hit = (feats, xywh, valid)
            if not torch.compiler.is_exporting():
                self._sentinels[b] = hit
        return hit

    def normalise(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the device -> /255, resized to the eval size,
        ImageNet-normalised fp32."""
        with annotate("serving.normalise"):
            x = resize_bilinear(frames.float() / 255.0, *self.eval_dims, align_corners=False)
            return (x - self.mean) / self.std

    def _at_input_res(self, depth: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        if self.output_at_input_res:
            return resize_bilinear(depth, frames.shape[1], frames.shape[2], align_corners=True)
        return depth

    def _split(self, b: int) -> bool:
        """Whether a batch of ``b`` splits over the grid's data axis."""
        return self.grid is not None and self.grid.n_data > 1 and b % self.grid.n_data == 0

    def _rows(self, frames: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of the request, ``[d::n_data]``."""
        if not self._split(frames.shape[0]):
            return frames
        return frames[self.grid.data_index::self.grid.n_data]

    def bands(self, h: int | None = None) -> spatial_split.BandPlan | None:
        """The band plan of a request of ``h`` eval rows (the eval height by
        default) on the grid's model axis; None for a server that is not
        spatial."""
        if not self.spatial:
            return None
        h = self.eval_dims[0] if h is None else h
        if self.grid is None:
            return spatial_split.BandPlan(h, 1, reason="the server has no grid")
        return spatial_split.band_plan(h, self.grid)

    def _depth(self, x: torch.Tensor, *objects) -> torch.Tensor:
        """The model's depth on normalised ``x``: on a spatial server, this
        rank's band through the model under the plan, then every rank's band."""
        plan = self.bands(x.shape[1])
        with annotate("serving.forward"):
            if plan is None or not plan.split:
                if plan is not None:
                    spatial_split.log_whole(plan)
                return self.model(x, *objects)["depth_pred"]
            lo, hi = plan.bands()[plan.index]
            with spatial_split.serving(plan):
                depth = self.model(x[:, lo:hi], *objects)["depth_pred"]
                return spatial_split.gather_rows(depth, 1)

    def _output(self, depth: torch.Tensor, frames: torch.Tensor, b: int) -> torch.Tensor:
        """The model's depth as the request returns it: at the input size
        with ``output_at_input_res``, every data rank's rows under a grid."""
        with annotate("serving.output"):
            return self._global(self._at_input_res(depth, frames), b)

    def _global(self, depth: torch.Tensor, b: int) -> torch.Tensor:
        """The request's depth from every data rank's rows, in the request's order."""
        if not self._split(b):
            return depth
        n = self.grid.n_data
        return gather_data(depth, self.grid).unflatten(0, (n, b // n)).transpose(0, 1).flatten(0, 1)

    def serve(self, frames: torch.Tensor) -> torch.Tensor:
        """A request's device work, with no host round trip: uint8 frames on
        the device -> ``normalise`` -> the model (GraphBins with the
        sentinel objects) -> depth, resized to the input size with
        ``output_at_input_res``. ``__call__`` runs it for a pipeline without
        a provider, and ``serving_export`` traces it. Under a grid, this
        rank's rows of ``frames`` through the model (on a spatial server,
        its band of them), then every rank's."""
        b, frames = frames.shape[0], self._rows(frames)
        x = self.normalise(frames)
        objects = self._sentinel_objects(frames.shape[0]) if self.model.takes_objects else ()
        return self._output(self._depth(x, *objects), frames, b)

    @torch.inference_mode()
    def __call__(self, frames_u8) -> torch.Tensor:
        """frames_u8: (B, H, W, 3) uint8 (numpy or tensor) -> (B, h, w, 1)
        fp32 depth in metres on the model's device."""
        with annotate("serving.request"):
            frames = device_frames(frames_u8, self.device)
            _count_request(frames)
            if self.provider is None or not self.model.takes_objects:
                return self.serve(frames)
            b, frames = frames.shape[0], self._rows(frames)
            x = self.normalise(frames)
            objs = self.provider(x.cpu().numpy())
            feats, xywh, valid = (torch.as_tensor(np.asarray(objs[k]), device=self.device)
                                  for k in ("features", "xywh", "valid"))
            return self._output(self._depth(x, feats, xywh, valid), frames, b)


def device_frames(frames_u8, device) -> torch.Tensor:
    """A request's frames on ``device``; ValueError unless (B, H, W, 3) uint8.
    A copy from the host to a card counts its bytes, as
    ``serving.h2d_pinned_bytes`` or ``serving.h2d_pageable_bytes``."""
    with annotate("serving.h2d"):
        host = torch.as_tensor(frames_u8)
        frames = host.to(device)
        if host.device.type == "cpu" and frames.device.type != "cpu":
            kind = "pinned" if host.is_pinned() else "pageable"
            count(f"serving.h2d_{kind}_bytes", host.nbytes)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[3] != 3:
        raise ValueError(
            f"frames must be uint8 (B, H, W, 3), got {frames.dtype} {tuple(frames.shape)}"
        )
    return frames


def _count_request(frames: torch.Tensor) -> None:
    count("serving.batches")
    count("serving.images", frames.shape[0])


def build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=(480, 640), seed: int = 0,
                            device="cuda", attn_impl: str = "plain",
                            encoder_impl: str = "plain", grid=None, **overrides) -> DepthPipeline:
    """Flagship GraphBins-B5 pipeline, BN folded, with random weights from
    ``seed``, its attention on the route ``attn_impl`` and its encoder on
    the route ``encoder_impl``; ``overrides`` update the model's arguments
    (ObjCAViT's options among them, ``benchkit.build_flagship_model``).
    With a process ``grid``, the model's attention stacks split over its
    model axis (``parallel/tp.py::tp_shard_model``) and the pipeline serves
    its data rank's rows."""
    from objcavit_torch.utils.benchkit import build_flagship_model

    model = build_flagship_model(dtype=dtype, seed=seed, device=device, attn_impl=attn_impl,
                                 encoder_impl=encoder_impl, **overrides)
    if grid is not None:
        from objcavit_torch.parallel.tp import tp_shard_model

        tp_shard_model(model, grid)
    return DepthPipeline(model, eval_dims=eval_dims, grid=grid)


def build_adabins_pipeline(dtype=torch.bfloat16, eval_dims=(480, 640), seed: int = 0,
                           device="cuda", attn_impl: str = "plain", **overrides) -> DepthPipeline:
    """AdaBins-B5 pipeline (``params/nyu_adabins_enet-b5.yaml``), BN folded,
    with random weights from ``seed``, its attention on the route
    ``attn_impl``; ``overrides`` update the model's arguments
    (``do_final_upscale=True`` is ``params/nyu_efficientnet-b5_final_upscale_1.yaml``'s
    model)."""
    from objcavit_torch.utils.benchkit import build_adabins_model

    model = build_adabins_model(dtype=dtype, seed=seed, device=device, attn_impl=attn_impl,
                                **overrides)
    return DepthPipeline(model, eval_dims=eval_dims)


def stream_depth(pipeline, frames_iter, batch_size: int = 8):
    """Streaming video inference: batches frames from an iterator, decoded
    and stacked by a feeder thread, and keeps one batch on the card while
    the next is decoded and launched. Yields (frames_u8, depth numpy) per
    batch; a final partial batch is zero-padded on the host and trimmed on
    yield. Works with ``DepthPipeline`` and ``FusedDepthPipeline``.

    Each batch's depth is copied to the host right after its launch, behind
    it on the stream, and an event marks the copy; the batch is yielded once
    the next one is launched, after waiting on that event only.
    """
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = object()
    cancelled = threading.Event()  # set when the consumer abandons the generator

    def put(item) -> bool:
        # a bounded put that gives up once the generator is closed, so an
        # abandoned stream does not park this thread on a full queue
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def feeder():
        try:
            buf = []
            for frame in frames_iter:
                buf.append(frame)
                if len(buf) == batch_size:
                    if not put((np.stack(buf), batch_size)):
                        return
                    buf = []
            if buf:
                n = len(buf)
                pad = [np.zeros_like(buf[0])] * (batch_size - n)
                if not put((np.stack(buf + pad), n)):
                    return
            put(stop)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    def host_copy(depth: torch.Tensor):
        if depth.device.type != "cuda":
            return depth, None
        out = depth.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, done

    threading.Thread(target=feeder, daemon=True).start()
    pending = None  # (frames, n, host depth, copy event)
    try:
        while True:
            with annotate("stream.feed_wait"):
                item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is stop:
                break
            frames, n = item
            depth = pipeline(frames)
            with annotate("stream.host_copy"):
                launched = (frames, n, *host_copy(depth))
            if pending is not None:
                yield _finish(pending)
            pending = launched
        if pending is not None:
            yield _finish(pending)
    finally:
        cancelled.set()


def _finish(pending):
    with annotate("stream.finish"):
        frames, n, depth, done = pending
        if done is not None:
            done.synchronize()
        return frames[:n], depth.numpy()[:n]


class FusedDepthPipeline:
    """uint8 frames -> YOLOv7-seg -> class-embedding gather -> depth.

    Port of ``objcavit_tpu/serving.py::FusedDepthPipeline``. For a per-class
    language strategy the phrase depends only on the detected class, so CLIP
    collapses to ``class_table`` (num_classes + 1, 512); its last row is the
    '<UNK>' embedding of the no-detection sentinel (xywh = -1, one valid
    slot, ObjCAViT.py:310-315). Everything runs on the model's device; the
    only host syncs are the NMS's convergence checks and the throttled
    saturation check.

    Knobs, as in the JAX package:

    * ``det_topk``: the class and coefficient head only on the top-k
      positions per level by objectness (a relaxation; None is exact);
    * ``pre_topk``: the NMS candidate pool, None -> min(1024, anchors);
    * ``class_max_head``: the dense head's conv and class max/argmax as one
      kernel (kernel 6) so the (B, A, 5 + nc + nm) logits never reach device
      memory; None switches it on above ``CLASS_MAX_MIN_ANCHORS`` anchors;
    * ``det_stride=K``: video keyframe mode, detection on every K-th frame
      of the batch, its objects reused by the K-1 frames after it;
    * ``det_scale=s``: detection on an s-scaled copy snapped to the
      stride-32 grid, boxes rescaled to eval pixels after NMS.
    """

    def __init__(self, model, detector, class_table, eval_dims: tuple[int, int] = (480, 640),
                 n_obj_max: int | None = None, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 det_topk: int | None = None, pre_topk: int | None = None,
                 class_max_head: bool | None = None, det_stride: int = 1, det_scale: float = 1.0):
        self.model = model.eval()
        self.detector = detector.eval()
        self.device = next(model.parameters()).device
        self.class_table = torch.as_tensor(class_table, dtype=torch.float32, device=self.device)
        # the decode's class slice comes from the table's row count: a
        # mismatch with the detector head would read mask coefficients as classes
        if detector.num_classes != self.class_table.shape[0] - 1:
            raise ValueError(
                f"class_table has {self.class_table.shape[0]} rows (classes + <UNK>) but the "
                f"detector head has {detector.num_classes} classes: expected "
                f"{detector.num_classes + 1} rows"
            )
        self.eval_dims = tuple(eval_dims)
        self.n_obj_max = default_capacity(model, self.eval_dims) if n_obj_max is None else n_obj_max
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        if class_max_head and det_topk is not None:
            raise ValueError(
                "class_max_head=True requires the dense head (det_topk=None): the fused "
                "class-max kernel replaces the full 1x1 head conv, while det_topk evaluates "
                "the head only on sparse top-k positions. Drop one of the two knobs."
            )
        self.det_topk = det_topk
        self.pre_topk = pre_topk
        self.class_max_head = class_max_head
        if det_stride < 1:
            raise ValueError(f"det_stride must be >= 1, got {det_stride}")
        self.det_stride = det_stride
        if not 0.0 < det_scale <= 1.0:
            raise ValueError(f"det_scale must be in (0, 1], got {det_scale}")
        self.det_scale = float(det_scale)
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)
        # candidate-pool saturation: ``last_det_meta`` holds the newest
        # per-frame counts (on the device); every ``saturation_check_interval``
        # calls one earlier call's counts are read back and checked
        self.last_det_meta = None
        self._pending_sat = None
        self.saturation_check_interval = 32
        self._sat_calls = 0

    def detector_dims(self) -> tuple[int, int]:
        """The detector's input size: the eval size, or with ``det_scale``
        its scaled copy snapped to YOLOv7's stride-32 grid."""
        eh, ew = self.eval_dims
        if self.det_scale == 1.0:
            return eh, ew
        return (max(32, int(round(eh * self.det_scale / 32)) * 32),
                max(32, int(round(ew * self.det_scale / 32)) * 32))

    def uses_class_max(self) -> bool:
        """Whether the detector takes the class-max head (kernel 6)."""
        from objcavit_torch.models.yolov7 import CLASS_MAX_MIN_ANCHORS, n_anchors

        cm = self.class_max_head
        if cm is None:
            cm = n_anchors(*self.detector_dims()) > CLASS_MAX_MIN_ANCHORS
        return self.det_topk is None and cm

    def _detections(self, x_det: torch.Tensor) -> dict:
        """Detector, decode and NMS: padded (B, n_obj_max) detections in
        detector-input pixels, with ``n_candidates`` and ``pre_topk``."""
        from objcavit_torch.models.yolov7 import (
            decode_best,
            decode_best_classmax,
            decode_best_sparse,
            pool_size,
        )
        from objcavit_torch.ops.nms import batched_nms, xywh_to_xyxy

        use_cm = self.uses_class_max()
        preds, _ = self.detector(x_det, topk_positions=self.det_topk, class_max=use_cm,
                                 with_proto=False)
        decode = (decode_best_sparse if self.det_topk is not None
                  else decode_best_classmax if use_cm else decode_best)
        boxes, best, best_cls, _ = decode(preds, self.detector.num_classes, self.detector.nm)
        pre_topk = pool_size(boxes.shape[1], self.pre_topk)
        det = batched_nms(xywh_to_xyxy(boxes), best, best_cls, self.conf_thres, self.iou_thres,
                          pre_topk=pre_topk, max_det=self.n_obj_max)
        det["pre_topk"] = pre_topk
        return det

    def _objects(self, det: dict, det_hw: tuple[int, int]):
        """Detections -> GraphBins' object slots: boxes rescaled to eval
        pixels, features gathered from the class table, the sentinel where
        a frame found nothing, each keyframe's objects repeated."""
        from objcavit_torch.ops.nms import xyxy_to_xywh

        (eh, ew), (dh, dw) = self.eval_dims, det_hw
        bx = det["boxes_xyxy"]
        if (dh, dw) != (eh, ew):  # NMS ran in the detector's frame
            bx = bx * torch.tensor([ew / dw, eh / dh, ew / dw, eh / dh], dtype=bx.dtype,
                                   device=bx.device)
        xywh = xyxy_to_xywh(bx)
        valid = det["valid"]
        feats = self.class_table[det["classes"]] * valid[..., None]
        sentinel = torch.zeros_like(valid)
        sentinel[:, 0] = ~valid.any(dim=1)
        valid = valid | sentinel
        feats = torch.where(sentinel[..., None], self.class_table[-1], feats)
        xywh = torch.where(sentinel[..., None], torch.full_like(xywh, -1.0), xywh)
        if self.det_stride > 1:
            feats, xywh, valid = (t.repeat_interleave(self.det_stride, dim=0)
                                  for t in (feats, xywh, valid))
        return feats, xywh, valid

    def _check_pending_saturation(self) -> None:
        """Throttled pool-saturation warning about an earlier call (its work
        long done): the readback is a device-to-host round trip."""
        if self._pending_sat is None:
            return
        self._sat_calls += 1
        if self._sat_calls < self.saturation_check_interval:
            return
        self._sat_calls = 0
        n_cand, pre_topk = self._pending_sat
        self._pending_sat = None
        from objcavit_torch.models.yolov7 import warn_if_saturated

        warn_if_saturated(logging.getLogger(__name__), n_cand.cpu().numpy(), pre_topk,
                          "fused serving")

    def serve(self, frames: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """A request's device work, with no host round trip but the NMS's
        convergence checks (none while ``torch.export`` traces): uint8
        frames on the device -> depth, and the detection meta
        {'n_candidates' (B,) on the device, 'pre_topk'}. ``__call__`` runs
        it, and ``serving_export`` traces it."""
        stride = self.det_stride
        x01 = resize_bilinear(frames.float() / 255.0, *self.eval_dims, align_corners=False)
        normed = (x01 - self.mean) / self.std
        x_det = x01[::stride] if stride > 1 else x01
        det_hw = self.detector_dims()
        if det_hw != self.eval_dims:
            x_det = resize_bilinear(x_det, *det_hw, align_corners=False)
        det = self._detections(x_det)
        feats, xywh, valid = self._objects(det, det_hw)
        with annotate("serving.forward"):
            depth = self.model(normed, feats, xywh, valid)["depth_pred"]
        return depth, {"n_candidates": det["n_candidates"], "pre_topk": det["pre_topk"]}

    @torch.inference_mode()
    def __call__(self, frames_u8) -> torch.Tensor:
        """frames_u8: (B, H, W, 3) uint8 (numpy or tensor) -> (B, h/2, w/2, 1)
        fp32 depth in metres on the model's device."""
        with annotate("serving.request"):
            frames = device_frames(frames_u8, self.device)
            stride = self.det_stride
            if frames.shape[0] % stride:
                raise ValueError(f"video det_stride={stride} needs the clip length divisible "
                                 f"by it, got batch {frames.shape[0]}")
            _count_request(frames)
            self._check_pending_saturation()
            depth, meta = self.serve(frames)
            self.last_det_meta = meta
            self._pending_sat = (meta["n_candidates"], meta["pre_topk"])
            return depth


def build_fused_flagship(dtype=torch.bfloat16, eval_dims=(480, 640), seed: int = 0,
                         device="cuda", attn_impl: str = "plain", num_classes: int = 1203,
                         class_names=None, language_strategy: str = "synset_def_wn",
                         clip_model=None, bpe_path: str | None = None,
                         yolov7_checkpoint: str | None = None, **pipeline_kwargs) -> FusedDepthPipeline:
    """The fused server at the flagship's width: GraphBins-B5 (BN folded),
    YOLOv7-seg with ``num_classes`` classes (BN folded, RepConvs merged) and
    the class table from the CLIP text tower (``clip_model``, or the
    full-width tower with random weights), all with random weights from
    ``seed`` through explicit generators; class names ``class_i`` by
    default; GraphBins' attention on the route ``attn_impl``.
    ``pipeline_kwargs`` go to ``FusedDepthPipeline`` (conf_thres, iou_thres,
    det_topk, pre_topk, class_max_head, det_stride, det_scale, n_obj_max).
    Released YOLOv7-seg and CLIP weights load through
    ``utils/torch_import.py``: the detector from ``yolov7_checkpoint``
    (``benchkit.load_detector``; 1203 classes), the text tower as
    ``clip_model`` (``load_clip_text_weights``, ``clip_text_from_state_dict``);
    otherwise this function draws random ones."""
    from objcavit_torch.language.embedding import build_class_table, make_embedder
    from objcavit_torch.utils.benchkit import build_detector, build_flagship_model, load_detector

    device = card_device(device)
    model = build_flagship_model(dtype=dtype, seed=seed, device=device, attn_impl=attn_impl)
    if yolov7_checkpoint is not None:
        detector = load_detector(yolov7_checkpoint, dtype, device)
    else:
        detector = build_detector(num_classes, dtype=dtype, seed=seed + 1, device=device)
    if class_names is None:
        class_names = [f"class_{i}" for i in range(num_classes)]
    embedder = make_embedder("clip", clip_model, bpe_path, device=device, seed=seed + 2)
    table = build_class_table(class_names, language_strategy, embedder)
    return FusedDepthPipeline(model, detector, table, eval_dims=eval_dims, **pipeline_kwargs)
