"""The port's servers against the JAX package's, end to end on the CPU:
``FusedDepthPipeline`` (uint8 frames -> YOLOv7-seg -> NMS -> class table ->
GraphBins) on the dense, class-max and sentinel routes and with the
``det_topk``, ``det_stride`` and ``det_scale`` knobs; ``DepthPipeline``'s
``unk_feature`` on the sentinel and provider routes; ``stream_depth``; the
saturation meta and its ``>`` rule; ``build_fused_flagship``.

GraphBins is efficientnet-tiny with 16 bins at 64x96 (6 image tokens, so 5
queries: the port's ``n_queries=5`` matches JAX's lazily shaped conv_out),
its vectors redrawn as in tests/test_torch_modules.py; the detector is the
calibrated nc = 4 one of tests/test_torch_detect.py. The JAX servers run
without a mesh. Depth is compared at the slice tests' tolerance (1e-3).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.models.yolov7 import Yolov7Seg as JaxYolov7Seg
from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline
from objcavit_tpu.serving import FusedDepthPipeline as JaxFusedDepthPipeline

from objcavit_torch.models.clip_text import CLIPTextEncoder
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.yolov7 import CLASS_MAX_MIN_ANCHORS
from objcavit_torch.serving import (
    DepthPipeline,
    FusedDepthPipeline,
    build_fused_flagship,
    stream_depth,
)
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.fold_bn import FoldedBatchNorm
from tests.test_torch_detect import NC, detector_variables, port_detector
from tests.test_torch_modules import _redraw_vectors

DIMS = (64, 96)
N_OBJ = 4
ENC = "efficientnet-tiny"
DEPTH_TOL = 1e-3  # fp32 through the tiny GraphBins, as tests/test_torch_slice.py


def jax_graphbins() -> JaxGraphBins:
    return JaxGraphBins(encoder_name=ENC, n_bins=16, min_depth=0.001, max_depth=10.0,
                        pos_strategy="learned_bbox_wh", dims_train=DIMS, dims_test=DIMS)


@functools.lru_cache(maxsize=None)
def graphbins_variables():
    model = jax_graphbins()
    objs = (jnp.zeros((1, N_OBJ, 512)), jnp.full((1, N_OBJ, 4), -1.0),
            jnp.zeros((1, N_OBJ), bool).at[:, 0].set(True))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, *DIMS, 3)), *objs)
    variables = _redraw_vectors(jax.tree.map(np.asarray, variables), np.random.default_rng(0))
    variables["params"]["conv_out"]["kernel"] = variables["params"]["conv_out"]["kernel"] * 10
    return variables


def port_graphbins() -> GraphBins:
    model = GraphBins(encoder_name=ENC, n_bins=16, n_queries=5)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_variables(graphbins_variables(), ENC).items()})
    return model.eval()


@functools.lru_cache(maxsize=None)
def class_table() -> np.ndarray:
    return np.random.default_rng(19).standard_normal((NC + 1, 512)).astype(np.float32)


def _frames(seed: int, b: int = 2, hw=DIMS) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, *hw, 3), dtype=np.uint8)


def _pipelines(**kw):
    jax_pipe = JaxFusedDepthPipeline(jax_graphbins(), graphbins_variables(),
                                     JaxYolov7Seg(num_classes=NC), detector_variables(),
                                     class_table(), eval_dims=DIMS, n_obj_max=N_OBJ,
                                     use_mesh=False, **kw)
    pipe = FusedDepthPipeline(port_graphbins(), port_detector(detector_variables()),
                              class_table(), eval_dims=DIMS, n_obj_max=N_OBJ, **kw)
    return jax_pipe, pipe


@pytest.mark.parametrize("kw,batch", [
    ({"conf_thres": 1e-4}, 2),
    ({"conf_thres": 1e-4, "class_max_head": True}, 2),
    ({"conf_thres": 2.0}, 2),
    ({"conf_thres": 1e-4, "det_topk": 8, "det_stride": 2}, 4),
    ({"conf_thres": 1e-4, "det_topk": 8, "det_scale": 0.5}, 2),
], ids=["dense", "class-max", "sentinel", "topk-stride2", "topk-scale0.5"])
def test_fused_server_matches_jax(kw, batch):
    """Depth and the candidate counts against JAX's fused program. conf
    1e-4 makes every anchor a candidate, so NMS and the table gather run on
    real detections; conf 2.0 leaves none, so every frame takes the <UNK>
    sentinel from the table's last row."""
    jax_pipe, pipe = _pipelines(**kw)
    frames = _frames(23, batch)
    want = np.asarray(jax_pipe(frames))
    detections, run = [], pipe._detections
    pipe._detections = lambda x: detections.append(run(x)) or detections[-1]
    got = pipe(frames)
    assert got.shape == want.shape == (batch, DIMS[0] // 2, DIMS[1] // 2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=DEPTH_TOL, atol=DEPTH_TOL)
    meta, jax_meta = pipe.last_det_meta, jax_pipe.last_det_meta
    assert meta["pre_topk"] == jax_meta["pre_topk"]
    np.testing.assert_array_equal(meta["n_candidates"].numpy(), np.asarray(jax_meta["n_candidates"]))
    assert bool(detections[0]["valid"].any()) == (kw["conf_thres"] < 1)


def test_fused_server_routes_and_checks():
    """The class-max gate (above 20,000 detector anchors unless forced), and
    the JAX package's ValueErrors."""
    model, detector, table = port_graphbins(), port_detector(detector_variables()), class_table()
    for dims, scale, want in [((480, 640), 1.0, False), ((352, 1216), 1.0, True),
                              ((352, 1216), 0.5, False)]:
        pipe = FusedDepthPipeline(model, detector, table, eval_dims=dims, det_scale=scale)
        assert pipe.uses_class_max() == want, (dims, scale)
    assert CLASS_MAX_MIN_ANCHORS == 20000
    assert FusedDepthPipeline(model, detector, table, eval_dims=DIMS, class_max_head=True).uses_class_max()
    assert FusedDepthPipeline(model, detector, table, eval_dims=(352, 1216), det_scale=0.5
                              ).detector_dims() == (192, 608)  # 176 / 32 = 5.5 rounds to 6
    with pytest.raises(ValueError, match="rows"):
        FusedDepthPipeline(model, detector, table[:-1], eval_dims=DIMS)
    with pytest.raises(ValueError, match="dense head"):
        FusedDepthPipeline(model, detector, table, eval_dims=DIMS, class_max_head=True, det_topk=8)
    with pytest.raises(ValueError, match="det_stride"):
        FusedDepthPipeline(model, detector, table, eval_dims=DIMS, det_stride=0)
    with pytest.raises(ValueError, match="det_scale"):
        FusedDepthPipeline(model, detector, table, eval_dims=DIMS, det_scale=1.5)
    pipe = FusedDepthPipeline(model, detector, table, eval_dims=DIMS, n_obj_max=N_OBJ, det_stride=2)
    with pytest.raises(ValueError, match="divisible"):
        pipe(_frames(1, 3))
    with pytest.raises(ValueError, match="uint8"):
        pipe(np.zeros((2, *DIMS, 3), np.float32))


def test_fused_saturation_meta_and_throttled_warning(caplog):
    """conf 0 makes all 378 anchors candidates: with pre_topk 8 the pool
    saturates and the throttled check warns on the call after; with
    pre_topk 378 every candidate fits (n_candidates == pre_topk), which the
    port does not call saturated (the JAX package warns at >=)."""
    model, detector, table = port_graphbins(), port_detector(detector_variables()), class_table()
    frames = _frames(29)
    pipe = FusedDepthPipeline(model, detector, table, eval_dims=DIMS, n_obj_max=N_OBJ,
                              conf_thres=0.0, pre_topk=8)
    pipe(frames)
    assert pipe.last_det_meta["pre_topk"] == 8
    assert pipe.last_det_meta["n_candidates"].tolist() == [378, 378]
    with caplog.at_level(logging.WARNING, logger="objcavit_torch.serving"):
        pipe(frames)  # default interval 32: not checked yet
        assert not caplog.records
        pipe.saturation_check_interval = 1
        pipe(frames)
        assert any("saturated on 2/2" in r.getMessage() for r in caplog.records)
        caplog.clear()
        full = FusedDepthPipeline(model, detector, table, eval_dims=DIMS, n_obj_max=N_OBJ,
                                  conf_thres=0.0, pre_topk=378)
        full.saturation_check_interval = 1
        full(frames)
        full(frames)
        assert full.last_det_meta["pre_topk"] == 378 and not caplog.records


def test_depth_pipeline_unk_feature_and_provider_match_jax():
    """Port of tests/test_serving.py::test_depth_pipeline_provider_contract_and_unk_sentinel:
    the provider gets normalised eval-size images and its objects feed the
    model; without a provider, slot 0 of the sentinel carries the given
    <UNK> feature, on both servers."""
    rng = np.random.default_rng(31)
    objs = {
        "features": rng.standard_normal((2, N_OBJ, 512)).astype(np.float32),
        "xywh": np.asarray([[[20, 30, 10, 12], [50, 20, 8, 8], [-1] * 4, [-1] * 4]] * 2,
                           np.float32),
        "valid": np.asarray([[True, True, False, False]] * 2),
    }
    seen = []

    def provider(images):
        seen.append(np.asarray(images))
        return objs

    frames = _frames(37, 2, (120, 160))
    unk = rng.standard_normal(512).astype(np.float32)
    for kw in ({"provider": provider}, {"unk_feature": unk}):
        want = np.asarray(JaxDepthPipeline(jax_graphbins(), graphbins_variables(), eval_dims=DIMS,
                                           n_obj_max=N_OBJ, use_mesh=False, **kw)(frames))
        pipe = DepthPipeline(port_graphbins(), eval_dims=DIMS, n_obj_max=N_OBJ, **kw)
        got = pipe(frames).numpy()
        np.testing.assert_allclose(got, want, rtol=DEPTH_TOL, atol=DEPTH_TOL)
    assert seen[0].shape == (2, *DIMS, 3)
    np.testing.assert_allclose(seen[1], seen[0], rtol=1e-5, atol=1e-5)  # same preprocessing
    feats, xywh, valid = pipe._sentinel_objects(2)
    np.testing.assert_array_equal(feats[:, 0].numpy(), np.tile(unk, (2, 1)))
    assert not feats[:, 1:].any() and (xywh == -1).all()
    assert valid[:, 0].all() and not valid[:, 1:].any()


def test_stream_depth_batches_trims_and_matches_direct_calls():
    """19 frames at batch 8 through both servers: batches of 8, 8 and 3
    (the last zero-padded on the host and trimmed), each equal to a direct
    call on the same batch."""
    stream = list(_frames(41, 19))
    for pipe in (DepthPipeline(port_graphbins(), eval_dims=DIMS, n_obj_max=N_OBJ),
                 FusedDepthPipeline(port_graphbins(), port_detector(detector_variables()),
                                    class_table(), eval_dims=DIMS, n_obj_max=N_OBJ,
                                    conf_thres=1e-4)):
        out = list(stream_depth(pipe, iter(stream), batch_size=8))
        assert [f.shape[0] for f, _ in out] == [8, 8, 3]
        assert [d.shape for _, d in out] == [(8, 32, 48, 1), (8, 32, 48, 1), (3, 32, 48, 1)]
        np.testing.assert_array_equal(out[1][1], pipe(np.stack(stream[8:16])).numpy())
        last = np.concatenate([np.stack(stream[16:]), np.zeros((5, *DIMS, 3), np.uint8)])
        np.testing.assert_array_equal(out[2][1], pipe(last).numpy()[:3])
        np.testing.assert_array_equal(out[2][0], np.stack(stream[16:]))


def test_stream_depth_raises_what_the_frame_source_raises():
    def frames():
        yield np.zeros((*DIMS, 3), np.uint8)
        raise OSError("camera lost")

    pipe = DepthPipeline(port_graphbins(), eval_dims=DIMS, n_obj_max=N_OBJ)
    with pytest.raises(OSError, match="camera lost"):
        list(stream_depth(pipe, frames(), batch_size=4))


def test_build_fused_flagship_assembles_the_three_models():
    """GraphBins-B5 and YOLOv7-seg folded, the class table from the given
    CLIP tower (nc + 1 rows, the last <UNK>), the pipeline's knobs passed
    through; built on the CPU, not run."""
    clip = CLIPTextEncoder(width=64, heads=4, layers=1).init_weights_(torch.Generator().manual_seed(0))
    pipe = build_fused_flagship(dtype=torch.float32, eval_dims=(384, 352), device="cpu",
                                num_classes=NC, clip_model=clip, det_topk=16, conf_thres=0.3)
    assert pipe.n_obj_max == 132 and pipe.det_topk == 16 and pipe.conf_thres == 0.3
    assert pipe.class_table.shape == (NC + 1, 512)
    for model in (pipe.model, pipe.detector):
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        assert any(isinstance(m, FoldedBatchNorm) for m in model.modules())
    assert pipe.detector.body.rep5.merged_conv is not None
    assert pipe.detector.num_classes == NC and not pipe.uses_class_max()
