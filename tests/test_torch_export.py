"""Export (``objcavit_torch/serving_export.py``) against the JAX package's
``serving_export`` contract, on the CPU.

The tiny models of tests/test_torch_fused.py (efficientnet-tiny GraphBins at
64x96 with 4 slots, its weights drawn by the port, carried to JAX by JAX's
``convert_state_dict`` and back by ``state_dict_from_variables``; the nc = 4
detector, its weights carried to JAX by the tree of ``jax.eval_shape``, so
no JAX init is compiled): an
artifact written by the CLI (``-o``, ``--batch 1 2``, ``--eval-dims``) and
by ``export_artifact`` reproduces the eager port bit for bit and JAX's
servers within the slice tests' 1e-3; a fresh process loads and runs a
bf16 artifact on the kernel routes, whose graph holds the ``objcavit::``
ops, with no model module imported; the exported NMS (``torch.while_loop``)
stops on the eager loop's fixed point; ``torch.library.opcheck`` accepts
each op of ``kernels/ops.py``. Exports are built once a module.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.models.yolov7 import Yolov7Seg as JaxYolov7Seg
from objcavit_tpu.ops import nms as jnms
from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline
from objcavit_tpu.serving import FusedDepthPipeline as JaxFusedDepthPipeline
from objcavit_tpu.utils.torch_import import convert_state_dict

from objcavit_torch import serving, serving_export
from objcavit_torch.kernels import ops as kops
from objcavit_torch.kernels.detect_head import pack_detect_head
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.yolov7 import Yolov7Seg
from objcavit_torch.ops import nms
from objcavit_torch.serving import DepthPipeline, FusedDepthPipeline
from objcavit_torch.serving_export import (
    ServingArtifact,
    export_artifact,
    export_pipeline,
    save_artifact,
)
from objcavit_torch.utils.benchkit import (
    DETECTOR_BN_AFFINE,
    build_flagship_model,
    calibrate_batchnorm_,
    init_weights_,
)
from objcavit_torch.utils.convert import state_dict_from_variables
from tests.test_torch_detect import NC
from tests.test_torch_fused import DEPTH_TOL, DIMS, ENC, N_OBJ, class_table, jax_graphbins
from tests.test_torch_options import _redraw_vectors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules a loading process must not import: models, servers, JAX
FORBIDDEN = ("objcavit_torch.models", "jax", "objcavit_tpu")


def _frames(seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, *DIMS, 3), dtype=np.uint8)


def _tiny_graphbins() -> GraphBins:
    return GraphBins(encoder_name=ENC, n_bins=16, n_queries=5)


@functools.lru_cache(maxsize=None)
def graphbins_variables():
    """JAX variables of the tiny GraphBins, from the port's init (every 1-D
    entry redrawn, conv_out's weight x10 so that depth spreads, as
    tests/test_torch_fused.py draws them) through JAX's
    ``convert_state_dict``: no JAX init is compiled."""
    sd = _redraw_vectors(init_weights_(_tiny_graphbins(), torch.Generator().manual_seed(0))
                         .state_dict(), np.random.default_rng(0))
    sd["conv_out.0.weight"] = sd["conv_out.0.weight"] * 10
    return convert_state_dict({f"model.{k}": v for k, v in sd.items()}, "graphbins", ENC,
                              pos_strategy="learned_bbox_wh")


def port_graphbins() -> GraphBins:
    """The tiny GraphBins with JAX's weights carried over."""
    model = _tiny_graphbins()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_variables(graphbins_variables(), ENC).items()})
    return model.eval()


def _flax_tree(shapes, sd: dict, prefix: str = "") -> dict:
    """``convert.flax_state_dict`` backwards: the leaves of the flax tree
    ``shapes`` from the port's state dict ``sd``."""
    names = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "keys"):
            out[k] = _flax_tree(v, sd, f"{prefix}{k}.")
            continue
        a = sd[prefix + names.get(k, k)].numpy()
        if k == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        assert a.shape == v.shape, (prefix + k, a.shape, v.shape)
        out[k] = np.ascontiguousarray(a)
    return out


@functools.lru_cache(maxsize=None)
def detector_pair():
    """The nc = 4 YOLOv7-seg, unfolded, as ``benchkit.build_detector`` draws
    it (detect convs N(0, 1/Cin), BN affines ``DETECTOR_BN_AFFINE``, the
    statistics calibrated on random frames), and the same weights as JAX
    variables, laid out by the tree of ``jax.eval_shape`` of JAX's init."""
    gen = torch.Generator().manual_seed(1)
    port = init_weights_(Yolov7Seg(num_classes=NC), gen)
    with torch.no_grad():
        for d in port.detects():
            d.weight.normal_(0.0, d.weight.shape[1] ** -0.5, generator=gen)
            d.bias.normal_(0.0, 0.1, generator=gen)
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(DETECTOR_BN_AFFINE[0])
                m.bias.fill_(DETECTOR_BN_AFFINE[1])
    calibrate_batchnorm_(port, torch.rand((32, *DIMS, 3), generator=gen))
    shapes = jax.eval_shape(JaxYolov7Seg(num_classes=NC).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *DIMS, 3)))
    sd = port.state_dict()
    return port, {col: _flax_tree(shapes[col], sd) for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def depth_dirs(tmp_path_factory):
    """The CLI's depth export, ``--batch 1 2 --eval-dims 64 96``, with the
    flagship builder swapped for the tiny fp32 server: (pipeline, dirs)."""
    path = str(tmp_path_factory.mktemp("depth"))
    pipe = DepthPipeline(port_graphbins(), eval_dims=DIMS, n_obj_max=N_OBJ)
    seen = {}

    def build(**kw):
        seen.update(kw)
        return pipe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "build_flagship_pipeline", build)
        dirs = serving_export.main(["-o", path, "--batch", "1", "2", "--eval-dims", *map(str, DIMS)],
                                   device="cpu")
    assert seen == {"eval_dims": DIMS, "device": "cpu"}
    return pipe, dirs


def test_depth_pipeline_artifact_roundtrip(depth_dirs):
    """The b2 artifact: the eager port bit for bit, JAX's DepthPipeline on
    the same weights within 1e-3; its meta; a wrong batch raises."""
    pipe, dirs = depth_dirs
    frames = _frames(23)
    want = pipe(frames)
    art = ServingArtifact.load(dirs[1])
    got = art(frames)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_pipe = JaxDepthPipeline(jax_graphbins(), graphbins_variables(), eval_dims=DIMS,
                                n_obj_max=N_OBJ, use_mesh=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pipe(frames)), rtol=DEPTH_TOL,
                               atol=DEPTH_TOL)
    assert art.frames_shape == frames.shape
    assert art.meta["platforms"] == ["cpu"] and art.meta["frames_dtype"] == "uint8"
    assert tuple(art.meta["depth_shape"]) == tuple(want.shape)
    assert art.meta["depth_dtype"] == "float32" and art.meta["pipeline"] == "depth"
    assert art.meta["torch_version"] == torch.__version__
    with pytest.raises(ValueError, match="compiled for frames"):
        art(frames[:1])


def test_multi_batch_export_writes_shared_meta(depth_dirs):
    """``export_artifact``'s layout, as the CLI wrote it: b1 and b2 under
    the path, a shared meta.json indexing them, each artifact's program a
    small fraction of its weights."""
    _, dirs = depth_dirs
    root = os.path.dirname(dirs[0])
    assert [os.path.basename(d) for d in dirs] == ["b1", "b2"]
    with open(os.path.join(root, "meta.json")) as f:
        shared = json.load(f)
    assert shared == {"batch_sizes": [1, 2], "dirs": ["b1", "b2"], "hw": list(DIMS),
                      "pipeline": "depth"}
    for d, b in zip(dirs, (1, 2)):
        with open(os.path.join(d, "meta.json")) as f:
            assert json.load(f)["frames_shape"] == [b, *DIMS, 3]
        program, weights = (os.path.getsize(os.path.join(d, f)) for f in ("program.pt2",
                                                                            "weights.pt"))
        assert program < weights / 10, (program, weights)


@pytest.fixture(scope="module")
def fused_art(tmp_path_factory):
    """The fused server at conf 1e-4 (every anchor a candidate) on the
    dense head's class-max route, and its artifact (bs 2)."""
    pipe = FusedDepthPipeline(port_graphbins(), detector_pair()[0], class_table(),
                              eval_dims=DIMS, n_obj_max=N_OBJ, conf_thres=1e-4,
                              class_max_head=True)
    (d,) = export_artifact(pipe, str(tmp_path_factory.mktemp("fused")), batch_sizes=(2,),
                           extra_meta={"pipeline": "fused"})
    return pipe, d


def test_fused_pipeline_artifact_roundtrip(fused_art):
    """Detector, class-max head, NMS and class table in the program: the
    eager port bit for bit, JAX's fused server within 1e-3."""
    pipe, d = fused_art
    frames = _frames(29)
    want = pipe(frames)
    art = ServingArtifact.load(d)
    got = art(frames)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_pipe = JaxFusedDepthPipeline(jax_graphbins(), graphbins_variables(),
                                     JaxYolov7Seg(num_classes=NC), detector_pair()[1],
                                     class_table(), eval_dims=DIMS,
                                     n_obj_max=N_OBJ, use_mesh=False, conf_thres=1e-4,
                                     class_max_head=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pipe(frames)), rtol=DEPTH_TOL,
                               atol=DEPTH_TOL)
    assert bool(pipe.last_det_meta["n_candidates"].gt(0).all())
    assert art.meta["ops"] == {} and art.meta["pipeline"] == "fused"  # fp32: no kernel op
    names = set(torch.load(os.path.join(d, "weights.pt"), weights_only=True))
    assert "class_table" in names and any(n.startswith("detector.") for n in names)


@pytest.fixture(scope="module")
def kernel_art(tmp_path_factory):
    """A tiny bf16 GraphBins, BN folded, on the kernel routes of attention
    and encoder, exported at bs 2: (frames, eager depth, artifact dir)."""
    model = build_flagship_model(dtype=torch.bfloat16, device="cpu", attn_impl="kernel",
                                 encoder_impl="kernel", encoder_name=ENC, n_bins=16,
                                 n_queries=5, dims_train=DIMS, dims_test=DIMS)
    pipe = DepthPipeline(model, eval_dims=DIMS, n_obj_max=N_OBJ)
    frames = _frames(31)
    path = str(tmp_path_factory.mktemp("kernel"))
    program, weights = export_pipeline(pipe, frames.shape)
    save_artifact(path, program, weights)
    return frames, pipe(frames), path


def test_kernel_routes_export_as_objcavit_ops(kernel_art):
    """Kernel 1's concat form at the four upsamples, kernel 2, kernel 5 at
    ObjCAViT's ten attentions, kernels 7 and 8 at the tiny encoder's fused
    blocks, each an ``objcavit::`` node, as the meta records them (the
    next test runs the artifact)."""
    _, _, path = kernel_art
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["ops"] == {"objcavit::attention_fwd": 10,
                           "objcavit::conv_bins_depth_batched": 1,
                           "objcavit::mbconv_head": 2,
                           "objcavit::resize_bilinear_ac_concat": 4,
                           "objcavit::se_project": 5}
    assert meta["frames_shape"] == [2, *DIMS, 3] and meta["platforms"] == ["cpu"]


def test_artifact_runs_without_model_modules(kernel_art, tmp_path):
    """A fresh process loads the kernel-route artifact and reproduces the
    eager depth bit for bit; no model module, no server module, nothing of
    JAX is imported there."""
    frames, want, path = kernel_art
    torch.save({"frames": torch.from_numpy(frames), "want": want}, tmp_path / "io.pt")
    code = (
        "import sys, torch\n"
        "from objcavit_torch.serving_export import ServingArtifact\n"
        f"io = torch.load({str(tmp_path / 'io.pt')!r})\n"
        f"art = ServingArtifact.load({path!r})\n"
        "assert torch.equal(art(io['frames']), io['want'])\n"
        "bad = [m for m in sys.modules\n"
        f"       if m == 'objcavit_torch.serving' or m.startswith({FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_cuda_artifact_without_a_card_raises(depth_dirs, tmp_path, monkeypatch):
    """An artifact exported on the card does not fall back to the CPU."""
    _, dirs = depth_dirs
    for name in ("program.pt2", "weights.pt"):
        os.symlink(os.path.join(dirs[0], name), tmp_path / name)
    with open(os.path.join(dirs[0], "meta.json")) as f:
        meta = json.load(f)
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({**meta, "platforms": ["cuda"]}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServingArtifact.load(tmp_path)


def test_export_rejects_host_provider_pipeline():
    pipe = DepthPipeline(port_graphbins(), eval_dims=DIMS, n_obj_max=N_OBJ,
                         provider=lambda x: None)
    with pytest.raises(ValueError, match="host-side object provider"):
        export_pipeline(pipe, (1, *DIMS, 3))
    with pytest.raises(TypeError, match="unsupported pipeline"):
        export_pipeline(object(), (1, *DIMS, 3))


def test_cli_fused_flags_reach_the_builder(monkeypatch, tmp_path):
    """``--fused`` with ``--yolov7-ckpt``, ``--bpe`` and ``--hw``: the fused
    builder gets them, the export its batch sizes, hw and extra meta."""
    seen = {}
    monkeypatch.setattr(serving, "build_fused_flagship", lambda **kw: seen.update(kw) or "pipe")

    def export(pipe, out, **kw):
        seen.update(pipe=pipe, out=out, **kw)
        return [out]

    monkeypatch.setattr(serving_export, "export_artifact", export)
    serving_export.main(["-o", str(tmp_path), "--fused", "--batch", "8", "--hw", "240", "320",
                         "--yolov7-ckpt", "y.pt", "--bpe", "b.txt.gz"], device="cpu")
    assert seen == {"eval_dims": (480, 640), "device": "cpu", "clip_model": None,
                    "bpe_path": "b.txt.gz", "yolov7_checkpoint": "y.pt", "pipe": "pipe",
                    "out": str(tmp_path), "batch_sizes": (8,), "hw": (240, 320),
                    "extra_meta": {"pipeline": "fused"}}


class _GreedyKeep(torch.nn.Module):
    def forward(self, iou, cand):
        return nms._greedy_keep(iou, cand, 0.45)


def _serial_greedy(iou: np.ndarray, cand: np.ndarray) -> np.ndarray:
    keep = np.zeros_like(cand)
    for i in range(cand.shape[0]):
        keep[i] = cand[i] and not np.any(keep[:i] & (iou[i, :i] > 0.45))
    return keep


def _chain(k: int = 40):
    """Boxes where each overlaps only the next (IoU 0.6 > 0.45): greedy
    keeps every other one, which takes ~K steps, past STEPS_PER_CHECK."""
    x = np.arange(k, dtype=np.float32) * 2.5
    return np.stack([x, np.zeros(k), x + 10.0, np.full(k, 10.0)], -1).astype(np.float32)[None]


@pytest.mark.parametrize("case", ["random", "deep-chain"])
def test_exported_nms_is_the_eager_fixed_point(case):
    """The exported ``_greedy_keep`` (``torch.while_loop``) against the
    eager loop, a serial greedy loop and JAX's ``_greedy_keep``, bit for
    bit."""
    rng = np.random.default_rng(7)
    if case == "random":
        xy = rng.uniform(0, 60, (2, 64, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (2, 64, 2))], -1).astype(np.float32)
        cand = torch.from_numpy(rng.uniform(size=(2, 64)) < 0.8)
    else:
        boxes = _chain()
        cand = torch.ones((1, boxes.shape[1]), dtype=torch.bool)
    iou = nms._iou_matrix(torch.from_numpy(boxes))
    program = torch.export.export(_GreedyKeep(), (iou, cand), strict=False)
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    got = program.module()(iou, cand)
    eager = nms._greedy_keep(iou, cand, 0.45)
    torch.testing.assert_close(got, eager, rtol=0, atol=0)
    for b in range(cand.shape[0]):
        want = _serial_greedy(iou[b].numpy(), cand[b].numpy())
        np.testing.assert_array_equal(got[b].numpy(), want)
        jax_keep = jnms._greedy_keep(jnp.asarray(iou[b].numpy()), jnp.asarray(cand[b].numpy()),
                                     0.45)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(jax_keep))
    if case == "deep-chain":
        assert got[0].tolist() == [i % 2 == 0 for i in range(boxes.shape[1])]


def _op_cases():
    g = torch.Generator().manual_seed(3)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)

    nc, nm, cin = 4, 2, 64
    packed = pack_detect_head(r(3 * (5 + nc + nm), cin, dtype=torch.float32),
                              r(3 * (5 + nc + nm), dtype=torch.float32), nc, nm, torch.bfloat16)
    return [
        ("resize", kops.resize_bilinear_ac, (r(2, 3, 4, 8), 5, 7)),
        ("resize-same-size", kops.resize_bilinear_ac, (r(1, 3, 4, 8), 3, 4)),
        ("resize-concat", kops.resize_bilinear_ac_concat, (r(2, 3, 4, 8), r(2, 5, 7, 8))),
        ("bins", kops.conv_bins_depth_batched,
         (r(2, 4, 4, 16), r(2, 16, 32), r(32, dtype=torch.float32),
          r(2, 32, dtype=torch.float32).abs())),
        ("attention", kops.attention_fwd,
         (r(2, 5, 2, 32), r(2, 7, 2, 32), r(2, 7, 2, 32), torch.zeros(2, 7))),
        ("attention-no-mask", kops.attention_fwd,
         (r(1, 6, 1, 32), r(1, 6, 1, 32), r(1, 6, 1, 32), None)),
        ("attention-past-512", kops.attention_fwd,
         (r(1, 530, 1, 32), r(1, 600, 1, 32), r(1, 600, 1, 32), torch.zeros(1, 600))),
        ("detect-head", kops.detect_head,
         (r(2, 6, cin), packed.wcls, packed.bcls, packed.w5c, packed.b5c, nc, nm)),
        ("se-project", kops.se_project,
         (r(2, 3, 4, 16), r(2, 16), r(16, 8), r(8, dtype=torch.float32), r(2, 3, 4, 8))),
        ("se-project-no-skip", kops.se_project,
         (r(2, 3, 4, 16), r(2, 16), r(16, 8), r(8, dtype=torch.float32), None)),
        ("mbconv-head", kops.mbconv_head,
         (r(2, 5, 6, 8), r(8, 16), r(16, dtype=torch.float32), r(9, 16),
          r(16, dtype=torch.float32), 3)),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_kernel_ops_pass_opcheck(case):
    """Each op's schema, fake implementation (shapes, dtypes, strides) and
    dispatch, on its CPU implementation, the kernel's plain version."""
    _, op, args = case
    torch.library.opcheck(op, args)
