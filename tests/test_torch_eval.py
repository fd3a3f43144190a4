"""The eval protocol: objcavit_torch against objcavit_tpu on the CPU.

The 16 metrics, the flip-TTA eval step (tiny GraphBins and AdaBins,
efficientnet-tiny, 16 bins, 64x96: 6 image tokens, so 5 queries reach
conv_out), checkpoints in the reference's Lightning layout, the eval
dataset on files the tests write, the loader and the config rules. Weights
come from the JAX package's ``init`` with every vector redrawn from a
seeded numpy RNG (tests/test_torch_modules.py) and reach the port through
``utils/convert.py``; inputs are numpy arrays from seeded RNGs handed to
both sides. The JAX eval step is compiled once per model for the file.
Each test states its tolerance.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.config import check_and_validate_args as jax_check_and_validate_args
from objcavit_tpu.config import get_latest_checkpoint as jax_get_latest_checkpoint
from objcavit_tpu.config import load_args as jax_load_args
from objcavit_tpu.data.dataset import DepthDataset as JaxDepthDataset
from objcavit_tpu.data.dataset import SyntheticDepthDataset as JaxSynthetic
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.metrics import MetricsPreprocessConfig as JaxMPConfig
from objcavit_tpu.metrics import metrics_compute as jax_metrics_compute
from objcavit_tpu.metrics import metrics_init as jax_metrics_init
from objcavit_tpu.metrics import metrics_preprocess as jax_metrics_preprocess
from objcavit_tpu.metrics import metrics_update as jax_metrics_update
from objcavit_tpu.models import AdaBins as JaxAdaBins
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.training.checkpoint import restore_checkpoint as jax_restore_checkpoint
from objcavit_tpu.training.providers import mirror_objects as jax_mirror_objects
from objcavit_tpu.training.steps import make_eval_step as jax_make_eval_step

from objcavit_torch.config import Config, check_and_validate_args, get_latest_checkpoint, load_args
from objcavit_torch.data.dataset import DepthDataset, SyntheticDepthDataset, make_dataset
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.errors import MissingAssetError
from objcavit_torch.language.tokenizer import MissingAssetError as TokenizerMissingAssetError
from objcavit_torch.losses import LossWrapper
from objcavit_torch.metrics import (
    METRIC_NAMES,
    MetricsPreprocessConfig,
    metrics_compute,
    metrics_init,
    metrics_preprocess,
    metrics_update,
)
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.training.checkpoint import CheckpointManager, restore_checkpoint
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.providers import mirror_objects
from objcavit_torch.training.steps import make_eval_step
from objcavit_torch.utils.convert import adabins_state_dict_from_variables, state_dict_from_variables
from objcavit_torch.utils.torch_import import load_torch_checkpoint
from tests.test_torch_modules import _redraw_vectors

ENC, N_BINS, N_QUERIES = "efficientnet-tiny", 16, 5
H, W, B, N = 64, 96, 2, 4
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])
# fp32, port vs JAX through a whole model: the tolerances of
# tests/test_torch_slice.py (depth 1e-3); the loss and the metric state are
# functions of that depth (and of the same GT), held to 1e-3 relative
DEPTH_TOL, STATE_RTOL, STATE_ATOL = 1e-3, 1e-3, 1e-6
# the metrics alone on the same inputs: fp32 sums in another order
METRICS_RTOL = 1e-5


# --------------------------------------------------------------- metrics

def _pred_gt(rng, shape, nonfinite=False):
    pred = rng.uniform(0.05, 9.5, shape).astype(np.float32)
    gt = rng.uniform(0.0, 11.0, shape).astype(np.float32)  # some outside (min, max]
    if nonfinite:
        pred.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    return pred, gt


def _both_metrics(updates):
    """Fold the same (pred, gt, mask) updates into both states; -> (port
    values, JAX values)."""
    state, jstate = metrics_init("cpu"), jax_metrics_init()
    for pred, gt, mask in updates:
        state = metrics_update(state, *map(torch.from_numpy, (pred, gt, mask)))
        jstate = jax_metrics_update(jstate, *map(jnp.asarray, (pred, gt, mask)))
    got = {k: float(v) for k, v in metrics_compute(state).items()}
    want = {k: float(v) for k, v in jax_metrics_compute(jstate).items()}
    return got, want


def _assert_metrics_close(got, want, rtol=METRICS_RTOL):
    assert set(got) == set(want) and len(got) == 16
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)


def test_metrics_two_updates_and_a_zero_valid_image_match_jax():
    """Two updates and one whose mask is empty: the running averages skip
    it (the count stays 2), the pixel family adds nothing; rmse_log_ra has
    no square root. rtol 1e-5."""
    rng = np.random.default_rng(3)
    updates = []
    for _ in range(2):
        pred, gt = _pred_gt(rng, (1, 12, 16, 1))
        updates.append((pred, gt, (gt > MIN_DEPTH) & (gt <= MAX_DEPTH)))
    pred, gt = _pred_gt(rng, (1, 12, 16, 1))
    updates.insert(1, (pred, gt, np.zeros_like(gt, bool)))
    got, want = _both_metrics(updates)
    _assert_metrics_close(got, want)
    state = metrics_init("cpu")
    for u in updates:
        state = metrics_update(state, *map(torch.from_numpy, u))
    assert float(state["abs_rel_ra/count"]) == 2.0
    # the quirk: rmse_log_ra averages the per-image mean squared log error
    per_image = []
    for pred, gt, mask in (updates[0], updates[2]):
        d = (np.log(gt) - np.log(pred))[mask]
        per_image.append(np.mean(d * d))
    np.testing.assert_allclose(got["rmse_log_ra"], np.mean(per_image), rtol=1e-5)


CROPS = {
    "none": dict(),
    "garg": dict(garg_crop=True, dataset="kitti"),
    "eigen-nyu": dict(eigen_crop=True, dataset="nyu"),
    "eigen-kitti": dict(eigen_crop=True, dataset="kitti"),
}


@pytest.mark.parametrize("crop", list(CROPS))
def test_metrics_preprocess_matches_jax(crop):
    """The upsample of a (2, 240, 320, 1) prediction to a 480x640 GT (the
    Eigen-NYU box needs 471x601 at least), the validity mask and each crop;
    then the metrics. The masks are equal; the upsampled predictions and the
    metrics within rtol 1e-5."""
    rng = np.random.default_rng(5)
    pred, _ = _pred_gt(rng, (2, 240, 320, 1))
    _, gt = _pred_gt(rng, (2, 480, 640, 1))
    cfg = dict(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH, **CROPS[crop])
    p, m = metrics_preprocess(torch.from_numpy(pred), torch.from_numpy(gt),
                              MetricsPreprocessConfig(**cfg))
    jp, jm = jax_metrics_preprocess(jnp.asarray(pred), jnp.asarray(gt), JaxMPConfig(**cfg))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    assert m.any() and not m.all()
    got, want = _both_metrics([(p.numpy(), gt, m.numpy())])
    _assert_metrics_close(got, want)


def test_metrics_preprocess_nonfinite_policy_matches_jax_at_the_gt_size():
    """nan -> min_depth, +inf and -inf -> max_depth, on a prediction at the
    GT's size (no upsample), as the JAX package: equal arrays."""
    rng = np.random.default_rng(6)
    pred, gt = _pred_gt(rng, (1, 12, 16, 1), nonfinite=True)
    cfg = dict(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH)
    p, _ = metrics_preprocess(torch.from_numpy(pred), torch.from_numpy(gt),
                              MetricsPreprocessConfig(**cfg))
    jp, _ = jax_metrics_preprocess(jnp.asarray(pred), jnp.asarray(gt), JaxMPConfig(**cfg))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert p.numpy().reshape(-1)[:3].tolist() == [np.float32(MIN_DEPTH), MAX_DEPTH, MAX_DEPTH]


def test_metrics_preprocess_keeps_a_nonfinite_value_local_as_the_reference():
    """A nan or inf in an upsampled prediction touches only the output
    pixels whose taps read it, as in the reference's F.interpolate (to
    rtol 1e-5), then takes the nan/inf policy. The JAX package upsamples
    with interpolation matrices, whose products spread it over whole rows
    and columns (ROADMAP section C)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(7)
    pred, gt = _pred_gt(rng, (1, 24, 32, 1), nonfinite=True)
    gt = np.repeat(np.repeat(gt, 2, 1), 2, 2)
    cfg = MetricsPreprocessConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH)
    p, _ = metrics_preprocess(torch.from_numpy(pred), torch.from_numpy(gt), cfg)
    ref = F.interpolate(torch.from_numpy(pred).permute(0, 3, 1, 2), size=(48, 64),
                        mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    touched = ~torch.isfinite(ref)
    assert 0 < int(touched.sum()) < 40
    want = torch.nan_to_num(ref, nan=MIN_DEPTH, posinf=MAX_DEPTH, neginf=MAX_DEPTH)
    np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    jp, _ = jax_metrics_preprocess(jnp.asarray(pred), jnp.asarray(gt), JaxMPConfig(
        min_depth=MIN_DEPTH, max_depth=MAX_DEPTH))
    spread = np.asarray(jp) != p.numpy()
    assert spread.sum() > 10 * int(touched.sum())


# ------------------------------------------------------------- eval step

def _jax_model(name):
    if name == "graphbins":
        return JaxGraphBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH,
                            max_depth=MAX_DEPTH, pos_strategy="learned_bbox_wh",
                            dims_train=(H, W), dims_test=(H, W))
    return JaxAdaBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH)


@functools.lru_cache(maxsize=None)
def jax_variables(name):
    model = _jax_model(name)
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    if name == "graphbins":
        objs = (jnp.zeros((1, N, 512)), jnp.full((1, N, 4), -1.0),
                jnp.zeros((1, N), bool).at[:, 0].set(True))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), img, *objs)
    else:
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), img)
    variables = _redraw_vectors(jax.tree.map(np.asarray, variables), np.random.default_rng(0))
    conv_out = variables["params"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(10.0)
    return variables


def port_state_dict(name):
    variables = jax_variables(name)
    if name == "graphbins":
        return state_dict_from_variables(variables, ENC)
    return adabins_state_dict_from_variables(variables, ENC)


def port_model(name, state_dict=None):
    cls = GraphBins if name == "graphbins" else AdaBins
    model = cls(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES)
    if state_dict is None:
        state_dict = {k: torch.from_numpy(v) for k, v in port_state_dict(name).items()}
    model.load_state_dict(state_dict)
    return model.eval()


@functools.lru_cache(maxsize=None)
def jax_eval_step(name, flip_tta=True):
    step = jax_make_eval_step(_jax_model(name), JaxLossWrapper(*LOSSES),
                              JaxMPConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH),
                              is_graphbins=name == "graphbins", flip_tta=flip_tta)
    return jax.jit(step)


def _eval_inputs(seed=11):
    """A batch of 2 with the second sample padded, and object slots: 3 valid
    in image 0 (one touching x = 0), the sentinel in image 1."""
    rng = np.random.default_rng(seed)
    batch = {
        "image": (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32),
        "depth": rng.uniform(0.0, 10.5, (B, H, W, 1)).astype(np.float32),
        "sample_valid": np.array([True, False]),
    }
    xywh = np.full((B, N, 4), -1.0, np.float32)
    xywh[0, :3] = np.stack([[0.0, 40.0, 95.0], rng.uniform(0, H, 3),
                            rng.uniform(8, 40, 3), rng.uniform(8, 40, 3)], -1)
    valid = np.zeros((B, N), bool)
    valid[0, :3] = valid[1, 0] = True
    feats = np.zeros((B, N, 512), np.float32)
    feats[0, :3] = rng.standard_normal((3, 512))
    objects = {"features": feats, "xywh": xywh, "valid": valid}
    return batch, objects, mirror_objects(objects, W)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def run_port_eval(model, batch, objects, mirrored, flip_tta=True):
    step = make_eval_step(model, LossWrapper(*LOSSES),
                          MetricsPreprocessConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH),
                          flip_tta=flip_tta)
    objs = (_torch_tree(objects), _torch_tree(mirrored)) if objects is not None else (None, None)
    return step(_torch_tree(batch), *objs, metrics_init("cpu"))


def run_jax_eval(name, variables, batch, objects, mirrored, flip_tta=True):
    out = jax_eval_step(name, flip_tta)(
        variables["params"], variables["batch_stats"], batch, objects, mirrored,
        jax_metrics_init())
    return jax.tree.map(np.asarray, out)


def _assert_eval_close(got, want):
    (state, loss, depth), (jstate, jloss, jdepth) = got, want
    np.testing.assert_allclose(depth.numpy(), jdepth, rtol=DEPTH_TOL, atol=DEPTH_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STATE_RTOL)
    assert set(state) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(float(state[k]), float(jstate[k]), rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=k)


def test_mirror_objects_matches_jax():
    """x -> W - x on valid slots with x >= 0; padded slots keep -1."""
    _, objects, mirrored = _eval_inputs()
    want = jax_mirror_objects(objects, W)
    for k in objects:
        np.testing.assert_array_equal(mirrored[k], want[k], err_msg=k)
    assert mirrored["xywh"][0, 0, 0] == W and (mirrored["xywh"][0, 3] == -1).all()
    assert (mirrored["xywh"][1] == -1).all()


@pytest.mark.parametrize("name", ["graphbins", "adabins"])
def test_eval_step_matches_jax(name):
    """One flip-TTA eval step with a padded second sample: the TTA depth, the
    loss over the valid sample and all 32 entries of the metric state, port
    vs JAX (depth rtol = atol = 1e-3; loss and state rtol 1e-3). The padded
    sample adds no pixel to the counts."""
    batch, objects, mirrored = _eval_inputs()
    if name == "adabins":
        objects = mirrored = None
    got = run_port_eval(port_model(name), batch, objects, mirrored)
    want = run_jax_eval(name, jax_variables(name), batch, objects, mirrored)
    _assert_eval_close(got, want)
    n_valid = ((batch["depth"][0] > MIN_DEPTH) & (batch["depth"][0] <= MAX_DEPTH)).sum()
    assert float(got[0]["abs_rel/count"]) == n_valid and float(got[0]["abs_rel_ra/count"]) == 1


def test_batched_flip_tta_equals_two_sequential_passes():
    """The port's 2B forward against the reference's two passes
    (GraphBinsLM.py:154-183): forward, mirrored forward un-flipped, each
    clamped, averaged. rtol = atol = 1e-5 (batch composition changes only
    the order of fp32 sums)."""
    batch, objects, mirrored = _eval_inputs()
    model = port_model("graphbins")
    _, _, got = run_port_eval(model, batch, objects, mirrored)
    t = _torch_tree({"b": batch, "o": objects, "m": mirrored})
    with torch.no_grad():
        def fwd(image, objs):
            return model(image, objs["features"], objs["xywh"], objs["valid"])["depth_pred"]

        pred = fwd(t["b"]["image"], t["o"]).clamp(MIN_DEPTH, MAX_DEPTH)
        pred_m = fwd(t["b"]["image"].flip(2), t["m"]).flip(2).clamp(MIN_DEPTH, MAX_DEPTH)
    np.testing.assert_allclose(got.numpy(), (0.5 * (pred + pred_m)).numpy(), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------- checkpoints

def _write_reference_ckpt(path, name="graphbins"):
    """A reference-layout Lightning .ckpt: 'state_dict' under 'model.'
    (here from JAX variables), a frozen detector entry the depth model does
    not load, and pickled hyperparameters."""
    sd = {f"model.{k}": torch.from_numpy(v) for k, v in port_state_dict(name).items()}
    sd["model.detector.model.0.conv.weight"] = torch.zeros(2, 3, 1, 1)
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {"args": {"lr": 1e-4}}}, path)


def _jax_args(name="graphbins"):
    return JaxConfig({"model": {"name": name}, name: {
        "encoder_name": ENC, "objcavit": {"positional_embedding_strategy": "learned_bbox_wh"}}})


def test_reference_ckpt_loads_into_port_and_jax_with_the_same_forward(tmp_path):
    """One .ckpt read by the port (load_state_dict, no conversion tree) and
    by JAX's restore_checkpoint (its conversion tree): the same eval step,
    at the eval-step test's tolerances."""
    path = str(tmp_path / "ref.ckpt")
    _write_reference_ckpt(path)
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES)
    ckpt = load_torch_checkpoint(path, model)
    assert ckpt["epoch"] == 3
    variables = jax_restore_checkpoint(path, args=_jax_args())
    batch, objects, mirrored = _eval_inputs(seed=12)
    _assert_eval_close(run_port_eval(model.eval(), batch, objects, mirrored),
                       run_jax_eval("graphbins", variables, batch, objects, mirrored))


def test_ckpt_of_another_architecture_fails_the_load(tmp_path):
    path = str(tmp_path / "adabins.ckpt")
    _write_reference_ckpt(path, name="adabins")
    with pytest.raises(KeyError, match="missing"):
        load_torch_checkpoint(path, GraphBins(encoder_name=ENC, n_bins=N_BINS,
                                              n_queries=N_QUERIES))


def test_reference_bn_without_num_batches_tracked_loads(tmp_path):
    """A reference checkpoint may lack num_batches_tracked; eval never
    reads it, so the load goes on and every other entry lands."""
    sd = {f"model.{k}": torch.from_numpy(v) for k, v in port_state_dict("adabins").items()
          if not k.endswith("num_batches_tracked")}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd}, path)
    model = AdaBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES)
    load_torch_checkpoint(path, model)
    for k, v in model.state_dict().items():
        if f"model.{k}" in sd:
            assert torch.equal(v, sd[f"model.{k}"]), k


def test_checkpoint_manager_round_trips_and_keeps_the_best_across_a_restart(tmp_path):
    """last.ckpt and best.ckpt hold the model, the optimizer and the
    scheduler; restore_checkpoint puts them back bit for bit. A new manager
    on the same run dir reads the best abs_rel from meta.json, so a worse
    save keeps best.ckpt. Both packages' get_latest_checkpoint find
    last.ckpt, and JAX restores the port's checkpoint."""
    run = tmp_path / "runs" / "tiny" / "version_0"
    model = port_model("graphbins")
    optimizer, scheduler = build_optimizer(model, 1e-3, 0.1, 10)
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, 0.01 * (i % 7 - 3))
    optimizer.step()
    scheduler.step()
    manager = CheckpointManager(str(run))
    manager.save(model, optimizer, scheduler, step=7, abs_rel=0.25)
    best_bytes = (run / "checkpoints" / "best.ckpt").read_bytes()

    model2 = port_model("graphbins")
    opt2, sched2 = build_optimizer(model2, 1e-3, 0.1, 10)
    assert restore_checkpoint(str(run / "checkpoints" / "last.ckpt"), model2, opt2, sched2) == 7
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(v, v2), k
    assert sched2.state_dict() == scheduler.state_dict()
    s1, s2 = optimizer.state_dict()["state"], opt2.state_dict()["state"]
    assert all(torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"]) for i in s1)

    restarted = CheckpointManager(str(run))
    assert restarted.best_metric == 0.25
    restarted.save(model2, step=8, abs_rel=0.5)
    assert (run / "checkpoints" / "best.ckpt").read_bytes() == best_bytes
    assert json.loads((run / "checkpoints" / "meta.json").read_text()) == {"best_metric": 0.25}
    restarted.save(model2, step=9, abs_rel=0.125)
    assert restarted.best_metric == 0.125

    args = Config({"paths": {"run_dir": str(tmp_path / "runs")}, "basic": {"name": "tiny"}})
    jargs = JaxConfig(args.to_dict())
    assert get_latest_checkpoint(args) == jax_get_latest_checkpoint(jargs) == str(
        run / "checkpoints" / "last.ckpt")
    variables = jax_restore_checkpoint(get_latest_checkpoint(args), args=_jax_args())
    got = state_dict_from_variables(variables, ENC)
    for k, v in model2.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_hparams_save_reads_back_through_the_unwrap(tmp_path):
    args = Config({"basic": {"name": "x", "dataset": "nyu"}, "loss": {"names": ["silog"]}})
    CheckpointManager(str(tmp_path)).save_hparams(args)
    back = load_args(str(tmp_path / "hparams.yaml"))
    assert back.basic.name == "x" and back.loss.names == ["silog"]
    assert jax_load_args(str(tmp_path / "hparams.yaml")).to_dict() == back.to_dict()


# --------------------------------------------------------------- data

def _data_args(root, dataset, split_lines, **dcfg):
    split = root / f"{dataset}_split.txt"
    split.write_text("\n".join(split_lines) + "\n")
    base = {"nyu": {"base_path": "nyu", "eval_path": "test", "image_norm_factor": 255.0,
                    "depth_norm_factor": 1000.0, "do_kb_crop": False},
            "kitti": {"base_path": "kitti", "data_path": "raw", "gt_path": "gt",
                      "image_norm_factor": 255.0, "depth_norm_factor": 256.0,
                      "do_kb_crop": True}}[dataset]
    cfg = {"basic": {"dataset": dataset}, "paths": {"data_dir": str(root / "data")},
           dataset: {**base, "filenames_file_eval": str(split), "min_depth": 0.001,
                     "max_depth": 80.0, "dimensions_train": [64, 96],
                     "dimensions_test": [64, 96], **dcfg}}
    return cfg


def _write_pair(image_path, depth_path, h, w, rng):
    os.makedirs(os.path.dirname(image_path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(image_path)
    if depth_path is not None:
        os.makedirs(os.path.dirname(depth_path), exist_ok=True)
        Image.fromarray(rng.integers(1, 20000, (h, w), dtype=np.uint16)).save(depth_path)


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_eval_dataset_on_disk_matches_jax(tmp_path, dataset):
    """Split lines with leading slashes, JPG images and 16-bit PNG depths
    the test writes. KITTI: its second line has no GT file and is dropped
    (len() shrinks from 3 to 2), and the kb crop cuts 375x1242 to 352x1216.
    Every sample equals the JAX package's, value for value."""
    rng = np.random.default_rng(2)
    data = tmp_path / "data"
    if dataset == "nyu":
        lines = ["/bathroom/rgb_00045.jpg /bathroom/sync_depth_00045.png 518.8579",
                 "kitchen/rgb_00001.jpg kitchen/sync_depth_00001.png 518.8579"]
        for ln in lines:
            img, dep = (p.lstrip("/") for p in ln.split()[:2])
            _write_pair(str(data / "nyu" / "test" / img), str(data / "nyu" / "test" / dep),
                        48, 64, rng)
        hw = (48, 64)
    else:
        lines = [f"2011_09_26/d/image_02/data/{i:010d}.png "
                 f"2011_09_26_drive/proj_depth/groundtruth/image_02/{i:010d}.png 721.5377"
                 for i in range(3)]
        for i, ln in enumerate(lines):
            img, dep = ln.split()[:2]
            _write_pair(str(data / "kitti" / "raw" / img),
                        None if i == 1 else str(data / "kitti" / "gt" / dep), 375, 1242, rng)
        hw = (352, 1216)
    cfg = _data_args(tmp_path, dataset, lines)
    ds, jds = DepthDataset(Config(cfg), "online_eval"), JaxDepthDataset(JaxConfig(cfg),
                                                                          "online_eval")
    assert isinstance(make_dataset(Config(cfg), "online_eval"), DepthDataset)
    n = len(lines) - (dataset == "kitti")
    samples = [ds.get(i, np.random.default_rng(0)) for i in range(n)]
    want = [jds.get(i, np.random.default_rng(0)) for i in range(n)]
    assert len(ds) == len(jds) == n
    for s, w in zip(samples, want):
        assert s["image"].shape == (*hw, 3) and s["depth"].shape == (*hw, 1)
        for k in s:
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
    # train mode reads the train split from the train path (its samples:
    # tests/test_torch_train_data.py); a train frame without GT raises
    train_cfg = copy.deepcopy(cfg)
    train_cfg[dataset].update(filenames_file_train=cfg[dataset]["filenames_file_eval"],
                              train_path="test")
    train = DepthDataset(Config(train_cfg), "train")
    assert train.filenames == lines and train.data_path == ds.data_path
    if dataset == "kitti":
        with pytest.raises(FileNotFoundError, match="missing train GT"):
            train.get(1, np.random.default_rng(0))


def test_synthetic_dataset_matches_jax():
    """Without the data root: 16 synthetic eval samples, seeded by index."""
    cfg = {
        "basic": {"dataset": "nyu"}, "paths": {"data_dir": "/nonexistent"},
        "nyu": {"filenames_file_eval": "/nonexistent", "base_path": "nyu", "min_depth": 0.001,
                "max_depth": 10.0, "do_kb_crop": False, "dimensions_train": [64, 96],
                "dimensions_test": [48, 80]}}
    ds = make_dataset(Config(cfg), "online_eval")
    assert isinstance(ds, SyntheticDepthDataset) and len(ds) == 16
    jds = JaxSynthetic(JaxConfig(cfg), "online_eval", length=16)
    for i in (0, 15):
        s, w = ds.get(i, None), jds.get(i, None)
        assert s["image"].shape == (48, 80, 3)
        for k in s:
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        return {"image": np.full((2, 3, 3), idx, np.float32),
                "depth": np.full((2, 3, 1), idx, np.float32), "focal": 1.0,
                "image_path": f"{idx}.jpg", "depth_path": f"{idx}.png"}


@pytest.mark.parametrize("synchronous", [True, False])
def test_loader_pads_the_final_batch_and_routes_host_only_keys(synchronous):
    """5 samples at batch 2: in order, the last batch padded with sample 0
    and marked in sample_valid; the hook's '_' keys go to meta, its other
    entries to the batch as tensors on the device."""
    def hook(batch):
        return {"objects": {"valid": batch["image"][:, 0, 0, :1] > 0}, "_annot": ["a"]}

    loader = DeviceLoader(_Indexed(5), 2, "cpu", host_hook=hook, synchronous=synchronous)
    out = list(loader)
    assert len(out) == len(loader) == 3
    firsts = [b["image"][:, 0, 0, 0].tolist() for b, _ in out]
    assert firsts == [[0, 1], [2, 3], [4, 0]]
    assert out[2][0]["sample_valid"].tolist() == [True, False]
    assert out[0][0]["objects"]["valid"].dtype == torch.bool
    assert out[2][1] == {"focal": [1.0, 1.0], "image_path": ["4.jpg", "0.jpg"],
                         "depth_path": ["4.png", "0.png"], "_annot": ["a"]}


def test_loader_worker_ends_when_the_consumer_stops_early():
    import threading

    before = set(threading.enumerate())
    for i, _ in enumerate(DeviceLoader(_Indexed(50), 1, "cpu")):
        if i == 1:
            break
    assert [t for t in threading.enumerate() if t not in before] == []


def test_loader_and_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DeviceLoader(_Indexed(1), 1)


# ------------------------------------------------------------- config

def test_config_rules_match_jax(tmp_path):
    """check_and_validate_args on a -i run: the name from the file name, the
    newest *last.ckpt under the run dir, the output dirs, and the nyu
    section taken from basicParams.yaml; both packages give the same tree."""
    import yaml

    ckpt = tmp_path / "runs" / "cfgname" / "version_0" / "checkpoints" / "last.ckpt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")
    cfg = {"basic": {"dataset": "nyu"}, "paths": {"run_dir": str(tmp_path / "runs")},
           "loss": {}, "hardware": {}, "nyu": {"eigen_crop": False}}
    path = tmp_path / "cfgname.yaml"
    path.write_text(yaml.safe_dump({"args": cfg}))
    basic = tmp_path / "basic.yaml"
    basic.write_text(yaml.safe_dump({"nyu": {"eigen_crop": True}, "kitti": {"garg_crop": True}}))
    got = check_and_validate_args(load_args(str(path), inference=True), str(basic))
    want = jax_check_and_validate_args(jax_load_args(str(path), inference=True), str(basic))
    assert got.to_dict() == want.to_dict()
    assert got.basic.val_checkpoint == str(ckpt) and got.nyu.eigen_crop is True
    assert got.predict_output_dir == str(tmp_path / "runs" / "cfgname" / "version_0" /
                                         "predict_output")
    assert os.path.isdir(got.predict_output_dir)


def test_missing_asset_error_has_one_home():
    assert MissingAssetError is TokenizerMissingAssetError
    assert issubclass(MissingAssetError, FileNotFoundError)


# ------------------------------------------------------ losses, figures

def test_loss_wrapper_from_args_matches_jax():
    args = Config({"loss": {"names": ["silog", "bins_chamfer"], "coeffs": [1, 0.1]}})
    got, want = LossWrapper.from_args(args), JaxLossWrapper.from_args(JaxConfig(args.to_dict()))
    assert (got.names, got.coeffs) == (want.names, want.coeffs) == (("silog", "bins_chamfer"),
                                                                      (1.0, 0.1))


def test_annotate_image_matches_jax():
    """Boxes (one past the border, one invalid) and masks on a 40x56 image:
    the same array as the JAX package's numpy code."""
    from objcavit_tpu.utils.annotate import annotate_image as jax_annotate_image

    from objcavit_torch.utils.annotate import annotate_image

    rng = np.random.default_rng(9)
    image = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    xywh = np.array([[10, 12, 14, 9], [50, 35, 30, 20], [20, 20, 5, 5]], np.float32)
    classes, valid = np.array([3, 14, 1]), np.array([True, True, False])
    masks = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    got = annotate_image(image, xywh, classes, valid, masks=masks)
    np.testing.assert_array_equal(got, jax_annotate_image(image, xywh, classes, valid, masks=masks))
    assert not np.array_equal(got, image)


def test_depth_colors_follow_inferno_r_and_blank_the_gt_below_range():
    """The PNG colour map: within 0.034 of matplotlib's 'inferno_r' in every
    channel; GT pixels below min_depth (and nan) white."""
    import matplotlib

    from objcavit_torch.utils.figures import depth_colors

    t = np.linspace(0.0, 1.0, 256)
    want = matplotlib.colormaps["inferno_r"](t)[:, :3]
    np.testing.assert_allclose(depth_colors(t[None], 0.0, 1.0, under_white=False)[0], want,
                               atol=0.034)
    gt = np.array([[0.0005, np.nan, 5.0]])
    rgb = depth_colors(gt, 0.001, 10.0, under_white=True)
    assert (rgb[0, :2] == 1.0).all() and not (rgb[0, 2] == 1.0).all()
