"""The -v/-i entry points: objcavit_torch.cli and Trainer against objcavit_tpu's
Trainer on the CPU.

A tiny config in the style of tests/test_train_loop.py (GraphBins,
efficientnet-tiny, 16 bins, 64x96, the zeros provider with 3 slots, the
synthetic NYU split: 16 images) and one reference-layout ``.ckpt`` written
from JAX variables (tests/test_torch_eval.py) feed both packages: the port
through ``cli.main([...], device="cpu")``, the JAX package through the
steps of its own CLI (``load_args``, ``check_and_validate_args``,
``Trainer``). Each test states its tolerance.
"""

import csv
import os
import re

import numpy as np
import pytest
import torch
import yaml

from objcavit_tpu.config import check_and_validate_args as jax_check_and_validate_args
from objcavit_tpu.config import load_args as jax_load_args
from objcavit_tpu.training.loop import Trainer as JaxTrainer

from objcavit_torch import cli
from objcavit_torch.errors import MissingAssetError
from objcavit_torch.language.provider import YoloClipObjectProvider
from objcavit_torch.metrics import METRIC_NAMES
from objcavit_torch.training.loop import Trainer
from tests.test_torch_eval import _write_reference_ckpt

# tests/test_eval_protocol.py's pinned column order of prediction_metrics.csv
CSV_HEADER = (["", "batch_idx", "image_filename", "depth_gt_filename"]
              + list(METRIC_NAMES) + [f"{k}_ra" for k in METRIC_NAMES] + ["loss"])
IMAGE_FILES = ("im.png", "depth_gt.png", "depth_pred.png", "depth_gt_raw.npy",
               "depth_pred_raw.npy")
# fp32, port vs JAX over 16 flip-TTA images: the eval step agrees to ~1e-5 m
# in depth (tests/test_torch_eval.py), so the metrics, sums over the same
# pixels, agree to 1e-4 relative
METRICS_RTOL = 1e-4

TINY = {
    "basic": {"dataset": "nyu", "batch_size": 8, "max_epochs": 1, "name": "tiny"},
    "optimizer": {"name": "adamw", "lr": 3.57e-4, "wd": 0.1},
    "model": {"name": "graphbins"},
    "graphbins": {
        "n_bins": 16, "encoder_name": "efficientnet-tiny", "yolov7_chkpt": "none",
        "objcavit": {"positional_embedding_strategy": "learned_bbox_wh", "embedding_dim": 128,
                     "obj_language_strategy": "none",
                     "language_embedding_strategy": "control_obj_zeros_512"},
    },
    "yolov7seg": {"conf_thres": 0.25, "iou_thres": 0.45, "max_det": 1000,
                  "agnostic_nms": False},
    "loss": {"names": ["silog", "bins_chamfer"], "coeffs": [1, 0.1]},
    "paths": {"data_dir": "/nonexistent", "run_dir": None},  # -> synthetic data
    "nyu": {
        "filenames_file_train": "/nonexistent", "filenames_file_eval": "/nonexistent",
        "base_path": "nyu", "train_path": "sync", "eval_path": "t",
        "image_norm_factor": 255.0, "depth_norm_factor": 1000.0, "min_depth": 0.001,
        "max_depth": 10, "eigen_crop": False, "garg_crop": False, "do_kb_crop": False,
        "do_random_rotate": True, "degree": 2.5, "dimensions_train": [64, 96],
        "dimensions_test": [64, 96],
    },
    "hardware": {"num_workers": 0},
    "objects_max": 3,
}


def _config(tmp_path, name="tiny", ckpt=True, **overrides) -> str:
    """A params file under tmp_path (no basicParams.yaml beside it); with
    ``ckpt`` a reference .ckpt at runs/<name>/version_0/checkpoints/last.ckpt,
    which the eval rules find."""
    cfg = yaml.safe_load(yaml.safe_dump(TINY))
    cfg["paths"]["run_dir"] = str(tmp_path / "runs")
    cfg["basic"]["name"] = name
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    if ckpt:
        path = tmp_path / "runs" / name / "version_0" / "checkpoints" / "last.ckpt"
        path.parent.mkdir(parents=True, exist_ok=True)
        _write_reference_ckpt(str(path))
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return str(cfg_path)


def _jax_run(cfg_path, **flags):
    """The JAX package's CLI steps, as objcavit_tpu/cli.py runs them."""
    args = jax_load_args(cfg_path, **{"debug": False, "log_debug": False, "validate": False,
                                      "inference": False, **flags})
    args = jax_check_and_validate_args(args, basic_params_path="/nonexistent")
    trainer = JaxTrainer(args)
    return trainer.validate() if args.get("validate") else trainer.predict()


def _read_validation_output(path):
    text = open(path).read()
    numbers = [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]
    return text, numbers


def _shape_of(text):
    return re.sub(r"-?\d+\.\d+(?:e-?\d+)?", "#", text)


def test_validate_through_the_cli_matches_jax(tmp_path):
    """-v on the 16 synthetic images, flip-TTA at batch size 1, from the
    same .ckpt: validation_output.txt has JAX's layout character for
    character but the numbers, and its 16 metrics (each printed twice: the
    dict and the log block) agree within rtol 1e-4."""
    cfg_path = _config(tmp_path)
    out = tmp_path / "runs" / "tiny" / "version_0" / "validation_output.txt"
    got = cli.main(["-c", cfg_path, "-v"], device="cpu")
    text, numbers = _read_validation_output(out)
    os.rename(out, str(out) + ".port")
    want = _jax_run(cfg_path, validate=True)
    jtext, jnumbers = _read_validation_output(out)
    assert _shape_of(text) == _shape_of(jtext)
    assert text.startswith("tiny[{'abs_rel': ") and "==#==" in text
    assert len(numbers) == len(jnumbers) == 32
    np.testing.assert_allclose(numbers, jnumbers, rtol=METRICS_RTOL)
    assert set(got) == set(want) and len(got) == 16
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRICS_RTOL, err_msg=k)


def test_predict_through_the_cli_matches_jax(tmp_path):
    """-i --debug (one image, no TTA): prediction_metrics.csv has the pinned
    header; its metrics agree with JAX's within rtol 1e-4; the per-image
    files have JAX's names, and the raw depths JAX's values within 1e-3 m."""
    cfg_path = _config(tmp_path)
    out = tmp_path / "runs" / "tiny" / "version_0" / "predict_output"
    rows = cli.main(["-c", cfg_path, "-i", "--debug"], device="cpu")
    assert len(rows) == 1
    port_files = sorted(os.listdir(out))
    with open(out / "prediction_metrics.csv", newline="") as f:
        got = list(csv.reader(f))
    pred = np.load(out / "0_depth_pred_raw.npy")
    for name in port_files:
        os.remove(out / name)
    _jax_run(cfg_path, inference=True, debug=True)
    with open(out / "prediction_metrics.csv", newline="") as f:
        want = list(csv.reader(f))
    assert got[0] == want[0] == CSV_HEADER
    assert got[1][:4] == want[1][:4] == ["0", "0", "synthetic/0.jpg", "synthetic/0.png"]
    np.testing.assert_allclose([float(x) for x in got[1][4:]], [float(x) for x in want[1][4:]],
                               rtol=METRICS_RTOL)
    assert port_files == sorted(os.listdir(out)) == sorted(
        ["prediction_metrics.csv"] + [f"0_{k}" for k in IMAGE_FILES])
    np.testing.assert_allclose(pred, np.load(out / "0_depth_pred_raw.npy"), atol=1e-3)


def test_predict_writes_every_image_and_bf16_validate_stays_near_fp32(tmp_path):
    """-i over the 16 images writes 16 rows and 16 x 5 files; -v --bf16 on
    the CPU (the kernels' plain versions) lands within 0.05 relative of fp32
    on abs_rel, rmse and d1 (bf16 keeps 8 bits through the network)."""
    cfg_path = _config(tmp_path)
    rows = cli.main(["-c", cfg_path, "-i"], device="cpu")
    out = tmp_path / "runs" / "tiny" / "version_0" / "predict_output"
    assert [r["batch_idx"] for r in rows] == list(range(16))
    assert len(os.listdir(out)) == 1 + 16 * len(IMAGE_FILES)
    fp32 = cli.main(["-c", cfg_path, "-v"], device="cpu")
    bf16 = cli.main(["-c", cfg_path, "-v", "--bf16"], device="cpu")
    for k in ("abs_rel", "rmse", "acc_1"):
        assert np.isfinite(bf16[k])
        np.testing.assert_allclose(bf16[k], fp32[k], rtol=0.05, err_msg=k)


def test_without_a_checkpoint_the_model_keeps_a_seeded_fresh_init(tmp_path):
    """A configured checkpoint that is not there: a fresh init from the
    seeded generator, the same on every run."""
    cfg_path = _config(tmp_path, ckpt=False, **{"basic.val_checkpoint": str(tmp_path / "x.ckpt")})
    a = cli.main(["-c", cfg_path, "-v", "--debug"], device="cpu")
    b = cli.main(["-c", cfg_path, "-v", "--debug"], device="cpu")
    assert a == b and np.isfinite(a["abs_rel"])


def test_clip_config_without_assets_fails_fast(tmp_path):
    cfg_path = _config(tmp_path, **{
        "graphbins.objcavit.language_embedding_strategy": "clip"})
    with pytest.raises(MissingAssetError, match="CLIP checkpoint"):
        cli.main(["-c", cfg_path, "-v"], device="cpu")


def test_clip_config_with_a_release_file_waits_for_its_loader(tmp_path):
    """Release files that exist: the port has no loader for them yet and
    says so, with every asset present, and under --debug with the detector's
    alone."""
    assets = {}
    for key, name in (("clip_checkpoint", "ViT-B-32.pt"), ("clip_bpe_path", "bpe.txt.gz"),
                      ("graphbins.yolov7_chkpt", "yolov7-seg.pt")):
        (tmp_path / name).write_bytes(b"")
        assets[key] = str(tmp_path / name)
    clip = {"graphbins.objcavit.language_embedding_strategy": "clip"}
    with pytest.raises(NotImplementedError, match="A.3a"):
        cli.main(["-c", _config(tmp_path, **clip, **assets), "-v"], device="cpu")
    yolo_only = {"graphbins.yolov7_chkpt": assets["graphbins.yolov7_chkpt"]}
    with pytest.raises(NotImplementedError, match="YOLOv7-seg.*A.3a"):
        cli.main(["-c", _config(tmp_path, **clip, **yolo_only), "-v", "--debug"], device="cpu")


def test_clip_config_under_debug_runs_random_towers(tmp_path):
    """--debug on a 'clip' config: a random YOLOv7-seg and CLIP text tower
    from seeds, the provider re-detects the mirrored image, one image is
    validated and one predicted, with finite metrics and a detections figure."""
    cfg_path = _config(tmp_path, **{
        "graphbins.objcavit.language_embedding_strategy": "clip",
        "graphbins.objcavit.obj_language_strategy": "name_synset_def_wn_rel_sz"})
    args = cli.load_args(cfg_path, debug=True, validate=True)
    args = cli.check_and_validate_args(args, "/nonexistent")
    trainer = Trainer(args, device="cpu")
    assert isinstance(trainer.provider, YoloClipObjectProvider)
    assert trainer.provider.recompute_on_mirror
    metrics = trainer.validate()
    assert all(np.isfinite(v) for v in metrics.values())
    rows = cli.main(["-c", cfg_path, "-i", "--debug"], device="cpu")
    out = tmp_path / "runs" / "tiny" / "version_0" / "predict_output"
    assert len(rows) == 1 and os.path.exists(out / "0_dets.png")


def test_a_run_without_v_or_i_reaches_fit_which_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="A.3d"):
        cli.main(["-c", _config(tmp_path, ckpt=False)], device="cpu")


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["-c", _config(tmp_path), "-v"])
