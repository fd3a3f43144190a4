"""Slice 14, SWA: objcavit_torch's SWA fit, its BN refresh and its checkpoint
against objcavit_tpu's on the CPU.

The fit is tests/test_torch_fit.py's, with ``optimizer.use_swa: true``,
10 epochs of one step (batch size 64 over the 64 synthetic train images,
validated every 5): the LR switches at step 8 (0.8 of 10 epochs), epochs 8
and 9 are averaged, and the BN statistics of the average are refreshed on
one train batch. The tolerances are tests/test_torch_fit.py's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.training.steps import make_bn_refresh_step as jax_make_bn_refresh_step

from objcavit_torch import cli
from objcavit_torch.data.dataset import make_dataset
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.losses import LossWrapper
from objcavit_torch.training import loop
from objcavit_torch.training.checkpoint import CheckpointManager
from objcavit_torch.training.steps import (
    cumulative_bn_stats,
    make_bn_refresh_step,
    make_train_loss_fn,
)
from objcavit_torch.utils.convert import state_dict_from_variables
from tests.test_torch_eval import ENC, H, W, _jax_model, jax_variables, port_model
from tests.test_torch_fit import (  # noqa: F401  (one_torch_thread: a fixture)
    check_fit_parity,
    one_torch_thread,
    run_both_fits,
    write_config,
)

# fp32, one train-mode forward's BN statistics from the same weights (the
# train step's one-step statistics agree to 1e-5, tests/test_torch_train.py)
REFRESH_RTOL = 1e-5


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_tb_writer", lambda run_dir: None)  # tests/test_torch_fit.py's
        return run_both_fits(tmp_path_factory.mktemp("swa"), **{
            "basic.max_epochs": 10, "basic.batch_size": 64, "basic.validate_every": 5,
            "optimizer.use_swa": True})


def test_swa_fit_matches_jax(fits):
    """10 steps with the SWA switch at step 8, the average of epochs 8 and
    9, and its refreshed BN statistics: per-step losses, the final (averaged)
    parameters and the refreshed statistics, and the last metrics against
    JAX's fit."""
    assert len(fits["port_losses"]) == len(fits["jax_losses"]) == 10
    # the LR of updates 8 and 9: SWALR's cos anneal toward 1e-2 from the switch
    assert fits["port_lrs"][8] < fits["port_lrs"][9] < 1e-2
    check_fit_parity(fits, averaged_after=(9, 10))


def test_swa_fit_persists_the_average_and_saves_it_with_refreshed_stats(fits):
    """meta.json counts 2 averaged epochs at step 10; swa.ckpt holds the
    average, and the final last.ckpt the averaged weights with the
    refreshed BN statistics, i.e. the model the fit returned."""
    ckpt_dir = fits["run_dir"] / "port" / "version_0" / "checkpoints"
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    assert (meta["swa_count"], meta["swa_step"]) == (2, 10)
    average = CheckpointManager(str(ckpt_dir.parent)).restore_swa(max_step=10)[0]
    last = torch.load(ckpt_dir / "last.ckpt", weights_only=False)
    assert last["global_step"] == 10
    for k, v in fits["port_state"].items():
        np.testing.assert_array_equal(last["state_dict"][f"model.{k}"].numpy(), v, err_msg=k)
        if k in average:
            np.testing.assert_array_equal(average[k].numpy(), v, err_msg=k)


def test_restore_swa_drops_an_average_ahead_of_the_state(tmp_path):
    """save_swa persists the average, its count and step; a new manager on
    the run dir restores them at a state at or past that step, and drops
    them (None) at an earlier one: the epochs after it would count twice."""
    avg = {"w": torch.arange(3.0), "b": torch.ones(2)}
    CheckpointManager(str(tmp_path)).save_swa(avg, 2, step=16)
    manager = CheckpointManager(str(tmp_path))
    restored, count = manager.restore_swa(max_step=16)
    assert count == 2 and set(restored) == {"w", "b"}
    assert torch.equal(restored["w"], avg["w"])
    assert manager.restore_swa(max_step=24)[1] == 2
    assert manager.restore_swa(max_step=8) is None
    assert CheckpointManager(str(tmp_path / "other")).restore_swa(max_step=100) is None


def _refresh_batches():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(2):
        valid = np.zeros((2, 4), bool)
        valid[:, :2] = True
        out.append(({"image": rng.standard_normal((2, H, W, 3)).astype(np.float32),
                     "depth": rng.uniform(0.01, 9.0, (2, H, W, 1)).astype(np.float32)},
                    {"features": rng.standard_normal((2, 4, 512)).astype(np.float32),
                     "xywh": rng.uniform(0, 60, (2, 4, 4)).astype(np.float32),
                     "valid": valid}))
    return out


def _dropout_off(model):
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return model


def test_bn_refresh_matches_jax():
    """Two batches through the port's refresh (the BNs' cumulative
    average) against JAX's make_bn_refresh_step (each batch's statistics
    from zeroed ones, averaged equally): every BN's mean and unbiased
    variance within REFRESH_RTOL, dropout 0 on both sides."""
    batches = _refresh_batches()
    variables = jax_variables("graphbins")
    refresh = jax.jit(jax_make_bn_refresh_step(_jax_model("graphbins").clone(dropout_rate=0.0),
                                               False, True))
    zeros = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
    stats = [refresh(variables["params"], zeros, jax.tree.map(jnp.asarray, b),
                     jax.tree.map(jnp.asarray, o), jax.random.PRNGKey(0)) for b, o in batches]
    mean = jax.tree.map(lambda a, b: np.asarray((a + b) / 2), *stats)
    want = state_dict_from_variables({"params": variables["params"], "batch_stats": mean}, ENC)

    model = _dropout_off(port_model("graphbins"))
    step = make_bn_refresh_step(model, augment_on_device=False)
    with cumulative_bn_stats(model) as n_bn:
        for b, o in batches:
            step({k: torch.from_numpy(v) for k, v in b.items()},
                 {k: torch.from_numpy(v) for k, v in o.items()})
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * n_bn > 0
    for k in keys:
        w = np.asarray(want[k], np.float64)
        err = np.linalg.norm(got[k].numpy() - w) / np.linalg.norm(w)
        assert err <= REFRESH_RTOL, (k, err)
    assert all(m.momentum == 0.1 for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_bn_refresh_on_the_augment_path_draws_as_the_train_step():
    """With device augmentation, a refresh batch sees the train step's
    forward: the same generator seed gives the same BN statistics as the
    train loss's forward, bit for bit (augmentation, then dropout)."""
    batch, objects = _refresh_batches()[0]
    batch = {"image": torch.from_numpy(np.clip(batch["image"], 0, 1)),
             "depth": torch.from_numpy(batch["depth"])}
    objects = {k: torch.from_numpy(v) for k, v in objects.items()}
    refreshed, trained = port_model("graphbins"), port_model("graphbins")
    with cumulative_bn_stats(refreshed):
        make_bn_refresh_step(refreshed, augment_on_device=True)(
            batch, objects, torch.Generator().manual_seed(7))
    loss_fn = make_train_loss_fn(trained, LossWrapper(["silog"], [1.0]), 0.001,
                                 augment_on_device=True)
    with cumulative_bn_stats(trained), torch.no_grad():
        loss_fn(batch, objects, torch.Generator().manual_seed(7))
    for (k, a), b in zip(refreshed.state_dict().items(), trained.state_dict().values()):
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(a, b), k


def test_bn_refresh_skips_a_padded_final_batch(tmp_path, monkeypatch):
    """64 train images at batch size 24: the third batch holds 16 real
    samples and 8 wrapped ones, and the refresh skips it (its wrapped
    samples would count twice), decided from the loader's sizes."""
    args = cli.check_and_validate_args(cli.load_args(write_config(
        tmp_path, **{"basic.batch_size": 24, "basic.use_adabins_dataloader": True})),
        "/nonexistent")
    trainer = loop.Trainer(args, device="cpu")
    loader = DeviceLoader(make_dataset(args, "train"), 24, "cpu", shuffle=True,
                          host_hook=trainer._train_hook, synchronous=True)
    seen = []
    real = loop.make_bn_refresh_step

    def spy(*a, **k):
        step = real(*a, **k)

        def counted(batch, objects, generator=None):
            seen.append(batch["sample_valid"].tolist())
            return step(batch, objects, generator)

        return counted

    monkeypatch.setattr(loop, "make_bn_refresh_step", spy)
    trainer._refresh_swa_batch_stats(loader, len(loader))
    assert len(loader) == 3 and seen == [[True] * 24] * 2
