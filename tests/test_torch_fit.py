"""Slice 14, training through the entry point: objcavit_torch's ``Trainer.fit``,
its optimizer paths and its CLI train mode against objcavit_tpu's on the CPU.

The fits run tests/test_torch_cli.py's tiny config (GraphBins,
efficientnet-tiny, 16 bins, 64x96, the zeros provider with 3 slots) on the
synthetic NYU split (64 train and 16 eval images, so 8 steps an epoch at
batch size 8) with ``use_adabins_dataloader: true``: the host samplers'
synthetic images are drawn by index and nothing augments, since random
numbers never agree across the frameworks. Transformer dropout is 0 on both
sides (each side's ``build_model`` is wrapped in the test; neither package
changes), and both warm-start from one reference-layout ``.ckpt`` that JAX's
``restore_checkpoint`` and the port's read alike (tests/test_torch_eval.py).
JAX's fit runs once per module. Each test states its tolerance.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import objcavit_tpu.training.loop as jax_loop
from objcavit_tpu.config import check_and_validate_args as jax_check_and_validate_args
from objcavit_tpu.config import load_args as jax_load_args
from objcavit_tpu.parallel import make_mesh
from objcavit_tpu.training.optim import build_optimizer as jax_build_optimizer
from objcavit_tpu.training.optim import current_lr as jax_current_lr

import objcavit_torch.training.loop as loop
from objcavit_torch import cli
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import TrainStep
from objcavit_torch.utils.convert import state_dict_from_variables
from tests.test_torch_eval import ENC, _write_reference_ckpt
from tests.test_torch_train import NO_GRAD

LR, WD, CLIP = 3.57e-4, 0.1, 0.1
STEPS_PER_EPOCH = 8  # 64 synthetic train images at batch size 8
# fp32, the same warm start: per-step losses within 2e-4 relative (measured
# at most 3.4e-6 over 16 steps, 2.3e-5 over the SWA fit's 10); each
# parameter rel L2 within 5e-3 and their median within 2e-4, as
# tests/test_trajectory_oracle.py holds (measured median 1.3e-5, worst
# 1.7e-3: the decoder's conv biases before a train-mode BN, whose gradient
# is 0 in exact arithmetic, so AdamW steps them on normalised rounding
# noise); each BN statistic within 5e-3 (measured 8.3e-4 and, after the SWA
# refresh, 2.0e-3: the running means follow those biases); the 16 metrics
# of the last validation within 2e-2 relative (measured 1.3e-3 and 7.7e-3:
# eval normalises with the running statistics, which carry that drift)
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_MEDIAN_RTOL, BN_RTOL = 5e-3, 2e-4, 5e-3
METRICS_RTOL = 2e-2
# JAX's schedules compute in fp32, torch's in float64 (tests/test_optim.py)
SCHEDULE_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs of this module on one intra-op thread, restored
    after: the Tier-1 command runs 6 workers on the host's cores, and a
    tiny model's 8-thread OpenMP regions spin against the other workers
    (a 2-epoch fit measured 177 s on 8 threads and 17 s on 1 beside 8
    busy processes; 6 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_config(tmp_path, name="tiny", **overrides) -> str:
    """tests/test_torch_cli.py's tiny config under ``tmp_path`` with a
    gradient clip of 0.1 and ``overrides`` (dotted keys)."""
    from tests.test_torch_cli import TINY  # it imports this module's fixture

    cfg = copy.deepcopy(TINY)
    cfg["paths"]["run_dir"] = str(tmp_path / "runs")
    cfg["basic"]["name"] = name
    cfg["optimizer"]["gradient_clip_val"] = CLIP
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def run_both_fits(tmp_path, **overrides) -> dict:
    """JAX's fit through its CLI's steps and the port's through ``cli.main``
    on one config (``overrides``), both warm-started from one ``.ckpt`` with
    dropout 0: their per-step losses, final state dicts (the port's layout),
    last metrics, the port's LR at each update and JAX's build_optimizer
    keywords. JAX's train step donates its state, and JAX's SWA keeps that
    state's params as the average (loop.py:370), which the next step deletes
    (ROADMAP §C): JAX's fit runs here with the donation off. JAX's Trainer
    lays its fit out on ``make_mesh()``, the 8 virtual CPU devices of
    tests/conftest.py: here on a mesh of one device, the single-process run
    the port's is, which computes the same steps (a batch sharded over the
    data axis sums the same rows) without 8 partitions of every program on
    the CPU."""
    warm = str(tmp_path / "warm.ckpt")
    _write_reference_ckpt(warm)
    overrides = {"basic.from_checkpoint": warm, "basic.use_adabins_dataloader": True,
                 **overrides}
    got = {"jax_losses": [], "port_losses": [], "port_lrs": [], "jax_optimizer_kwargs": []}
    real_jit = jax.jit
    real_jax_train_step, real_jax_build = jax_loop.make_train_step, jax_loop.build_model
    real_jax_optimizer, real_call = jax_loop.build_optimizer, TrainStep.__call__
    real_build = loop.build_model

    def jax_train_step(*args, **kwargs):
        step = real_jax_train_step(*args, **kwargs)

        def recorded(state, batch, objects, rng):
            state, loss = step(state, batch, objects, rng)
            jax.debug.callback(lambda v: got["jax_losses"].append(float(v)), loss)
            return state, loss

        return recorded

    def jax_optimizer(*args, **kwargs):
        got["jax_optimizer_kwargs"].append(kwargs)
        return real_jax_optimizer(*args, **kwargs)

    def port_build(*args, **kwargs):
        model = real_build(*args, **kwargs)
        for m in model.modules():
            if hasattr(m, "dropout_rate"):
                m.dropout_rate = 0.0
        return model

    def port_call(self, batch, objects):
        loss = real_call(self, batch, objects)
        got["port_losses"].append(float(loss))
        got["port_lrs"].append(self.last_lr)
        return loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "make_train_step", jax_train_step)
        mp.setattr(jax_loop, "build_optimizer", jax_optimizer)
        mp.setattr(jax_loop, "build_model",
                   lambda *a, **k: real_jax_build(*a, **k).clone(dropout_rate=0.0))
        mp.setattr(jax, "jit", lambda f, *a, donate_argnums=None, **k: real_jit(f, *a, **k))
        mp.setattr(jax_loop.Trainer, "_tb_writer", lambda self, run_dir: None)  # not compared
        mp.setattr(jax_loop, "make_mesh", lambda: make_mesh(n_data=1))
        cfg = write_config(tmp_path, "jax", **overrides)
        args = jax_load_args(cfg, debug=False, log_debug=False, validate=False,
                             inference=False)
        state, got["jax_metrics"] = jax_loop.Trainer(
            jax_check_and_validate_args(args, basic_params_path="/nonexistent")).fit()
    got["jax_state"] = state_dict_from_variables(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}, ENC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "build_model", port_build)
        mp.setattr(TrainStep, "__call__", port_call)
        cfg = write_config(tmp_path, "port", **overrides)
        model, got["port_metrics"] = cli.main(["-c", cfg], device="cpu")
    got["port_state"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    got["warm"] = {k[len("model."):]: v.numpy() for k, v in torch.load(
        warm, weights_only=False)["state_dict"].items() if k[len("model."):] in got["port_state"]}
    got["run_dir"] = tmp_path / "runs"
    return got


def check_fit_parity(fits: dict, averaged_after: tuple[int, ...] | None = None) -> None:
    """The per-step losses, the final parameters and BN statistics, and
    the last metrics of the two fits, at this module's tolerances. The four
    parameters without a gradient stay at the warm start in the port
    (torch's AdamW skips them) and decay by lr * wd a step in JAX (an SWA
    fit's final value: the mean of the values after the ``averaged_after``
    updates)."""
    np.testing.assert_allclose(fits["port_losses"], fits["jax_losses"], rtol=LOSS_RTOL)
    port, want = fits["port_state"], fits["jax_state"]
    assert set(want) <= set(port)
    rels = {}
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in NO_GRAD:
            np.testing.assert_array_equal(port[name], fits["warm"][name])
            decays = np.cumprod([1.0 - lr * WD for lr in fits["port_lrs"]])
            decay = np.mean([decays[n - 1] for n in averaged_after or [len(decays)]])
            np.testing.assert_allclose(w, fits["warm"][name] * decay, rtol=1e-5)
            continue
        rels[name] = _rel(port[name], w)
    stats = {k: v for k, v in rels.items() if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in rels.items() if k not in stats}
    assert stats and max(stats.values()) <= BN_RTOL, max(stats.items(), key=lambda kv: kv[1])
    assert max(params.values()) <= PARAM_RTOL, max(params.items(), key=lambda kv: kv[1])
    assert np.median(list(params.values())) <= PARAM_MEDIAN_RTOL
    assert set(fits["port_metrics"]) == set(fits["jax_metrics"])
    for k, w in fits["jax_metrics"].items():
        np.testing.assert_allclose(fits["port_metrics"][k], w, rtol=METRICS_RTOL, err_msg=k)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Two epochs on the OneCycle path (use_swa absent), 16 steps."""
    return run_both_fits(tmp_path_factory.mktemp("fit"), **{"basic.max_epochs": 2})


def test_fit_matches_jax_over_two_epochs(fits):
    """16 steps from one warm start: per-step losses, final parameters and
    BN statistics, and the last validation's 16 metrics against JAX's fit."""
    assert len(fits["port_losses"]) == len(fits["jax_losses"]) == 2 * STEPS_PER_EPOCH
    check_fit_parity(fits)


def test_fit_writes_the_run_dir_and_logs_jax_scalars(fits):
    """One version dir with hparams.yaml, last.ckpt and best.ckpt holding
    the model, AdamW's state, the scheduler and step 16; the TensorBoard
    event file where the writer imports."""
    run = fits["run_dir"] / "port" / "version_0"
    assert sorted(os.listdir(fits["run_dir"] / "port")) == ["version_0"]
    assert (run / "hparams.yaml").exists()
    ckpt = torch.load(run / "checkpoints" / "last.ckpt", weights_only=False)
    assert ckpt["global_step"] == 2 * STEPS_PER_EPOCH
    assert ckpt["optimizer_states"] and ckpt["lr_schedulers"]
    assert (run / "checkpoints" / "best.ckpt").exists()
    if loop._tb_writer is not None and any(f.startswith("events.") for f in os.listdir(run)):
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        events = EventAccumulator(str(run), size_guidance={"images": 0, "scalars": 0})
        events.Reload()
        tags = events.Tags()
        assert {"train/loss", "lr-AdamW", "metrics/abs_rel", "metrics_ra/abs_rel_ra"} <= set(
            tags["scalars"])
        assert {"train/samples", "val/samples"} <= set(tags["images"])
        # step % 50 == 1: the first step only, at the LR of the first update
        assert [e.step for e in events.Scalars("train/loss")] == [1]
        assert events.Scalars("lr-AdamW")[0].value == pytest.approx(LR / 25, rel=1e-6)


def test_jax_fit_builds_its_constant_lr_adamw_without_the_parameter_tree(fits):
    """The slow-encoder divergence (ROADMAP §C): JAX's fit passes no
    ``params_example``, so on ``use_swa: false`` its AdamW moves every leaf
    at ``lr``; the port's encoder group runs at ``lr / slow_encoder``, as
    the reference's param groups (GraphBinsLM.py:455-490)."""
    kwargs = fits["jax_optimizer_kwargs"][0]
    assert "params_example" not in kwargs
    tx = jax_build_optimizer(**{**kwargs, "use_swa": False, "slow_encoder": 10})
    params = {"encoder": {"w": jax.numpy.ones(3)}, "decoder": {"w": jax.numpy.ones(3)}}
    grads = jax.tree.map(jax.numpy.ones_like, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    np.testing.assert_allclose(updates["encoder"]["w"], updates["decoder"]["w"])

    model = loop.build_model(cli.load_args(write_config(fits["run_dir"].parent, "div")))
    optimizer, scheduler = build_optimizer(model, LR, WD, 10, use_swa=False, slow_encoder=10)
    assert scheduler is None
    enc = {id(p) for n, p in model.named_parameters() if "encoder" in n.split(".")}
    assert enc and {id(p) for p in optimizer.param_groups[1]["params"]} == enc
    assert [g["lr"] for g in optimizer.param_groups] == [LR, LR / 10]


# ------------------------------------------------------------------ schedules

def _jax_schedule(total, n, **kwargs):
    """(lr, b1) of JAX's optimizer at each of n updates (None for the LR on
    the constant path, as its current_lr)."""
    tx = jax_build_optimizer(LR, WD, total, gradient_clip_val=CLIP, **kwargs)
    params = {"w": jax.numpy.ones(2)}
    state = tx.init(params)
    lrs, b1s = [], []
    for _ in range(n):
        _, state = tx.update(jax.tree.map(jax.numpy.ones_like, params), state, params)
        lrs.append(jax_current_lr(state))
        hp = getattr(state[1], "hyperparams", None)
        b1s.append(None if hp is None else float(hp["b1"]))
    return lrs, b1s


def _port_schedule(total, n, start_step=0, **kwargs):
    """(lr, beta1) of the port's AdamW at each of n updates from ``start_step``."""
    p = torch.nn.Parameter(torch.ones(2))
    optimizer, scheduler = build_optimizer(torch.nn.ParameterList([p]), LR, WD, total,
                                           start_step=start_step, **kwargs)
    step = TrainStep(None, optimizer, scheduler, None)
    lrs, b1s = [], []
    for _ in range(n):
        b1s.append(optimizer.param_groups[0]["betas"][0])
        p.grad = torch.ones(2)
        step.update()
        lrs.append(step.last_lr)
    return lrs, b1s


@pytest.mark.parametrize("use_swa", [None, True, False], ids=["onecycle", "swa", "constant"])
def test_schedules_match_jax_over_60_steps(use_swa):
    """LR and beta1 at each of 60 updates on the three paths: OneCycle;
    OneCycle to step 48 (0.8 of 60), then the SWA anneal to 1e-2 over 10
    steps with beta1 frozen at the switch; constant (no LR scalar, as JAX's
    ``current_lr`` gives None), within rtol 1e-4."""
    swa = dict(swa_start_step=48, swa_anneal_steps=10) if use_swa else {}
    want_lr, want_b1 = _jax_schedule(60, 60, use_swa=use_swa, **swa)
    got_lr, got_b1 = _port_schedule(60, 60, use_swa=use_swa, **swa)
    if use_swa is False:
        assert got_lr == want_lr == [None] * 60
        assert want_b1 == [None] * 60 and got_b1 == [0.9] * 60  # AdamW's default beta1
        return
    np.testing.assert_allclose(got_lr, want_lr, rtol=SCHEDULE_RTOL)
    np.testing.assert_allclose(got_b1, want_b1, rtol=SCHEDULE_RTOL)
    if use_swa:
        assert got_lr[58:] == pytest.approx([1e-2, 1e-2], rel=1e-6)
        assert len(set(got_b1[48:])) == 1


@pytest.mark.parametrize("use_swa", [None, True], ids=["onecycle", "swa"])
def test_a_resumed_schedule_is_rebuilt_for_the_new_total(use_swa):
    """A run of 24 steps resumed with a total of 48 (one epoch of 24 to
    two): updates 24-47 at JAX's schedule for 48 steps at those steps, not
    the old schedule's (which would step past its end)."""
    swa = dict(swa_start_step=36, swa_anneal_steps=24) if use_swa else {}
    want_lr, want_b1 = _jax_schedule(48, 48, use_swa=use_swa, **swa)
    got_lr, got_b1 = _port_schedule(48, 24, start_step=24, use_swa=use_swa, **swa)
    np.testing.assert_allclose(got_lr, want_lr[24:], rtol=SCHEDULE_RTOL)
    np.testing.assert_allclose(got_b1, want_b1[24:], rtol=SCHEDULE_RTOL)


def test_onecycle_overwrites_the_slow_encoders_group():
    """The reference's quirk: a scalar max_lr sets every group's LR, the
    slow encoder's too, on the two OneCycle paths; there the port, as JAX,
    makes no group for the slow encoder, and every parameter runs at the
    schedule's LR."""
    model = torch.nn.Module()
    model.encoder, model.head = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    for use_swa in (None, True):
        optimizer, _ = build_optimizer(model, LR, WD, 20, use_swa=use_swa, slow_encoder=10,
                                       swa_start_step=16)
        assert [g["lr"] for g in optimizer.param_groups] == pytest.approx([LR / 25], rel=1e-12)
        assert len(optimizer.param_groups[0]["params"]) == 4


# ------------------------------------------------------- resume, dirs, CLI

def _spy_loaders(mp) -> list:
    seen = []
    real = loop.DeviceLoader

    class Spy(real):
        def __init__(self, dataset, batch_size, *args, **kwargs):
            seen.append(batch_size)
            super().__init__(dataset, batch_size, *args, **kwargs)

    mp.setattr(loop, "DeviceLoader", Spy)
    return seen


def test_kill_and_resume_continues_the_run(tmp_path, monkeypatch):
    """One epoch (8 steps), then --resume with max_epochs 2: the same
    version dir, step 16, AdamW's moments restored bit for bit from
    last.ckpt (and each parameter's Adam step count 16 at the end, not a
    fresh 8), the LR of updates 8-15 the schedule of 16 steps at those
    steps; --no-resume then opens version_1."""
    cfg = write_config(tmp_path, **{"basic.max_epochs": 1})
    cli.main(["-c", cfg], device="cpu")
    last = tmp_path / "runs" / "tiny" / "version_0" / "checkpoints" / "last.ckpt"
    saved = torch.load(last, weights_only=False)["optimizer_states"][0]["state"]
    lrs, restored = [], {}
    real_call = TrainStep.__call__

    def spy(self, batch, objects):
        if not lrs:  # the moments the first resumed update starts from
            optimizer = self.optimizer
            restored.update({i: optimizer.state[p]["exp_avg"].clone() for i, p in enumerate(
                q for g in optimizer.param_groups for q in g["params"]) if p in optimizer.state})
        loss = real_call(self, batch, objects)
        lrs.append(self.last_lr)
        return loss

    monkeypatch.setattr(TrainStep, "__call__", spy)
    cfg = write_config(tmp_path, **{"basic.max_epochs": 2})
    cli.main(["-c", cfg, "--resume"], device="cpu")
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[i], s["exp_avg"]) for i, s in saved.items())
    base = tmp_path / "runs" / "tiny"
    assert sorted(os.listdir(base)) == ["version_0"]
    ckpt = torch.load(last, weights_only=False)
    assert ckpt["global_step"] == 2 * STEPS_PER_EPOCH
    state = ckpt["optimizer_states"][0]["state"]
    assert state and all(float(s["step"]) == 2 * STEPS_PER_EPOCH for s in state.values())
    assert sum(float(s["exp_avg_sq"].abs().sum()) for s in state.values()) > 0
    want, _ = _port_schedule(16, 16)
    assert lrs == pytest.approx(want[8:], rel=1e-12)
    cli.main(["-c", cfg, "--no-resume", "--debug"], device="cpu")
    assert sorted(os.listdir(base)) == ["version_0", "version_1"]


def test_infit_validation_runs_at_basic_batch_size_even_after_a_validate(tmp_path,
                                                                          monkeypatch):
    """In-fit validation at basic.batch_size (the reference's val loaders);
    a validate (-v, batch size 1) on the same args before the fit leaves the
    fit's batch size alone (tests/test_train_loop.py pins JAX's)."""
    seen = _spy_loaders(monkeypatch)
    args = cli.check_and_validate_args(
        cli.load_args(write_config(tmp_path), debug=True), "/nonexistent")
    args.val_output_dir = str(tmp_path / "val")
    trainer = loop.Trainer(args, device="cpu")
    trainer.validate()
    trainer.fit()
    assert seen == [1, 8, 8], seen


def test_cli_trains_then_validates_the_run(tmp_path):
    """The train mode through cli.main, then -v on the run's hparams.yaml:
    the eval path reads the fit's last.ckpt (the metrics of the fit's last
    validation, at batch size 8, against -v's at 1: the same 16 images and
    weights, metrics within 1e-4 relative for the per-pixel family)."""
    cfg = write_config(tmp_path, **{"basic.max_epochs": 1})
    model, fit_metrics = cli.main(["-c", cfg], device="cpu")
    assert all(np.isfinite(v) for v in fit_metrics.values())
    hparams = tmp_path / "runs" / "tiny" / "version_0" / "hparams.yaml"
    metrics = cli.main(["-c", str(hparams), "-v"], device="cpu")
    for k in ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "acc_1", "acc_2", "acc_3"):
        np.testing.assert_allclose(metrics[k], fit_metrics[k], rtol=1e-4, err_msg=k)


def test_without_tensorboard_the_fit_logs_nothing_and_trains(tmp_path, monkeypatch):
    """Where torch.utils.tensorboard does not import (the card's machine
    may lack the package), fit has no writer, as JAX's, and trains on."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _, metrics = cli.main(["-c", write_config(tmp_path), "--debug"], device="cpu")
    run = tmp_path / "runs" / "tiny" / "version_0"
    assert all(np.isfinite(v) for v in metrics.values())
    assert not [f for f in os.listdir(run) if f.startswith("events.")]


def test_loader_pulls_jax_init_batch_before_training(tmp_path, monkeypatch):
    """fit draws the first train batch before its first step, as JAX's model
    init does (loop.py:171-187), so the first epoch trains on the order
    the loader's stream draws second."""
    orders = []
    real = DeviceLoader.host_batches

    def spy(self):
        for batch, meta in real(self):
            if self.shuffle:
                orders.append(list(meta["image_path"]))
            yield batch, meta

    monkeypatch.setattr(DeviceLoader, "host_batches", spy)
    cli.main(["-c", write_config(tmp_path), "--debug"], device="cpu")
    rng = np.random.default_rng(loop.TRAIN_SEED)
    first, second = rng.permutation(64), rng.permutation(64)
    assert orders[0] == [f"synthetic/{i}.jpg" for i in first[:8]]
    assert orders[1] == [f"synthetic/{i}.jpg" for i in second[:8]]
