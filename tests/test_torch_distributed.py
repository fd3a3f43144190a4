"""Multi-process training (objcavit_torch.parallel) on the CPU, over gloo.

The ranks are real processes: ``objcavit_torch.parallel.launch.launch``
(``--cpu``) starts ``tests/torch_dist_workers.py`` once a rank with the
OBJCAVIT_* env, each joins a gloo group and writes what it computed; this
process holds the single-process port and the JAX package beside them:

* the env contract, the no-op and ``process_local_indices`` against JAX's;
* 4 ranks: ``metrics_sync`` against JAX's on ``make_mesh(n_data=4)`` with
  the same per-worker states, the loader's rows against the single-process
  batches, its divisibility error, ``rand_rows`` and the run dir; the
  global BatchNorm and the MSE on uneven rows against one process's on the
  whole batch; ``GradientReducer``'s mean and its layout check;
* 2 ranks, one train step of tests/test_torch_train.py's tiny GraphBins on
  its batch with augmentation and dropout on: against the port's
  single-process step on the global batch (one generator seed), and, fed the
  random numbers JAX draws for the global batch, against JAX's
  ``make_train_loss_fn``;
* 2 ranks, a ``--debug`` fit through ``cli.main`` against the
  single-process fit, and ``-v`` through the CLI with two processes.

Each comparison states its tolerance.
"""

from __future__ import annotations

import functools
import importlib.util
import io
import json
import os
import sys
import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.metrics import metrics_init as jax_metrics_init
from objcavit_tpu.metrics import metrics_sync as jax_metrics_sync
from objcavit_tpu.metrics import metrics_update as jax_metrics_update
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.parallel import make_mesh
from objcavit_tpu.parallel.distributed import (
    process_local_indices as jax_process_local_indices,
    resolve_distributed_args as jax_resolve_distributed_args,
)
from objcavit_tpu.training.steps import make_train_loss_fn as jax_make_train_loss_fn
from objcavit_tpu.utils.torch_import import convert_state_dict

from objcavit_torch import cli
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.metrics import METRIC_NAMES
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.parallel import (
    initialize_distributed,
    process_count,
    process_local_indices,
    resolve_distributed_args,
)
from objcavit_torch.parallel.launch import launch
from objcavit_torch.training import loop
from objcavit_torch.utils.benchkit import init_weights_
from tests.test_torch_cli import TINY
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (an autouse fixture)
from tests.test_torch_modules import ENC, H, W
from tests.test_torch_train import (
    CLIP,
    LOSSES,
    LR,
    MAX_DEPTH,
    MIN_DEPTH,
    N_BINS,
    NO_GRAD,
    TOTAL_STEPS,
    WD,
    _batch,
)
from tests.torch_dist_workers import IndexDataset, make_step, tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_workers.py")
LAUNCH_TIMEOUT = 240  # seconds a launch may take before its ranks are killed
STEP_SEED = 11  # the train step's generator (augmentation, then dropout)
JAX_KEY = 3  # JAX's step key
DROPOUT = 0.1


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def launch_cpu(cmd: list[str], n: int, timeout: float = LAUNCH_TIMEOUT) -> tuple[int, str]:
    """``n`` processes of ``cmd`` through the port's launcher on the CPU, one
    torch thread each, killed after ``timeout`` seconds; -> (exit status,
    their rank-prefixed output)."""
    env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    try:
        rc = launch(cmd, n, cpu=True, out=out, timeout=timeout)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return rc, out.getvalue()


def run_ranks(task: str, work, n: int, timeout: float = LAUNCH_TIMEOUT) -> list[dict]:
    """``n`` ranks of ``task``; -> each rank's output."""
    rc, text = launch_cpu([sys.executable, WORKER, task, str(work)], n, timeout)
    assert rc == 0, text[-6000:]
    return [torch.load(os.path.join(work, f"{task}_{r}.pt"), weights_only=False)
            for r in range(n)]


# ------------------------------------------------------------ env contract


ENVS = [
    {},
    {"OBJCAVIT_COORDINATOR": "h:1", "OBJCAVIT_NUM_PROCESSES": "4", "OBJCAVIT_PROCESS_ID": "3"},
    {"OBJCAVIT_COORDINATOR": "h:1", "OBJCAVIT_NUM_PROCESSES": "4"},
    {"OBJCAVIT_PROCESS_ID": "0"},
    {"OBJCAVIT_COORDINATOR": "h:1", "OBJCAVIT_NUM_PROCESSES": "2", "OBJCAVIT_PROCESS_ID": "2"},
    {"OBJCAVIT_COORDINATOR": "h:1", "OBJCAVIT_NUM_PROCESSES": "2", "OBJCAVIT_PROCESS_ID": "-1"},
]


@pytest.mark.parametrize("env", ENVS, ids=["none", "all", "partial", "one", "past", "negative"])
def test_resolve_distributed_args_matches_jax(env):
    """The same arguments, or the same ValueError and message."""
    try:
        want = jax_resolve_distributed_args(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_distributed_args(env)
        assert str(got.value) == str(e)
        return
    assert resolve_distributed_args(env) == want


def test_initialize_distributed_without_env_is_a_noop(monkeypatch):
    for k in ("OBJCAVIT_COORDINATOR", "OBJCAVIT_NUM_PROCESSES", "OBJCAVIT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized() and process_count() == 1


def test_initialize_distributed_refuses_nccl_on_the_cpu():
    with pytest.raises(ValueError, match="NCCL"):
        initialize_distributed("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("p, n", [(0, 1), (0, 4), (3, 4), (1, 3)])
def test_process_local_indices_match_jax(p, n):
    idxs = np.random.default_rng(p + n).permutation(13)
    np.testing.assert_array_equal(process_local_indices(idxs, p, n),
                                  jax_process_local_indices(idxs, p, n))


# ----------------------------------------------------------------- 4 ranks

GROUP = {"n": 22, "batch": 8, "seed": 42,
         "rand": [((2, 3), 0), ((4, 5), 1), ((3, 1, 1, 1), 0)]}


def _metric_states():
    """Four per-worker states, each of one batch (test_metrics_sync.py's
    fake batches), as numpy dicts."""
    rng = np.random.default_rng(0)
    states = []
    for _ in range(4):
        gt = rng.uniform(0.5, 9.0, (2, 8, 12, 1)).astype(np.float32)
        pred = np.clip(gt + rng.normal(0, 0.5, gt.shape), 0.01, 10).astype(np.float32)
        mask = rng.uniform(size=gt.shape) < 0.7
        state = jax_metrics_update(jax_metrics_init(), pred, gt, mask)
        states.append({k: np.asarray(v, np.float32) for k, v in state.items()})
    return states


def _uneven_batch() -> dict:
    """An fp64 NCHW batch of 10 rows, rank p holding p + 1 of them, for the
    BatchNorm (channel means ~3 apart, so the merge of the ranks' statistics
    matters) and the MSE."""
    rng = np.random.default_rng(7)
    c = 5
    ends = np.cumsum([1, 2, 3, 4])
    return {"x": rng.normal(0, 1, (10, c, 3, 4)) * rng.uniform(0.5, 2, (1, c, 1, 1))
            + rng.uniform(-3, 3, (1, c, 1, 1)) + np.arange(10).reshape(10, 1, 1, 1) * 0.2,
            "c": rng.normal(0, 1, (10, c, 3, 4)), "weight": rng.uniform(0.5, 1.5, c),
            "bias": rng.normal(0, 1, c), "eps": 1e-3,
            "pred": rng.uniform(0.5, 9, (10, 6, 7, 1)), "gt": rng.uniform(0.5, 9, (10, 6, 7, 1)),
            "rows": [(int(e) - (p + 1), int(e)) for p, e in enumerate(ends)]}


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("group")
    states = _metric_states()
    uneven = _uneven_batch()
    torch.save({**GROUP, "states": states, "uneven": uneven}, work / "group_in.pt")
    return {"states": states, "uneven": uneven, "ranks": run_ranks("group", work, 4),
            "work": work}


def test_four_ranks_know_their_places(group_run):
    ranks = group_run["ranks"]
    assert [(r["rank"], r["world"], r["main"]) for r in ranks] == [
        (0, 4, True), (1, 4, False), (2, 4, False), (3, 4, False)]


def test_metrics_sync_over_four_ranks_matches_jax(group_run):
    """Each rank's state merged over the group against JAX's metrics_sync
    of the same four states on the 4-device mesh: every value rel 1e-5,
    counts exact, the same on every rank."""
    states = group_run["states"]
    stacked = {k: np.stack([s[k] for s in states]) for k in states[0]}
    want = {k: float(v) for k, v in jax_metrics_sync(stacked, make_mesh(n_data=4)).items()}
    for r in group_run["ranks"]:
        got = r["merged"]
        assert set(got) == set(want)
        for k, v in want.items():
            if k.endswith("count"):
                assert got[k] == v, k
            else:
                assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
        assert got == group_run["ranks"][0]["merged"]


def test_loader_rows_interleave_the_single_process_batches(group_run):
    """Rank p's rows of each global batch are rows [p::4] of the
    single-process loader's batch (the same order from the same seed),
    ``sample_valid`` with them; the padded last batch included."""
    single = DeviceLoader(IndexDataset(GROUP["n"]), GROUP["batch"], "cpu", shuffle=True,
                          seed=GROUP["seed"], synchronous=True)
    want = [(b["image"][:, 0, 0, 0].astype(int), b["sample_valid"])
            for b, _ in single.host_batches()]
    assert len(want) == 3 and not want[-1][1].all()
    for r in group_run["ranks"]:
        p = r["rank"]
        assert len(r["batches"]) == len(want)
        for (idxs, valid), (w_idxs, w_valid) in zip(r["batches"], want):
            assert idxs == w_idxs[p::4].tolist()
            assert valid == w_valid[p::4].tolist()


def test_loader_refuses_a_batch_size_the_ranks_do_not_divide(group_run):
    """JAX's ValueError and message (objcavit_tpu/data/loader.py:71-76)."""
    want = ("global batch_size 10 must divide the 4-process run (each process loads "
            "batch_size/process_count samples)")
    assert all(r["divide_error"] == want for r in group_run["ranks"])


def test_rand_rows_keep_each_ranks_rows_of_the_global_draw(group_run):
    """Every rank's draw is its rows [p::4] (along the batch dim) of the
    draw one process makes for the global batch from the same seed."""
    for i, (shape, dim) in enumerate(GROUP["rand"]):
        full = list(shape)
        full[dim] *= 4
        u = torch.rand(full, generator=torch.Generator().manual_seed(5))
        for r in group_run["ranks"]:
            want = u[(slice(None),) * dim + (slice(r["rank"], None, 4),)]
            assert torch.equal(torch.tensor(r["rand"][i]), want)


def test_run_dir_is_rank_zeros_and_an_unseen_one_fails_on_every_rank(group_run):
    """One version dir, chosen by rank 0, on every rank; a rank that cannot
    see its run dir makes every rank raise, that rank with its own name."""
    ranks, work = group_run["ranks"], group_run["work"]
    assert {r["run_dir"] for r in ranks} == {os.path.join(work, "runs", "version_0")}
    assert os.listdir(work / "runs") == ["version_0"]
    assert "rank 3 cannot see rank 0's run dir" in ranks[3]["unseen_error"]
    for r in ranks[:3]:
        assert "another rank cannot see rank 0's run dir" in r["unseen_error"]
        assert "filesystem they share" in r["unseen_error"]


def test_global_batch_norm_is_one_process_bn_on_the_whole_batch(group_run):
    """The group's train-mode BatchNorm2d on rows 1, 2, 3 and 4 a rank: each
    rank's output and input gradient are its rows of nn.BatchNorm2d's on the
    whole fp64 batch, the weight and bias gradients sum over the ranks to
    its, and every rank's running statistics are its (rel 1e-12)."""
    inp = group_run["uneven"]
    bn = torch.nn.BatchNorm2d(inp["x"].shape[1], eps=inp["eps"]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(inp["c"]))
    got = [r["bn"] for r in group_run["ranks"]]
    for r, (a, b) in zip(got, inp["rows"]):
        assert _rel(r["y"], y.detach()[a:b]) < 1e-12
        assert _rel(r["dx"], x.grad[a:b]) < 1e-12
        assert _rel(r["running_mean"], bn.running_mean) < 1e-12
        assert _rel(r["running_var"], bn.running_var) < 1e-12
    assert _rel(sum(r["dw"] for r in got), bn.weight.grad) < 1e-12
    assert _rel(sum(r["db"] for r in got), bn.bias.grad) < 1e-12


def test_global_batch_norm_takes_one_collective_each_way(group_run):
    """One all-reduce forward (the ranks' counts, means and squared
    deviations together) and one backward (the sums of dy and dy (x - mean)),
    as SyncBatchNorm's gather and reduce."""
    for r in group_run["ranks"]:
        assert r["bn"]["fwd"] == ["all_reduce"] and r["bn"]["bwd"] == ["all_reduce"]


def test_mse_over_four_ranks_is_the_global_batchs(group_run):
    """Every rank's MSE of its uneven rows is the whole batch's mean (rel
    1e-12); its gradient, divided by the 4 ranks (the reducer's mean), is
    its rows of the whole batch's."""
    inp = group_run["uneven"]
    pred = torch.from_numpy(inp["pred"]).requires_grad_()
    want = torch.mean((pred - torch.from_numpy(inp["gt"])) ** 2)
    want.backward()
    for r, (a, b) in zip(group_run["ranks"], inp["rows"]):
        assert r["mse"] == pytest.approx(want.item(), rel=1e-12)
        assert _rel(r["mse_grad"] / 4, pred.grad[a:b]) < 1e-12


def test_gradient_reducer_means_gradients_and_refuses_other_sets(group_run):
    """Gradients rank + 1 become their mean, 2.5, on every rank, a parameter
    without a gradient stays None; ranks with as many gradients but on other
    parameters raise, naming the first that differs, instead of mixing them
    in a bucket."""
    for r in group_run["ranks"]:
        assert r["reduced"] == [[2.5] * 3, None, [2.5] * 3]
        assert "the ranks differ on which parameters have a gradient (2 of 3, the first #0" \
            in r["layout_error"]


EMPTY_GRADS_TIMEOUT = 60  # seconds: a rank that skipped the check left its peer waiting


def test_gradient_reducer_raises_on_every_rank_when_one_has_no_gradient(tmp_path):
    """Two ranks over gloo, rank 1 without any gradient: the layout check
    still runs there, so both ranks raise. Rank 1 used to return and leave
    rank 0 in the check's all-reduce: until its group went away, or past a
    training loop's next collective, for good."""
    ranks = run_ranks("empty_grads", tmp_path, 2, timeout=EMPTY_GRADS_TIMEOUT)
    errors = [r["error"] for r in ranks]
    assert "rank 0: the ranks differ on which parameters have a gradient (2 of 2, the first " \
        "#0, on this rank with one)" in errors[0], errors
    assert "rank 1: the ranks differ on which parameters have a gradient (2 of 2, the first " \
        "#0, on this rank without one)" in errors[1], errors


# ------------------------------------------------------- 2 ranks, one step


def _draws_as_uniforms(aug: dict, masks: list) -> list[np.ndarray]:
    """JAX's augmentation draws and dropout masks as the uniforms the port
    draws, in its order: ``draw_augment``'s (4, B) (flip and Planckian coins
    as u < 0.5, gamma's u, the temperature's u), then one (B, ...) a
    dropout, kept where u >= rate."""
    aug_u = np.stack([
        np.where(aug["flip"], 0.25, 0.75), aug["gamma_u"],
        np.where(aug["planck_on"], 0.25, 0.75), (aug["temperature"] - 3000.0) / 12000.0,
    ]).astype(np.float32)
    return [aug_u] + [np.asarray(m).astype(np.float32) for m in masks]


@functools.lru_cache(maxsize=None)
def _weights():
    """The tiny GraphBins' state dict (the port's init from seed 0, conv_out
    x 10 so depth spreads) and JAX's variables of it."""
    model = init_weights_(GraphBins(encoder_name=ENC, n_bins=N_BINS),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.conv_out[0].weight.mul_(10.0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_state_dict({f"model.{k}": v.numpy() for k, v in sd.items()}, "graphbins",
                                   ENC, pos_strategy="learned_bbox_wh")
    return sd, variables


def _global_batch():
    """tests/test_torch_train.py's batch at B 2, as the global batch."""
    batch, objects = _batch(0)
    batch = {**batch, "image": np.clip(batch["image"] + 0.5, 0.0, 1.0).astype(np.float32)}
    return batch, objects


def _jax_loss_and_grads():
    """JAX's make_train_loss_fn on the global batch (augmentation and
    dropout on, key JAX_KEY): the loss, the gradients in the port's layout,
    and the augmentation draws and dropout masks it made (recorded where
    flax's Dropout draws them)."""
    from objcavit_torch.utils.convert import state_dict_from_variables

    _, variables = _weights()
    batch, objects = _global_batch()
    model = JaxGraphBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                         pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W),
                         dropout_rate=DROPOUT)
    loss_fn = jax_make_train_loss_fn(model, JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                     augment_on_device=True, is_graphbins=True)
    recorded = []

    class RecordingRandom(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax.random, name)

        @staticmethod
        def bernoulli(key, p=0.5, shape=None):
            mask = jax.random.bernoulli(key, p, shape)
            recorded.append(mask)
            return mask

    def f(params):
        recorded.clear()
        loss, _ = loss_fn(params, variables["batch_stats"], jax.tree.map(jnp.asarray, batch),
                          jax.tree.map(jnp.asarray, objects), jax.random.PRNGKey(JAX_KEY))
        return loss, list(recorded)

    real = flax_stochastic.random
    flax_stochastic.random = RecordingRandom("random")
    try:
        (loss, masks), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]))
    finally:
        flax_stochastic.random = real
    # the augmentation's draws, split as steps.py:112 and augment.py split them
    aug_rng, _ = jax.random.split(jax.random.PRNGKey(JAX_KEY))
    k_flip, k_gamma, k_pl_on, k_pl_t = jax.random.split(aug_rng, 4)
    b = batch["image"].shape[0]
    aug = {"flip": np.asarray(jax.random.bernoulli(k_flip, 0.5, (b,))),
           "gamma_u": np.asarray(jax.random.uniform(k_gamma, (b, 1, 1, 1))).reshape(b),
           "planck_on": np.asarray(jax.random.bernoulli(k_pl_on, 0.5, (b,))),
           "temperature": np.asarray(jax.random.uniform(k_pl_t, (b,), minval=3000.0,
                                                        maxval=15000.0))}
    grads = state_dict_from_variables({"params": jax.tree.map(np.asarray, grads)}, ENC)
    return float(loss), grads, _draws_as_uniforms(aug, masks)


def _single_process_step(inp: dict):
    """The port's fp64 step on the global batch in this process (no group),
    from the ranks' generator seed."""
    step = make_step(inp, torch.float64)
    loss = step(tensors(inp["batch"], torch.float64), tensors(inp["objects"], torch.float64))
    return {"loss": float(loss), "state": step.model.state_dict(),
            "grads": {n: None if p.grad is None else p.grad
                      for n, p in step.model.named_parameters()}}


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("step")
    sd, _ = _weights()
    jax_loss, jax_grads, draws = _jax_loss_and_grads()
    batch, objects = _global_batch()
    inp = {"state": sd, "batch": batch, "objects": objects, "jax_draws": draws, "enc": ENC,
           "n_bins": N_BINS, "dropout": DROPOUT, "lr": LR, "wd": WD, "total_steps": TOTAL_STEPS,
           "losses": LOSSES, "min_depth": MIN_DEPTH, "clip": CLIP, "seed": STEP_SEED}
    torch.save(inp, work / "step_in.pt")
    return {"ranks": run_ranks("step", work, 2), "single": _single_process_step(inp),
            "jax": (jax_loss, jax_grads)}


def test_two_rank_step_loss_is_the_global_batchs(step_run):
    """Both ranks hold one loss, the single-process step's on the global
    batch within rel 1e-5, and each made its step with a gradient reducer."""
    ranks, single = step_run["ranks"], step_run["single"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["loss"] == pytest.approx(single["loss"], rel=1e-5)
    assert {r["reducer"] for r in ranks} == {"GradientReducer"}


def test_two_rank_step_gradients_are_the_global_batchs(step_run):
    """Each parameter's reduced, clipped gradient: the same bits on both
    ranks, and within rel L2 1e-5 of the single-process step's (measured:
    3e-6 at most, the regressor's), plus an absolute 1e-12 of the whole
    gradient's norm for the gradients that are zero in exact arithmetic (the
    biases of the decoder's convs, which a train-mode BN follows: ~1e-17 of
    rounding noise on both sides). The four parameters nothing reads have
    none."""
    ranks, single = step_run["ranks"], step_run["single"]
    total = float(torch.sqrt(sum((g * g).sum() for g in single["grads"].values()
                                 if g is not None)))
    worst = {}
    for name, want in single["grads"].items():
        g0, g1 = ranks[0]["grads"][name], ranks[1]["grads"][name]
        if want is None:
            assert g0 is None and g1 is None and name in NO_GRAD, name
            continue
        assert torch.equal(g0, g1), name
        err, ref = float((g0 - want).norm()), float(want.norm())
        worst[name] = (err, ref)
    for name, (err, ref) in worst.items():
        assert err <= 1e-5 * ref + 1e-12 * total, (name, err, ref)


def test_two_rank_step_bn_statistics_and_parameters_are_the_global_batchs(step_run):
    """After the step: every BN running statistic and every parameter the
    same bits on both ranks and within rel L2 1e-5 of the single-process
    step's, the BN counts equal. Absolute terms: 1e-12 for the running means
    that are zero in exact arithmetic (a BN whose input channels have mean
    zero: ~1e-17 of rounding noise on both sides); 1e-4 of a first Adam
    step (lr0 a element) for the parameters, as Adam divides by |g| + 1e-8
    and the bins head's plain softmax runs in fp32 even in an fp64 step
    (measured: the decoder's BN biases, zero before the step, land 1.1e-5
    of their norm apart)."""
    ranks, single = step_run["ranks"], step_run["single"]
    params = {n for n, _ in GraphBins(encoder_name=ENC, n_bins=N_BINS).named_parameters()}
    for key, want in single["state"].items():
        s0, s1 = ranks[0]["state"][key], ranks[1]["state"][key]
        assert torch.equal(s0, s1), key
        if key.endswith("num_batches_tracked"):
            assert torch.equal(s0, want), key
            continue
        err, ref = float((s0 - want).norm()), float(want.norm())
        atol = 1e-4 * LR / 25 * want.numel() ** 0.5 if key in params else 1e-12
        assert err <= 1e-5 * ref + atol, (key, err, ref)


def test_two_rank_step_matches_jax_on_jax_draws(step_run):
    """Fed the uniforms JAX drew for the global batch (every draw taken, in
    JAX's order and shapes), the two ranks' loss and reduced gradients
    against JAX's make_train_loss_fn at tests/test_torch_train.py's JAX
    tolerances: the loss rel 1e-5; each gradient ||got - want|| <= 1e-2
    ||want|| + 5e-7 of the whole gradient's norm (that harness's 5e-8 at its
    clipped norm of 0.1; these gradients are not clipped) and a median
    relative error under 2e-3."""
    want_loss, want_grads = step_run["jax"]
    total = float(np.sqrt(sum(np.sum(np.square(g)) for g in want_grads.values())))
    rels = {}
    for r in step_run["ranks"]:
        fed = r["jax_fed"]
        assert fed["draws_left"] == 0
        assert fed["loss"] == pytest.approx(want_loss, rel=1e-5)
        for name, g in fed["grads"].items():
            w = want_grads[name]
            if name in NO_GRAD:
                assert g is None and not np.any(w), name
                continue
            err, ref = np.linalg.norm(g.numpy() - w), np.linalg.norm(w)
            assert err <= 1e-2 * ref + 5e-7 * total, (name, err, ref, total)
            if ref > 0:
                rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3


# ------------------------------------------------------- 2 ranks, the CLI


def _tiny_config(tmp_path, name: str) -> str:
    cfg = yaml.safe_load(yaml.safe_dump(TINY))
    cfg["paths"]["run_dir"] = str(tmp_path / "runs")
    cfg["basic"]["name"] = name
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    cfg = _tiny_config(work, "dist")
    with open(work / "cli_argv.json", "w") as f:
        json.dump(["-c", cfg, "--debug"], f)
    ranks = run_ranks("cli", work, 2)
    # no TensorBoard in the single-process fit (its import takes ~10 s here;
    # the metrics do not depend on it)
    real_writer = loop._tb_writer
    loop._tb_writer = lambda run_dir: None
    try:
        _, single = cli.main(["-c", _tiny_config(work, "single"), "--debug"],
                             basic_params_path="/nonexistent", device="cpu")
    finally:
        loop._tb_writer = real_writer
    return {"ranks": ranks, "single": single, "work": work, "cfg": cfg}


def test_two_rank_fit_writes_one_run_from_rank_zero(cli_run):
    """One version dir; hparams.yaml, last.ckpt and best.ckpt written once,
    all by rank 0, and one TensorBoard file where TensorBoard imports; the
    checkpoint in the model's own names."""
    r0, r1 = cli_run["ranks"]
    assert sorted(r0["written"]) == ["best.ckpt", "hparams.yaml", "last.ckpt"]
    assert r1["written"] == []
    runs = cli_run["work"] / "runs" / "dist"
    assert os.listdir(runs) == ["version_0"]
    events = [f for f in os.listdir(runs / "version_0") if f.startswith("events.out.tfevents")]
    assert len(events) == int(importlib.util.find_spec("tensorboard") is not None)
    ckpt = torch.load(runs / "version_0" / "checkpoints" / "last.ckpt", weights_only=False)
    assert ckpt["global_step"] == 1
    assert "model.conv_out.0.weight" in ckpt["state_dict"]


def test_two_rank_fit_metrics_equal_the_single_process_fits(cli_run):
    """Both ranks' last metrics: the same values, each within rel 1e-5 of
    the single-process fit's."""
    (r0, r1), single = cli_run["ranks"], cli_run["single"]
    assert r0["metrics"] == r1["metrics"]
    for k in METRIC_NAMES:
        for key in (k, f"{k}_ra"):
            assert r0["metrics"][key] == pytest.approx(single[key], rel=1e-5), key


def test_validate_with_two_processes_raises_jaxs_error(cli_run):
    """-v (batch size 1) through the CLI with two processes: JAX's
    ValueError (objcavit_tpu/data/loader.py:71-76), a non-zero exit."""
    rc, text = launch_cpu([sys.executable, "-m", "objcavit_torch.cli", "-c", cli_run["cfg"],
                           "-v", "--debug"], 2)
    assert rc != 0
    msg = ("ValueError: global batch_size 1 must divide the 2-process run (each process "
           "loads batch_size/process_count samples)")
    assert msg in text, text[-3000:]
