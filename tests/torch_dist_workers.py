"""The processes of tests/test_torch_distributed.py, one rank each.

    python tests/torch_dist_workers.py <task> <workdir>

started by ``objcavit_torch.parallel.launch`` (``--cpu``), so each process
has the OBJCAVIT_* env of its rank and joins a gloo group on the CPU. A task
reads its inputs from ``workdir`` and writes ``<task>_<rank>.pt`` there. No
JAX here: the test process holds the JAX side. Tasks:

* ``group``: ranks, ``metrics_sync`` of this rank's metric state, the
  loader's rows of each global batch and its divisibility error,
  ``rand_rows``, the run dir chosen by rank 0, and a rank that cannot see it;
  the global BatchNorm and the MSE on rows 1, 2, 3 and 4 rows a rank, with
  the collectives the BatchNorm made each way; ``GradientReducer`` on one
  set of gradients and on two sets of one size;
* ``step``: one train step of the tiny GraphBins on this rank's rows of a
  global batch, augmentation and dropout on: in fp64 from the seeded
  generator, then in fp32 (loss and reduced gradients) on the uniform draws
  JAX made for the global batch, replayed in place of ``torch.rand``;
* ``cli``: ``cli.main`` on a params file (a ``--debug`` fit), with the
  files each rank writes;
* ``tp_grid`` (tests/test_torch_tp.py, a 2 x 2 grid): the tiny GraphBins of
  tests/test_parallel_2d.py split over the model axis, its eval forward on
  this rank's rows in fp32 and fp64, the gathered state dict,
  ``DepthPipeline(grid=...)``'s served depth, ``spatial=True``'s depth of
  the model whole and split, in fp32 and fp64, with the plan, and
  ``tp_step``'s step on this rank's rows;
* ``tp_step`` (a 1 x 2 grid): one fp64 train step of that model, split, with
  augmentation, dropout and clipping (its loss, the norm the clipping saw,
  the gathered gradients and parameters, the local shapes after the step),
  a split miniViT's forward, and ``spatial=True``'s depth of the tiny
  GraphBins and AdaBins on each request of ``inp['spatial']`` (one image
  each: even, uneven and too few bands), in fp32 and fp64, and of the
  option models of ``inp['spatial']['options']`` in fp64, with the plans;
* ``tp_card`` (tests/test_torch_gpu.py, a 1 x 2 grid over gloo on one
  card): the tiny GraphBins in bf16 on kernel 5's route, split, one
  forward: its depth, kernel 5's launches and each launch's (B, H) and
  error against the plain version;
* ``spatial_card`` (tests/test_torch_gpu.py, the same grid): that model on
  ``encoder_impl="kernel"`` served spatially: its depth, the launches of
  kernel 1's row-window form and kernel 8's halo form, and each launch's
  error against its plain version.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

from objcavit_torch import cli
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.losses import LossWrapper
from objcavit_torch.losses.losses import mse_loss
from objcavit_torch.metrics import metrics_sync
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.common import BatchNorm2d
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.minivit import MiniViT
from objcavit_torch.parallel import make_grid, tp_gather_state_dict, tp_shard_model
from objcavit_torch.parallel.collectives import GradientReducer, rand_rows
from objcavit_torch.parallel.distributed import (
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    shutdown_distributed,
)
from objcavit_torch.training import checkpoint
from objcavit_torch.training.loop import Trainer
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.training import steps
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import make_train_step
from objcavit_torch.utils.benchkit import build_flagship_model


class IndexDataset:
    """Sample i is an image filled with i; its draws come from the loader's
    generator, as a train sample's do."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        rng.random()
        return {"image": np.full((2, 2, 3), idx, np.float32),
                "depth": np.ones((2, 2, 1), np.float32), "focal": 1.0,
                "image_path": f"{idx}.jpg", "depth_path": f"{idx}.png"}


def task_group(work: str) -> dict:
    inp = torch.load(os.path.join(work, "group_in.pt"), weights_only=False)
    rank, world = process_index(), process_count()
    out = {"rank": rank, "world": world, "main": is_main_process()}
    state = {k: torch.tensor(v) for k, v in inp["states"][rank].items()}
    out["merged"] = {k: float(v) for k, v in metrics_sync(state).items()}

    loader = DeviceLoader(IndexDataset(inp["n"]), inp["batch"], "cpu", shuffle=True,
                          seed=inp["seed"], synchronous=True)
    out["batches"] = [(b["image"][:, 0, 0, 0].astype(int).tolist(), b["sample_valid"].tolist())
                      for b, _ in loader.host_batches()]
    try:
        DeviceLoader(IndexDataset(inp["n"]), inp["batch"] + world // 2, "cpu")
    except ValueError as e:
        out["divide_error"] = str(e)

    out["rand"] = [rand_rows(shape, torch.Generator().manual_seed(5), "cpu", dim).tolist()
                   for shape, dim in inp["rand"]]

    holder = types.SimpleNamespace(is_main=is_main_process(), device=torch.device("cpu"))
    out["run_dir"] = Trainer._run_dir(holder, os.path.join(work, "runs"), False)[0]
    unseen = os.path.join(work, "unseen")
    if rank == world - 1:  # this rank sees no run dir under ``unseen``
        real = os.path.isdir
        os.path.isdir = lambda p: False if str(p).startswith(unseen) else real(p)
    try:
        Trainer._run_dir(holder, unseen, False)
    except RuntimeError as e:
        out["unseen_error"] = str(e)
    out.update(uneven_rows(inp["uneven"], rank))
    out.update(reduce_gradients(rank))
    return out


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "all_to_all")


class CountCollectives:
    """Counts the calls of ``torch.distributed``'s collectives while open."""

    def __enter__(self):
        self.calls, self.saved = [], {n: getattr(dist, n) for n in COLLECTIVES}
        for name, fn in self.saved.items():
            setattr(dist, name, lambda *a, _n=name, _f=fn, **k: (self.calls.append(_n),
                                                                  _f(*a, **k))[1])
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def uneven_rows(inp: dict, rank: int) -> dict:
    """Rank p's rows ``inp['rows'][p]`` of the fp64 global batch: the
    group's ``BatchNorm2d`` in training (its output, running statistics and
    the gradients of sum(y * c) over this rank's rows), the collectives it
    made forward and backward; the MSE of this rank's rows and its
    gradient."""
    rows = slice(*inp["rows"][rank])
    x = torch.from_numpy(inp["x"][rows]).requires_grad_()
    bn = BatchNorm2d(x.shape[1], eps=inp["eps"]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    with CountCollectives() as fwd:
        y = bn(x)
    with CountCollectives() as bwd:
        y.backward(torch.from_numpy(inp["c"][rows]))
    pred = torch.from_numpy(inp["pred"][rows]).requires_grad_()
    mse = mse_loss(pred, torch.from_numpy(inp["gt"][rows]))
    mse.backward()
    return {"bn": {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                   "running_mean": bn.running_mean, "running_var": bn.running_var,
                   "fwd": fwd.calls, "bwd": bwd.calls},
            "mse": float(mse), "mse_grad": pred.grad}


def reduce_gradients(rank: int) -> dict:
    """``GradientReducer`` over three parameters: gradients rank + 1 on #0
    and #2 of every rank (#1 without one), then #0, #1 on even ranks and
    #1, #2 on odd ones: as many a rank, other sets."""
    params = [torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)) for _ in range(3)]
    for i in (0, 2):
        params[i].grad = torch.full((3,), rank + 1.0, dtype=torch.float64)
    GradientReducer(params)()
    out = {"reduced": [None if p.grad is None else p.grad.tolist() for p in params]}
    for i, p in enumerate(params):
        p.grad = torch.ones(3, dtype=torch.float64) if i in ((0, 1) if rank % 2 == 0
                                                              else (1, 2)) else None
    try:
        GradientReducer(params)()
    except RuntimeError as e:
        out["layout_error"] = str(e)
    return out


def task_empty_grads(work: str) -> dict:
    """``GradientReducer`` where rank 0 has gradients on both parameters and
    rank 1 none: each rank's error, or None."""
    params = [torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)) for _ in range(2)]
    if process_index() == 0:
        for p in params:
            p.grad = torch.ones(3, dtype=torch.float64)
    try:
        GradientReducer(params)()
    except RuntimeError as e:
        return {"error": str(e)}
    return {"error": None}


def make_step(inp: dict, dtype: torch.dtype = torch.float32):
    """tests/test_torch_train.py's step of the tiny GraphBins from
    ``inp``'s weights and settings, with parameters and compute in
    ``dtype``, augmentation and dropout on."""
    model = GraphBins(encoder_name=inp["enc"], n_bins=inp["n_bins"], dropout_rate=inp["dropout"])
    model.load_state_dict(inp["state"])
    model.to(dtype)
    optimizer, scheduler = build_optimizer(model, inp["lr"], inp["wd"], inp["total_steps"])
    return make_train_step(model, optimizer, scheduler, LossWrapper(*inp["losses"]),
                           inp["min_depth"], augment_on_device=True,
                           gradient_clip_val=inp["clip"], compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(inp["seed"]))


def tensors(tree: dict, dtype: torch.dtype = torch.float32, rows=slice(None)) -> dict:
    """Numpy arrays -> tensors of ``rows``, floating ones in ``dtype``."""
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def _grads(model) -> dict:
    return {n: None if p.grad is None else p.grad.detach().clone()
            for n, p in model.named_parameters()}


def task_step(work: str) -> dict:
    inp = torch.load(os.path.join(work, "step_in.pt"), weights_only=False)
    rows = slice(process_index(), None, process_count())
    step = make_step(inp, torch.float64)
    loss = step(tensors(inp["batch"], torch.float64, rows),
                tensors(inp["objects"], torch.float64, rows))
    out = {"loss": float(loss), "grads": _grads(step.model),
           "state": {k: v.clone() for k, v in step.model.state_dict().items()},
           "reducer": type(step.grad_reducer).__name__}

    draws = [torch.from_numpy(a) for a in inp["jax_draws"]]
    real_rand = torch.rand

    def replay(size, generator=None, device=None, **_):
        want = draws.pop(0)
        if tuple(size) != tuple(want.shape):
            raise AssertionError(f"draw of {tuple(size)}, JAX drew {tuple(want.shape)}")
        return want.to(device)

    step = make_step(inp)
    torch.rand = replay
    try:
        loss = step.loss(tensors(inp["batch"], rows=rows), tensors(inp["objects"], rows=rows))
        loss.backward()
        step.grad_reducer()
    finally:
        torch.rand = real_rand
    out["jax_fed"] = {"loss": float(loss.detach()), "grads": _grads(step.model),
                      "draws_left": len(draws)}
    return out


def tiny_tp_model(inp: dict, dtype: torch.dtype) -> GraphBins:
    """tests/test_parallel_2d.py's tiny GraphBins from ``inp``'s weights, in ``dtype``."""
    model = GraphBins(encoder_name=inp["enc"], n_bins=inp["n_bins"], n_queries=inp["n_queries"],
                      dims_train=inp["dims"], dims_test=inp["dims"], dropout_rate=inp["dropout"])
    model.load_state_dict(inp["state"])
    return model.to(dtype)


def _local_shapes(model, specs) -> dict:
    return {n: tuple(model.get_parameter(n).shape) for n in specs}


def task_tp_grid(work: str) -> dict:
    inp = torch.load(os.path.join(work, "tp_grid_in.pt"), weights_only=False)
    grid = make_grid(*inp["grid"])
    rows = slice(grid.data_index, None, grid.n_data)
    out = {"place": (process_index(), grid.data_index, grid.model_index)}
    for label, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        model = tiny_tp_model(inp, dtype).eval()
        specs = tp_shard_model(model, grid)
        with torch.no_grad():
            out[label] = model(*tensors(inp["inputs"], dtype, rows).values())["depth_pred"]
    out["specs"], out["local_shapes"] = specs, _local_shapes(model, specs)
    out["gathered"] = tp_gather_state_dict(model, grid)
    pipe = DepthPipeline(model.float(), eval_dims=inp["dims"], n_obj_max=inp["n_obj"], grid=grid)
    out["served"] = pipe(inp["frames"])
    out["spatial"] = {}
    for label, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        for name, m in (("whole", tiny_tp_model(inp, dtype).eval()), ("split", model.to(dtype))):
            served = serve_spatially(m, inp, inp["frames"], grid)
            out["spatial"][f"{name} {label}"] = served["depth"]
            out["spatial"]["plan"] = served["plan"]
    out["step"] = tp_step(inp["step"], grid)
    return out


def serve_spatially(model, inp: dict, frames, grid) -> dict:
    """``DepthPipeline(grid=grid, spatial=True)`` of ``model`` on
    ``frames``, at their height: the depth, the plan's bands and why it
    serves whole (None where it splits)."""
    pipe = DepthPipeline(model, eval_dims=frames.shape[1:3], n_obj_max=inp["n_obj"], grid=grid,
                         spatial=True)
    plan = pipe.bands()
    return {"depth": pipe(frames), "plan": (plan.bands(), plan.reason)}


def tp_step(inp: dict, grid) -> dict:
    """One fp64 train step of the tiny GraphBins split over ``grid``'s model
    axis, on this rank's rows of the global batch: its loss, the norm the
    clipping saw, the gathered (clipped) gradients and parameters after the
    step, the specs and the local shapes after it."""
    rows = slice(grid.data_index, None, grid.n_data)
    dtype = torch.float64
    model = tiny_tp_model(inp, dtype)
    optimizer, scheduler = build_optimizer(model, inp["lr"], inp["wd"], inp["total_steps"])
    specs = tp_shard_model(model, grid)  # after the optimizer: it keeps the same parameters
    step = make_train_step(model, optimizer, scheduler, LossWrapper(*inp["losses"]),
                           inp["min_depth"], augment_on_device=True,
                           gradient_clip_val=inp["clip"], compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(inp["seed"]))
    seen = {}
    real_clip = steps.clip_grad_norm_

    def clip(m, max_norm):
        seen["norm"] = float(real_clip(m, max_norm))
        seen["grads"] = tp_gather_state_dict(m, grid, grads=True)  # clipped
        return seen["norm"]

    steps.clip_grad_norm_ = clip
    try:
        loss = step(tensors(inp["batch"], dtype, rows), tensors(inp["objects"], dtype, rows))
    finally:
        steps.clip_grad_norm_ = real_clip
    return {"loss": float(loss), "norm": seen["norm"], "grads": seen["grads"], "specs": specs,
            "local_shapes": _local_shapes(model, specs),
            "state": tp_gather_state_dict(model, grid)}


def task_tp_step(work: str) -> dict:
    inp = torch.load(os.path.join(work, "tp_step_in.pt"), weights_only=False)
    grid = make_grid(*inp["grid"])
    out = tp_step(inp, grid)
    dtype = torch.float64
    vit = MiniViT(**inp["minivit"]["kwargs"]).to(dtype).eval()
    vit.load_state_dict(inp["minivit"]["state"])
    out["minivit_specs"] = tp_shard_model(vit, grid)
    with torch.no_grad():
        out["minivit"] = vit(torch.from_numpy(inp["minivit"]["x"]))
    out["spatial"] = {}
    for label, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        for name, frames in inp["spatial"]["frames"].items():
            model = tiny_tp_model(inp, dtype).eval()
            out["spatial"][f"{name} {label}"] = serve_spatially(model, inp, frames, grid)
        adabins = AdaBins(**inp["spatial"]["adabins"]["kwargs"]).to(dtype).eval()
        adabins.load_state_dict(inp["spatial"]["adabins"]["state"])
        out["spatial"][f"adabins {label}"] = serve_spatially(
            adabins, inp, inp["spatial"]["adabins"]["frames"], grid)
    for name, spec in inp["spatial"]["options"].items():
        model = GraphBins(**spec["kwargs"]).double().eval()
        model.load_state_dict(spec["state"])
        out["spatial"][f"{name} fp64"] = serve_spatially(model, inp, spec["frames"], grid)
    return out


def task_tp_card(work: str) -> dict:
    from objcavit_torch.kernels import attention as kattn
    from objcavit_torch.utils.kernel_io import attention_plain_outputs, record_attention_io

    inp = torch.load(os.path.join(work, "tp_card_in.pt"), weights_only=False)
    grid = make_grid(1, 2)
    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny",
                                 attn_impl="kernel")
    tp_shard_model(model, grid)
    before = kattn.fused_mha_fwd.launches
    with torch.no_grad(), record_attention_io() as records:
        depth = model(*(t.cuda() for t in inp["inputs"]))["depth_pred"]
    torch.cuda.synchronize()
    errs = []
    for rec in records:
        for _, got, want in attention_plain_outputs(rec):
            bound = 2.0 ** -7 * want.float().abs() + 1e-4 * float(want.float().abs().max())
            errs.append(float(((got.float() - want.float()).abs() - bound).max()))
    return {"depth": depth.cpu(), "launches": kattn.fused_mha_fwd.launches - before,
            "heads": sorted({tuple(r["q"].shape[::2]) for r in records}), "excess": max(errs)}


def task_spatial_card(work: str) -> dict:
    """The tiny GraphBins in bf16 on ``encoder_impl="kernel"``, split over a
    1 x 2 grid and served spatially: the depth, the plan, the launches of
    kernel 1's row-window form and kernel 8's halo form, and each launch's
    count of values out of its check against the plain version."""
    from objcavit_torch.kernels import mbconv as kmb
    from objcavit_torch.kernels import resize as kresize
    from objcavit_torch.utils.kernel_io import (
        mbconv_head_errors,
        record_encoder_kernel_io,
        record_resize_rows_io,
        resize_rows_errors,
    )

    inp = torch.load(os.path.join(work, "spatial_card_in.pt"), weights_only=False)
    grid = make_grid(1, 2)
    model = build_flagship_model(device="cuda", encoder_name="efficientnet-tiny",
                                 attn_impl="kernel", encoder_impl="kernel")
    tp_shard_model(model, grid)
    frames = inp["frames"]
    pipe = DepthPipeline(model, eval_dims=frames.shape[1:3], n_obj_max=6, grid=grid, spatial=True)
    counters = (kresize.resize_bilinear_align_corners_rows, kmb.mbconv_expand_dw_pool_rows)
    before = [f.launches for f in counters]
    with record_resize_rows_io() as resized, record_encoder_kernel_io() as encoder:
        depth = pipe(frames)
    torch.cuda.synchronize()
    bad = sum(resize_rows_errors(r)["bad"] for r in resized)
    for r in encoder:
        if r["kind"] == "mbconv_head_rows":
            x, we, be, wd, bd, k, top, bottom = r["args"]
            bad += mbconv_head_errors(x, we, be, wd, bd, k, *r["out"], 2.0 ** -7, 1e-5, 1e-4,
                                      rows=(top, bottom))["bad"]
    return {"depth": depth.cpu(), "plan": pipe.bands().bands(), "bad": bad,
            "launches": [f.launches - b for f, b in zip(counters, before)]}


def task_cli(work: str) -> dict:
    with open(os.path.join(work, "cli_argv.json")) as f:
        argv = json.load(f)
    written = []
    real_save, real_config = checkpoint._save_atomic, checkpoint.save_config

    def save(obj, path):
        written.append(os.path.basename(path))
        real_save(obj, path)

    def save_config(cfg, path):
        written.append(os.path.basename(path))
        real_config(cfg, path)

    checkpoint._save_atomic, checkpoint.save_config = save, save_config
    _, metrics = cli.main(argv, basic_params_path="/nonexistent")
    return {"metrics": metrics, "written": written}


def main() -> None:
    task, work = sys.argv[1], sys.argv[2]
    rank = int(os.environ["OBJCAVIT_PROCESS_ID"])
    if task in ("tp_grid", "tp_step"):
        # the tiny model's ranks on one intra-op thread each: a rank's
        # OpenMP regions spin against the other ranks and the test workers
        # (tests/test_torch_fit.py::one_torch_thread)
        torch.set_num_threads(1)
    if task == "cli":  # cli.main joins and leaves the group itself
        out = task_cli(work)
    else:
        # two ranks share the one card in tp_card: NCCL refuses that, gloo does not
        backend = "gloo" if task in ("tp_card", "spatial_card") else None
        if not initialize_distributed(backend=backend,
                                      device=os.environ.get(cli.ENV_DEVICE, "cuda")):
            raise SystemExit("no OBJCAVIT_* env: start this through objcavit_torch.parallel.launch")
        try:
            out = {"group": task_group, "step": task_step, "empty_grads": task_empty_grads,
                   "tp_grid": task_tp_grid, "tp_step": task_tp_step,
                   "tp_card": task_tp_card, "spatial_card": task_spatial_card}[task](work)
        finally:
            shutdown_distributed()
    torch.save(out, os.path.join(work, f"{task}_{rank}.pt"))
    print(json.dumps({"task": task, "done": True}), flush=True)


if __name__ == "__main__":
    main()
