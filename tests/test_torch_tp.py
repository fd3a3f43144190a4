"""Tensor parallelism of the attention stacks (objcavit_torch.parallel.tp) on the CPU.

The port's counterpart of tests/test_parallel_2d.py's three TP tests, on
its tiny GraphBins (``efficientnet-tiny``, 16 bins, 64x96, 3 objects) and
its numpy inputs. The ranks are real processes over gloo, started once a
module fixture through ``objcavit_torch.parallel.launch`` (``--cpu``), as
tests/test_torch_distributed.py starts them (``tests/torch_dist_workers.py``):

* the split names and their count against JAX's ``tp_spec_for`` and
  ``count_tp_sharded`` on the same variables, at n = 2, 4 and 7, and the
  one divergence, the head split, at n = 8 with 4 heads;
* a 2 x 2 grid's eval forward in fp32 against JAX's ``tp_shard_params``
  forward on ``make_mesh(n_data=4, n_model=2)``, at test_parallel_2d.py's
  tolerance, and in fp64 against one process's at rel 1e-10; its gathered
  state dict; ``DepthPipeline(grid=...)``;
* a 1 x 2 grid's fp64 train step (augmentation, dropout, clipping at 0.1)
  against one process's on the same draws at rel 1e-10, the norm the
  clipping saw, and the split parameters still split after the step;
* a split miniViT (AdaBins' head) against one process's;
* spatial serving (``DepthPipeline(spatial=True)``, ``parallel/spatial.py``)
  in the same launches: on the 2 x 2 grid at bs 4, the model whole and
  split; on the 1 x 2 grid at bs 1 (test_parallel_2d.py's ``-v`` case),
  on uneven bands (3 units: 2 + 1), on a height of fewer units than
  model ranks (served whole, as the plan says) and for the tiny AdaBins;
  fp32 against JAX's ``DepthPipeline(mesh=..., spatial=True)`` at
  test_parallel_2d.py's tolerance, fp64 against one process's at rel
  1e-10, and each plan's bands; ObjCAViT's options, the final upsample
  and a V2 encoder on bands in fp64 against one process's.

Each comparison states its tolerance.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from objcavit_tpu.models import AdaBins as JaxAdaBins
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.parallel import count_tp_sharded as jax_count_tp_sharded
from objcavit_tpu.parallel import make_mesh, shard_batch, tp_shard_params
from objcavit_tpu.parallel import tp_spec_for as jax_tp_spec_for
from objcavit_tpu.utils.torch_import import convert_state_dict

from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline

from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.minivit import MiniViT
from objcavit_torch.parallel import count_tp_sharded, current_grid, make_grid, tp_spec_for
from objcavit_torch.parallel.mesh import reset_grid
from objcavit_torch.parallel.tp import tp_specs
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.training import steps
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.utils.benchkit import init_weights_
from objcavit_torch.utils.convert import state_dict_from_variables
from tests.test_parallel_2d import NOBJ, H, W, _inputs
from tests.test_torch_distributed import _rel, run_ranks
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (an autouse fixture)
from tests.test_torch_train import CLIP, LOSSES, LR, MAX_DEPTH, MIN_DEPTH, TOTAL_STEPS, WD
from tests.torch_dist_workers import tensors, tiny_tp_model

ENC, N_BINS = "efficientnet-tiny", 16
N_QUERIES = (H // 2 // 16) * (W // 2 // 16) - 1  # JAX's lazily shaped conv_out at 64x96: 5
FP64_REL = 1e-10
STEP_SEED = 7
MINIVIT = {"in_channels": 16, "n_query_channels": 8, "patch_size": 4, "dim_out": 16,
           "embed_dim": 128, "num_heads": 4, "max_seq_len": 16, "dropout_rate": 0.1}


def _jax_model():
    return JaxGraphBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                        pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W))


@pytest.fixture(scope="module")
def weights():
    """The tiny GraphBins' state dict (the port's init from seed 0) and
    JAX's variables of it."""
    model = init_weights_(GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES,
                                    dims_train=(H, W), dims_test=(H, W)),
                          torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_state_dict({f"model.{k}": v.numpy() for k, v in sd.items()}, "graphbins",
                                   ENC, pos_strategy="learned_bbox_wh")
    return sd, variables


def _inp(sd: dict, **extra) -> dict:
    return {"state": sd, "enc": ENC, "n_bins": N_BINS, "n_queries": N_QUERIES, "dims": (H, W),
            "dropout": 0.1, **extra}


# ------------------------------------------------------------------- specs


def _jax_split_names(variables, n: int) -> set[str]:
    """The port's names of the parameters JAX's tp_spec_for splits at n:
    each JAX leaf replaced by ones where it splits, zeros where not, mapped
    onto the port's state dict."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, float(jax_tp_spec_for(path, x, n) != P()), np.float32),
        variables["params"])
    sd = state_dict_from_variables({"params": marked}, ENC)
    return {k for k, v in sd.items() if v.size and np.all(v == 1.0)}


@pytest.mark.parametrize("n", [2, 4, 7])
def test_split_names_and_count_match_jax(weights, n):
    """Wherever the 4 heads divide by n (and at 7, where nothing splits in
    either), the port splits JAX's parameters: the same names, the same
    count as JAX's count_tp_sharded, and each along JAX's axis mapped onto
    the torch layout (dim 0 of in_proj and linear1, dim 1 of out_proj and
    linear2)."""
    sd, variables = weights
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES,
                      dims_train=(H, W), dims_test=(H, W))
    specs = tp_specs(model, n)
    assert set(specs) == _jax_split_names(variables, n)
    assert count_tp_sharded(model, n) == jax_count_tp_sharded(variables["params"], n)
    if n == 7:
        assert not specs
        return
    assert count_tp_sharded(model, n) >= 20
    for name, dim in specs.items():
        leaf = name.rsplit(".", 2)
        want = 0 if leaf[-1].startswith("in_proj") or leaf[-2] == "linear1" else 1
        assert dim == want, name


def test_head_split_diverges_from_jax_where_heads_do_not_divide(weights):
    """At n = 8 JAX still splits the 4-head attentions' in_proj (3E = 384
    columns) and out_kernel (E = 128 rows); the port splits by heads, so
    they stay replicated. The two sets differ by exactly those three
    parameters of every attention; the FFNs split in both."""
    sd, variables = weights
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES,
                      dims_train=(H, W), dims_test=(H, W))
    port, jax_names = set(tp_specs(model, 8)), _jax_split_names(variables, 8)
    attns = [p for p, m in model.named_modules() if type(m).__name__ == "MultiHeadAttention"]
    assert len(attns) == 10
    assert jax_names - port == {f"{a}.{n}" for a in attns
                                for n in ("in_proj_weight", "in_proj_bias", "out_proj.weight")}
    assert not port - jax_names and port and all(".linear" in n for n in port)
    with pytest.raises(ValueError, match="num_heads"):
        tp_spec_for("a.in_proj_weight", sd["objcavit.saca_1.cross_attn_obj_im.in_proj_weight"], 2)


def test_grid_without_a_group_is_one_by_one():
    """With no process group the grid is 1 x 1 with no group, made or not;
    a shape the world does not fill raises ValueError."""
    try:
        for grid in (current_grid(), make_grid(), make_grid(1, 1)):
            assert (grid.n_data, grid.n_model, grid.data_index, grid.model_index) == (1, 1, 0, 0)
            assert grid.data_group is None and grid.model_group is None
        for shape in ((2, 1), (1, 2), (2, 2)):
            with pytest.raises(ValueError, match="processes"):
                make_grid(*shape)
    finally:
        reset_grid()


# --------------------------------------------------------------- 2 x 2 grid


@pytest.fixture(scope="module")
def grid_run(weights, tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_grid")
    sd, _ = weights
    img, feats, xywh, valid = _inputs(4)
    frames = np.random.default_rng(3).integers(0, 256, (4, H, W, 3)).astype(np.uint8)
    inputs = {"image": img, "features": feats, "xywh": xywh, "valid": valid}
    step = _step_inp(sd)
    torch.save(_inp(sd, grid=(2, 2), inputs=inputs, frames=frames, n_obj=NOBJ, step=step),
               work / "tp_grid_in.pt")
    return {"ranks": run_ranks("tp_grid", work, 4), "inputs": inputs, "frames": frames,
            "single_step": _single_step(step)}


def _interleave(parts: list[torch.Tensor]) -> torch.Tensor:
    """The global batch from each data rank's rows [d::n]."""
    n = len(parts)
    out = torch.empty((parts[0].shape[0] * n,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype)
    for d, rows in enumerate(parts):
        out[d::n] = rows
    return out


def _grid_depth(ranks: list[dict], label: str) -> torch.Tensor:
    """The 2 x 2 grid's global depth: both model ranks of a data index hold
    the same bits; the data ranks' rows interleaved."""
    by_data = {}
    for r in ranks:
        _, d, _ = r["place"]
        if d in by_data:
            assert torch.equal(by_data[d], r[label]), (label, r["place"])
        by_data[d] = r[label]
    return _interleave([by_data[d] for d in sorted(by_data)])


def test_grid_places_ranks_as_jax_reshapes_devices(grid_run):
    """Rank r at data r // 2, model r % 2; each rank's split parameters
    hold its half."""
    ranks = grid_run["ranks"]
    assert [r["place"] for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    for r in ranks:
        for name, dim in r["specs"].items():
            full = r["gathered"][name].shape
            want = list(full)
            want[dim] //= 2
            assert r["local_shapes"][name] == tuple(want), name


def test_grid_forward_matches_jax_tensor_parallel(weights, grid_run):
    """The 2 x 2 grid's fp32 depth against JAX's forward with
    tp_shard_params on make_mesh(n_data=4, n_model=2) over the 8 virtual
    CPU devices: tests/test_parallel_2d.py:112's rtol 2e-4, atol 2e-5."""
    _, variables = weights
    model = _jax_model()
    mesh = make_mesh(n_data=4, n_model=2)
    tp_vars = {"params": tp_shard_params(mesh, variables["params"]),
               "batch_stats": variables["batch_stats"]}
    inputs = grid_run["inputs"]
    batch = shard_batch(mesh, (inputs["image"], inputs["features"], inputs["xywh"],
                               inputs["valid"]))
    want = jax.jit(lambda v, i, f, x, m: model.apply(v, i, f, x, m, train=False))(tp_vars, *batch)
    np.testing.assert_allclose(_grid_depth(grid_run["ranks"], "fp32").numpy(),
                               np.asarray(want["depth_pred"], np.float32), rtol=2e-4, atol=2e-5)


def test_grid_forward_matches_one_process_in_fp64(weights, grid_run):
    """The 2 x 2 grid's fp64 depth against the port's single-process fp64
    forward on the whole batch: rel L2 1e-10 (the split only reorders the
    sums of out_proj's and linear2's products)."""
    sd, _ = weights
    model = tiny_tp_model(_inp(sd), torch.float64).eval()
    with torch.no_grad():
        want = model(*tensors(grid_run["inputs"], torch.float64).values())["depth_pred"]
    assert _rel(_grid_depth(grid_run["ranks"], "fp64"), want) < FP64_REL


def test_gathered_state_dict_is_the_single_process_one(weights, grid_run):
    """tp_gather_state_dict on every rank: the single-process state dict,
    the split parameters joined from their two halves bit for bit."""
    sd, _ = weights
    for r in grid_run["ranks"]:
        got = r["gathered"]
        assert list(got) == list(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v.to(got[k].dtype)), k


def test_grid_server_returns_the_global_depth(weights, grid_run):
    """DepthPipeline(grid=...) on the 2 x 2 grid: every rank returns the
    whole request's depth, the same bits, within rtol 1e-5, atol 1e-6 of
    one process's server (fp32; the split reorders sums)."""
    sd, _ = weights
    model = tiny_tp_model(_inp(sd), torch.float32)
    want = DepthPipeline(model, eval_dims=(H, W), n_obj_max=NOBJ)(grid_run["frames"])
    ranks = grid_run["ranks"]
    for r in ranks:
        assert torch.equal(r["served"], ranks[0]["served"])
    np.testing.assert_allclose(ranks[0]["served"].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ spatial serving


def _jax_spatial(model, variables, frames, n_data: int) -> np.ndarray:
    """JAX's spatial server on make_mesh(n_data, 2) at the frames' size."""
    pipe = JaxDepthPipeline(model, variables, eval_dims=frames.shape[1:3], n_obj_max=NOBJ,
                            mesh=make_mesh(n_data=n_data, n_model=2), spatial=True)
    return np.asarray(pipe(frames), np.float32)


def _one_process(model, frames) -> torch.Tensor:
    return DepthPipeline(model, eval_dims=frames.shape[1:3], n_obj_max=NOBJ)(frames)


def test_spatial_grid_matches_jax_and_one_process(weights, grid_run):
    """DepthPipeline(spatial=True) on the 2 x 2 grid, bs 4 at 64x96: bands
    of 32 rows on each model rank; every rank returns the whole request's
    depth, the same bits; the model whole and split over the model axis
    (its attention on the tokens every model rank gathered) within
    test_parallel_2d.py's rtol 2e-4, atol 2e-5 of JAX's spatial server on
    make_mesh(n_data=2, n_model=2) in fp32, and within rel L2 1e-10 of one
    process's server in fp64."""
    sd, variables = weights
    frames = grid_run["frames"]
    want = _jax_spatial(_jax_model(), variables, frames, n_data=2)
    one = _one_process(tiny_tp_model(_inp(sd), torch.float64).eval(), frames)
    ranks = [r["spatial"] for r in grid_run["ranks"]]
    for r in ranks:
        assert r["plan"] == ([(0, 32), (32, 64)], None)
        for key in ("whole fp32", "split fp32", "whole fp64", "split fp64"):
            assert torch.equal(r[key], ranks[0][key]), key
    for name in ("whole", "split"):
        np.testing.assert_allclose(ranks[0][f"{name} fp32"].numpy(), want, rtol=2e-4, atol=2e-5)
        assert _rel(ranks[0][f"{name} fp64"], one) < FP64_REL, name


# ----------------------------------------------------------- 1 x 2, a step


def _step_inputs():
    rng = np.random.default_rng(1)
    img, feats, xywh, valid = _inputs(4)
    batch = {"image": img, "depth": rng.uniform(0.0005, 9.0, (4, H, W, 1)).astype(np.float32)}
    return batch, {"features": feats, "xywh": xywh, "valid": valid}


def _minivit():
    vit = init_weights_(MiniViT(**MINIVIT), torch.Generator().manual_seed(2))
    x = np.random.default_rng(4).standard_normal((2, 12, 12, MINIVIT["in_channels"]))
    return {"kwargs": MINIVIT, "state": vit.state_dict(), "x": x}


ADABINS = {"encoder_name": ENC, "n_bins": N_BINS, "n_queries": N_QUERIES,
           "min_depth": MIN_DEPTH, "max_depth": MAX_DEPTH}
# the 1 x 2 grid's spatial requests, one image each: (rows, columns)
SPATIAL_FRAMES = {"bs1": (H, W), "uneven": (96, 64), "whole": (32, 192)}
SPATIAL_BANDS = {"bs1": ([(0, 32), (32, 64)], None), "uneven": ([(0, 64), (64, 96)], None),
                 "whole": ([(0, 32), (0, 32)], "32 rows are 1 of 32-row units, fewer than 2 model ranks"),
                 "adabins": ([(0, 32), (32, 64)], None)}


# ObjCAViT's options, the final upsample and a V2 encoder on bands: every
# option reads coordinates only, so none is refused spatially
SPATIAL_OPTIONS = {
    "grid_roi_align+use_2_saca+final_upscale": {
        "encoder_name": ENC, "n_bins": N_BINS, "n_queries": 23, "dims_train": (H, W),
        "dims_test": (H, W), "pos_strategy": "grid_random_roi_align", "use_2_saca": True,
        "do_final_upscale": True},
    "grid_random+no_obj_sa+v2": {
        "encoder_name": "efficientnet-v2-tiny", "n_bins": N_BINS, "n_queries": N_QUERIES,
        "dims_train": (H, W), "dims_test": (H, W), "pos_strategy": "grid_random",
        "no_obj_sa": True},
}


def _spatial_inp() -> dict:
    rng = np.random.default_rng(11)
    frames = {k: rng.integers(0, 256, (1, h, w, 3)).astype(np.uint8)
              for k, (h, w) in SPATIAL_FRAMES.items()}
    adabins = init_weights_(AdaBins(**ADABINS), torch.Generator().manual_seed(5))
    options = {name: {"kwargs": kw, "frames": frames["bs1"], "state": init_weights_(
        GraphBins(**kw), torch.Generator().manual_seed(6)).eval().state_dict()}
        for name, kw in SPATIAL_OPTIONS.items()}
    return {"frames": frames, "options": options,
            "adabins": {"kwargs": ADABINS, "state": adabins.state_dict(),
                        "frames": rng.integers(0, 256, (1, H, W, 3)).astype(np.uint8)}}


def _step_inp(sd: dict, **extra) -> dict:
    batch, objects = _step_inputs()
    return _inp(sd, batch=batch, objects=objects, lr=LR, wd=WD, total_steps=TOTAL_STEPS,
                losses=LOSSES, min_depth=MIN_DEPTH, clip=CLIP, seed=STEP_SEED, **extra)


@pytest.fixture(scope="module")
def step_run(weights, tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_step")
    sd, _ = weights
    inp = _step_inp(sd, grid=(1, 2), minivit=_minivit(), spatial=_spatial_inp(), n_obj=NOBJ)
    torch.save(inp, work / "tp_step_in.pt")
    return {"ranks": run_ranks("tp_step", work, 2), "single": _single_step(inp), "inp": inp}


def _single_step(inp: dict) -> dict:
    """The same fp64 step in this process, no group, from the same seed."""
    from objcavit_torch.training.steps import make_train_step

    model = tiny_tp_model(inp, torch.float64)
    optimizer, scheduler = build_optimizer(model, LR, WD, TOTAL_STEPS)
    step = make_train_step(model, optimizer, scheduler, LossWrapper(*LOSSES), MIN_DEPTH,
                           augment_on_device=True, gradient_clip_val=CLIP,
                           compute_dtype=torch.float64,
                           generator=torch.Generator().manual_seed(STEP_SEED))
    seen = {}
    real_clip = steps.clip_grad_norm_

    def clip(m, max_norm):
        seen["norm"] = float(real_clip(m, max_norm))
        seen["grads"] = {n: None if p.grad is None else p.grad.clone()
                         for n, p in m.named_parameters()}
        return seen["norm"]

    steps.clip_grad_norm_ = clip
    try:
        loss = step(tensors(inp["batch"], torch.float64), tensors(inp["objects"], torch.float64))
    finally:
        steps.clip_grad_norm_ = real_clip
    return {"loss": float(loss), "state": model.state_dict(), **seen}


def _assert_step_matches(ranks: list[dict], single: dict) -> None:
    """Every rank: the same loss, within rel 1e-10 of one process's; every
    clipped gradient and every parameter and BN statistic after the step,
    gathered, within rel L2 1e-10 of one process's (an absolute 1e-10 of
    the whole gradient's norm for gradients that are zero in exact
    arithmetic, the decoder's conv biases before train-mode BNs, and 1e-14
    for the running means that are), the same bits on every rank. The
    parameters nothing reads keep no gradient."""
    assert len({r["loss"] for r in ranks}) == 1
    assert ranks[0]["loss"] == pytest.approx(single["loss"], rel=FP64_REL)
    total = float(torch.sqrt(sum((g * g).sum() for g in single["grads"].values()
                                 if g is not None)))
    for r in ranks:
        for name, want in single["grads"].items():
            got = r["grads"][name]
            if want is None:
                assert got is None, name
                continue
            assert float((got - want).norm()) <= FP64_REL * (float(want.norm()) + total), name
        for key, want in single["state"].items():
            got = r["state"][key]
            if not want.is_floating_point():  # the BNs' counts
                assert torch.equal(got, want), key
                continue
            assert float((got - want).norm()) <= FP64_REL * float(want.norm()) + 1e-14, key
        for key in r["state"]:
            assert torch.equal(r["state"][key], ranks[0]["state"][key]), key


def test_tp_step_matches_one_process(step_run):
    """The 1 x 2 grid's fp64 step against one process's (``_assert_step_matches``)."""
    _assert_step_matches(step_run["ranks"], step_run["single"])


def test_grid_step_matches_one_process(grid_run):
    """The 2 x 2 grid's fp64 step, each data rank on its 2 of the 4 rows,
    against one process's on all 4 (``_assert_step_matches``): the split
    gradients averaged over the data axis, the replicated ones over every
    rank, the BatchNorms over the data axis's rows, the dropout's columns
    and rows of the global draw. Measured on this CPU: 1.1e-15 of a
    gradient's norm plus the whole gradient's, 5.3e-15 on a parameter."""
    _assert_step_matches([r["step"] for r in grid_run["ranks"]], grid_run["single_step"])


def test_tp_clip_norm_is_the_whole_models(step_run):
    """The norm the clipping saw under the split (the replicated gradients
    once, the split ones' squares summed over the model group) is one
    process's, rel 1e-10, on both ranks; it is above the 0.1 clip, so the
    clip scaled every gradient."""
    single = step_run["single"]
    assert single["norm"] > CLIP
    for r in step_run["ranks"]:
        assert r["norm"] == pytest.approx(single["norm"], rel=FP64_REL)


def test_tp_step_keeps_the_split(step_run):
    """After the update the split parameters still hold one model rank's
    half (JAX's test_tp_train_step_runs_and_keeps_sharding): at least 20 of
    them, each of half the gathered size along its split dim."""
    for r in step_run["ranks"]:
        assert len(r["specs"]) >= 20
        for name, dim in r["specs"].items():
            full = list(r["state"][name].shape)
            full[dim] //= 2
            assert r["local_shapes"][name] == tuple(full), name


def test_split_minivit_matches_one_process(step_run):
    """AdaBins' miniViT (4 heads, FFN 1024) split over 1 x 2 ranks: its
    four layers' attentions and FFNs split (6 parameters each), and the bin
    widths, features and queries within rel L2 1e-10 of one process's in
    fp64."""
    inp = step_run["inp"]["minivit"]
    vit = MiniViT(**inp["kwargs"]).double().eval()
    vit.load_state_dict(inp["state"])
    with torch.no_grad():
        want = vit(torch.from_numpy(inp["x"]))
    for r in step_run["ranks"]:
        assert len(r["minivit_specs"]) == 4 * 6
        for got, w in zip(r["minivit"], want):
            assert _rel(got, w) < FP64_REL


@pytest.mark.parametrize("case", ["bs1", "uneven", "whole", "adabins"])
def test_spatial_one_by_two_matches_jax_and_one_process(weights, step_run, case):
    """DepthPipeline(spatial=True) on the 1 x 2 grid, one image: at 64x96
    (test_parallel_2d.py's -v case, bs 1), at 96x64 (3 units on 2 ranks:
    bands of 64 and 32 rows), at 32 rows (1 unit for 2 ranks: served whole
    on both, as the plan says) and the tiny AdaBins (its miniViT on the
    gathered tokens). Both ranks return the same bits; the plan's bands;
    fp32 within test_parallel_2d.py's rtol 2e-4, atol 2e-5 of JAX's spatial
    server on make_mesh(n_data=1, n_model=2) (of one process's fp32 server
    where the port serves whole), fp64 within rel L2 1e-10 of one
    process's server."""
    sd, variables = weights
    inp = step_run["inp"]["spatial"]
    ranks = [r["spatial"] for r in step_run["ranks"]]
    if case == "adabins":
        frames = inp["adabins"]["frames"]
        model = AdaBins(**ADABINS).eval()
        model.load_state_dict(inp["adabins"]["state"])
        jax_model = JaxAdaBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH,
                               max_depth=MAX_DEPTH)
        variables = convert_state_dict({f"model.{k}": v.numpy() for k, v in
                                        inp["adabins"]["state"].items()}, "adabins", ENC)
    else:
        frames = inp["frames"][case]
        model = tiny_tp_model(_inp(sd), torch.float32).eval()
        jax_model = _jax_model()
    for label in ("fp32", "fp64"):
        got = [r[f"{case} {label}"] for r in ranks]
        assert [g["plan"] for g in got] == [SPATIAL_BANDS[case]] * 2
        assert torch.equal(got[0]["depth"], got[1]["depth"])
    if case == "whole":
        want = _one_process(model, frames).numpy()
    else:
        want = _jax_spatial(jax_model, variables, frames, n_data=1)
    got = ranks[0][f"{case} fp32"]["depth"]
    assert got.shape == (1, frames.shape[1] // 2, frames.shape[2] // 2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    assert _rel(ranks[0][f"{case} fp64"]["depth"], _one_process(model.double(), frames)) < FP64_REL


@pytest.mark.parametrize("name", list(SPATIAL_OPTIONS))
def test_spatial_serves_every_option_on_bands(step_run, name):
    """ObjCAViT's options (both grid strategies, use_2_saca, no_obj_sa),
    the final upsample (the image's band as its skip, the features at full
    resolution) and a V2 encoder (torchvision's symmetric padding) served
    on the 1 x 2 grid's bands of 32 rows: both ranks the same bits, within
    rel L2 1e-10 of one process's server in fp64."""
    spec = step_run["inp"]["spatial"]["options"][name]
    ranks = [r["spatial"][f"{name} fp64"] for r in step_run["ranks"]]
    assert [r["plan"] for r in ranks] == [([(0, 32), (32, 64)], None)] * 2
    assert torch.equal(ranks[0]["depth"], ranks[1]["depth"])
    model = GraphBins(**spec["kwargs"]).double().eval()
    model.load_state_dict(spec["state"])
    assert _rel(ranks[0]["depth"], _one_process(model, spec["frames"])) < FP64_REL
