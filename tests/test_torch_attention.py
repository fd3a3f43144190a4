"""Kernel 5 and GraphBins on the attention-kernel route: objcavit_torch
against objcavit_tpu on the CPU.

JAX runs its Pallas kernel (``mha_core(impl="pallas")``,
``ops/pallas_attention.py``) under ``pltpu.force_tpu_interpret_mode()``, as
tests/test_pallas_attention.py does; the port runs kernel 5's plain
versions, which its wrappers take for CPU tensors, through the same
``torch.autograd.Function`` (``FusedMHA``) the card runs, so the backward
here is the plain backward formula the CUDA backward implements. Inputs
come from seeded numpy generators; the models use tests/test_torch_modules.py's
JAX variables (efficientnet-tiny, B = 2 at 384x352: 132 tokens). Each test
states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.ops.attention import mha_core as jax_mha_core
from objcavit_tpu.training.optim import build_optimizer as jax_build_optimizer
from objcavit_tpu.training.state import TrainState
from objcavit_tpu.training.steps import make_train_step as jax_make_train_step
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.layers import MultiHeadAttention
from objcavit_torch.models.minivit import MiniViT
from objcavit_torch.models.objcavit import ObjCAViT
from objcavit_torch.ops.attention import mha_core
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import make_train_step
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm
from tests.test_torch_modules import ENC, H, W, graphbins_variables, port_state_dict
from tests.test_torch_slice import _objects

B, D, HEADS = 2, 32, 4
N_BINS = 32
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
LR, WD, CLIP, TOTAL_STEPS = 3.57e-4, 0.1, 0.1, 100
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])


def _inputs(dtype: str, mask_kind: str, sq: int = 24, sk: int = 16, seed: int = 5):
    """q, k, v, the output's cotangent and a mask as numpy: 'none',
    'partial' (image 0 keeps 10 keys, image 1 keeps 5), or 'full' (image 1
    entirely masked)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, sq, HEADS, D), (B, sk, HEADS, D), (B, sk, HEADS, D)))
    g = rng.standard_normal((B, sq, HEADS, D)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        mask = np.zeros((B, sk), bool)
        mask[0, 10:] = True
        mask[1, 5:] = True
        if mask_kind == "full":
            mask[1] = True
    return (q, k, v, g), mask


def _both(arrays, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# tolerances: fp32 are tests/test_pallas_attention.py's; in bf16 both sides
# round the same fp32 arithmetic once, so a value near a rounding boundary
# may land one bf16 ulp (<= 2^-7 relative) away
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 1e-5)}
GRAD_TOLS = {"float32": (1e-3, 1e-4), "bfloat16": (2.0 ** -7, 1e-3)}


@pytest.mark.parametrize("mask_kind", ["none", "partial", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel5_forward_matches_pallas(dtype, mask_kind):
    """Sq = 24, Sk = 16; a fully masked image is uniform over its keys on
    both sides (the -1e30 bias, not -inf)."""
    (q, k, v, _), mask = _inputs(dtype, mask_kind)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mha_core(jq, jk, jv, None if mask is None else jnp.asarray(mask), impl="pallas")
    launches = kattn.fused_mha_fwd.launches
    got = mha_core(tq, tk, tv, None if mask is None else torch.from_numpy(mask), impl="kernel")
    assert kattn.fused_mha_fwd.launches == launches  # the CPU runs the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 24, HEADS, D)
    rtol, atol = TOLS[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)
    if mask_kind == "full":
        uniform = np.broadcast_to(_f32(tv)[1].mean(0), (24, HEADS, D))
        np.testing.assert_allclose(_f32(got)[1], uniform, rtol=rtol,
                                   atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype,mask_kind", [("float32", "partial"), ("float32", "full"),
                                             ("bfloat16", "partial")])
def test_kernel5_gradients_match_pallas(dtype, mask_kind):
    """The ``FusedMHA`` backward (the plain backward formula) against
    ``jax.grad`` through the Pallas custom VJP. fp32: JAX's own gradient
    tolerance (rtol 1e-3, atol 1e-4); bf16: one bf16 ulp, plus 1e-3 absolute
    for entries that cancel (the rows of ds sum to zero)."""
    (q, k, v, g), mask = _inputs(dtype, mask_kind)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g), dtype)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_mha_core(q_, k_, v_, jmask, impl="pallas")
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = mha_core(*leaves, None if mask is None else torch.from_numpy(mask), impl="kernel")
    (out.float() * tg.float()).sum().backward()
    rtol, atol = GRAD_TOLS[dtype]
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(_f32(leaf.grad), _f32(w), rtol=rtol, atol=atol, err_msg=name)


def _tiled_inputs(sq: int, sk: int, mask_kind: str, seed: int = 11):
    """As ``_inputs``, with masks that end inside the second and third
    64-key tiles (image 0 keeps 100 keys, image 1 keeps 130), or image 1
    entirely masked ('full')."""
    (q, k, v, g), _ = _inputs("float32", "none", sq, sk, seed)
    mask = np.zeros((B, sk), bool)
    mask[0, 100:] = True
    mask[1, 130:] = True
    if mask_kind == "full":
        mask[1] = True
    return (q, k, v, g), mask


@pytest.mark.parametrize("dtype,sq,mask_kind", [("float32", 40, "partial"),
                                                ("float32", 150, "full"),
                                                ("bfloat16", 40, "partial")])
def test_kernel5_key_tile_decomposition_matches_pallas(dtype, sq, mask_kind):
    """The cluster route's arithmetic (``mha_bwd_by_key_tiles``: Sk 150 in
    three 64-key tiles, the partial row terms and the partial dq summed in
    rank order, dk and dv per tile) against ``jax.grad`` through the Pallas
    custom VJP in interpret mode, at ``test_kernel5_gradients_match_pallas``'s
    tolerances; and against the plain backward formula in fp64 (1e-12)."""
    sk = 150
    (q, k, v, g), mask = _tiled_inputs(sq, sk, mask_kind)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g), dtype)
    jmask = jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_mha_core(q_, k_, v_, jmask, impl="pallas")
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    bias = kattn.mask_bias(torch.from_numpy(mask))
    got = kattn.mha_bwd_by_key_tiles(tq, tk, tv, bias, tg)
    assert kattn.bwd_route(sq, sk) == "cluster" and -(-sk // kattn.KEY_TILE) == 3
    rtol, atol = GRAD_TOLS[dtype]
    for name, x, w in zip("qkv", got, want):
        assert x.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_f32(x), _f32(w), rtol=rtol, atol=atol, err_msg=name)
    f64 = [torch.from_numpy(a).double() for a in (q, k, v, g)]
    tiled = kattn.mha_bwd_by_key_tiles(*f64[:3], bias.double(), f64[3])
    for x, w in zip(tiled, kattn.mha_fused_bwd_plain(*f64[:3], bias.double(), f64[3])):
        torch.testing.assert_close(x, w, rtol=1e-12, atol=1e-12)


def _long_inputs(sq: int, sk: int, mask_kind: str, seed: int = 13):
    """q, k, v, g (B 2, S, H 2, D 32) as numpy, past 512 keys or queries,
    and a mask that ends inside a late 64-key tile (image 0 keeps Sk - 37
    keys) and the second (image 1 keeps 100), or image 1 entirely masked
    ('full')."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, s, 2, D)).astype(np.float32) for s in (sq, sk, sk, sq))
    mask = np.zeros((B, sk), bool)
    mask[0, sk - 37:] = True
    mask[1, 100:] = True
    if mask_kind == "full":
        mask[1] = True
    return (q, k, v, g), mask


@pytest.mark.parametrize("dtype,sq,sk,mask_kind", [("float32", 520, 600, "partial"),
                                                   ("float32", 600, 530, "full"),
                                                   ("bfloat16", 560, 560, "partial"),
                                                   ("bfloat16", 600, 520, "full")])
def test_kernel5_long_route_decomposition_matches_pallas(dtype, sq, sk, mask_kind):
    """The long route's backward arithmetic (``mha_bwd_long_tiles``: D summed
    over the key tiles in order by a first pass, dk and dv of each key tile
    summed over the query tiles in order, dq of each query tile over the key
    tiles in order) just past 512 keys and queries, against ``jax.grad`` through the Pallas custom VJP in
    interpret mode at ``test_kernel5_gradients_match_pallas``'s tolerances;
    and against the plain backward formula in fp64 (1e-12)."""
    (q, k, v, g), mask = _long_inputs(sq, sk, mask_kind)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g), dtype)
    jmask = jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_mha_core(q_, k_, v_, jmask, impl="pallas")
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    bias = kattn.mask_bias(torch.from_numpy(mask))
    got = kattn.mha_bwd_long_tiles(tq, tk, tv, bias, tg)
    assert kattn.bwd_route(sq, sk) == "long" and kattn.fwd_plan(4, sq, sk, 132) is None
    rtol, atol = GRAD_TOLS[dtype]
    for name, x, w in zip("qkv", got, want):
        assert x.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_f32(x), _f32(w), rtol=rtol, atol=atol, err_msg=name)
    f64 = [torch.from_numpy(a).double() for a in (q, k, v, g)]
    tiled = kattn.mha_bwd_long_tiles(*f64[:3], bias.double(), f64[3])
    for x, w in zip(tiled, kattn.mha_fused_bwd_plain(*f64[:3], bias.double(), f64[3])):
        torch.testing.assert_close(x, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sq,sk,route", [(300, 300, "cluster"), (221, 221, "cluster"),
                                         (512, 512, "cluster"), (1, 512, "cluster"),
                                         (513, 513, "long"), (40, 513, "long"),
                                         (513, 40, "long"), (1200, 1200, "long")])
def test_kernel5_backward_route_by_shape(sq, sk, route):
    """The backward takes one cluster launch while every key tile of 64 fits
    a portable cluster of 8 blocks (and the queries fit its shared memory),
    the long route beyond: the C entry point's rule. The forward takes its
    long route at the same lengths: the two routes' residuals differ (log2
    units on the long one)."""
    assert kattn.bwd_route(sq, sk) == route
    assert (route == "cluster") == (-(-sk // kattn.KEY_TILE) <= 8 and sq <= kattn.CLUSTER_MAX_S)
    assert kattn.long_route(sq, sk) == (route == "long")
    assert (kattn.fwd_plan(32, sq, sk, 132) is None) == (route == "long")


def test_kernel5_plain_backward_is_the_gradient_of_the_plain_forward():
    """The plain backward formula equals autograd of the plain forward in
    fp64, a fully masked image included."""
    (q, k, v, g), mask = _inputs("float64", "full")
    t = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    bias = kattn.mask_bias(torch.from_numpy(mask))
    want = torch.autograd.grad(kattn.mha_fused_plain(*t, bias), t, torch.from_numpy(g).double())
    got = kattn.mha_fused_bwd_plain(*(x.detach() for x in t), bias, torch.from_numpy(g).double())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_mha_core_routes():
    """'plain' is JAX's 'xla' (weights cast to v's dtype); any other name raises."""
    (q, k, v, _), mask = _inputs("float32", "partial")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jax_mha_core(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), impl="xla")
    got = mha_core(tq, tk, tv, torch.from_numpy(mask), impl="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        mha_core(tq, tk, tv, impl="pallas")


@pytest.mark.parametrize("cls,n_attn,head,takes_objects", [(GraphBins, 10, ObjCAViT, True),
                                                          (AdaBins, 4, MiniViT, False)],
                         ids=["graphbins", "adabins"])
def test_models_name_their_attention_route_and_head(cls, n_attn, head, takes_objects):
    """Every attention of a model is on the route it was built with, which
    the model names (``attn_impl``); the model names its transformer head
    and whether its forward takes object slots, which the servers, the train
    loss and the profilers read."""
    for route in ("plain", "kernel"):
        model = cls(encoder_name=ENC, n_bins=N_BINS, attn_impl=route)
        attns = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
        assert len(attns) == n_attn and {m.attn_impl for m in attns} == {route}
        assert model.attn_impl == route
        assert isinstance(model.transformer_head, head)
        assert model.takes_objects is takes_objects


# ------------------------------------------------------ GraphBins, kernel route


def _jax_graphbins(dtype=jnp.float32, fold_bn=False, dropout_rate=0.1):
    return JaxGraphBins(
        encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
        pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W),
        dtype=dtype, fold_bn=fold_bn, attn_impl="pallas", dropout_rate=dropout_rate,
    )


def _port_graphbins(variables, dropout_rate=0.1) -> GraphBins:
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS, attn_impl="kernel",
                      dropout_rate=dropout_rate)
    model.load_state_dict(port_state_dict(variables))
    return model


def _run_forward(dtype_name: str, fold: bool):
    variables = graphbins_variables()
    rng = np.random.default_rng(7)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    objs = _objects(rng)
    jvars = jax_fold_batchnorm(variables) if fold else variables
    jmodel = _jax_graphbins(getattr(jnp, dtype_name), fold)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
            jvars, *map(jnp.asarray, (img, *objs)))
    model = _port_graphbins(variables).eval()
    if fold:
        fold_batchnorm(model)
    model.cast(getattr(torch, dtype_name))
    launches = kattn.fused_mha_fwd.launches
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, *objs)))
    assert kattn.fused_mha_fwd.launches == launches
    return got, want


def test_graphbins_kernel_route_fp32_matches_jax_pallas():
    """tests/test_torch_slice.py's fp32 tolerances: depth 1e-3, edges 1e-4."""
    got, want = _run_forward("float32", fold=False)
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)


def test_graphbins_kernel_route_bf16_folded_matches_jax_pallas():
    """tests/test_torch_slice.py's bf16 bounds (the frameworks round to bf16
    at other points outside the attention): edges 0.04 m, depth max gap
    0.15 m, mean gap 0.03 m, correlation over 0.97."""
    got, want = _run_forward("bfloat16", fold=True)
    depth, ref = got["depth_pred"].numpy(), np.asarray(want["depth_pred"])
    assert np.isfinite(depth).all()
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=0, atol=0.04)
    gap = np.abs(depth - ref)
    assert gap.max() < 0.15 and gap.mean() < 0.03, (gap.max(), gap.mean())
    assert np.corrcoef(depth.ravel(), ref.ravel())[0, 1] > 0.97


def _train_batch():
    rng = np.random.default_rng(0)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    gt = rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)
    feats, xywh, valid = _objects(rng)
    return {"image": img, "depth": gt}, {"features": feats, "xywh": xywh, "valid": valid}


@functools.lru_cache(maxsize=None)
def _train_runs():
    """One fp32 step on each side, dropout 0, augmentation off: JAX's
    make_train_step with attn_impl='pallas' in interpret mode, and the port's
    with attn_impl='kernel'. Returns (jax, port) dicts of the loss, the
    clipped gradients and the parameters after the step."""
    variables = graphbins_variables()
    batch, objects = _train_batch()
    tx = jax_build_optimizer(LR, WD, TOTAL_STEPS, gradient_clip_val=CLIP)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                              jax.tree.map(jnp.asarray, variables["batch_stats"]), tx)
    step = jax.jit(jax_make_train_step(_jax_graphbins(dropout_rate=0.0), tx,
                                       JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                       augment_on_device=False, is_graphbins=True))
    with pltpu.force_tpu_interpret_mode():
        state, loss = step(state, jax.tree.map(jnp.asarray, batch),
                           jax.tree.map(jnp.asarray, objects), jax.random.PRNGKey(0))
    inject = state.opt_state[1]
    mu, b1 = inject.inner_state[0].mu, float(inject.hyperparams["b1"])
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1.0 - b1), mu)
    want = {"loss": float(loss),
            "grads": state_dict_from_variables({"params": grads}, ENC),
            "params": state_dict_from_variables({"params": jax.tree.map(np.asarray, state.params)},
                                                ENC)}

    model = _port_graphbins(variables, dropout_rate=0.0)
    optimizer, scheduler = build_optimizer(model, LR, WD, TOTAL_STEPS)
    port_step = make_train_step(model, optimizer, scheduler, LossWrapper(*LOSSES), MIN_DEPTH,
                                augment_on_device=False, gradient_clip_val=CLIP)
    bwd = kattn.fused_mha_bwd.launches
    loss = port_step({k: torch.from_numpy(v) for k, v in batch.items()},
                     {k: torch.from_numpy(v) for k, v in objects.items()})
    assert kattn.fused_mha_bwd.launches == bwd
    got = {"loss": float(loss),
           "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                     if p.grad is not None},
           "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
    return want, got


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def test_graphbins_kernel_route_train_step_matches_jax_pallas():
    """One fp32 step on the kernel route, at tests/test_torch_train.py's
    tolerances for the plain route: the loss rel 1e-5; each clipped
    gradient within 1e-2 of its norm + 5e-8 with a median under 2e-3, and
    the image attentions' in_proj within 1e-2; every parameter after AdamW rel 1e-4
    (the four parameters nothing reads excepted: torch's AdamW leaves them,
    optax decays them)."""
    want, got = _train_runs()
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    rels = {}
    for name, g in got["grads"].items():
        w = want["grads"][name]
        err, ref = np.linalg.norm(g - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + 5e-8, (name, err, ref)
        if ref > 0:
            rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3
    # the image transformer's attentions; the object transformer's get no
    # gradient on either side: the reference's cross-attention masks the
    # object block it front-pads (models/objcavit.py), so nothing reads it
    attn = [n for n in rels if n.endswith("self_attn.in_proj_weight")]
    assert len(attn) == 4 and max(rels[n] for n in attn) <= 1e-2
    for name, p in got["params"].items():
        if name in got["grads"]:
            assert _rel(p, want["params"][name]) <= 1e-4, name
