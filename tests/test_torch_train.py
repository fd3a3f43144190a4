"""Slice 2, the train step: objcavit_torch against objcavit_tpu on the CPU.

The tiny GraphBins (efficientnet-tiny, 256 bins, B=2 at 384x352, so 132
image tokens) takes one step of the port's ``make_train_step`` and one of
the JAX package's, from the same weights (tests/test_torch_modules.py's
variables, converted by ``state_dict_from_variables``) on the same numpy
batch, with transformer dropout 0 on both sides and augmentation off:
random numbers never agree across the frameworks, so dropout and the
augmentation are pinned by tests of their own below. On the CPU the kernel
wrappers run their plain versions. Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.config import Config
from objcavit_tpu.data.augment import augment_batch as jax_augment_batch
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.losses.losses import silog_loss as jax_silog_loss
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.models.objcavit import SelfAttnCrossAttn as JaxSACA
from objcavit_tpu.ops.bins import bins_head_depth as jax_bins_head_depth
from objcavit_tpu.ops.bins import bins_head_depth_factored as jax_bins_head_depth_factored
from objcavit_tpu.ops.chamfer import masked_chamfer_1d as jax_masked_chamfer_1d
from objcavit_tpu.training.optim import (
    build_optimizer as jax_build_optimizer,
    onecycle_momentum_schedule,
    torch_onecycle_schedule,
)
from objcavit_tpu.training.providers import StubObjectProvider as JaxStub
from objcavit_tpu.training.providers import ZerosObjectProvider as JaxZeros
from objcavit_tpu.training.state import TrainState
from objcavit_tpu.training.steps import build_model as jax_build_model
from objcavit_tpu.training.steps import make_train_step as jax_make_train_step

from objcavit_torch.data.augment import augment_with, draw_augment
from objcavit_torch.losses import LossWrapper, silog_loss
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.objcavit import SelfAttnCrossAttn
from objcavit_torch.ops.bins import bins_head_depth, bins_head_depth_factored
from objcavit_torch.ops.chamfer import masked_chamfer_1d
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.providers import StubObjectProvider, ZerosObjectProvider
from objcavit_torch.training.steps import build_model, make_train_step
from objcavit_torch.utils.benchkit import build_flagship_train
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm
from tests.test_torch_modules import ENC, H, W, graphbins_variables, port_state_dict

B, N_SLOTS, N_BINS = 2, 4, 256
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
LR, WD, CLIP, TOTAL_STEPS = 3.57e-4, 0.1, 0.1, 100
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])
# torch's AdamW skips a parameter without a gradient (weight decay too);
# optax decays every leaf. In the single-SACA model nothing reads the
# object branch of the cross-attention (its output is discarded, as in the
# reference), so these four get no gradient.
NO_GRAD = {
    f"objcavit.saca_1.cross_attn_im_obj.{n}"
    for n in ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


# ------------------------------------------------------------- step parity


def _batch(seed: int):
    """A batch like tests/test_trajectory_oracle.py's: some GT under
    min_depth (masked), 1..N_SLOTS valid object slots per image."""
    rng = np.random.default_rng(seed)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    gt = rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)
    feats = np.zeros((B, N_SLOTS, 512), np.float32)
    xywh = np.full((B, N_SLOTS, 4), -1.0, np.float32)
    valid = np.zeros((B, N_SLOTS), bool)
    for i in range(B):
        c = int(rng.integers(1, N_SLOTS + 1))
        feats[i, :c] = rng.standard_normal((c, 512))
        xywh[i, :c] = np.stack([rng.uniform(0, W, c), rng.uniform(0, H, c),
                                rng.uniform(10, 120, c), rng.uniform(10, 120, c)], -1)
        valid[i, :c] = True
    return {"image": img, "depth": gt}, {"features": feats, "xywh": xywh, "valid": valid}


def _port_step(compute_dtype=torch.float32):
    variables = graphbins_variables(n_bins=N_BINS)
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS, dropout_rate=0.0)
    model.load_state_dict({k: _t(v) for k, v in state_dict_from_variables(variables, ENC).items()})
    optimizer, scheduler = build_optimizer(model, LR, WD, TOTAL_STEPS)
    return make_train_step(model, optimizer, scheduler, LossWrapper(*LOSSES), MIN_DEPTH,
                           augment_on_device=False, gradient_clip_val=CLIP,
                           compute_dtype=compute_dtype)


def _adam_mu_and_b1(opt_state):
    """(mu tree, b1 of the last update) from the JAX optimizer state."""
    inject = opt_state[1]
    return inject.inner_state[0].mu, float(inject.hyperparams["b1"])


N_STEPS = 3


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's make_train_step (jitted once) over N_STEPS batches; returns the
    losses and, after the first step, its clipped gradients (read back from
    Adam's first moment: mu = (1 - b1) g after one update), params and BN
    statistics, all in the port's state-dict layout."""
    variables = graphbins_variables(n_bins=N_BINS)
    model = JaxGraphBins(
        encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
        pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W),
        dropout_rate=0.0,
    )
    tx = jax_build_optimizer(LR, WD, TOTAL_STEPS, gradient_clip_val=CLIP)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                              jax.tree.map(jnp.asarray, variables["batch_stats"]), tx)
    step = jax.jit(jax_make_train_step(model, tx, JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                       augment_on_device=False, is_graphbins=True))
    losses, first = [], None
    for i in range(N_STEPS):
        batch, objects = _batch(i)
        state, loss = step(state, jax.tree.map(jnp.asarray, batch),
                           jax.tree.map(jnp.asarray, objects), jax.random.PRNGKey(i))
        losses.append(float(loss))
        if i == 0:
            mu, b1 = _adam_mu_and_b1(state.opt_state)
            grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1.0 - b1), mu)
            first = {
                "grads": state_dict_from_variables({"params": grads}, ENC),
                "state": state_dict_from_variables(
                    {"params": jax.tree.map(np.asarray, state.params),
                     "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}, ENC),
            }
    return losses, first


@functools.lru_cache(maxsize=None)
def _port_run():
    step = _port_step()
    losses, first = [], None
    for i in range(N_STEPS):
        batch, objects = _batch(i)
        losses.append(float(step({k: _t(v) for k, v in batch.items()},
                                 {k: _t(v) for k, v in objects.items()})))
        if i == 0:
            first = {
                "grads": {n: (p.grad.numpy().copy() if p.grad is not None else None)
                          for n, p in step.model.named_parameters()},
                "state": {k: v.numpy().copy() for k, v in step.model.state_dict().items()},
                "lr0": LR / 25.0,
            }
    return losses, first


def test_train_step_fp32_loss_matches_jax():
    """The first step's loss, rel 1e-5: the same fp32 arithmetic in another
    order (tests/test_trajectory_oracle.py holds 10 steps to 5e-4)."""
    (want, _), (got, _) = _jax_run(), _port_run()
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)


def test_train_step_fp32_gradients_match_jax():
    """Every parameter's clipped gradient (global norm 0.1), per parameter
    ||got - want|| <= 1e-2 ||want|| + 5e-8, and a median relative error
    under 2e-3. Measured: median 8e-4, conv_out 7.5e-5 (its error is the
    clip coefficient's); worst 5e-3 on the SE reduce convs, whose gradients
    are ~4e-6 in norm. Train-mode BatchNorm's backward subtracts the batch
    mean of the incoming gradient, which magnifies the fp32 accumulation
    order of the two frameworks (eval-mode BN gives 6.7e-6 in
    tests/test_backward_oracle.py); the decoder's
    conv biases before a train-mode BN have an exactly zero gradient in
    exact arithmetic, ~1e-9 of rounding noise on both sides, which the
    absolute 5e-8 (5e-7 of the global norm) covers. decoder.conv2 is among them,
    so the decoder's resize carries a gradient in training (slice 1's
    forward-only kernel 1 would have cut it on the card). The four
    parameters nothing reads have no gradient in the port and a zero one in
    JAX."""
    _, want = _jax_run()
    _, got = _port_run()
    assert set(got["grads"]) == set(want["grads"])
    rels = {}
    for name, g in got["grads"].items():
        if name in NO_GRAD:
            assert g is None and not np.any(want["grads"][name]), name
            continue
        assert g is not None, name
        w = want["grads"][name]
        err, ref = np.linalg.norm(g - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + 5e-8, (name, err, ref)
        if ref > 0:
            rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3
    conv2 = got["grads"]["dense_feature_extractor.decoder.conv2.weight"]
    assert np.abs(conv2).max() > 0


def test_train_step_fp32_params_match_jax():
    """Every parameter after one clipped AdamW step, rel L2 <= 1e-4
    (measured up to 1.6e-5: Adam's first update moves each weight by about
    lr0 = 1.4e-5 times the sign of its gradient, whatever its size). JAX
    decays the four parameters without a gradient; the port, like the
    reference's torch AdamW, leaves them."""
    _, want = _jax_run()
    _, got = _port_run()
    params = dict(GraphBins(encoder_name=ENC, n_bins=N_BINS).named_parameters())
    before = state_dict_from_variables(graphbins_variables(n_bins=N_BINS), ENC)
    for name in params:
        if name in NO_GRAD:
            np.testing.assert_array_equal(got["state"][name], before[name])
            np.testing.assert_allclose(want["state"][name],
                                       before[name] * (1 - got["lr0"] * WD), rtol=1e-6)
            continue
        assert _rel(got["state"][name], want["state"][name]) <= 1e-4, name


def test_train_step_fp32_bn_running_stats_match_jax():
    """Every BN's running mean and unbiased running variance after one
    train-mode step (momentum 0.1), rel L2 <= 1e-5."""
    _, want = _jax_run()
    _, got = _port_run()
    keys = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in GraphBins(ENC, N_BINS).modules())
    assert len(keys) == 2 * n_bn > 0
    for k in keys:
        assert _rel(got["state"][k], want["state"][k]) <= 1e-5, k


def test_train_three_steps_fp32_losses_match_jax():
    """N_STEPS steps on as many batches, each loss rel 1e-4."""
    want, _ = _jax_run()
    got, _ = _port_run()
    np.testing.assert_allclose(got, want, rtol=1e-4)


# group -> (parameter-name prefixes, bound on the bf16 step's rel L2 error)
BF16_GROUPS = {
    "conv_out": (("conv_out.",), 0.05),
    "regressor": (("objcavit.regressor.",), 0.1),
    "decoder.conv2": (("dense_feature_extractor.decoder.conv2.",), 0.6),
    "encoder stem": (("dense_feature_extractor.encoder.original_model.conv_stem.",
                      "dense_feature_extractor.encoder.original_model.bn1."), 0.4),
}


def test_train_step_bf16_matches_fp32_jax():
    """bf16 compute, fp32 parameters: the port's step against JAX's fp32
    step on the same batch. The loss within 1e-3 relative; the gradient of
    each named group within a bound set by what bf16 does to JAX itself:
    JAX's own bf16 step lands 0.006 (conv_out), 0.018 (regressor), 0.42
    (decoder.conv2) and 0.21 (stem) in rel L2 from its fp32 step here
    (measured), and the port's 0.012, 0.025, 0.36 and 0.19. The two deep
    groups sit behind train-mode BatchNorms, whose backward subtracts the
    mean of the incoming gradient and so magnifies its bf16 rounding."""
    step = _port_step(compute_dtype=torch.bfloat16)
    batch, objects = _batch(0)
    loss = step.loss({k: _t(v) for k, v in batch.items()}, {k: _t(v) for k, v in objects.items()})
    want_losses, want = _jax_run()
    assert abs(float(loss.detach()) - want_losses[0]) <= 1e-3 * abs(want_losses[0])
    loss.backward()
    torch.nn.utils.clip_grad_norm_(step.model.parameters(), CLIP)
    grads = {n: p.grad for n, p in step.model.named_parameters()}
    for group, (prefixes, bound) in BF16_GROUPS.items():
        names = [n for n in grads if n.startswith(prefixes)]
        assert names, group
        g = np.concatenate([grads[n].float().numpy().ravel() for n in names])
        w = np.concatenate([want["grads"][n].ravel() for n in names])
        assert _rel(g, w) <= bound, (group, _rel(g, w))


# ---------------------------------------------------------------- repairs


def test_bf16_train_forward_takes_no_forward_only_kernel():
    """In training, bf16, the decoder's upsamples and the bins head take
    their differentiable routes (the forward-only kernel wrappers would
    raise under autograd, as the eval-mode forward below shows), and
    decoder.conv2 gets a gradient."""
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS)
    model.load_state_dict({k: _t(v) for k, v in
                           state_dict_from_variables(graphbins_variables(n_bins=N_BINS), ENC).items()})
    batch, objects = _batch(4)
    inputs = (_t(batch["image"]), *(_t(objects[k]) for k in ("features", "xywh", "valid")))
    params = model.params_in(torch.bfloat16)
    model.train()
    out = torch.func.functional_call(model, params, inputs)
    out["depth_pred"].mean().backward()
    assert model.dense_feature_extractor.decoder.conv2.weight.grad.abs().max() > 0
    model.eval()
    with pytest.raises(RuntimeError, match="forward-only"):
        torch.func.functional_call(model, params, inputs)


def test_resize_taps_cached_by_a_served_request_serve_a_later_backward():
    """The resize taps are cached per size; the first request to need a size
    may run in inference mode (DepthPipeline does), and a training step at
    the same size must still differentiate through them."""
    from objcavit_torch.ops.resize import resize_bilinear

    with torch.inference_mode():
        resize_bilinear(torch.zeros(1, 7, 5, 2), 13, 11)
    x = torch.rand(1, 7, 5, 2, requires_grad=True)
    resize_bilinear(x, 13, 11).sum().backward()
    assert x.grad.abs().sum() > 0


def test_folded_model_refuses_to_train():
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS)
    fold_batchnorm(model.eval())
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        model.dense_feature_extractor(x)  # eval: fine
        model.train()
        with pytest.raises(RuntimeError, match="folded"):
            model.dense_feature_extractor(x)


# ------------------------------------------------------------- bins head


def _head_inputs(seed=3, b=2, h=6, w=10, c=16, kq=12, k=N_BINS):
    rng = np.random.default_rng(seed)
    widths = rng.random((b, k)).astype(np.float32) + 0.1
    widths /= widths.sum(1, keepdims=True)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    queries = rng.standard_normal((b, kq, c)).astype(np.float32)
    kern = (0.3 * rng.standard_normal((kq, k))).astype(np.float32)  # (Kq, K)
    bias = (0.1 * rng.standard_normal(k)).astype(np.float32)
    return widths, feat, queries, kern, bias


def _weight(kern) -> torch.Tensor:
    """(Kq, K) HWIO slice -> the port's (K, Kq, 1, 1) conv weight."""
    return _t(np.ascontiguousarray(kern.T[:, :, None, None]))


def test_bins_head_factored_train_matches_jax_with_gradients():
    """The training route (range maps, conv_out, softmax-expectation) in
    fp32: depth rel 1e-5 and the gradients of every input rel L2 1e-4."""
    widths, feat, queries, kern, bias = _head_inputs()
    g = np.random.default_rng(9).standard_normal((2, 6, 10, 1)).astype(np.float32)

    def jax_loss(*args):
        depth, edges = jax_bins_head_depth_factored(
            args[0], args[1], args[2], args[3][None, None], args[4], MIN_DEPTH, MAX_DEPTH, True)
        return jnp.sum(depth * g) + jnp.sum(edges ** 2), depth

    jargs = tuple(jnp.asarray(a) for a in (widths, feat, queries, kern, bias))
    (_, want_depth), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True)(*jargs)
    targs = [_t(a).requires_grad_() for a in (widths, feat, queries)]
    weight = _weight(kern).requires_grad_()
    tbias = _t(bias).requires_grad_()
    depth, edges = bins_head_depth_factored(*targs, weight, tbias, MIN_DEPTH, MAX_DEPTH,
                                            train=True)
    ((depth * _t(g)).sum() + (edges ** 2).sum()).backward()
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(want_depth), rtol=1e-5, atol=1e-5)
    got_grads = [t.grad.numpy() for t in targs] + [
        weight.grad.numpy()[:, :, 0, 0].T, tbias.grad.numpy()]
    for name, got, want in zip(("widths", "feat", "queries", "kernel", "bias"),
                               got_grads, want_grads):
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bins_head_depth_matches_jax_fp32(train):
    """The unfactored head on range maps, fp32: depth rel 1e-5."""
    widths, feat, _, kern, bias = _head_inputs(c=12)
    want, want_edges = jax_bins_head_depth(*map(jnp.asarray, (widths, feat)),
                                           jnp.asarray(kern[None, None]), jnp.asarray(bias),
                                           MIN_DEPTH, MAX_DEPTH, train)
    depth, edges = bins_head_depth(_t(widths), _t(feat), _weight(kern), _t(bias),
                                   MIN_DEPTH, MAX_DEPTH, train)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(edges.numpy(), np.asarray(want_edges), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [True, False], ids=["train-kernel4", "eval-kernel3"])
def test_bins_head_depth_bf16_matches_jax(train):
    """bf16 range maps: training takes bf16 logits into kernel 4's
    autograd.Function, eval takes kernel 3 (the shared-W fused head, fp32
    logits of the bf16-exact products); on the CPU both run their plain
    versions. JAX's CPU path rounds the logits to bf16 in both modes, so
    depth is held to 5e-2 m over a 10 m range: a bf16 logit is off by up to
    2^-9 of its size (~0.01 here), which moves depth by that much times the
    spread of the centres the softmax weighs (a few metres); measured
    0.022 m at most."""
    widths, feat, _, kern, bias = _head_inputs(c=16, kq=16)
    want, _ = jax_bins_head_depth(jnp.asarray(widths), jnp.asarray(feat, jnp.bfloat16),
                                  jnp.asarray(kern[None, None]), jnp.asarray(bias),
                                  MIN_DEPTH, MAX_DEPTH, train)
    with torch.no_grad():
        depth, _ = bins_head_depth(_t(widths), _t(feat).to(torch.bfloat16), _weight(kern),
                                   _t(bias), MIN_DEPTH, MAX_DEPTH, train)
    assert depth.dtype == torch.float32 and depth.shape == (2, 6, 10, 1)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want), rtol=0, atol=5e-2)


# ------------------------------------------------------------------ losses


def _chamfer_case():
    """Row 0: masked targets and GT values repeated many times; row 1: no
    valid target (adds nothing); row 2: one valid target."""
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0.001, 10, (3, 16)), 1).astype(np.float32)
    y = np.round(rng.uniform(0.0, 9.5, (3, 200)), 1).astype(np.float32)  # ~100 distinct values
    mask = y > 0.5
    mask[1] = False
    mask[2] = False
    mask[2, 7] = True
    return x, y, mask


def test_masked_chamfer_matches_jax_with_gradient():
    """Value rel 1e-6 and d/dx rel L2 1e-5: both pick each point's nearest
    neighbour and square the same fp32 difference. GT values repeat here,
    which JAX's min splits among and torch.minimum halves between: for
    d_x the gradient with respect to x is the same at every tie."""
    x, y, mask = _chamfer_case()
    want, want_dx = jax.value_and_grad(jax_masked_chamfer_1d)(*map(jnp.asarray, (x, y, mask)))
    tx = _t(x).requires_grad_()
    got = masked_chamfer_1d(tx, _t(y), _t(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert _rel(tx.grad.numpy(), want_dx) <= 1e-5


def test_masked_chamfer_all_rows_empty_is_zero():
    x, y, _ = _chamfer_case()
    got = masked_chamfer_1d(_t(x), _t(y), torch.zeros(y.shape, dtype=torch.bool))
    want = jax_masked_chamfer_1d(jnp.asarray(x), jnp.asarray(y), jnp.zeros(y.shape, bool))
    assert float(got) == float(want) == 0.0


def _loss_inputs():
    rng = np.random.default_rng(8)
    pred = rng.uniform(0.5, 9.0, (2, 12, 10, 1)).astype(np.float32)
    gt = rng.uniform(0.0005, 9.5, (2, 24, 20, 1)).astype(np.float32)
    widths = rng.random((2, 32)).astype(np.float32) + 0.1
    widths /= widths.sum(1, keepdims=True)
    edges = np.concatenate([np.full((2, 1), MIN_DEPTH, np.float32),
                            MIN_DEPTH + np.cumsum((MAX_DEPTH - MIN_DEPTH) * widths, 1)], 1)
    return pred, gt, gt > MIN_DEPTH, edges.astype(np.float32)


def test_silog_matches_jax_with_gradient():
    """SILog with the align_corners upsample of the prediction: value rel
    1e-5, gradient rel L2 1e-5."""
    pred, gt, mask, _ = _loss_inputs()
    want, want_g = jax.value_and_grad(jax_silog_loss)(*map(jnp.asarray, (pred, gt, mask)))
    tp = _t(pred).requires_grad_()
    got = silog_loss(tp, _t(gt), _t(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert _rel(tp.grad.numpy(), want_g) <= 1e-5


def test_loss_wrapper_matches_jax_with_gradients():
    """silog + 0.1 bins chamfer + 0.5 mse (mse at GT resolution): value rel
    1e-5, gradients of the prediction and the bin edges rel L2 1e-5."""
    pred, gt, mask, edges = _loss_inputs()
    names, coeffs = ["silog", "bins_chamfer"], [1.0, 0.1]
    jw = JaxLossWrapper(names, coeffs)
    want, (want_dp, want_de) = jax.value_and_grad(
        lambda p, e: jw(p, jnp.asarray(gt), jnp.asarray(mask), e), argnums=(0, 1)
    )(jnp.asarray(pred), jnp.asarray(edges))
    tp, te = _t(pred).requires_grad_(), _t(edges).requires_grad_()
    got = LossWrapper(names, coeffs)(tp, _t(gt), _t(mask), te)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert _rel(tp.grad.numpy(), want_dp) <= 1e-5
    assert _rel(te.grad.numpy(), want_de) <= 1e-5
    same = np.random.default_rng(1).uniform(1, 2, (2, 24, 20, 1)).astype(np.float32)
    mse = LossWrapper(["mse"], [0.5])(_t(same), _t(gt), _t(mask))
    want_mse = JaxLossWrapper(["mse"], [0.5])(jnp.asarray(same), jnp.asarray(gt), jnp.asarray(mask))
    np.testing.assert_allclose(float(mse), float(want_mse), rtol=1e-6)
    with pytest.raises(ValueError, match="unrecognised"):
        LossWrapper(["l1"], [1.0])


# ------------------------------------------------------------ augmentation


def test_augmentation_on_jax_draws_matches_jax():
    """The port's deterministic part fed the very values JAX draws (keys
    split as steps.py:112 and augment.py:69): the flip and the depth equal,
    the image within 2e-6 (a few fp32 ulps: XLA's pow and the Planckian
    polynomials may round differently from PyTorch's). Both coins take
    both values across the 8 images."""
    rng = np.random.default_rng(12)
    b = 8
    image = rng.uniform(-0.05, 1.0, (b, 6, 7, 3)).astype(np.float32)
    depth = rng.uniform(0, 10, (b, 6, 7, 1)).astype(np.float32)
    aug_rng, _ = jax.random.split(jax.random.PRNGKey(5))
    k_flip, k_gamma, k_pl_on, k_pl_t = jax.random.split(aug_rng, 4)
    draws = {
        "flip": jax.random.bernoulli(k_flip, 0.5, (b,)),
        "gamma_u": jax.random.uniform(k_gamma, (b, 1, 1, 1)).reshape(b),
        "planck_on": jax.random.bernoulli(k_pl_on, 0.5, (b,)),
        "temperature": jax.random.uniform(k_pl_t, (b,), minval=3000.0, maxval=15000.0),
    }
    assert 0 < int(draws["flip"].sum()) < b and 0 < int(draws["planck_on"].sum()) < b
    want_img, want_depth = jax_augment_batch(aug_rng, jnp.asarray(image), jnp.asarray(depth))
    got_img, got_depth = augment_with(_t(image), _t(depth), **{k: _t(v) for k, v in draws.items()})
    np.testing.assert_array_equal(got_depth.numpy(), np.asarray(want_depth))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=2e-6, atol=2e-6)


def test_augmentation_draws_are_reproducible_and_in_range():
    a = draw_augment(64, torch.Generator().manual_seed(3), "cpu")
    b = draw_augment(64, torch.Generator().manual_seed(3), "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["flip"].dtype == torch.bool and 0 < int(a["flip"].sum()) < 64
    assert float(a["gamma_u"].min()) >= 0 and float(a["gamma_u"].max()) < 1
    t = a["temperature"]
    assert float(t.min()) >= 3000 and float(t.max()) < 15000


# --------------------------------------------------- optimizer, dropout, rest


def test_lr_and_beta1_schedules_match_jax_over_10_steps():
    """The learning rate and beta1 each update uses, steps 0-9, against the
    JAX package's torch-exact schedules (rel 1e-6, fp32 there)."""
    p = torch.nn.Parameter(torch.zeros(3))
    optimizer, scheduler = build_optimizer(torch.nn.ParameterList([p]), LR, WD, total_steps=20)
    lr_fn, b1_fn = torch_onecycle_schedule(20, LR, final_div_factor=100.0), \
        onecycle_momentum_schedule(20)
    for k in range(10):
        group = optimizer.param_groups[0]
        np.testing.assert_allclose(group["lr"], float(lr_fn(k)), rtol=1e-6)
        np.testing.assert_allclose(group["betas"][0], float(b1_fn(k)), rtol=1e-6)
        p.grad = torch.ones(3)
        optimizer.step()
        scheduler.step()


def test_dropout_rate_one_zeroes_the_three_sites_like_jax():
    """At rate 1.0 dropout returns zeros on both sides, so each encoder
    layer is norm2(norm1(x)): the outputs match (the tolerance of
    tests/test_objcavit_parity.py) only if dropout sits after
    self-attention, after the ReLU and after linear2 (linear2's bias would
    survive otherwise), and nowhere in the cross-attention."""
    variables = graphbins_variables()
    saca_vars = {c: t["objcavit"]["saca_1"] for c, t in variables.items() if "objcavit" in t}
    rng = np.random.default_rng(30)
    image_emb = rng.standard_normal((2, 12, 128)).astype(np.float32)
    obj_emb = rng.standard_normal((2, 5, 128)).astype(np.float32)
    pad = np.zeros((2, 5), bool)
    pad[1, 3:] = True
    want = JaxSACA(128, 4, 1024, dropout_rate=1.0).apply(
        saca_vars, jnp.asarray(image_emb), jnp.asarray(obj_emb), jnp.asarray(pad),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    port = SelfAttnCrossAttn(128, 4, 1024, dropout_rate=1.0)
    port.load_state_dict(port_state_dict(variables, "objcavit.saca_1."))
    with torch.no_grad():
        got = port.train()(_t(image_emb), _t(obj_emb), _t(pad), torch.Generator().manual_seed(0))
        eval_out = port.eval()(_t(image_emb), _t(obj_emb), _t(pad))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert not np.allclose(got[0].numpy(), eval_out[0].numpy(), atol=1e-3)


def test_dropout_draws_from_its_generator():
    """Rate 0.5 in training: the same generator seed gives the same output,
    another seed another one; about half the activations survive, scaled
    by 2."""
    from objcavit_torch.models.layers import dropout

    x = torch.ones(4000)
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, dropout(x, 0.5, True, torch.Generator().manual_seed(1)))
    assert not torch.equal(a, dropout(x, 0.5, True, torch.Generator().manual_seed(2)))
    assert set(a.unique().tolist()) == {0.0, 2.0} and 1800 < int((a > 0).sum()) < 2200
    assert dropout(x, 0.5, False) is x


@pytest.mark.parametrize("n_max", [None, 7])
def test_object_providers_match_jax(n_max):
    images = np.zeros((3, H, W, 3), np.float32)
    stub, jstub = StubObjectProvider(n_max, seed=4), JaxStub(n_max, seed=4)
    for _ in range(2):  # the call count moves the stub's seed
        got, want = stub(images), jstub(images)
        for k in ("features", "xywh", "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = ZerosObjectProvider(n_max)(images), JaxZeros(n_max)(images)
    for k in ("features", "xywh", "valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_model_from_a_reference_config_matches_jax():
    args = Config({
        "basic": {"dataset": "nyu"}, "model": {"name": "graphbins"},
        "nyu": {"min_depth": 0.001, "max_depth": 10.0, "dimensions_train": [416, 544],
                "dimensions_test": [480, 640]},
        "graphbins": {"n_bins": 256, "encoder_name": ENC, "objcavit": {
            "embedding_dim": 128, "positional_embedding_strategy": "learned_bbox_wh"}},
    })
    model, jmodel = build_model(args), jax_build_model(args)
    assert (model.min_depth, model.max_depth) == (jmodel.min_depth, jmodel.max_depth)
    assert model.conv_out[0].out_channels == jmodel.n_bins == 256
    assert all(p.dtype == torch.float32 for p in model.parameters())
    args.graphbins.objcavit.use_2_saca = True
    assert build_model(args).objcavit.use_2_saca and jax_build_model(args).use_2_saca
    args.graphbins.do_final_upscale = True
    model, jmodel = build_model(args), jax_build_model(args)
    assert model.do_final_upscale and jmodel.do_final_upscale
    assert model.dense_feature_extractor.decoder.final_upscale._net[0].in_channels == 64 // 16 + 3
    assert model.conv_out[0].in_channels == 128  # min(128, 884 - 1) full-resolution queries


def test_build_flagship_train_steps_on_the_cpu():
    """The flagship train builder with a tiny encoder override: fp32
    parameters, bf16 compute, dropout and augmentation on; two steps give
    finite losses, move the weights and the BN statistics, and advance the
    schedule."""
    step, batch, objects = build_flagship_train(batch=2, h=H, w=W, n_obj=6, device="cpu",
                                                encoder_name=ENC)
    model = step.model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert batch["image"].shape == (2, H, W, 3) and objects["valid"].all()
    w0 = model.conv_out[0].weight.detach().clone()
    bn = model.dense_feature_extractor.encoder["original_model"].bn1
    mean0 = bn.running_mean.clone()
    losses = [float(step(batch, objects)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert not torch.equal(w0, model.conv_out[0].weight)
    assert not torch.equal(mean0, bn.running_mean)
    assert step.scheduler.last_epoch == 2
