"""AdaBins, the paper's baseline: objcavit_torch against objcavit_tpu on the CPU.

The tiny AdaBins (efficientnet-tiny, 32 bins, B = 2 at 384x352, so 132 patch
tokens) gets its weights from the JAX package's own ``init``, with every
bias, norm scale and BN statistic redrawn from a seeded numpy generator
(tests/test_torch_modules.py's ``_redraw_vectors``); they reach the port
through ``adabins_state_dict_from_variables``. Inputs come from seeded
numpy generators. miniViT's attention runs on both routes: the port's
``"plain"`` against JAX's ``"xla"``, and the port's ``"kernel"`` (kernel 5's
plain versions on the CPU) against JAX's ``"pallas"`` in interpret mode.
Also here: the builders' card default, which raises without a card. Each
test states its tolerance.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.config import load_config
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.models import AdaBins as JaxAdaBins
from objcavit_tpu.models.minivit import MiniViT as JaxMiniViT
from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline
from objcavit_tpu.training.optim import build_optimizer as jax_build_optimizer
from objcavit_tpu.training.state import TrainState
from objcavit_tpu.training.steps import build_model as jax_build_model
from objcavit_tpu.training.steps import make_train_step as jax_make_train_step
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm

import objcavit_torch.language.embedding as embedding
import objcavit_torch.serving as serving
import objcavit_torch.utils.benchkit as benchkit
from objcavit_torch.kernels import attention as kattn
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.minivit import MiniViT
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import build_model, make_train_step
from objcavit_torch.utils.convert import _minivit, _Reader, adabins_state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm
from tests.test_torch_modules import ENC, H, W, _redraw_vectors

B, N_BINS = 2, 32
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
LR, WD, CLIP, TOTAL_STEPS = 3.57e-4, 0.1, 0.1, 100
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])
PARAMS_FILE = Path(__file__).resolve().parents[1] / "params" / "nyu_adabins_enet-b5.yaml"
# the port's attention route -> JAX's
ROUTES = {"plain": "xla", "kernel": "pallas"}


def jax_adabins(dtype=jnp.float32, fold_bn=False, attn_impl="xla", dropout_rate=0.1):
    return JaxAdaBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                      dtype=dtype, fold_bn=fold_bn, attn_impl=attn_impl,
                      dropout_rate=dropout_rate)


@functools.lru_cache(maxsize=None)
def adabins_variables(seed: int = 0):
    """Unfolded JAX variables of the tiny AdaBins as numpy trees; the bin
    logits spread over a few units (conv_out x 10), as the GraphBins tests'."""
    variables = jax.jit(jax_adabins().init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, H, W, 3), jnp.float32))
    variables = _redraw_vectors(jax.tree.map(np.asarray, variables), np.random.default_rng(seed))
    conv_out = variables["params"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(10.0)
    return variables


def port_adabins(variables, attn_impl="plain", dropout_rate=0.1) -> AdaBins:
    model = AdaBins(encoder_name=ENC, n_bins=N_BINS, attn_impl=attn_impl,
                    dropout_rate=dropout_rate)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           adabins_state_dict_from_variables(variables, ENC).items()})
    return model.eval()


def _image(seed: int = 7) -> np.ndarray:
    return (0.5 * np.random.default_rng(seed).standard_normal((B, H, W, 3))).astype(np.float32)


def test_adabins_state_dict_has_the_reference_keys():
    """The converted variables fill every key of the port's AdaBins with its
    shape, under the reference's names."""
    sd = adabins_state_dict_from_variables(adabins_variables(), ENC)
    port_sd = AdaBins(encoder_name=ENC, n_bins=N_BINS).state_dict()
    assert set(sd) == set(port_sd)
    for k, v in sd.items():
        assert tuple(port_sd[k].shape) == v.shape, k
    assert sd["adaptive_bins_layer.patch_transformer.positional_encodings"].shape == (500, 128)
    for key in ("adaptive_bins_layer.patch_transformer.embedding_convPxP.weight",
                "adaptive_bins_layer.patch_transformer.transformer_encoder.layers.3.linear2.bias",
                "adaptive_bins_layer.conv3x3.weight", "adaptive_bins_layer.regressor.4.weight",
                "conv_out.0.weight"):
        assert key in sd, key


def _run(dtype_name: str, fold: bool, route: str):
    variables = adabins_variables()
    img = _image()
    jvars = jax_fold_batchnorm(variables) if fold else variables
    jmodel = jax_adabins(getattr(jnp, dtype_name), fold, ROUTES[route])
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jvars, jnp.asarray(img))
    model = port_adabins(variables, route)
    if fold:
        fold_batchnorm(model)
    model.cast(getattr(torch, dtype_name))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    return got, want


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_adabins_fp32_matches_jax(route):
    """tests/test_torch_slice.py's fp32 tolerances: depth 1e-3, edges 1e-4."""
    got, want = _run("float32", fold=False, route=route)
    assert got["depth_pred"].shape == (B, H // 2, W // 2, 1)
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_adabins_bf16_folded_matches_jax(route):
    """BN folded, then bf16. The frameworks round to bf16 at different
    points, so depth gaps scale with the depth's spread: they are held to
    tests/test_torch_slice.py's bf16 bounds for GraphBins taken relative to
    its spread (0.15 m max and 0.03 m mean gap over a std of 0.097 m: 1.5
    and 0.3 std), edges to its 0.04 m, correlation over 0.97. This AdaBins
    spreads over a std of 0.44 m; measured: max gap 0.32 m (plain) and 0.35
    m (kernel), at the image's last column; mean 0.010 and 0.006 m;
    correlation 0.9996; edges 0.010 m."""
    got, want = _run("bfloat16", fold=True, route=route)
    depth, ref = got["depth_pred"].numpy(), np.asarray(want["depth_pred"])
    assert np.isfinite(depth).all()
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=0, atol=0.04)
    gap, spread = np.abs(depth - ref), ref.std()
    assert gap.max() < 1.5 * spread and gap.mean() < 0.3 * spread, (gap.max(), gap.mean(), spread)
    assert np.corrcoef(depth.ravel(), ref.ravel())[0, 1] > 0.97


@pytest.mark.parametrize("frame_hw,at_input_res", [((H, W), False), ((300, 400), True)],
                         ids=["eval-size", "resized"])
def test_adabins_depth_pipeline_matches_jax(frame_hw, at_input_res):
    """uint8 frames through both servers, the model on the image alone; the
    fp32 tolerances of tests/test_torch_slice.py's pipeline test: 1e-3."""
    variables = adabins_variables()
    frames = np.random.default_rng(13).integers(0, 256, (B, *frame_hw, 3), dtype=np.uint8)
    jpipe = JaxDepthPipeline(jax_adabins(), variables, eval_dims=(H, W), use_mesh=False,
                             output_at_input_res=at_input_res)
    pipe = DepthPipeline(port_adabins(variables), eval_dims=(H, W),
                         output_at_input_res=at_input_res)
    assert not pipe.model.takes_objects
    want = np.asarray(jpipe(frames))
    got = pipe(frames).numpy()
    out_hw = frame_hw if at_input_res else (H // 2, W // 2)
    assert got.shape == want.shape == (B, *out_hw, 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _batch():
    rng = np.random.default_rng(0)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    gt = rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)
    return {"image": img, "depth": gt}


@functools.lru_cache(maxsize=None)
def _train_runs():
    """One fp32 step on each side, dropout 0, augmentation off, kernel 5's
    route (JAX's 'pallas' in interpret mode): (jax, port) dicts of the
    loss, the clipped gradients (JAX's read back from Adam's first moment)
    and the parameters after the step."""
    variables = adabins_variables()
    batch = _batch()
    tx = jax_build_optimizer(LR, WD, TOTAL_STEPS, gradient_clip_val=CLIP)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                              jax.tree.map(jnp.asarray, variables["batch_stats"]), tx)
    step = jax.jit(jax_make_train_step(jax_adabins(attn_impl="pallas", dropout_rate=0.0), tx,
                                       JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                       augment_on_device=False, is_graphbins=False))
    with pltpu.force_tpu_interpret_mode():
        state, loss = step(state, jax.tree.map(jnp.asarray, batch), {}, jax.random.PRNGKey(0))
    inject = state.opt_state[1]
    mu, b1 = inject.inner_state[0].mu, float(inject.hyperparams["b1"])
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1.0 - b1), mu)
    want = {"loss": float(loss),
            "grads": adabins_state_dict_from_variables({"params": grads}, ENC),
            "params": adabins_state_dict_from_variables(
                {"params": jax.tree.map(np.asarray, state.params)}, ENC)}

    model = port_adabins(variables, "kernel", dropout_rate=0.0)
    optimizer, scheduler = build_optimizer(model, LR, WD, TOTAL_STEPS)
    port_step = make_train_step(model, optimizer, scheduler, LossWrapper(*LOSSES), MIN_DEPTH,
                                augment_on_device=False, gradient_clip_val=CLIP)
    loss = port_step({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    got = {"loss": float(loss),
           "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
           "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
    return want, got


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def test_adabins_train_step_matches_jax():
    """One fp32 step on kernel 5's route at tests/test_torch_train.py's
    tolerances: the loss rel 1e-5; every clipped gradient within 1e-2 of its
    norm + 5e-8, median under 2e-3, miniViT's attentions within 1e-2; every
    parameter after AdamW rel 1e-4."""
    want, got = _train_runs()
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    rels = {}
    for name, g in got["grads"].items():
        w = want["grads"][name]
        err, ref = np.linalg.norm(g - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + 5e-8, (name, err, ref)
        if ref > 0:
            rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3
    attn = [n for n in rels if n.endswith("self_attn.in_proj_weight")]
    assert len(attn) == 4 and max(rels[n] for n in attn) <= 1e-2
    for name, p in got["params"].items():
        assert _rel(p, want["params"][name]) <= 1e-4, name


def test_build_model_from_the_adabins_params_file_matches_jax():
    """``params/nyu_adabins_enet-b5.yaml`` builds AdaBins-B5 on both sides:
    256 bins, NYU's 0.001-10 m, the B5 encoder; the port's parameters are
    fp32 and have the shapes of JAX's (from ``jax.eval_shape``, converted)."""
    args = load_config(str(PARAMS_FILE))
    model, jmodel = build_model(args, attn_impl="kernel"), jax_build_model(args)
    assert isinstance(model, AdaBins) and isinstance(jmodel, JaxAdaBins)
    assert (model.min_depth, model.max_depth) == (jmodel.min_depth, jmodel.max_depth)
    assert model.conv_out[0].out_channels == jmodel.n_bins == 256
    assert {m.attn_impl for m in model.modules() if hasattr(m, "attn_impl")} == {"kernel"}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 480, 640, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = adabins_state_dict_from_variables(zeros, args.adabins.encoder_name)
    port_sd = model.state_dict()
    assert set(sd) == set(port_sd)
    for k, v in port_sd.items():
        assert v.shape == sd[k].shape and (v.dtype == torch.float32 or "num_batches" in k), k


@pytest.mark.parametrize("norm", ["linear", "softmax", "sigmoid"])
def test_minivit_norms_match_jax(norm):
    """miniViT alone with each width norm ('sigmoid' stands for JAX's else
    branch), 4 queries over 3x4 patch tokens of a (2, 48, 64, 128) feature
    map, fp32: widths, feat and queries within 1e-4."""
    jmodel = JaxMiniViT(n_query_channels=4, norm=norm)
    x = np.random.default_rng(3).standard_normal((B, 48, 64, 128)).astype(np.float32)
    variables = _redraw_vectors(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1),
                                                                      jnp.asarray(x))),
                                np.random.default_rng(2))
    want = jmodel.apply(variables, jnp.asarray(x))
    reader = _Reader({col: {"vit": tree} for col, tree in variables.items()})
    _minivit(reader, "vit", "vit")
    model = MiniViT(n_query_channels=4, norm=norm)
    model.load_state_dict({k[len("vit."):]: torch.from_numpy(v) for k, v in reader.sd.items()})
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0].sum(1).numpy(), 1.0, rtol=1e-5)


def test_adabins_final_upscale_state_dict_has_the_reference_keys():
    """With do_final_upscale the port's AdaBins has the reference's
    ``decoder.final_upscale._net.{0,1,3,4}`` and a 1200-row positional
    table (JAX's ``max_seq_len`` under the option), and no other new key."""
    plain = AdaBins(encoder_name=ENC, n_bins=N_BINS).state_dict()
    final = AdaBins(encoder_name=ENC, n_bins=N_BINS, do_final_upscale=True).state_dict()
    prefix = "dense_feature_extractor.decoder.final_upscale._net."
    extra = set(final) - set(plain)
    assert set(plain) <= set(final) and extra and all(k.startswith(prefix) for k in extra)
    assert {k[len(prefix):].split(".")[0] for k in extra} == {"0", "1", "3", "4"}
    assert final["adaptive_bins_layer.patch_transformer.positional_encodings"].shape == (1200, 128)


def test_adabins_train_builder_steps_on_the_cpu():
    """``build_adabins_train`` with a tiny encoder and 16 queries at 192x176
    (30 patch tokens): two bf16-compute steps on the CPU give finite losses
    and move the weights; the plain versions run, so no kernel launch is
    counted."""
    step, batch = benchkit.build_adabins_train(batch=2, h=192, w=176, device="cpu",
                                               encoder_name=ENC, attn_impl="kernel", n_queries=16)
    w0 = step.model.conv_out[0].weight.detach().clone()
    before = kattn.fused_mha_fwd.launches, kattn.fused_mha_bwd.launches
    losses = [float(step(batch, None)) for _ in range(2)]
    assert all(np.isfinite(losses)) and not torch.equal(w0, step.model.conv_out[0].weight)
    assert (kattn.fused_mha_fwd.launches, kattn.fused_mha_bwd.launches) == before


@pytest.mark.parametrize("build", [
    benchkit.build_flagship_model, benchkit.build_adabins_model, benchkit.build_flagship_train,
    benchkit.build_adabins_train, benchkit.build_detector, serving.build_flagship_pipeline,
    serving.build_adabins_pipeline, serving.build_fused_flagship,
    lambda: benchkit.build_flagship(2), lambda: embedding.make_embedder("clip"),
], ids=["flagship_model", "adabins_model", "flagship_train", "adabins_train", "detector",
        "flagship_pipeline", "adabins_pipeline", "fused_flagship", "flagship", "clip_embedder"])
def test_builders_raise_without_a_card(monkeypatch, build):
    """Every entry point builds on the card by default and raises, rather
    than falling back to the CPU, when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build()
