"""The EfficientNet-V2 encoders (and B1) in objcavit_torch against objcavit_tpu, on the CPU.

``efficientnet-v2-tiny`` is the V2 topology at tiny widths: FusedMBConv
stages (expand 1 and 4), MBConv stages, torch (symmetric) padding and the
head's BN and SiLU, in torchvision's layout. Weights: the port's models
drawn by ``benchkit.init_weights_`` with every 1-D entry redrawn from a
seeded numpy RNG (``tests/test_torch_options.py``'s recipe), carried to the
JAX package's variables by its own ``convert_state_dict`` (which reads
torchvision's keys through ``_convert_efficientnet_v2``) and back by
``convert.state_dict_from_variables``; their tree is held against
``jax.eval_shape`` of JAX's own init, so no JAX init is compiled. Inputs are
numpy arrays from seeded RNGs, 64x96 and, for the stride-2 symmetric
padding on odd sizes, 67x83. Each test states its tolerance.
"""

import collections
import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.models import AdaBins as JaxAdaBins
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.models.decoder import DenseFeatureExtractor as JaxDFE
from objcavit_tpu.models.efficientnet import ENCODER_SPECS as JAX_SPECS
from objcavit_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from objcavit_tpu.ops import mbconv_pallas as jax_mp
from objcavit_tpu.ops import se_project_pallas as jax_sp
from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline
from objcavit_tpu.training.steps import make_train_loss_fn as jax_make_train_loss_fn
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm
from objcavit_tpu.utils.torch_import import (
    TreeBuilder,
    _convert_decoder,
    _convert_efficientnet,
    convert_state_dict,
)
from objcavit_tpu.utils.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint

from objcavit_torch import cli
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.efficientnet import EfficientNetEncoder
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.training.steps import make_train_loss_fn
from objcavit_torch.utils.benchkit import build_flagship_model, init_weights_
from objcavit_torch.utils.convert import adabins_state_dict_from_variables, state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm
from objcavit_torch.utils.kernel_io import record_encoder_kernel_io
from objcavit_torch.utils.torch_import import load_torch_checkpoint
from tests.test_dfe_oracle_v2 import TorchV2Encoder, _randomize_v2
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (a fixture)
from tests.test_torch_options import REPO, _objects, _redraw_vectors, _t

ENC = "efficientnet-v2-tiny"
N_BINS = 16
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
# 64x96 images: dense features 32x48, a 2x3 patch grid, 6 tokens, 5 queries
H, W = 64, 96
ODD = (67, 83)
N_QUERIES = 5
B = 2
POS = "learned"  # the GraphBins-V2-M params file's strategy
ENC_PREFIX = "dense_feature_extractor.encoder.original_model."
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])


def _port(model: str, **kw):
    if model == "graphbins":
        return GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES, pos_strategy=POS,
                         dims_train=(H, W), dims_test=(H, W), **kw)
    return AdaBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES, **kw)


def _jax(model: str, **kw):
    common = dict(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH, **kw)
    if model == "graphbins":
        return JaxGraphBins(pos_strategy=POS, dims_train=(H, W), dims_test=(H, W), **common)
    return JaxAdaBins(**common)


def _state_dict(model: str, variables) -> dict:
    if model == "graphbins":
        return state_dict_from_variables(variables, ENC, POS)
    return adabins_state_dict_from_variables(variables, ENC)


@functools.lru_cache(maxsize=None)
def weights(model: str):
    """(JAX variables, the port's state dict) of the tiny V2 GraphBins or
    AdaBins; the bin logits spread over a few units (conv_out x 10)."""
    port = init_weights_(_port(model), torch.Generator().manual_seed(0))
    sd = _redraw_vectors(port.state_dict(), np.random.default_rng(0))
    sd["conv_out.0.weight"] = sd["conv_out.0.weight"] * np.float32(10.0)
    variables = convert_state_dict({f"model.{k}": v for k, v in sd.items()}, model, ENC,
                                   pos_strategy=POS)
    return variables, sd


def port_model(model: str, **kw):
    variables, _ = weights(model)
    port = _port(model, **kw)
    port.load_state_dict({k: _t(v) for k, v in _state_dict(model, variables).items()})
    return port.eval()


def port_encoder(**switches) -> EfficientNetEncoder:
    enc = EfficientNetEncoder(ENC, **switches)
    enc.load_state_dict({k[len(ENC_PREFIX):]: _t(v) for k, v in weights("graphbins")[1].items()
                         if k.startswith(ENC_PREFIX)})
    return enc.eval()


def jax_encoder_variables(fold: bool) -> dict:
    variables, _ = weights("graphbins")
    enc = {col: tree["dense_feature_extractor"]["encoder"] for col, tree in variables.items()}
    return jax_fold_batchnorm(enc) if fold else enc


def _image(seed: int, hw=(H, W)) -> np.ndarray:
    return (0.5 * np.random.default_rng(seed).standard_normal((B, *hw, 3))).astype(np.float32)


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want))


# ------------------------------------------- the layout, both directions


@pytest.mark.parametrize("model", ["graphbins", "adabins"])
def test_v2_state_dict_round_trips_through_jax_converter(model):
    """The port's V2 state dict, through JAX's converter (torchvision's keys
    read by ``_convert_efficientnet_v2``), gives variables with the tree of
    JAX's own init, and ``state_dict_from_variables`` gives back the state
    dict bit for bit: the torchvision layout holds both ways."""
    variables, sd = weights(model)
    back = _state_dict(model, variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    args = (jnp.zeros((1, H, W, 3)),)
    if model == "graphbins":
        args += tuple(jnp.asarray(a[:1]) for a in _objects(0))
    shapes = jax.eval_shape(_jax(model).init, jax.random.PRNGKey(0), *args)
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, variables)


def test_torchvision_skeleton_loads_into_the_port():
    """tests/test_dfe_oracle_v2.py's torchvision-semantics skeleton (its
    ``Conv2dNormActivation``, ``FusedMBConv``, ``MBConv`` and
    ``SqueezeExcitation``) loads into the port's encoder with a plain strict
    ``load_state_dict``, and both forwards agree at an odd size within fp32
    rounding (rtol 1e-5, atol 1e-6: the same convs in another memory
    format)."""
    ref = TorchV2Encoder(JAX_SPECS[ENC])
    _randomize_v2(ref, np.random.default_rng(3))
    enc = EfficientNetEncoder(ENC)
    enc.load_state_dict(ref.state_dict())
    x = _image(4, ODD)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = enc.eval()(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"level {i}")


# ------------------------------------------------------------ the encoder


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("hw", [(H, W), ODD], ids=["64x96", "67x83"])
def test_v2_encoder_matches_jax(hw, fold):
    """The five levels in fp32 at tests/test_dfe_oracle_v2.py's tiny
    tolerance (rtol 1e-4, atol 1e-5), unfolded and folded; a folded V2
    encoder holds no BatchNorm (the stem's, every block's and the head's
    are folded through ``bn_folds``)."""
    x = _image(1, hw)
    jenc = JaxEncoder(ENC, fold_bn=fold)
    want = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(jax_encoder_variables(fold),
                                                               jnp.asarray(x))
    enc = port_encoder()
    if fold:
        fold_batchnorm(enc)
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in enc.modules())
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"level {i}")


# bf16 folded encoder, kernel 7's route vs JAX's bf16 encoder with its
# Pallas kernel 7 in interpret mode, rel L2 per level: both round every
# conv's output to bf16, but XLA's and PyTorch's CPU convs sum in other
# orders and JAX reads the biases in fp32 where the port rounds them to
# bf16 first, so values one bf16 ulp apart (2^-8 relative) compound over
# the eight blocks (measured 0.0031-0.0053 by level at this input, where
# each package's bf16 encoder lies within 0.0054 of its fp32 one)
BF16_ENCODER_REL = 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_kernel7_route_matches_jax(dtype, monkeypatch):
    """The folded encoder on ``encoder_impl="kernel"`` (kernel 7's plain
    version on the CPU) against JAX's with ``se_project_pallas.INTERPRET``
    (and ``mbconv_pallas.INTERPRET``) on: fp32 at tests/test_torch_mbconv.py's
    encoder tolerance (2e-4), bf16 within BF16_ENCODER_REL. Every MBConv
    block takes kernel 7 in both packages, and no block takes kernel 8."""
    reached = collections.Counter()
    for mod, name in ((jax_mp, "mbconv_expand_dw_pool"), (jax_sp, "se_gate_project")):
        monkeypatch.setattr(mod, "INTERPRET", True)
        original = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=original, _n=name, **kw:
                            reached.update([_n]) or _o(*a, **kw))
    x = _image(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jenc = JaxEncoder(ENC, fold_bn=True, fused_mbconv_head=True, dtype=jdt)
    want = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(jax_encoder_variables(True),
                                                               jnp.asarray(x, jdt))
    assert reached == {"se_gate_project": 4}
    enc = fold_batchnorm(port_encoder(fused_mbconv_head=True, se_project=True)).to(tdt)
    assert collections.Counter(enc.block_routes()) == {"se_project": 4, "plain": 4}
    with torch.no_grad(), record_encoder_kernel_io() as records:
        got = enc(torch.from_numpy(x).to(tdt))
    assert len(records) == (4 if dtype == "bfloat16" else 0)  # fp32 calls the plain version
    for i, (g, w) in enumerate(zip(got, want)):
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                       err_msg=f"level {i}")
        else:
            assert _rel_l2(g, w.astype(jnp.float32)) < BF16_ENCODER_REL, i


@pytest.mark.parametrize("name,mbconv,fused", [("efficientnet-v2-s", 30, 10),
                                               ("efficientnet-v2-m", 44, 13)])
def test_v2_full_width_routes(name, mbconv, fused):
    """At full width, on the meta device: every MBConv block takes kernel 7
    folded at inference (30 at V2-S, 44 at V2-M), every FusedMBConv block
    stays plain, no block takes kernel 8; unfolded or training, all plain."""
    with torch.device("meta"):
        enc = EfficientNetEncoder(name, fused_mbconv_head=True, se_project=True)
    assert collections.Counter(enc.eval().block_routes()) == {"plain": mbconv + fused}
    fold_batchnorm(enc)
    assert collections.Counter(enc.block_routes()) == {"se_project": mbconv, "plain": fused}
    assert set(enc.train().block_routes()) == {"plain"}


# ------------------------------------------------------------ whole models


def test_graphbins_v2_served_matches_jax():
    """GraphBins-V2-tiny behind ``DepthPipeline`` (uint8 frames, a provider's
    object slots) against JAX's pipeline at the slice tests' 1e-3."""
    variables, _ = weights("graphbins")
    feats, xywh, valid = _objects(7)

    def provider(_normed):
        return {"features": feats, "xywh": xywh, "valid": valid}

    frames = np.random.default_rng(13).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    jpipe = JaxDepthPipeline(_jax("graphbins"), variables, eval_dims=(H, W), use_mesh=False,
                             provider=provider)
    pipe = DepthPipeline(port_model("graphbins"), eval_dims=(H, W), provider=provider)
    want = np.asarray(jpipe(frames))
    got = pipe(frames).numpy()
    assert got.shape == want.shape == (B, H // 2, W // 2, 1)
    assert np.std(want) > 0.05  # the depth spreads: the comparison is not of constants
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_graphbins_v2_train_step_matches_jax():
    """One fp32 train-mode loss (dropout 0, no augmentation) and its
    gradients, at tests/test_torch_options.py's bounds: the loss rel 1e-5;
    each parameter's gradient ||got - want|| <= 1e-2 ||want|| + 5e-7 of the
    global gradient norm, the median rel error <= 2e-3. The last SACA's
    object cross-attention, which nothing reads, has no gradient in the
    port and a zero one in JAX."""
    variables, _ = weights("graphbins")
    rng = np.random.default_rng(5)
    batch = {"image": _image(5), "depth": rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)}
    feats, xywh, valid = _objects(5)
    objects = {"features": feats, "xywh": xywh, "valid": valid}
    loss_fn = jax_make_train_loss_fn(_jax("graphbins", dropout_rate=0.0),
                                     JaxLossWrapper(*LOSSES), MIN_DEPTH, augment_on_device=False,
                                     is_graphbins=True)

    def jax_loss(params):
        return loss_fn(params, variables["batch_stats"], batch, objects, jax.random.PRNGKey(0))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(variables["params"])
    want_grads = state_dict_from_variables({"params": jax.tree.map(np.asarray, want_grads)}, ENC,
                                           POS)
    model = port_model("graphbins", dropout_rate=0.0)
    loss = make_train_loss_fn(model, LossWrapper(*LOSSES), MIN_DEPTH, augment_on_device=False)(
        {k: _t(v) for k, v in batch.items()}, {k: _t(v) for k, v in objects.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    atol = 5e-7 * np.sqrt(sum(np.sum(np.square(g)) for g in want_grads.values()))
    rels = {}
    for name, p in model.named_parameters():
        w = want_grads[name]
        if name.startswith("objcavit.saca_1.cross_attn_im_obj."):
            assert p.grad is None and not np.any(w), name
            continue
        assert p.grad is not None, name
        err, ref = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + atol, (name, err, ref)
        if ref > 0:
            rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3
    assert any(name.startswith(ENC_PREFIX + "features.") for name in rels)


def test_adabins_v2_forward_matches_jax():
    """AdaBins-V2-tiny in fp32 at tests/test_torch_adabins.py's tolerances:
    depth 1e-3, edges 1e-4."""
    variables, _ = weights("adabins")
    img = _image(7)
    jmodel = _jax("adabins")
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port_model("adabins")(torch.from_numpy(img))
    assert got["depth_pred"].shape == (B, H // 2, W // 2, 1)
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)


def test_v2_checkpoint_loads_as_jax_loads_it(tmp_path):
    """A reference-layout .ckpt of GraphBins-V2-tiny (torchvision's encoder
    keys under ``model.``): the port's ``load_torch_checkpoint`` and JAX's
    land the same weights, bit for bit."""
    variables, _ = weights("graphbins")
    sd = {f"model.{k}": _t(v) for k, v in state_dict_from_variables(variables, ENC, POS).items()}
    path = str(tmp_path / "v2.ckpt")
    torch.save({"state_dict": sd, "epoch": 1}, path)
    model = _port("graphbins")
    load_torch_checkpoint(path, model)
    config = JaxConfig({"model": {"name": "graphbins"}, "graphbins": {
        "encoder_name": ENC, "objcavit": {"positional_embedding_strategy": POS}}})
    want = state_dict_from_variables(jax_load_torch_checkpoint(path, config), ENC, POS)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_v2_tiny_bf16_kernel_route_serves_on_the_cpu():
    """``build_flagship_model`` with the V2 encoder on ``encoder_impl="kernel"``
    (bf16, BN folded) behind ``DepthPipeline``: finite depth in range, one
    kernel-7 call per MBConv block and none of kernel 8."""
    model = build_flagship_model(dtype=torch.bfloat16, device="cpu", encoder_name=ENC,
                                 n_bins=N_BINS, n_queries=N_QUERIES, pos_strategy=POS,
                                 encoder_impl="kernel")
    frames = np.random.default_rng(6).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    with record_encoder_kernel_io() as records:
        depth = DepthPipeline(model, eval_dims=(H, W), n_obj_max=4)(frames)
    assert depth.shape == (B, H // 2, W // 2, 1) and torch.isfinite(depth).all()
    assert float(depth.min()) >= MIN_DEPTH and float(depth.max()) <= MAX_DEPTH * (1 + 2**-8)
    assert collections.Counter(r["kind"] for r in records) == {"se_project": 4}


# ------------------------------------------------------------ entry points

V2_FILES = {"graphbins": "nyu_graphbins_enet-v2-m_ocv_pos_learned_emb_128_1.yaml",
            "adabins": "nyu_efficientnet-v2-s_clip_0.1_lossfixed.yaml"}


def _tiny_copy(tmp_path, name: str) -> str:
    """The params file ``name`` at tiny size: efficientnet-v2-tiny, 16 bins,
    64x96, the zeros language strategy for GraphBins, the synthetic NYU
    split, a run dir under tmp_path. These files' own nyu sections predate
    the dataset keys training reads, so the copy takes basicParams.yaml's
    (what -v and -i read in any case)."""
    with open(f"{REPO}/params/{name}") as f:
        cfg = yaml.safe_load(f)
    with open(f"{REPO}/params/basicParams.yaml") as f:
        cfg["nyu"] = yaml.safe_load(f)["nyu"]
    model = cfg["model"]["name"]
    assert cfg[model]["encoder_name"].startswith("efficientnet-v2-")
    cfg[model].update(encoder_name=ENC, n_bins=N_BINS)
    if model == "graphbins":
        cfg["graphbins"]["objcavit"]["language_embedding_strategy"] = "control_obj_zeros_512"
    cfg["nyu"].update(dimensions_train=[H, W], dimensions_test=[H, W], eigen_crop=False)
    cfg["basic"].update(batch_size=2, name="tiny")
    cfg["paths"] = {"data_dir": str(tmp_path / "no_data"), "run_dir": str(tmp_path / "runs")}
    cfg["hardware"] = {"num_workers": 0}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("model", list(V2_FILES))
def test_v2_params_file_trains_and_validates_through_the_cli(tmp_path, model, monkeypatch):
    """A copy of the GraphBins-V2-M and the AdaBins-V2-S params file (at
    v2-tiny) through ``cli.main`` on the CPU: a --debug fit writes its run
    with a V2 encoder, then -v --debug restores that run's last.ckpt and
    writes validation_output.txt with 32 finite numbers. The fit runs
    without TensorBoard, as on a machine where it does not import
    (tests/test_torch_fit.py covers both): here its first import takes
    ~13 s."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _tiny_copy(tmp_path, V2_FILES[model])
    built, _ = cli.main(["-c", cfg, "--debug"], basic_params_path=None, device="cpu")
    assert type(built).__name__ == {"graphbins": "GraphBins", "adabins": "AdaBins"}[model]
    enc = built.dense_feature_extractor.encoder["original_model"]
    assert enc.pad_style == "torch" and hasattr(enc, "features")
    run = tmp_path / "runs" / "tiny" / "version_0"
    assert (run / "checkpoints" / "last.ckpt").exists()
    metrics = cli.main(["-c", str(run / "hparams.yaml"), "-v", "--debug"], basic_params_path=None,
                       device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    numbers = re.findall(r"-?\d+\.\d+(?:e-?\d+)?", (run / "validation_output.txt").read_text())
    assert len(numbers) == 32 and all(np.isfinite(float(x)) for x in numbers)


# --------------------------------------------------------------------- B1


def test_b1_dense_feature_extractor_matches_jax():
    """B1's DenseFeatureExtractor (its spec has been in the port since the
    encoder was ported) against JAX's at 64x64, fp32: the weights drawn for
    the port and carried to JAX by its own ``_convert_efficientnet`` and
    ``_convert_decoder`` (their tree held against ``jax.eval_shape`` of
    JAX's init); the 128 features within rtol 1e-4 and atol 1e-4 of the
    output's largest entry."""
    name = "efficientnet-b1"
    dfe = init_weights_(DenseFeatureExtractor(name), torch.Generator().manual_seed(1))
    sd = _redraw_vectors(dfe.state_dict(), np.random.default_rng(1))
    dfe.load_state_dict({k: _t(v) for k, v in sd.items()})
    tb = TreeBuilder()
    _convert_efficientnet(tb, sd, "encoder.original_model", "encoder", name)
    _convert_decoder(tb, sd, "decoder", "decoder", do_final_upscale=False)
    variables = {"params": tb.params, "batch_stats": tb.batch_stats}
    x = (0.5 * np.random.default_rng(2).standard_normal((1, 64, 64, 3))).astype(np.float32)
    jdfe = JaxDFE(name)
    shapes = jax.eval_shape(jdfe.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, variables)
    want = np.asarray(jax.jit(lambda v, a: jdfe.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        got = dfe.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
