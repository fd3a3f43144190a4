"""``do_final_upscale`` and ``drop_path_rate``: objcavit_torch against
objcavit_tpu on the CPU.

``do_final_upscale`` adds the decoder's fifth upsample, whose skip is the
image, so the dense features come out at full resolution and the image
tokens quadruple (miniViT's table grows to 1200 rows; servers hold 1000
slots at 480x640). ``drop_path_rate`` is the encoder's stochastic depth.

Weights come from the port's init with every vector redrawn from a seeded
numpy generator (tests/test_torch_options.py's ``_redraw_vectors``) and
reach JAX through its ``convert_state_dict``, so no JAX init is compiled;
JAX's gradients come back through ``utils/convert.py``. The models are the tiny ones (efficientnet-tiny, 32 bins) at 64x96, whose full
resolution gives 4 x 6 = 24 patch tokens, so 23 queries on both sides (JAX's
``conv_out`` takes the tokens there are). Random numbers never agree across
the frameworks, so the drop-path masks JAX draws are recorded and replayed
in the port, and the train-step test runs at rate 0 with dropout 0. Each
test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import objcavit_tpu.models.common as jax_common
from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.models import AdaBins as JaxAdaBins
from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.models.decoder import DenseFeatureExtractor as JaxDFE
from objcavit_tpu.models.decoder import UpSampleWithSkip as JaxUpSampleWithSkip
from objcavit_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from objcavit_tpu.ops import resize_pallas as rp
from objcavit_tpu.serving import _default_capacity as jax_default_capacity
from objcavit_tpu.training.providers import StubObjectProvider as JaxStub
from objcavit_tpu.training.providers import ZerosObjectProvider as JaxZeros
from objcavit_tpu.training.steps import build_model as jax_build_model
from objcavit_tpu.training.steps import image_seq_len as jax_image_seq_len
from objcavit_tpu.training.steps import make_train_loss_fn as jax_make_train_loss_fn
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm
from objcavit_tpu.utils.torch_import import (
    TreeBuilder,
    _convert_efficientnet,
    _convert_efficientnet_v2,
    convert_state_dict,
)
from objcavit_tpu.utils.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint

import objcavit_torch.models.common as common
from objcavit_torch.config import Config
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.decoder import DenseFeatureExtractor, UpSampleWithSkip
from objcavit_torch.models.efficientnet import EfficientNetEncoder
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.serving import DepthPipeline, FusedDepthPipeline, image_seq_len
from objcavit_torch.training.checkpoint import checkpoint_dict
from objcavit_torch.training.providers import StubObjectProvider, ZerosObjectProvider
from objcavit_torch.training.steps import build_model, make_train_loss_fn
from objcavit_torch.utils.benchkit import init_weights_
from objcavit_torch.utils.convert import (
    adabins_state_dict_from_variables,
    state_dict_from_variables,
)
from objcavit_torch.utils.fold_bn import fold_batchnorm
from objcavit_torch.utils.torch_import import load_torch_checkpoint
from tests.test_torch_modules import ENC, _sub
from tests.test_torch_options import _redraw_vectors

B, H, W, N_BINS, N_SLOTS = 2, 64, 96, 32, 6
N_QUERIES = (H // 16) * (W // 16) - 1  # 23: every token after the regression one
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _image(seed: int = 7, b: int = B) -> np.ndarray:
    return (0.5 * np.random.default_rng(seed).standard_normal((b, H, W, 3))).astype(np.float32)


def _objects(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    valid = np.zeros((B, N_SLOTS), bool)
    valid[0, :4], valid[1, :1] = True, True
    xywh = np.stack([rng.uniform(0, W, (B, N_SLOTS)), rng.uniform(0, H, (B, N_SLOTS)),
                     rng.uniform(8, 60, (B, N_SLOTS)), rng.uniform(8, 60, (B, N_SLOTS))], -1)
    return {"features": rng.standard_normal((B, N_SLOTS, 512)).astype(np.float32),
            "xywh": np.where(valid[..., None], xywh, -1.0).astype(np.float32), "valid": valid}


def jax_model(name: str, dtype=jnp.float32, fold_bn: bool = False):
    kwargs = dict(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                  do_final_upscale=True, dropout_rate=0.0, dtype=dtype, fold_bn=fold_bn)
    if name == "adabins":
        return JaxAdaBins(**kwargs)
    return JaxGraphBins(pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W),
                        **kwargs)


def _new_model(name: str, **kwargs):
    cls = AdaBins if name == "adabins" else GraphBins
    extra = {} if name == "adabins" else {"dims_train": (H, W), "dims_test": (H, W)}
    return cls(encoder_name=ENC, n_bins=N_BINS, do_final_upscale=True, dropout_rate=0.0,
               n_queries=N_QUERIES, **extra, **kwargs)


@functools.lru_cache(maxsize=None)
def variables(name: str, seed: int = 0):
    """Unfolded JAX variables of the tiny final-upscale model as numpy
    trees, from the port's init with its vectors redrawn; conv_out x 10, so
    depth spreads over the image."""
    model = init_weights_(_new_model(name), torch.Generator().manual_seed(seed))
    sd = _redraw_vectors(model.state_dict(), np.random.default_rng(seed))
    sd["conv_out.0.weight"] = sd["conv_out.0.weight"] * np.float32(10.0)
    return convert_state_dict({f"model.{k}": v for k, v in sd.items()}, name, ENC,
                              pos_strategy="learned_bbox_wh", do_final_upscale=True)


def port_state_dict(name: str, tree) -> dict:
    if name == "adabins":
        sd = adabins_state_dict_from_variables(tree, ENC, do_final_upscale=True)
    else:
        sd = state_dict_from_variables(tree, ENC, do_final_upscale=True)
    return {k: _t(v) for k, v in sd.items()}


def port_model(name: str, **kwargs):
    model = _new_model(name, **kwargs)
    model.load_state_dict(port_state_dict(name, variables(name)))
    return model.eval()


def _inputs(name: str, img: np.ndarray) -> tuple:
    if name == "adabins":
        return (img,)
    objs = _objects()
    return (img, objs["features"], objs["xywh"], objs["valid"])


# ------------------------------------------------------------------ decoder


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_feature_extractor_final_upscale_matches_jax(dtype):
    """The encoder and the five-stage decoder, full-resolution features.
    fp32 (BN unfolded): tests/test_torch_modules.py's tolerance, 1e-4 rel
    and 1e-5 abs. bf16 (BN folded, as served): the frameworks round to bf16
    at other points (JAX's resize rounds its H pass; the port lerps in fp32
    and rounds once), through ~30 bf16 layers; measured max gap 0.031 and
    mean 0.0026 on features of std 0.33, held to 0.1 and 0.01."""
    tree = _sub(variables("adabins"), "dense_feature_extractor")
    img = _image()
    port = DenseFeatureExtractor(ENC, do_final_upscale=True)
    port.load_state_dict({k[len("dense_feature_extractor."):]: v
                          for k, v in port_state_dict("adabins", variables("adabins")).items()
                          if k.startswith("dense_feature_extractor.")})
    port.eval()
    if dtype == "bfloat16":
        tree = jax_fold_batchnorm(tree)
        fold_batchnorm(port)
        port.to(torch.bfloat16)
    jdfe = JaxDFE(ENC, do_final_upscale=True, fold_bn=dtype == "bfloat16",
                  dtype=getattr(jnp, dtype))
    want = np.asarray(jax.jit(jdfe.apply)(tree, jnp.asarray(img)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(img).to(getattr(torch, dtype))).float().numpy()
    assert got.shape == want.shape == (B, H, W, 128)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        gap = np.abs(got - want)
        assert gap.max() < 0.1 and gap.mean() < 0.01, (gap.max(), gap.mean(), want.std())


def test_final_upscale_stage_bf16_eval_matches_jax_pallas(monkeypatch):
    """The fifth up-stage as B5 has it (C = 128, the 3-channel image as its
    skip) in bf16 eval, BN folded: the port's route (kernel 1's bare form,
    its plain version on the CPU, then ``torch.cat``) against JAX's
    UpSampleWithSkip on its Pallas resize in interpret mode (C = 128 passes
    ``resize_eligible``) and on its einsum resize. The bounds of
    tests/test_torch_resize.py's up-stage test: max 0.02, mean 0.002
    (measured max 0.0078, mean 0.0006)."""
    rng = np.random.default_rng(11)
    cx, out = 128, 16
    x = rng.standard_normal((1, 8, 12, cx)).astype(np.float32)
    image = rng.standard_normal((1, 16, 24, 3)).astype(np.float32)
    assert rp.resize_eligible(8, 12, cx, 16, 24)
    jm = JaxUpSampleWithSkip(out, fold_bn=True, dtype=jnp.bfloat16)
    xb, ib = jnp.asarray(x, jnp.bfloat16), jnp.asarray(image, jnp.bfloat16)
    tree = jm.init(jax.random.PRNGKey(0), xb, ib, False)
    params = jax.tree.map(np.asarray, tree["params"])
    wants = [np.asarray(jm.apply(tree, xb, ib, False), np.float32)]
    monkeypatch.setattr(rp, "INTERPRET", True)
    wants.append(np.asarray(jm.apply(tree, xb, ib, False), np.float32))

    port = fold_batchnorm(UpSampleWithSkip(cx + 3, out).eval())
    with torch.no_grad():
        for idx, name in ((0, "conv0"), (3, "conv1")):
            conv = port._net[idx]
            conv.weight.copy_(_t(params[name]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(_t(params[name]["bias"]))
        port = port.to(torch.bfloat16)
        got = port(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                   torch.from_numpy(image).to(torch.bfloat16).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == (1, 16, 24, out)
    for want in wants:
        gap = np.abs(got - want)
        assert gap.max() < 0.02 and gap.mean() < 0.002, (gap.max(), gap.mean())


# ------------------------------------------------------------------- models


@functools.lru_cache(maxsize=None)
def _jax_forward(name: str):
    img = _image()
    return jax.tree.map(np.asarray, jax.jit(
        lambda v, *a: jax_model(name).apply(v, *a, train=False))(
            variables(name), *map(jnp.asarray, _inputs(name, img))))


@pytest.mark.parametrize("name", ["adabins", "graphbins"])
def test_model_final_upscale_matches_jax(name):
    """AdaBins (miniViT over 24 tokens of a 1200-row table) and GraphBins
    (ObjCAViT over 24 tokens, objects placed with a feature stride of 2, as
    JAX does), fp32 eval: full-resolution depth within
    tests/test_torch_slice.py's fp32 tolerances, depth 1e-3 and edges 1e-4."""
    want = _jax_forward(name)
    model = port_model(name)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, _inputs(name, _image())))
    assert got["depth_pred"].shape == want["depth_pred"].shape == (B, H, W, 1)
    np.testing.assert_allclose(got["bin_edges"].numpy(), want["bin_edges"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), want["depth_pred"], rtol=1e-3,
                               atol=1e-3)
    assert float(np.std(want["depth_pred"])) > 0.05  # a depth that varies over the image


def test_adabins_final_upscale_train_loss_and_gradients_match_jax():
    """One train-mode loss of the final-upscale AdaBins (BN on batch
    statistics, dropout 0, augmentation off) and its gradients, fp32: the
    loss rel 1e-5; each parameter's gradient ||got - want|| <= 1e-2 ||want||
    + 5e-8 and the median relative error under 2e-3, the bounds of
    tests/test_torch_train.py's step, whose 5e-8 is 5e-7 of its clipped
    global norm: here 5e-7 of the unclipped one. Train-mode BN's backward
    magnifies the two frameworks' accumulation order, and the decoder's
    conv biases before a train-mode BN have a gradient of exactly zero in
    exact arithmetic, rounding noise on both sides."""
    tree = variables("adabins")
    rng = np.random.default_rng(5)
    batch = {"image": _image(9), "depth": rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)}
    jloss_fn = jax_make_train_loss_fn(jax_model("adabins"), JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                      augment_on_device=False, is_graphbins=False)
    (want_loss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree["params"]), jax.tree.map(jnp.asarray, tree["batch_stats"]),
        jax.tree.map(jnp.asarray, batch), {}, jax.random.PRNGKey(0))
    want = port_state_dict("adabins", {"params": jax.tree.map(np.asarray, jgrads)})

    model = port_model("adabins").train()
    loss = make_train_loss_fn(model, LossWrapper(*LOSSES), MIN_DEPTH, augment_on_device=False)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    loss.backward()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    atol = 5e-7 * np.sqrt(sum(float((v.double() ** 2).sum()) for v in want.values()))
    rels = {}
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        err, ref = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + atol, (pname, err, ref, atol)
        if ref > 0:
            rels[pname] = err / ref
    assert np.median(list(rels.values())) <= 2e-3
    fu = "dense_feature_extractor.decoder.final_upscale._net.0.weight"
    assert np.abs(dict(model.named_parameters())[fu].grad.numpy()).max() > 0


def test_final_upscale_ckpt_loads_in_both_packages(tmp_path):
    """A reference-format .ckpt (``state_dict`` under ``model.``) of the
    final-upscale AdaBins, its ``decoder.final_upscale._net.{0,1,3,4}`` keys
    and a 1200-row positional table among them, loads in both packages
    with every key matched; their fp32 outputs agree within 1e-3 (depth)
    and 1e-4 (edges)."""
    source = port_model("adabins")
    path = str(tmp_path / "final_upscale.ckpt")
    torch.save(checkpoint_dict(source), path)
    sd = torch.load(path, weights_only=False)["state_dict"]
    assert "model.dense_feature_extractor.decoder.final_upscale._net.4.running_var" in sd
    assert sd["model.adaptive_bins_layer.patch_transformer.positional_encodings"].shape == (1200, 128)

    args = {"model": {"name": "adabins"},
            "adabins": {"encoder_name": ENC, "n_bins": N_BINS, "do_final_upscale": True}}
    jtree = jax_load_torch_checkpoint(path, JaxConfig(args))
    model = AdaBins(encoder_name=ENC, n_bins=N_BINS, do_final_upscale=True, dropout_rate=0.0,
                    n_queries=N_QUERIES)
    load_torch_checkpoint(path, model)
    img = _image(21)
    want = jax.jit(lambda v, x: jax_model("adabins").apply(v, x, train=False))(
        jtree, jnp.asarray(img))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img))
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------- slot sizing


class _Detector(torch.nn.Module):
    num_classes = 2


@pytest.mark.parametrize("dims,slots", [((480, 640), 1000), ((416, 544), 884), ((96, 128), 48)])
def test_final_upscale_slot_sizing_matches_jax(dims, slots):
    """Full-resolution tokens size the object slots: ``image_seq_len``, the
    providers and both servers give min(max_det 1000, tokens), as JAX's
    (1000 at 480x640, 884 at 416x544), and the half-resolution count
    without the option."""
    assert image_seq_len(*dims, True) == jax_image_seq_len(*dims, True)
    assert image_seq_len(*dims) == jax_image_seq_len(*dims) == jax_image_seq_len(*dims, False)
    assert min(1000, image_seq_len(*dims, True)) == slots
    images = np.zeros((1, *dims, 3), np.float32)
    for port_cls, jax_cls in ((ZerosObjectProvider, JaxZeros), (StubObjectProvider, JaxStub)):
        for fu in (False, True):
            got = port_cls(None, final_upscale=fu).slots(images)
            assert got == jax_cls(None, final_upscale=fu).slots(images)
            assert got == (slots if fu else min(1000, image_seq_len(*dims)))
    with torch.device("meta"):
        model = GraphBins(encoder_name=ENC, n_bins=N_BINS, do_final_upscale=True)
    assert DepthPipeline(model, eval_dims=dims).n_obj_max == slots
    assert FusedDepthPipeline(model, _Detector(), np.zeros((3, 512), np.float32),
                              eval_dims=dims).n_obj_max == slots
    assert slots == jax_default_capacity(dims, do_final_upscale=True)


def test_unknown_model_name_raises_value_error_in_both_packages():
    """A model name other than graphbins or adabins raises ValueError
    ('unrecognised model') in both build_model."""
    tree = {"basic": {"dataset": "nyu"}, "model": {"name": "unet"},
            "nyu": {"min_depth": 0.001, "max_depth": 10.0, "dimensions_train": [416, 544],
                    "dimensions_test": [480, 640]},
            "unet": {"n_bins": 256, "encoder_name": ENC}}
    with pytest.raises(ValueError, match="unrecognised model: unet"):
        build_model(Config(tree))
    with pytest.raises(ValueError, match="unrecognised model: unet"):
        jax_build_model(JaxConfig(tree))


# --------------------------------------------------------------- drop path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.2, 0.7])
def test_drop_path_arithmetic_matches_jax(dtype, rate):
    """``drop_path`` on the mask JAX draws (``jax.random.bernoulli`` of the
    keep rate) equals JAX's ``drop_path`` bit for bit, in fp32 and bf16; in
    eval mode, or at rate 0, both are the identity."""
    x = np.random.default_rng(4).standard_normal((8, 5, 6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_common.drop_path(jx, rate, False, key), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    mask = None
    if rate > 0:
        mask = _t(np.asarray(jax.random.bernoulli(key, 1.0 - rate, (8, 1, 1, 1)), np.float32))
        assert 0 < float(mask.sum()) < 8  # some samples kept, some dropped
    got = common.drop_path(tx.permute(0, 3, 1, 2), rate, True, mask).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(common.drop_path(tx, rate, False, mask), tx)
    eval_want = np.asarray(jax_common.drop_path(jx, rate, True, key), np.float32)
    np.testing.assert_array_equal(eval_want, tx.float().numpy())


def test_drop_path_draws_from_its_generator():
    """The keep mask comes from the generator it is given: one seed, one
    mask; the fraction kept is about the keep rate."""
    x = torch.ones(4000, 3, 2, 2)
    draws = [common.drop_path(x, 0.3, True, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    kept = float((draws[0][:, 0, 0, 0] > 0).float().mean())
    assert abs(kept - 0.7) < 0.03
    assert torch.allclose(draws[0][draws[0] > 0], torch.tensor(1 / 0.7))


@pytest.mark.parametrize("encoder", [ENC, "efficientnet-v2-tiny"])
def test_encoder_drop_path_replays_jax_masks(encoder, monkeypatch):
    """The whole encoder in training mode at drop_path_rate 0.9: each mask
    JAX draws (recorded by wrapping ``objcavit_tpu.models.common.
    drop_path``, JAX run eagerly so the masks are values) is replayed in
    the port (``keep_mask`` patched), block by block; each residual block's
    rate equals JAX's ``rate * block_idx / total_blocks``, and the five
    outputs agree within 1e-4 rel and 1e-5 abs (train-mode BN, as
    tests/test_torch_modules.py's encoder); at least one sample was
    dropped."""
    rate, b = 0.9, 4
    x = np.random.default_rng(2).standard_normal((b, 32, 48, 3)).astype(np.float32)
    port = init_weights_(EfficientNetEncoder(encoder, drop_path_rate=rate),
                         torch.Generator().manual_seed(1))
    sd = _redraw_vectors(port.state_dict(), np.random.default_rng(1))
    port.load_state_dict({k: _t(v) for k, v in sd.items()})
    tb = TreeBuilder()
    convert = _convert_efficientnet_v2 if "v2" in encoder else _convert_efficientnet
    convert(tb, {f"enc.{k}": v for k, v in sd.items()}, "enc", "enc", encoder)
    tree = {"params": tb.params["enc"], "batch_stats": tb.batch_stats["enc"]}
    jenc = JaxEncoder(encoder, drop_path_rate=rate)
    drawn, original = [], jax_common.drop_path

    def recording(h, r, deterministic, rng=None):
        mask = None
        if not deterministic and r > 0:
            mask = np.asarray(jax.random.bernoulli(rng, 1.0 - r, (h.shape[0], 1, 1, 1)),
                              np.float32)
        drawn.append((r, mask))
        return original(h, r, deterministic, rng)

    monkeypatch.setattr(jax_common, "drop_path", recording)
    want, _ = jenc.apply(tree, jnp.asarray(x), train=True, mutable=["batch_stats"],
                         rngs={"droppath": jax.random.PRNGKey(5)})
    monkeypatch.setattr(jax_common, "drop_path", original)

    blocks = [blk for stage in port.stages() for blk in stage]
    assert [round(blk.drop_path_rate, 12) for blk in blocks if blk.has_residual] == [
        round(r, 12) for r, _ in drawn]
    masks = [torch.from_numpy(m) for _, m in drawn if m is not None]
    assert masks and min(float(m.min()) for m in masks) == 0.0
    replay = iter(masks)
    monkeypatch.setattr(common, "keep_mask", lambda h, keep, generator: next(replay).to(h.dtype))
    port.train()
    got = port(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert next(replay, None) is None  # every mask consumed
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"level {i}")


def test_drop_path_is_the_identity_in_eval_and_keeps_the_fused_routes():
    """At inference a model with drop_path_rate equals the same weights at
    rate 0 bit for bit, draws nothing from the generator, and its blocks
    take the same routes (kernels 7 and 8 on ``encoder_impl="kernel"``)."""
    img = torch.from_numpy(_image(3))
    outs, routes = [], []
    for rate in (0.0, 0.5):
        torch.manual_seed(0)
        model = AdaBins(encoder_name=ENC, n_bins=N_BINS, do_final_upscale=True,
                        drop_path_rate=rate, n_queries=N_QUERIES, encoder_impl="kernel")
        fold_batchnorm(model.eval())
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            outs.append(model(img, gen)["depth_pred"])
        assert torch.equal(gen.get_state(), torch.Generator().manual_seed(9).get_state())
        routes.append(model.dense_feature_extractor.encoder["original_model"].block_routes())
    assert torch.equal(outs[0], outs[1])
    assert routes[0] == routes[1] and "mbconv_head" in routes[0] and "se_project" in routes[0]
