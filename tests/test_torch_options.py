"""ObjCAViT's options (positional strategies ``learned``, ``grid_random``,
``grid_random_roi_align`` and ``learned_bbox_wh``; ``no_obj_sa``;
``use_2_saca``) in objcavit_torch against objcavit_tpu on the CPU.

Weights: a port model of each option, its parameters drawn by
``benchkit.init_weights_`` and every 1-D leaf (biases, norm scales, BN
statistics) redrawn from a seeded numpy RNG, so a misplaced vector cannot
hide behind zeros and ones; JAX's ``convert_state_dict`` turns them into
the JAX package's variables, and ``convert.state_dict_from_variables``
carries those back to the port, which must give the same state dict. So no
JAX init is compiled: each option's variables are made once (a cache) and
their tree is held against ``jax.eval_shape`` of JAX's own init. Inputs are
numpy arrays from a seeded RNG handed to both sides. Each test states its
tolerance.
"""

import functools
import glob
import logging
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.config import load_args as jax_load_args
from objcavit_tpu.losses import LossWrapper as JaxLossWrapper
from objcavit_tpu.models.efficientnet import ENCODER_SPECS as JAX_ENCODER_SPECS
from objcavit_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from objcavit_tpu.models.objcavit import GridRandomPositionalEmbeddings as JaxGridPos
from objcavit_tpu.models.objcavit import ObjCAViT as JaxObjCAViT
from objcavit_tpu.ops.grid_sample import grid_sample_bilinear as jax_grid_sample_bilinear
from objcavit_tpu.ops.roi_align import ps_roi_align_1x1 as jax_ps_roi_align_1x1
from objcavit_tpu.training.steps import build_model as jax_build_model
from objcavit_tpu.training.steps import make_train_loss_fn as jax_make_train_loss_fn
from objcavit_tpu.utils.torch_import import TreeBuilder, _convert_efficientnet_v2, convert_state_dict
from objcavit_tpu.utils.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint

from objcavit_torch import cli
from objcavit_torch.config import Config, load_args
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.efficientnet import EfficientNetEncoder
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.objcavit import POS_STRATEGIES, GridRandomPositionalEmbeddings
from objcavit_torch.ops.grid_sample import grid_sample_bilinear
from objcavit_torch.ops.roi_align import ps_roi_align_1x1
from objcavit_torch.serving import DepthPipeline
from objcavit_torch.training.steps import build_model, make_train_loss_fn
from objcavit_torch.utils.benchkit import build_flagship_model, init_weights_
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.torch_import import load_torch_checkpoint
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (a fixture)

ENC = "efficientnet-tiny"
N_BINS = 16
MIN_DEPTH, MAX_DEPTH = 0.001, 10.0
# 64x96 images: dense features 32x48, a 2x3 patch grid, 6 tokens, 5 queries
H, W = 64, 96
N_QUERIES = 5
# the full-resolution sizes that size grid_random's table: 4x6 and 6x4
# patches, so 24 rows, of which a 2x3 grid reads the first 6
DIMS_TRAIN, DIMS_TEST = (64, 96), (96, 64)
B, N_SLOTS = 2, 6
VARIANTS = {"default": {}, "no_obj_sa": {"no_obj_sa": True}, "use_2_saca": {"use_2_saca": True}}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _redraw_vectors(sd: dict, rng: np.random.Generator) -> dict:
    """Numpy values for every 1-D float entry of a port state dict."""
    out = {}
    for k, v in sd.items():
        v = v.numpy().copy()
        if v.ndim == 1 and v.dtype == np.float32:
            n = v.shape
            if k.endswith("running_var"):
                v = 0.5 + rng.random(n)
            elif k.endswith("running_mean"):
                v = 0.2 * rng.standard_normal(n)
            elif k.endswith("weight"):  # norm scales
                v = 1.0 + 0.2 * rng.standard_normal(n)
            else:  # biases
                v = 0.1 * rng.standard_normal(n)
            v = v.astype(np.float32)
        out[k] = v
    return out


def _port_graphbins(dropout_rate=0.1, **options) -> GraphBins:
    return GraphBins(encoder_name=ENC, n_bins=N_BINS, n_queries=N_QUERIES, dims_train=DIMS_TRAIN,
                     dims_test=DIMS_TEST, dropout_rate=dropout_rate, **options)


def _jax_graphbins(**options):
    from objcavit_tpu.models import GraphBins as JaxGraphBins

    return JaxGraphBins(encoder_name=ENC, n_bins=N_BINS, min_depth=MIN_DEPTH,
                        max_depth=MAX_DEPTH, dims_train=DIMS_TRAIN, dims_test=DIMS_TEST,
                        dropout_rate=0.0, **options)


def _key(pos_strategy, variant):
    return (pos_strategy,) + tuple(sorted(VARIANTS[variant].items()))


@functools.lru_cache(maxsize=None)
def option_weights(key):
    """(JAX variables, the port's state dict) of the tiny GraphBins with the
    options ``key`` (a cache: one draw per option for the module)."""
    pos_strategy, options = key[0], dict(key[1:])
    model = init_weights_(_port_graphbins(pos_strategy=pos_strategy, **options),
                          torch.Generator().manual_seed(0))
    sd = _redraw_vectors(model.state_dict(), np.random.default_rng(0))
    variables = convert_state_dict({f"model.{k}": v for k, v in sd.items()}, "graphbins", ENC,
                                   pos_strategy=pos_strategy, **options)
    return variables, sd


def _objects(seed: int):
    """Image 0: five objects (an ordinary box, one past 40 samples a side,
    one over the image's right and bottom edges, one wholly outside it and
    one with a negative corner) and a padded slot holding 0.0001; image 1:
    the no-detection sentinel (xywh -1, valid) and padded slots at -1."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, N_SLOTS, 512)).astype(np.float32)
    xywh = np.array([
        [[40.0, 30.0, 20.0, 16.0], [48.0, 32.0, 1500.0, 1400.0], [90.0, 60.0, 30.0, 20.0],
         [300.0, 200.0, 10.0, 10.0], [2.0, 3.0, 9.0, 50.0], [0.0001] * 4],
        [[-1.0] * 4] * N_SLOTS,
    ], np.float32)
    xywh[0, :5, :2] += rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    valid = np.zeros((B, N_SLOTS), bool)
    valid[0, :5], valid[1, 0] = True, True
    return feats, xywh, valid


# ------------------------------------------------------------------ ops

def _roi_boxes(rng):
    """xyxy boxes on a 15x20 grid at scale 1/32 (object boxes): ordinary,
    past 40 samples a side (47 x 43), at and beyond the grid's far edges,
    collapsed to a point, the sentinel's (-1 clamped to 0), and random."""
    fixed = np.array([[10.0, 20.0, 200.0, 150.0], [0.0, 0.0, 1500.0, 1380.0],
                      [560.0, 420.0, 640.0, 480.0], [620.0, 470.0, 700.0, 560.0],
                      [900.0, 900.0, 950.0, 990.0], [33.0, 33.0, 33.0, 33.0],
                      [0.0, 0.0, 0.0, 0.0], [639.9, 479.9, 640.0, 480.0]], np.float32)
    x1 = rng.uniform(-50, 650, 24)
    y1 = rng.uniform(-50, 490, 24)
    rand = np.stack([x1, y1, x1 + rng.uniform(0, 400, 24), y1 + rng.uniform(0, 300, 24)], -1)
    return np.concatenate([fixed, np.maximum(rand, 0.0).astype(np.float32)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ps_roi_align_matches_jax(dtype):
    """Object boxes (scale 1/32, 40 samples at most) and patch boxes (scale
    1/16, 2 at most) on a 15x20 grid, against JAX's lattice gather: atol
    1e-6 in fp32 and in bf16 (the same bf16 grid values, fp32 weights and
    sums, the count rounded to bf16 on both sides: 47 x 43 = 2021 reads
    2016), relative to the grid's largest value."""
    rng = np.random.default_rng(0)
    grid = rng.uniform(0, 1, (15, 20, 8)).astype(np.float32)
    boxes = _roi_boxes(rng)
    cells = np.stack(np.meshgrid(np.arange(20) * 16.0, np.arange(15) * 16.0), -1).reshape(-1, 2)
    patch_boxes = np.concatenate([cells, cells + 16.0], -1).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for b, scale, max_samples in ((boxes, 1 / 32, 40), (patch_boxes, 1 / 16, 2)):
        got = ps_roi_align_1x1(torch.from_numpy(grid).to(tdt), torch.from_numpy(b), scale,
                               max_samples)
        want = jax.jit(jax_ps_roi_align_1x1, static_argnums=(2, 3))(
            jnp.asarray(grid, jdt), jnp.asarray(b), scale, max_samples)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the batched form is the per-image form
    two = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()]))
    batched = ps_roi_align_1x1(torch.from_numpy(grid), two, 1 / 32)
    for i in range(2):
        torch.testing.assert_close(batched[i], ps_roi_align_1x1(torch.from_numpy(grid), two[i],
                                                                1 / 32), rtol=0, atol=0)


def test_grid_sample_matches_jax():
    """Points inside, on the edges (+-1), just outside, and far outside (the
    "img" mode's raw patch coordinates, which read 0) of a 15x20 grid, in
    fp32 and from a bf16 grid: atol 1e-6."""
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((15, 20, 8)).astype(np.float32)
    pts = np.concatenate([
        rng.uniform(-1.2, 1.2, (40, 2)),
        [[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [-1.05, 0.3], [0.2, 1.06]],
        np.stack([np.arange(8.0, 320.0, 16.0)] * 2, -1),
    ]).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        got = grid_sample_bilinear(torch.from_numpy(grid).to(getattr(torch, dt)),
                                   torch.from_numpy(pts))
        want = jax.jit(jax_grid_sample_bilinear)(jnp.asarray(grid, getattr(jnp, dt)),
                                                 jnp.asarray(pts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-6)
    assert not got[-20:].any()  # far out of range: zeros


@pytest.mark.parametrize("dims", [((416, 544), (480, 640), 1200), ((352, 704), (376, 1241), 1872)],
                         ids=["nyu", "kitti"])
def test_grid_table_rows_match_jax(dims):
    """The table has one row per patch of the larger FULL-resolution size,
    as JAX's: 1200 for NYU, 1872 for KITTI."""
    train, test, rows = dims
    port = GridRandomPositionalEmbeddings(128, 16, "roi_align", train, test)
    want = JaxGridPos(128, 16, "roi_align", train, test)._sequence_length()
    assert port.positional_encodings.shape == (rows, 128) and want == rows


# ------------------------------------------------------- ObjCAViT forward

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("pos_strategy", POS_STRATEGIES)
def test_objcavit_forward_matches_jax(pos_strategy, variant):
    """ObjCAViT of each option in fp32 on 32x48 features with five objects,
    a padded slot and the sentinel: bin widths, feat and queries within JAX's
    existing tolerance (rtol 1e-4, atol 1e-5). The option's variables have
    the tree of JAX's own init, and carried to the port by
    ``state_dict_from_variables`` they are the port's state dict."""
    options = VARIANTS[variant]
    variables, sd = option_weights(_key(pos_strategy, variant))
    back = state_dict_from_variables(variables, ENC, pos_strategy, **options)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)

    jmodel = JaxObjCAViT(n_query_channels=N_QUERIES, dim_out=N_BINS, pos_strategy=pos_strategy,
                         dims_train=DIMS_TRAIN, dims_test=DIMS_TEST, **options)
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((B, H // 2, W // 2, 128)).astype(np.float32)
    objects = _objects(4)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), feat, *objects)["params"]
    params = variables["params"]["objcavit"]
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, params)

    port = _port_graphbins(pos_strategy=pos_strategy, **options)
    port.load_state_dict({k: _t(v) for k, v in back.items()})
    with torch.no_grad():
        got = port.objcavit.eval()(_t(feat), *(_t(a) for a in objects))
    want = jmodel.apply({"params": params}, feat, *objects)
    for name, g, w in zip(("widths", "feat", "queries"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------------------ one train step

TRAIN_CASES = {"grid_random_roi_align+no_obj_sa": ("grid_random_roi_align", "no_obj_sa"),
               "learned+use_2_saca": ("learned", "use_2_saca")}
LOSSES = (["silog", "bins_chamfer"], [1.0, 0.1])


def _train_batch(seed: int):
    rng = np.random.default_rng(seed)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    gt = rng.uniform(0.0005, 9.5, (B, H, W, 1)).astype(np.float32)
    feats, xywh, valid = _objects(seed)
    return {"image": img, "depth": gt}, {"features": feats, "xywh": xywh, "valid": valid}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_loss_and_gradients_match_jax(case):
    """One fp32 train-mode loss (dropout 0, no augmentation) and its
    gradients, as tests/test_torch_train.py holds the default: the loss rel
    1e-5; each parameter's gradient ||got - want|| <= 1e-2 ||want|| + 5e-7
    of the global gradient norm (that test's 5e-8 at its clipped norm of
    0.1: the conv biases before a train-mode BN have a zero gradient in
    exact arithmetic and rounding noise on both sides), the median rel
    error <= 2e-3. The cross-attention output nothing reads
    (the last SACA's object branch) has no gradient in the port and a zero
    one in JAX; under use_2_saca the first SACA's object branch feeds the
    second and has one."""
    pos_strategy, variant = TRAIN_CASES[case]
    options = VARIANTS[variant]
    variables, _ = option_weights(_key(pos_strategy, variant))
    batch, objects = _train_batch(5)

    jmodel = _jax_graphbins(pos_strategy=pos_strategy, **options)
    loss_fn = jax_make_train_loss_fn(jmodel, JaxLossWrapper(*LOSSES), MIN_DEPTH,
                                     augment_on_device=False, is_graphbins=True)

    def jax_loss(params):
        return loss_fn(params, variables["batch_stats"], batch, objects, jax.random.PRNGKey(0))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(variables["params"])
    want_grads = state_dict_from_variables({"params": jax.tree.map(np.asarray, want_grads)}, ENC,
                                           pos_strategy, **options)

    model = _port_graphbins(pos_strategy=pos_strategy, dropout_rate=0.0, **options)
    model.load_state_dict({k: _t(v) for k, v in state_dict_from_variables(
        variables, ENC, pos_strategy, **options).items()})
    port_loss_fn = make_train_loss_fn(model, LossWrapper(*LOSSES), MIN_DEPTH,
                                      augment_on_device=False)
    loss = port_loss_fn({k: _t(v) for k, v in batch.items()},
                        {k: _t(v) for k, v in objects.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))

    last = "saca_2" if options.get("use_2_saca") else "saca_1"
    unread = f"objcavit.{last}.cross_attn_im_obj."
    atol = 5e-7 * np.sqrt(sum(np.sum(np.square(g)) for g in want_grads.values()))
    rels = {}
    for name, p in model.named_parameters():
        w = want_grads[name]
        if name.startswith(unread):
            assert p.grad is None and not np.any(w), name
            continue
        assert p.grad is not None, name
        err, ref = np.linalg.norm(p.grad.numpy() - w), np.linalg.norm(w)
        assert err <= 1e-2 * ref + atol, (name, err, ref)
        if ref > 0:
            rels[name] = err / ref
    assert np.median(list(rels.values())) <= 2e-3


# ----------------------------------------------------------- checkpoints

def _jax_config(pos_strategy, **options):
    return JaxConfig({"model": {"name": "graphbins"}, "graphbins": {
        "encoder_name": ENC, "objcavit": {"positional_embedding_strategy": pos_strategy,
                                          **options}}})


def test_no_obj_sa_grid_roi_align_ckpt_loads_as_jax_loads_it(tmp_path, caplog):
    """A reference-layout .ckpt of a no_obj_sa + grid_random_roi_align
    GraphBins, written from JAX variables, with the object transformer's
    entries a reference checkpoint may still hold: JAX's import reads none
    of them, and the port skips them with a warning. Both land the same
    weights, bit for bit. Without the grid table the port's load raises."""
    pos_strategy, options = "grid_random_roi_align", {"no_obj_sa": True}
    variables, _ = option_weights(_key(pos_strategy, "no_obj_sa"))
    sd = {f"model.{k}": _t(v) for k, v in state_dict_from_variables(
        variables, ENC, pos_strategy, **options).items()}
    extra = {f"model.{k}": v for k, v in _port_graphbins().state_dict().items()
             if ".obj_transformer_encoder." in k}
    assert extra
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {**sd, **extra}, "epoch": 1}, path)

    model = _port_graphbins(pos_strategy=pos_strategy, **options)
    with caplog.at_level(logging.WARNING):
        load_torch_checkpoint(path, model)
    assert f"{len(extra)} entries the model does not have were skipped" in caplog.text
    want = state_dict_from_variables(
        jax_load_torch_checkpoint(path, _jax_config(pos_strategy, **options)), ENC,
        pos_strategy, **options)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    table = "model.objcavit.positional_encoder.positional_encodings"
    torch.save({"state_dict": {k: v for k, v in sd.items() if k != table}}, path)
    with pytest.raises(KeyError, match="missing"):
        load_torch_checkpoint(path, _port_graphbins(pos_strategy=pos_strategy, **options))


# ----------------------------------------------- build_model, every file

PARAMS_FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "params", "*.yaml")))
# the one params file neither package parses (a stray line at 76)
UNPARSEABLE = "kitti_graphbins_enet-b5_ocv_pos_grid_random_emb_128_lang_none_control_obj_zeros_512_old_dl_1.yaml"
# the one params file with do_final_upscale (AdaBins-B5)
FINAL_UPSCALE = "nyu_efficientnet-b5_final_upscale_1.yaml"


@pytest.mark.parametrize("name", PARAMS_FILES)
def test_build_model_on_every_params_file(name):
    """build_model on each params file, built on the meta device at its
    real widths: every parseable file builds (the five with a V2 encoder
    among them, and the one with do_final_upscale, whose decoder has its
    fifth stage and whose miniViT a 1200-row table, as JAX's). Each is JAX's
    build_model's class with its bins, encoder and do_final_upscale;
    a GraphBins has the options JAX's build_model gives its module (and a
    grid table of one row per patch of the larger full-resolution size)."""
    path = os.path.join(REPO, "params", name)
    if name == UNPARSEABLE:
        with pytest.raises(yaml.YAMLError):
            load_args(path)
        return
    args, jargs = load_args(path), jax_load_args(path)
    dataset = args.basic.dataset
    if "dimensions_train" not in args[dataset]:
        # a file without the sizes trains on basicParams.yaml's dataset
        # section, as both CLIs give it (check_and_validate_args)
        basic = os.path.join(REPO, "params", "basicParams.yaml")
        args[dataset], jargs[dataset] = load_args(basic)[dataset], jax_load_args(basic)[dataset]
    with torch.device("meta"):
        model = build_model(args)
    jmodel = jax_build_model(jargs)
    assert type(model).__name__ == type(jmodel).__name__
    assert model.conv_out[0].out_channels == jmodel.n_bins
    assert model.do_final_upscale == jmodel.do_final_upscale == (name == FINAL_UPSCALE)
    if model.do_final_upscale:
        head = model.dense_feature_extractor.decoder.conv2.in_channels
        stage = model.dense_feature_extractor.decoder.final_upscale._net[0]
        assert (stage.in_channels, stage.out_channels) == (head // 16 + 3, head // 16)
        table = model.adaptive_bins_layer.patch_transformer.positional_encodings
        assert tuple(table.shape) == (1200, 128)
    spec = JAX_ENCODER_SPECS[jmodel.encoder_name]
    assert model.dense_feature_extractor.encoder["original_model"].pad_style == spec.pad_style
    # the port keeps the head's BN and SiLU where pad_style is "torch"
    assert spec.head_bn_act == (spec.pad_style == "torch")
    assert model.dense_feature_extractor.decoder.conv2.in_channels == spec.head_channels
    if args.model.name != "graphbins":
        return
    objcavit = model.objcavit
    assert objcavit.pos_strategy == jmodel.pos_strategy
    assert objcavit.saca_1.no_obj_sa == jmodel.no_obj_sa
    assert objcavit.use_2_saca == jmodel.use_2_saca == hasattr(objcavit, "saca_2")
    if jmodel.pos_strategy.startswith("grid_random"):
        rows = max(math.ceil(h / 16) * math.ceil(w / 16)
                   for h, w in (jmodel.dims_train, jmodel.dims_test))
        assert objcavit.positional_encoder.positional_encodings.shape[0] == rows


@pytest.mark.parametrize("encoder_name", ["efficientnet-v2-s", "efficientnet-v2-m"])
def test_v2_full_width_keys_are_the_keys_jax_reads(encoder_name):
    """The port's V2-S and V2-M encoders at full width, on the meta device:
    their state-dict keys (less BN's ``num_batches_tracked``, which JAX has
    no counterpart of) are exactly the keys JAX's
    ``_convert_efficientnet_v2`` reads, and what it makes of them at their
    shapes is the tree of JAX's own init (``jax.eval_shape``)."""
    with torch.device("meta"):
        enc = EfficientNetEncoder(encoder_name)
    shapes = {f"enc.{k}": tuple(v.shape) for k, v in enc.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    read = set()

    class Reading(dict):
        def __getitem__(self, key):
            read.add(key)
            return np.zeros(shapes[key], np.float32)

    tb = TreeBuilder()
    _convert_efficientnet_v2(tb, Reading(), "enc", "encoder", encoder_name)
    assert read == set(shapes)
    want = jax.eval_shape(JaxEncoder(encoder_name).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))
    got = {"params": tb.params["encoder"], "batch_stats": tb.batch_stats["encoder"]}
    assert jax.tree.map(lambda a: a.shape, want) == jax.tree.map(np.shape, got)


@pytest.mark.parametrize("missing", ["dimensions_train", "dimensions_test"])
def test_build_model_without_a_dataset_size_raises_as_jax(missing):
    """A GraphBins config without the dataset's train or test size fails in
    both packages, rather than sizing grid_random's table from another
    dataset's defaults."""
    tree = {
        "basic": {"dataset": "kitti"}, "model": {"name": "graphbins"},
        "kitti": {"min_depth": 0.001, "max_depth": 80.0, "dimensions_train": [352, 704],
                  "dimensions_test": [376, 1241]},
        "graphbins": {"n_bins": N_BINS, "encoder_name": ENC, "objcavit": {
            "embedding_dim": 128, "positional_embedding_strategy": "grid_random_roi_align"}},
    }
    del tree["kitti"][missing]
    with pytest.raises(AttributeError, match=missing):
        jax_build_model(JaxConfig(tree))
    with torch.device("meta"), pytest.raises(AttributeError, match=missing):
        build_model(Config(tree))


# ------------------------------------------------------- entry points

OPTION_FILES = {
    "learned": "nyu_graphbins_enet-b5_ocv_pos_learned_emb_128_old_dl_1.yaml",
    "grid_random": "nyu_graphbins_enet-b5_ocv_pos_grid_random_emb_128_old_dl_1.yaml",
    "grid_random_roi_align":
        "nyu_graphbins_enet-b5_ocv_pos_grid_random_roi_align_emb_128_old_dl_1.yaml",
    "no_obj_sa": "nyu_graphbins_enet-b5_ocv_pos_learned_emb_128_no_obj_sa_old_dl_1.yaml",
    "use_2_saca": "nyu_graphbins_enet-b5_ocv_pos_learned_bbox_wh_emb_128_lang_name_synset_def_wn"
                  "_rel_sz_clip_use_2_saca_1.yaml",
}


def _tiny_copy(tmp_path, name: str) -> str:
    """The params file ``name`` at tiny size: efficientnet-tiny, 16 bins,
    64x96, the zeros language strategy, the synthetic NYU split, a run dir
    under tmp_path; ObjCAViT's options as the file sets them."""
    with open(os.path.join(REPO, "params", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["graphbins"].update(encoder_name=ENC, n_bins=N_BINS)
    cfg["graphbins"]["objcavit"]["language_embedding_strategy"] = "control_obj_zeros_512"
    cfg["nyu"].update(dimensions_train=[H, W], dimensions_test=[H, W], eigen_crop=False)
    cfg["basic"].update(batch_size=2, name="tiny")
    cfg["paths"] = {"data_dir": str(tmp_path / "no_data"), "run_dir": str(tmp_path / "runs")}
    cfg["hardware"] = {"num_workers": 0}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("option", list(OPTION_FILES))
def test_params_file_of_each_option_trains_and_validates_through_the_cli(tmp_path, option):
    """A copy of each option's params file (tiny size) through ``cli.main``
    on the CPU: a --debug fit (one step, one validation batch) writes its
    run and checkpoints with the option's weights, then -v --debug restores
    that run's last.ckpt and writes validation_output.txt with 32 finite
    numbers."""
    cfg = _tiny_copy(tmp_path, OPTION_FILES[option])
    model, _ = cli.main(["-c", cfg, "--debug"], basic_params_path=None, device="cpu")
    args = load_args(cfg)
    ocfg = args.graphbins.objcavit
    assert model.objcavit.pos_strategy == ocfg.positional_embedding_strategy
    assert model.objcavit.saca_1.no_obj_sa == bool(ocfg.get("no_obj_sa"))
    assert model.objcavit.use_2_saca == bool(ocfg.get("use_2_saca"))
    run = tmp_path / "runs" / "tiny" / "version_0"
    assert (run / "checkpoints" / "last.ckpt").exists()
    metrics = cli.main(["-c", str(run / "hparams.yaml"), "-v", "--debug"], basic_params_path=None,
                       device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    numbers = re.findall(r"-?\d+\.\d+(?:e-?\d+)?", (run / "validation_output.txt").read_text())
    assert len(numbers) == 32 and all(np.isfinite(float(x)) for x in numbers)


@pytest.mark.parametrize("option", [{"pos_strategy": s} for s in POS_STRATEGIES[:3]]
                         + [{"no_obj_sa": True}, {"use_2_saca": True}],
                         ids=["learned", "grid_random", "grid_random_roi_align", "no_obj_sa",
                              "use_2_saca"])
def test_depth_pipeline_serves_each_option_on_the_cpu(option):
    """``build_flagship_model`` with each option (tiny encoder, bf16, BN
    folded) behind ``DepthPipeline``: uint8 frames in, finite depth in range
    out, on the sentinel route and with detections."""
    model = build_flagship_model(dtype=torch.bfloat16, device="cpu", encoder_name=ENC,
                                 n_bins=N_BINS, n_queries=N_QUERIES, **option)
    frames = np.random.default_rng(6).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    feats, xywh, valid = _objects(7)

    def provider(_normed):
        return {"features": feats, "xywh": xywh, "valid": valid}

    for pipe in (DepthPipeline(model, eval_dims=(H, W), n_obj_max=N_SLOTS),
                 DepthPipeline(model, eval_dims=(H, W), provider=provider)):
        depth = pipe(frames)
        assert depth.shape == (B, H // 2, W // 2, 1) and torch.isfinite(depth).all()
        assert float(depth.min()) >= MIN_DEPTH and float(depth.max()) <= MAX_DEPTH * (1 + 2**-8)
