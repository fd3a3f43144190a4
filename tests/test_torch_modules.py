"""objcavit_torch modules against their objcavit_tpu counterparts, on the CPU.

Weights come from the JAX package's own ``init`` (kernels) with every bias,
norm scale and BN statistic redrawn from a seeded numpy RNG, so transposed
or misplaced vectors cannot hide behind zeros and ones. They reach the port
through ``objcavit_torch.utils.convert.state_dict_from_variables``. Inputs
are numpy arrays from a seeded RNG handed to both sides. The JAX side runs
under ``jax.jit``: one compile of the whole module is faster here than
op-by-op dispatch.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.models import GraphBins as JaxGraphBins
from objcavit_tpu.models.decoder import DenseFeatureExtractor as JaxDFE
from objcavit_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from objcavit_tpu.models.objcavit import SelfAttnCrossAttn as JaxSACA
from objcavit_tpu.ops.attention import mha_core as jax_mha_core
from objcavit_tpu.ops.bins import bin_edges_centers as jax_bin_edges_centers
from objcavit_tpu.utils.torch_import import convert_state_dict

from objcavit_torch.models.common import Conv2dSame
from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.models.objcavit import SelfAttnCrossAttn
from objcavit_torch.ops.attention import mha_core
from objcavit_torch.ops.bins import bin_edges_centers
from objcavit_torch.utils.convert import state_dict_from_variables
from objcavit_torch.utils.fold_bn import fold_batchnorm

ENC = "efficientnet-tiny"
N_BINS = 32
H, W = 384, 352  # dense 192x176 -> 12x11 = 132 tokens >= 129


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _redraw_vectors(variables, rng: np.random.Generator):
    """Numpy values for every 1-D leaf: biases, norm scales, BN statistics."""

    def visit(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "keys"):
                out[k] = visit(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if v.ndim == 1:
                n = v.shape
                if k == "scale":
                    v = 1.0 + 0.2 * rng.standard_normal(n)
                elif k == "mean":
                    v = 0.2 * rng.standard_normal(n)
                elif k == "var":
                    v = 0.5 + rng.random(n)
                else:  # biases
                    v = 0.1 * rng.standard_normal(n)
            out[k] = np.asarray(v, np.float32)
        return out

    return {name: visit(tree) for name, tree in variables.items()}


def jax_graphbins(dtype=jnp.float32, fold_bn=False, encoder_name=ENC, n_bins=N_BINS):
    return JaxGraphBins(
        encoder_name=encoder_name, n_bins=n_bins, min_depth=0.001, max_depth=10.0,
        pos_strategy="learned_bbox_wh", dims_train=(H, W), dims_test=(H, W),
        dtype=dtype, fold_bn=fold_bn,
    )


@functools.lru_cache(maxsize=None)
def graphbins_variables(seed: int = 0, n_bins: int = N_BINS):
    """Unfolded JAX variables of the tiny GraphBins as numpy trees."""
    model = jax_graphbins(n_bins=n_bins)
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    feats = jnp.zeros((1, 4, 512), jnp.float32)
    xywh = jnp.full((1, 4, 4), -1.0, jnp.float32)
    valid = jnp.zeros((1, 4), bool).at[:, 0].set(True)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), img, feats, xywh, valid)
    variables = _redraw_vectors(jax.tree.map(np.asarray, variables), np.random.default_rng(seed))
    # spread the bin logits over a few units, so depth varies across the
    # image (by ~1 m) instead of sitting at the middle of the range
    conv_out = variables["params"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(10.0)
    return variables


def port_state_dict(variables, prefix: str = "") -> dict:
    sd = state_dict_from_variables(variables, ENC)
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items() if k.startswith(prefix)}


def port_graphbins(variables) -> GraphBins:
    model = GraphBins(encoder_name=ENC, n_bins=N_BINS)
    model.load_state_dict(port_state_dict(variables))
    return model.eval()


def _sub(variables, *path):
    out = {}
    for col, tree in variables.items():
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[col] = tree
    return out


# ------------------------------------------------------------------- common


@pytest.mark.parametrize(
    "k,stride,hw", [(3, 1, (9, 12)), (3, 2, (10, 12)), (5, 2, (11, 14)), (5, 2, (16, 9))]
)
def test_conv2d_same_matches_tf_same_padding(k, stride, hw):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)  # HWIO
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    conv = Conv2dSame(6, 5, k, stride, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- encoder + decoder


def test_encoder_decoder_match_jax_tiny():
    """Every encoder level and the decoder output, TF-SAME at an odd size;
    the tolerance of tests/test_dfe_oracle.py."""
    variables = graphbins_variables()
    x = np.random.default_rng(1).standard_normal((2, 67, 83, 3)).astype(np.float32)

    port = DenseFeatureExtractor(ENC)
    port.load_state_dict(port_state_dict(variables, "dense_feature_extractor."))
    port.eval()
    with torch.no_grad():
        feats = port.encoder["original_model"](torch.from_numpy(x))
        out = port(torch.from_numpy(x))

    enc_vars = _sub(variables, "dense_feature_extractor", "encoder")
    want_feats = jax.jit(JaxEncoder(ENC).apply)(enc_vars, jnp.asarray(x))
    for i, (g, w) in enumerate(zip(feats, want_feats)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"encoder level {i}")
    dfe_vars = _sub(variables, "dense_feature_extractor")
    want = jax.jit(JaxDFE(ENC).apply)(dfe_vars, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_fold_batchnorm_matches_unfolded():
    """Folding every conv/BN pair (eps 1e-3 encoder, 1e-5 decoder, decoder
    convs biased) leaves no BN behind and changes the output only by fp32
    rounding (tolerance of tests/test_fold_bn.py)."""
    variables = graphbins_variables()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(np.float32))
    port = DenseFeatureExtractor(ENC)
    port.load_state_dict(port_state_dict(variables, "dense_feature_extractor."))
    port.eval()
    with torch.no_grad():
        ref = port(x)
        fold_batchnorm(port)
        out = port(x)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    np.testing.assert_allclose(_nhwc(out), _nhwc(ref), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_core_matches_jax(dtype):
    """fp32 scores and softmax, -inf key padding, weights cast to v's dtype.
    bf16: products of bf16 inputs are exact in fp32 on both sides; the
    bound is the bf16 rounding of the output (2^-8 relative) plus that of
    the weights before the V product, summed over 12 keys."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 5, 4, 8)).astype(np.float32) for _ in range(3))
    mask = np.zeros((2, 5), bool)
    mask[0, 3:] = True
    mask[1, 1] = True
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_mha_core(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask))
    got = mha_core(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(mask))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "counts,s,n_max",
    [
        ((3, 1), 12, 8),  # slots wider than the batch's largest count
        ((9, 4), 12, 9),  # n_b > S/2: pads and objects mix among the keys
        ((12, 5), 12, 12),  # slots fill the whole image sequence
    ],
    ids=["few-objects", "object-rich", "full-capacity"],
)
def test_self_attn_cross_attn_front_pad_quirk(counts, s, n_max):
    """The data-dependent front-pad with an end-extended mask and 0.0001 pad
    value, both outputs, at the tolerance of tests/test_objcavit_parity.py."""
    variables = graphbins_variables()
    saca_vars = _sub(variables, "objcavit", "saca_1")
    rng = np.random.default_rng(sum(counts) + s)
    b, e = len(counts), 128
    image_emb = rng.standard_normal((b, s, e)).astype(np.float32)
    obj_emb = np.full((b, n_max, e), 0.0001, np.float32)
    valid = np.zeros((b, n_max), bool)
    for i, c in enumerate(counts):
        obj_emb[i, :c] = rng.standard_normal((c, e))
        valid[i, :c] = True

    want_img, want_obj = jax.jit(JaxSACA(128, 4, 1024).apply)(
        saca_vars, jnp.asarray(image_emb), jnp.asarray(obj_emb), jnp.asarray(~valid)
    )
    port = SelfAttnCrossAttn(128, 4, 1024)
    port.load_state_dict(port_state_dict(variables, "objcavit.saca_1."))
    with torch.no_grad():
        got_img, got_obj = port.eval()(
            torch.from_numpy(image_emb), torch.from_numpy(obj_emb), torch.from_numpy(~valid)
        )
    np.testing.assert_allclose(_nhwc(got_img), np.asarray(want_img), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got_obj), np.asarray(want_obj), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------- bins, weights


def test_bin_edges_centers_match_jax():
    rng = np.random.default_rng(4)
    w = rng.random((3, 16)).astype(np.float32) + 0.1
    w /= w.sum(1, keepdims=True)
    want = jax_bin_edges_centers(jnp.asarray(w), 0.001, 10.0)
    got = bin_edges_centers(torch.from_numpy(w), 0.001, 10.0)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(ww), rtol=1e-6, atol=1e-6)


def test_state_dict_round_trips_through_convert_state_dict():
    """convert_state_dict(state_dict_from_variables(v)) == v leaf by leaf, and
    the port's own parameter names are exactly the converted keys."""
    variables = graphbins_variables()
    sd = state_dict_from_variables(variables, ENC)
    back = convert_state_dict(
        {f"model.{k}": v for k, v in sd.items()}, "graphbins", ENC,
        pos_strategy="learned_bbox_wh",
    )
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))

    port_sd = GraphBins(encoder_name=ENC, n_bins=N_BINS).state_dict()
    assert set(port_sd) == set(sd)
    for k, v in sd.items():
        assert tuple(port_sd[k].shape) == v.shape, k


@pytest.mark.parametrize(
    "kwargs", [{"pos_strategy": "grid_random"}, {"encoder_name": "efficientnet-v2-s"}]
)
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        GraphBins(**{"encoder_name": ENC, **kwargs})


def test_port_imports_no_jax():
    """Every objcavit_torch module (walked with pkgutil, the language modules,
    kernels 5, 7 and 8's and the eval protocol's among them) imports without
    jax, flax or objcavit_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import objcavit_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(objcavit_torch.__path__, 'objcavit_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'objcavit_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "want = {'objcavit_torch.language.embedding', 'objcavit_torch.language.provider',\n"
        "        'objcavit_torch.kernels.attention', 'objcavit_torch.models.adabins',\n"
        "        'objcavit_torch.kernels.mbconv', 'objcavit_torch.kernels.se_project',\n"
        "        'objcavit_torch.errors', 'objcavit_torch.config', 'objcavit_torch.cli',\n"
        "        'objcavit_torch.metrics', 'objcavit_torch.metrics.metrics',\n"
        "        'objcavit_torch.data.preprocess', 'objcavit_torch.data.dataset',\n"
        "        'objcavit_torch.data.loader', 'objcavit_torch.training.steps',\n"
        "        'objcavit_torch.training.providers', 'objcavit_torch.training.checkpoint',\n"
        "        'objcavit_torch.training.loop', 'objcavit_torch.utils.torch_import',\n"
        "        'objcavit_torch.utils.annotate', 'objcavit_torch.utils.figures'}\n"
        "assert want <= set(names), want - set(names)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
