"""The port's detection path against the JAX package's, on the CPU: kernel 6's
plain version, the YOLOv7-seg detector (dense, class-max and sparse heads,
proto, folded), the decoders, NMS, the CLIP text tower, the class table,
the host-side detector, the provider and the mask assembly.

One JAX detector (nc = 4, full width, 64x96) is initialised per file. Its
random init shrinks the activations to ~1e-5 by the detect heads, so the
fixture redraws every BN affine (around ``benchkit.DETECTOR_BN_AFFINE``)
and the detect biases from a seeded numpy RNG, and sets the BN statistics
from the port's BN inputs in one eval-mode forward of uniform frames
(``utils/benchkit.py::calibrate_batchnorm_``): both sides then see logits
of order 1. Inputs are numpy arrays from seeded RNGs.
The Pallas kernel runs in interpret mode, as the JAX package's own tests
run it.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.language.embedding import ClipEmbedder as JaxClipEmbedder
from objcavit_tpu.language.embedding import build_class_table as jax_build_class_table
from objcavit_tpu.language.provider import YoloClipObjectProvider as JaxProvider
from objcavit_tpu.language.strategy import ObjectLanguageStrategy
from objcavit_tpu.language.tokenizer import HashTokenizer
from objcavit_tpu.models import yolov7 as jyolo
from objcavit_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from objcavit_tpu.ops import nms as jnms
from objcavit_tpu.ops.detect_head_pallas import fused_detect_head, fused_detect_head_reference
from objcavit_tpu.ops.masks import process_masks as jax_process_masks
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm

from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.language.embedding import ClipEmbedder, build_class_table
from objcavit_torch.language.provider import YoloClipObjectProvider
from objcavit_torch.models import yolov7
from objcavit_torch.models.clip_text import CLIPTextEncoder
from objcavit_torch.ops import nms
from objcavit_torch.ops.masks import process_masks
from objcavit_torch.utils.benchkit import calibrate_batchnorm_
from objcavit_torch.utils.convert import (
    clip_text_state_dict_from_params,
    yolov7_state_dict_from_variables,
)
from objcavit_torch.utils.fold_bn import fold_batchnorm

NC = 4
DET_HW = (64, 96)  # 3 x (8x12 + 4x6 + 2x3) = 378 anchors
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits: one ulp <= 2^-7 relative


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _put_stats(stats: dict, sd: dict) -> None:
    """Write the port's BN running statistics into a JAX batch_stats tree."""
    for key, value in sd.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        *path, leaf = key.split(".")
        tree = stats
        for p in path:
            tree = tree[p]
        tree["mean" if leaf == "running_mean" else "var"] = value.numpy().astype(np.float32)


@functools.lru_cache(maxsize=None)
def detector_variables(seed: int = 1):
    """Unfolded JAX Yolov7Seg variables (numpy trees) with redrawn BN affines
    and detect biases and calibrated BN statistics (see the module note)."""
    model = jyolo.Yolov7Seg(num_classes=NC)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *DET_HW, 3)))
    variables = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    rng = np.random.default_rng(seed)

    def redraw(tree):
        # BN affines around benchkit.DETECTOR_BN_AFFINE (SiLU's near-linear
        # range, where the random network is not chaotic); detect biases ~0.1
        is_bn = "scale" in tree
        for k, v in tree.items():
            if hasattr(v, "keys"):
                redraw(v)
            elif k == "scale":
                tree[k] = (0.5 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "bias":
                tree[k] = (float(is_bn) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    redraw(variables["params"])
    port = yolov7.Yolov7Seg(num_classes=NC)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in yolov7_state_dict_from_variables(variables).items()})
    # 32 frames: at P5 (2x3 cells) fewer samples leave near-constant
    # channels whose tiny variance amplifies any other input ~30x
    frames = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (32, *DET_HW, 3))
                              .astype(np.float32))
    calibrate_batchnorm_(port, frames)
    _put_stats(variables["batch_stats"], port.state_dict())
    return variables


def port_detector(variables, fold: bool = False) -> yolov7.Yolov7Seg:
    model = yolov7.Yolov7Seg(num_classes=NC)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in yolov7_state_dict_from_variables(variables).items()})
    model.eval()
    return fold_batchnorm(model) if fold else model


def _frames(seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, *DET_HW, 3)).astype(np.float32)


# ------------------------------------------------------------ kernel 6


def _head_case(rng, b, s, cin, nc, nm):
    no = 5 + nc + nm
    flat = (0.3 * rng.standard_normal((b, s, cin))).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((cin, 3 * no))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * no)).astype(np.float32)
    return flat, kernel, bias


def _port_head(flat, kernel, bias, nc, nm, dtype=torch.float32):
    packed = kdetect.pack_detect_head(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
                                      nc, nm, dtype)
    return kdetect.fused_detect_head(torch.from_numpy(flat).to(dtype), packed)


@pytest.mark.parametrize("s,cin,nc,nm", [(256, 128, 200, 8), (300, 256, 1203, 32), (100, 64, 130, 4)],
                         ids=["tile", "lvis-width", "ragged-s-and-nc"])
def test_detect_head_plain_matches_pallas_and_reference(s, cin, nc, nm):
    """fp32: same math up to accumulation order, the tolerance of
    tests/test_detect_head_pallas.py; S not a multiple of the 256 tile and
    nc not a multiple of 128 in the last case (pad rows dropped, pad classes
    never win)."""
    flat, kernel, bias = _head_case(np.random.default_rng(s + nc), 2, s, cin, nc, nm)
    got = _port_head(flat, kernel, bias, nc, nm)
    assert [tuple(t.shape) for t in got] == [(2, s, 3, 5), (2, s, 3, nm), (2, s, 3), (2, s, 3)]
    assert got[3].dtype == torch.int32 and int(got[3].max()) < nc
    args = (jnp.asarray(flat), jnp.asarray(kernel), jnp.asarray(bias), nc, nm)
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_detect_head(*args)
    for want in (pallas, fused_detect_head_reference(*args)):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)
        # random continuous weights: no two logits of a row are fp-equal
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_detect_head_plain_breaks_ties_first():
    """Classes 3 and 200 share their weights, so their logits are equal and
    the winning one is positive: the argmax must be the first, 3."""
    cin, nc, nm = 16, 260, 2
    no = 5 + nc + nm
    rng = np.random.default_rng(41)
    kernel = np.zeros((cin, 3 * no), np.float32)
    col = rng.standard_normal(cin).astype(np.float32)
    for a in range(3):
        kernel[:, a * no + 5 + 3] = col
        kernel[:, a * no + 5 + 200] = col
    flat = ((np.abs(rng.standard_normal((1, 8, cin))) + 0.5) * np.sign(col)).astype(np.float32)
    bias = np.zeros(3 * no, np.float32)
    _, _, cmax, carg = _port_head(flat, kernel, bias, nc, nm)
    with pltpu.force_tpu_interpret_mode():
        _, _, _, want = fused_detect_head(jnp.asarray(flat), jnp.asarray(kernel),
                                          jnp.asarray(bias), nc, nm)
    assert (cmax > 0).all() and (carg == 3).all()
    np.testing.assert_array_equal(carg.numpy(), np.asarray(want))


def test_detect_head_plain_bf16_matches_pallas():
    """bf16 features and weights: both take fp32 products of the bf16 values
    plus the fp32 bias and round once, so y5, coef and the max agree to one
    bf16 ulp (the sums run in another order); the argmax agrees wherever a
    row's two largest rounded logits differ, and where they are equal the
    port's index holds the max too."""
    nc, nm = 1203, 32
    flat, kernel, bias = _head_case(np.random.default_rng(7), 2, 120, 256, nc, nm)
    flat_bf = torch.from_numpy(flat).bfloat16()
    packed = kdetect.pack_detect_head(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
                                      nc, nm, torch.bfloat16)
    got = kdetect.fused_detect_head(flat_bf, packed)
    with pltpu.force_tpu_interpret_mode():
        want = fused_detect_head(jnp.asarray(flat_bf.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(kernel), jnp.asarray(bias), nc, nm)
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w, np.float32)
        assert np.all(np.abs(_np(g) - w) <= BF16_ULP * np.abs(w) + 1e-6)
    logits = kdetect.class_logits_plain(flat_bf, packed).numpy()
    arg, want_arg = got[3].numpy(), np.asarray(want[3])
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] > top2[..., 0]
    np.testing.assert_array_equal(arg[clear], want_arg[clear])
    at = np.take_along_axis(logits, arg[..., None].astype(np.int64), -1)[..., 0]
    np.testing.assert_array_equal(at, top2[..., 1])


def test_detect_head_wrapper_on_cpu_counts_nothing_and_refuses_autograd():
    nc, nm = 10, 4
    flat, kernel, bias = _head_case(np.random.default_rng(3), 1, 5, 64, nc, nm)
    packed = kdetect.pack_detect_head(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
                                      nc, nm, torch.float32)
    before = kdetect.fused_detect_head.launches
    kdetect.fused_detect_head(torch.from_numpy(flat), packed)
    assert kdetect.fused_detect_head.launches == before
    assert packed.wcls.shape == (3, 128, 64) and packed.bcls[0, nc:].max() == kdetect.PAD_BIAS
    with pytest.raises(RuntimeError, match="forward-only"):
        kdetect.fused_detect_head(torch.from_numpy(flat).requires_grad_(), packed)
    with pytest.raises(ValueError, match="nm"):
        kdetect.pack_detect_head(torch.zeros(3 * (5 + nc + 40), 64), torch.zeros(3 * (5 + nc + 40)),
                                 nc, 40, torch.float32)


def test_class_keys_max_decodes_to_the_first_argmax():
    """The kernel merges each anchor's (max, index) over blocks by the max of
    a 64-bit key; the twin of its encoding in kernels/detect_head.py must
    order keys so that their max decodes to torch's amax and first argmax:
    negative rows, -0.0 against +0.0, infinities and exact ties."""
    rng = np.random.default_rng(11)
    vals = np.round(rng.standard_normal((40, 300)) * 4) / 4  # many exact ties
    vals[0] = -np.abs(vals[0]) - 1.0  # every value negative
    vals[1] = -3.0
    vals[1, [9, 2, 200]] = [0.0, -0.0, 0.0]  # -0.0 first: it ties with +0.0
    vals[2] = -7.5  # the whole row one tie
    vals[3, [4, 250]] = np.inf
    vals[4] = -np.inf
    vals[4, 299] = -1e30  # the pad classes' bias
    vals[5, [17, 18]] = [np.float32(2.0 ** -126), 2.0 ** -149]  # smallest normal, subnormal
    v = torch.from_numpy(vals.astype(np.float32))
    idx = torch.arange(v.shape[1], dtype=torch.int32).expand_as(v)
    keys = kdetect.encode_class_key(v, idx)
    got_max, got_arg = kdetect.decode_class_key(keys.amax(-1))
    assert torch.equal(got_max, v.amax(-1)) and torch.equal(got_arg.long(), v.argmax(-1))
    assert got_arg[1] == 2 and got_arg[2] == 0 and got_arg[3] == 4
    # a row split over blocks: the max of the parts' keys is the whole row's
    parts = []
    for lo in (0, 128, 256):
        part = v[:, lo:lo + 128]
        parts.append(kdetect.encode_class_key(part.amax(-1), part.argmax(-1) + lo))
    merged_max, merged_arg = kdetect.decode_class_key(torch.stack(parts, -1).amax(-1))
    assert torch.equal(merged_max, got_max) and torch.equal(merged_arg, got_arg)
    # round trip; -0.0 comes back as +0.0
    back, back_idx = kdetect.decode_class_key(keys)
    assert torch.equal(back, v) and torch.equal(back_idx, idx)
    assert not torch.signbit(back[1, 2])


# ------------------------------------------------------------ detector


def test_detector_state_dict_names_match_the_jax_tree():
    """The converted keys are the port's own, shape for shape, unfolded and
    folded (merged RepConvs, biased convs)."""
    variables = detector_variables()
    sd = yolov7_state_dict_from_variables(variables)
    port_sd = yolov7.Yolov7Seg(num_classes=NC).state_dict()
    assert set(sd) == set(port_sd)
    for k, v in sd.items():
        assert tuple(port_sd[k].shape) == v.shape, k
    folded = yolov7_state_dict_from_variables(jax_fold_batchnorm(variables))
    port_folded = port_detector(variables, fold=True).state_dict()
    assert set(folded) == set(port_folded)
    assert "body.rep3.merged_conv.weight" in folded and "body.s0.conv.bias" in folded


@functools.lru_cache(maxsize=None)
def _jax_forward(mode: str, fold: bool = False):
    variables = detector_variables()
    model = jyolo.Yolov7Seg(num_classes=NC, fold_bn=fold)
    v = jax_fold_batchnorm(variables) if fold else variables
    kw = {"class_max": True} if mode == "class_max" else (
        {"topk_positions": 20} if mode == "sparse" else {})
    return jax.jit(lambda v, x: model.apply(v, x, train=False, **kw))(v, jnp.asarray(_frames(5)))


def _close(got, want, tol=2e-5):
    """fp32 through ~100 conv layers in two frameworks, whose accumulation
    orders differ at every layer: measured up to 2.6e-6 of the tensor's
    largest magnitude (logits of order 1-10), so the bound is 2e-5 of it,
    elementwise. A wrong layer, concat order or layout moves values by the
    order of the values themselves."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_detector_dense_head_and_proto_match_jax(fold):
    """The dense head at every level and the prototypes; folded, the port's
    folded BNs and merged RepConvs against JAX's (whose stem takes the
    space-to-depth rewrite, the same math)."""
    preds, proto = _jax_forward("dense", fold)
    model = port_detector(detector_variables(), fold=fold)
    with torch.no_grad():
        got, got_proto = model(torch.from_numpy(_frames(5)))
    assert len(got) == 3
    for g, w in zip(got, preds):
        assert tuple(g.shape) == w.shape
        assert float(np.std(np.asarray(w))) > 0.3  # not a collapsed network
        _close(g, w)
    _close(got_proto, proto)


def test_detector_class_max_head_matches_jax():
    preds, _ = _jax_forward("class_max")
    model = port_detector(detector_variables())
    with torch.no_grad():
        got, proto = model(torch.from_numpy(_frames(5)), class_max=True, with_proto=False)
    assert proto is None
    for g, w in zip(got, preds):
        assert g["hw"] == tuple(int(d) for d in w["hw"])
        for key in ("y5", "coef", "cls_max"):
            _close(g[key], w[key])
        np.testing.assert_array_equal(g["cls_arg"].numpy(), np.asarray(w["cls_arg"]))


def test_detector_sparse_head_matches_jax():
    """topk_positions=20: the same positions by objectness and the
    class/coefficient head on them. Two positions whose objectness agrees
    to fp32 rounding may come in either order, so both sides are compared
    in position order."""
    preds, _ = _jax_forward("sparse")
    model = port_detector(detector_variables())
    with torch.no_grad():
        got, _ = model(torch.from_numpy(_frames(5)), topk_positions=20)

    def by_position(idx, *arrays):
        order = np.argsort(idx, axis=1)
        return [np.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), 1)
                for a in (idx, *arrays)]

    for g, w in zip(got, preds):
        g_idx, g_y5, g_rest = by_position(*(t.numpy() for t in (g["pos_idx"], g["y5"], g["rest"])))
        w_idx, w_y5, w_rest = by_position(*(np.asarray(w[k]) for k in ("pos_idx", "y5", "rest")))
        np.testing.assert_array_equal(g_idx, w_idx)
        _close(g_y5, w_y5)
        _close(g_rest, w_rest)


def test_decoders_match_jax():
    """decode_predictions, decode_best, decode_best_classmax and
    decode_best_sparse on the JAX detector's own outputs, fed to both."""
    dense, _ = _jax_forward("dense")
    cm, _ = _jax_forward("class_max")
    sparse, _ = _jax_forward("sparse")

    def torch_levels(levels):
        # the jitted forward returns 'hw' as arrays
        return [{k: (tuple(int(d) for d in v) if k == "hw" else torch.from_numpy(np.asarray(v)))
                 for k, v in lvl.items()} for lvl in levels]

    cases = [
        (yolov7.decode_predictions, jyolo.decode_predictions, dense,
         [torch.from_numpy(np.asarray(p)) for p in dense]),
        (yolov7.decode_best, jyolo.decode_best, dense, [torch.from_numpy(np.asarray(p)) for p in dense]),
        (yolov7.decode_best_classmax, jyolo.decode_best_classmax, cm, torch_levels(cm)),
        (yolov7.decode_best_sparse, jyolo.decode_best_sparse, sparse, torch_levels(sparse)),
    ]
    for port_fn, jax_fn, jax_in, port_in in cases:
        want = jax_fn(jax_in, NC)
        got = port_fn(port_in, NC)
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape, port_fn.__name__
            if np.asarray(w).dtype.kind == "i":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-5)


def test_folded_detector_refuses_training():
    model = port_detector(detector_variables(), fold=True).train()
    with pytest.raises(RuntimeError, match="folded|merged"):
        model(torch.from_numpy(_frames(5)))


def test_repconv_with_identity_branch_merges_like_jax():
    """cin == cout adds the identity BN branch (no RepConv of the detector
    has it): unmerged and merged against JAX's RepConv and its merge."""
    c, rng = 16, np.random.default_rng(9)
    jmodel = jyolo.RepConv(c)
    x = rng.standard_normal((2, 5, 7, c)).astype(np.float32)
    v = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = jax.tree.map(lambda a: (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32), v)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])  # variances stay positive
    want = jmodel.apply(v, jnp.asarray(x))
    want_merged = jyolo.RepConv(c, fold_bn=True).apply(jax_fold_batchnorm(v), jnp.asarray(x))
    port = yolov7.RepConv(c, c)
    port.load_state_dict({k: torch.from_numpy(a) for k, a in yolov7_state_dict_from_variables(v).items()})
    port.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1)
        fold_batchnorm(port)
        got_merged = port(xt).permute(0, 2, 3, 1)
    assert port.rbr_identity_bn is None and port.merged_conv is not None
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_merged), np.asarray(want_merged), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- NMS


def _nms_case(kind: str, rng, b=2, a=300, nc=5):
    if kind == "random":
        xy = rng.uniform(0, 200, (b, a, 2))
        wh = rng.uniform(5, 60, (b, a, 2))
        scores = rng.uniform(0, 1, (b, a))
    elif kind == "clusters":  # overlapping clusters: long suppression chains
        centres = rng.uniform(20, 180, (b, 8, 2))
        xy = centres[:, rng.integers(0, 8, a)] + rng.normal(0, 3, (b, a, 2))
        wh = rng.uniform(20, 40, (b, a, 2))
        scores = rng.uniform(0.2, 1, (b, a))
    else:  # "ties": most scores exactly equal, many under the threshold
        xy = rng.uniform(0, 200, (b, a, 2))
        wh = rng.uniform(5, 60, (b, a, 2))
        scores = np.where(rng.uniform(size=(b, a)) < 0.7, 0.1, 0.5)
        scores[:, ::17] = 0.9
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    classes = rng.integers(0, nc, (b, a)).astype(np.int32)
    return boxes, scores.astype(np.float32), classes


@pytest.mark.parametrize("agnostic", [False, True], ids=["class-aware", "agnostic"])
@pytest.mark.parametrize("kind,pre_topk,max_det", [
    ("random", 128, 50), ("clusters", 256, 300), ("ties", 64, 100), ("ties", 300, 40),
], ids=["random", "clusters-pool-below-max-det", "ties-pool-below-max-det", "ties-full-pool"])
def test_batched_nms_matches_jax_in_every_slot(kind, pre_topk, max_det, agnostic):
    """Every slot, valid or padded: boxes, scores, classes, nms_idx and
    valid exactly (the same fp32 arithmetic; ties resolved by index), and
    n_candidates."""
    boxes, scores, classes = _nms_case(kind, np.random.default_rng(pre_topk + max_det))
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                            0.25, 0.45, pre_topk=pre_topk, max_det=max_det, agnostic=agnostic)
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(classes), 0.25, 0.45, pre_topk=pre_topk,
                          max_det=max_det, agnostic=agnostic)
    assert set(got) == set(want)
    assert got["valid"].any()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_greedy_keep_matches_jax_on_a_deep_chain():
    """A chain where each box overlaps only the next: greedy keeps every
    other box, which takes ~K steps to reach (more than one check's worth)."""
    k = 40
    x = np.arange(k, dtype=np.float32) * 6.0
    boxes = np.stack([x, np.zeros(k), x + 10.0, np.full(k, 10.0)], -1).astype(np.float32)
    iou = nms._iou_matrix(torch.from_numpy(boxes))
    cand = torch.ones(k, dtype=torch.bool)
    got = nms._greedy_keep(iou, cand, 0.2)  # neighbours overlap at IoU 0.25
    want = jnms._greedy_keep(jnp.asarray(iou.numpy()), jnp.asarray(cand.numpy()), 0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [i % 2 == 0 for i in range(k)]


def test_box_format_round_trip_matches_jax():
    xywh = np.random.default_rng(2).uniform(1, 50, (3, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(nms.xywh_to_xyxy(torch.from_numpy(xywh)).numpy(),
                                  np.asarray(jnms.xywh_to_xyxy(jnp.asarray(xywh))))
    xyxy = nms.xywh_to_xyxy(torch.from_numpy(xywh))
    np.testing.assert_array_equal(nms.xyxy_to_xywh(xyxy).numpy(),
                                  np.asarray(jnms.xyxy_to_xywh(jnp.asarray(xyxy.numpy()))))


# ------------------------------------------------------------ CLIP, table

CLIP_KW = dict(width=64, heads=4, layers=2)


@functools.lru_cache(maxsize=None)
def clip_params():
    """Narrow JAX CLIP params, every vector redrawn (numpy trees)."""
    model = JaxCLIP(**CLIP_KW)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3),
                                                 jnp.zeros((1, 77), jnp.int32))["params"])
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                        if a.ndim == 1 else a, params)


def port_clip() -> CLIPTextEncoder:
    model = CLIPTextEncoder(**CLIP_KW)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in clip_text_state_dict_from_params(clip_params()).items()})
    return model.eval()


def test_clip_text_tower_matches_jax():
    """2 layers at width 64 on hash-tokenizer ids (EOT the largest id) and
    on rows padded as ClipEmbedder pads them; fp32, tolerance for the two
    frameworks' LayerNorm and softmax orders."""
    toks = HashTokenizer().tokenize(["a red chair", "the <UNK>", "class_3 near a table"])
    toks = np.concatenate([toks, np.zeros((1, 77), np.int32)])
    toks[-1, 0] = 1
    want = JaxCLIP(**CLIP_KW).apply({"params": clip_params()}, jnp.asarray(toks))
    with torch.no_grad():
        got = port_clip()(torch.from_numpy(toks).long())
    assert tuple(got.shape) == (4, 512)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def _jax_narrow_embedder(batch: int = 8) -> JaxClipEmbedder:
    """The JAX package's ClipEmbedder (phrase cache, padded batches) around
    the narrow tower and the hash tokenizer; its constructor builds the
    full-width tower, so the test sets the same attributes itself."""
    emb = JaxClipEmbedder.__new__(JaxClipEmbedder)
    model = JaxCLIP(**CLIP_KW)
    params = clip_params()
    emb.model, emb.tokenizer, emb.batch, emb._cache = model, HashTokenizer(), batch, {}
    emb._apply = jax.jit(lambda toks: model.apply({"params": params}, toks))
    return emb


def test_class_table_matches_jax():
    """build_class_table through the hash tokenizer, both per-class
    strategies, batches of 8 over 11 phrases (a padded second batch)."""
    names = [f"class_{i}" for i in range(10)]
    for strategy in ("none", "synset_def_wn"):
        want = jax_build_class_table(names, strategy, _jax_narrow_embedder())
        embedder = ClipEmbedder(port_clip(), batch=8, device="cpu")
        embedder.tokenizer = HashTokenizer()
        got = build_class_table(names, strategy, embedder)
        assert got.shape == (11, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="per-class"):
        build_class_table(names, "name_synset_def_wn_rel_sz", embedder)


# ------------------------------------------- host detector, provider, masks


def _jax_detector(**kw):
    return jyolo.Yolov7SegDetector(num_classes=NC, params=detector_variables(), **kw)


def _normed(seed: int) -> np.ndarray:
    x = _frames(seed)
    return ((x - np.asarray(yolov7.IMAGENET_MEAN)) / np.asarray(yolov7.IMAGENET_STD)).astype(np.float32)


def test_host_detector_matches_jax():
    """Yolov7SegDetector: padded detections (xywh, scores, classes, valid,
    nms_idx, coeffs), names and the candidate count against JAX's, at conf
    0.3 with a pool smaller than the candidates."""
    kw = dict(conf_thres=0.3, iou_thres=0.45, max_det=20, pre_topk=100)
    images = _normed(11)
    want = _jax_detector(**kw)(images)
    got = yolov7.Yolov7SegDetector(port_detector(detector_variables()), **kw)(images)
    assert got["valid"].any() and got["pre_topk"] == int(want["pre_topk"]) == 100
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    for k in ("valid", "classes", "nms_idx"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("xywh", "scores", "coeffs", "proto"):
        _close(got[k], want[k])  # the detector's tolerance
    assert got["names"] == want["names"]


def test_provider_matches_jax():
    """YoloClipObjectProvider: lowest confidence first, phrases through the
    strategy, features through the phrase cache, the sentinel where an image
    has no detection (conf 0.6 leaves image 1 empty)."""
    images = _normed(12)
    jax_prov = JaxProvider.__new__(JaxProvider)
    jax_prov._init_sizing(8, max_det=1000, final_upscale=False)
    jax_prov.keep_annotations = False
    jax_prov.strategy = ObjectLanguageStrategy("synset_def_wn")
    jax_prov.embedder = _jax_narrow_embedder()
    jax_prov.detector = _jax_detector(conf_thres=0.6, iou_thres=0.45, max_det=8)
    want = jax_prov(images)

    embedder = ClipEmbedder(port_clip(), batch=8, device="cpu")
    embedder.tokenizer = HashTokenizer()
    detector = yolov7.Yolov7SegDetector(port_detector(detector_variables()), conf_thres=0.6,
                                        iou_thres=0.45, max_det=8)
    got = YoloClipObjectProvider(detector, embedder, "synset_def_wn", n_max=8)(images)
    assert got["valid"].sum(1).tolist() == want["valid"].sum(1).tolist()
    assert got["valid"][:, 1:].any(), "some image must carry real detections"
    np.testing.assert_array_equal(got["valid"], want["valid"])
    _close(got["xywh"], want["xywh"])  # the detector's tolerance
    np.testing.assert_allclose(got["features"], want["features"], rtol=1e-4, atol=1e-5)


def test_process_masks_matches_jax():
    rng = np.random.default_rng(4)
    proto = rng.standard_normal((16, 24, 8)).astype(np.float32)
    coeffs = rng.standard_normal((5, 8)).astype(np.float32)
    xy = rng.uniform(0, 80, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (5, 2))], -1).astype(np.float32)
    valid = np.array([True, True, False, True, False])
    want = jax_process_masks(*map(jnp.asarray, (proto, coeffs, boxes, valid)), DET_HW)
    got = process_masks(*map(torch.from_numpy, (proto, coeffs, boxes, valid)), DET_HW)
    assert tuple(got.shape) == (5, *DET_HW)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    small = process_masks(*map(torch.from_numpy, (proto, coeffs, boxes, valid)), DET_HW,
                          upsample=False)
    assert tuple(small.shape) == (5, 16, 24) and float(small[2].abs().max()) == 0.0


def test_saturation_warning_fires_only_past_the_pool(caplog):
    """At n_candidates == pre_topk every candidate fit: no warning (the JAX
    package warns at >=); one more and it warns."""
    logger = logging.getLogger("objcavit_torch.test")
    with caplog.at_level(logging.WARNING, logger="objcavit_torch.test"):
        assert not yolov7.warn_if_saturated(logger, np.array([100, 64]), 100, "t")
        assert not caplog.records
        assert yolov7.warn_if_saturated(logger, np.array([101, 64]), 100, "t")
    assert any("saturated on 1/2" in r.getMessage() for r in caplog.records)
