"""Slice 14, the release loaders: objcavit_torch's load_yolov7_weights and
load_clip_text_weights against objcavit_tpu's on files the tests write.

No release file is in the repository, so the files come from the torch
oracles of tests/test_yolov7_import.py (yolov7-seg in the u7 layout,
``model.{i}.<child>``, with ISegment's implicit layers; 2 classes, 4 mask
coefficients) and tests/test_clip_import.py (CLIP's text tower, release key
names, reduced sizes). Each loader's state dict must equal what JAX's
loader gives, carried to the port's names by ``utils/convert.py``, and the
loaded port model must give the oracle's outputs.
"""

import numpy as np
import pytest
import torch

from objcavit_tpu.utils.torch_import import load_clip_text_weights as jax_load_clip_text_weights
from objcavit_tpu.utils.torch_import import load_yolov7_weights as jax_load_yolov7_weights

from objcavit_torch.models.yolov7 import Yolov7Seg
from objcavit_torch.utils.convert import (
    clip_text_state_dict_from_params,
    yolov7_state_dict_from_variables,
)
from objcavit_torch.utils.torch_import import (
    clip_text_from_state_dict,
    load_clip_text_weights,
    load_yolov7_weights,
)
from tests.test_clip_import import CTX, HEADS, VOCAB, TorchCLIPText
from tests.test_yolov7_import import NC, NM, TorchYolo, _Payload, _randomize
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (a fixture)

# fp32 on the same weights in another summation order (the detector's
# 1x1 detect convs carry the folded implicits): the forward of
# tests/test_yolov7_import.py's parity test, rtol 1e-4 and atol 1e-4 of
# outputs of order 1-10
FORWARD_RTOL, FORWARD_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def yolo():
    torch.manual_seed(0)
    model = TorchYolo().eval()
    _randomize(model)
    return model


def _port_yolo(path) -> Yolov7Seg:
    return load_yolov7_weights(str(path), Yolov7Seg(num_classes=NC, nm=NM)).eval()


def _jax_state(path) -> dict:
    class Expect:
        num_classes = NC

    return yolov7_state_dict_from_variables(jax_load_yolov7_weights(str(path), Expect()))


@pytest.mark.parametrize("layout", ["model", "ema", "state_dict"])
def test_yolov7_weights_match_jax_loader_and_oracle(tmp_path, yolo, layout):
    """Each release layout ({'model': module}, {'model', 'ema'} with EMA
    first, a raw state dict): the port's loaded state equals JAX's loader's
    through utils/convert.py, value for value; on the EMA layout the loaded
    detector's three heads and prototypes equal the oracle's forward (eval
    mode, BN unfolded) within FORWARD_RTOL/ATOL."""
    sd = {k: v.detach().numpy() for k, v in yolo.state_dict().items()}
    path = tmp_path / "yolov7-seg.pt"
    if layout == "model":
        torch.save({"model": _Payload(sd)}, path)
    elif layout == "ema":
        zeroed = {**sd, "model.0.conv.weight": np.zeros_like(sd["model.0.conv.weight"])}
        torch.save({"model": _Payload(zeroed), "ema": _Payload(sd)}, path)
    else:
        torch.save(yolo.state_dict(), path)
    model = _port_yolo(path)
    want = _jax_state(path)
    got = model.state_dict()
    assert set(want) - {k for k in want if k.endswith("num_batches_tracked")} <= set(got)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    if layout != "ema":
        return  # the same weights: the forward is checked once
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs, proto = yolo(x)
        preds, got_proto = model(x.permute(0, 2, 3, 1), with_proto=True)
    for level, (p, o) in enumerate(zip(preds, outs)):
        b, _, h, w = o.shape
        want_level = o.view(b, 3, -1, h, w).permute(0, 3, 4, 1, 2).reshape(p.shape)
        torch.testing.assert_close(p, want_level, rtol=FORWARD_RTOL, atol=FORWARD_ATOL,
                                   msg=f"level {level}")
    torch.testing.assert_close(got_proto, proto.permute(0, 2, 3, 1), rtol=FORWARD_RTOL,
                               atol=FORWARD_ATOL)


def test_yolov7_class_count_mismatch_raises(tmp_path, yolo):
    """A release file of 2 classes into a detector of 1203 raises, as JAX's."""
    path = tmp_path / "yolov7-seg.pt"
    torch.save(yolo.state_dict(), path)
    with pytest.raises(ValueError, match="2 classes"):
        load_yolov7_weights(str(path), Yolov7Seg())

    class Expect:
        num_classes = 1203

    with pytest.raises(ValueError, match="nc=2"):
        jax_load_yolov7_weights(str(path), Expect())


@pytest.mark.parametrize("layout", ["torchscript", "state_dict"])
def test_clip_text_weights_match_jax_loader_and_oracle(tmp_path, layout):
    """A TorchScript archive (with a visual-tower entry, dropped) and a
    plain state dict: the port's text-tower state dict equals JAX's loader's
    through utils/convert.py, and the tower built from it embeds tokens as
    the oracle's encode_text (rtol 1e-4, atol 1e-5, tests/test_clip_import.py's)."""
    torch.manual_seed(0)
    oracle = TorchCLIPText().eval()
    oracle.register_buffer("visual_proj", torch.zeros(2, 2))  # a non-text entry
    rng = np.random.default_rng(0)
    toks = np.zeros((3, CTX), np.int64)
    for i, n in enumerate((3, 7, CTX - 1)):  # 0-padded after the EOT, the highest id
        toks[i, 0] = VOCAB - 2
        toks[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        toks[i, n] = VOCAB - 1
    toks = torch.from_numpy(toks)
    path = tmp_path / "clip.pt"
    if layout == "torchscript":
        torch.jit.save(torch.jit.trace(oracle, toks), str(path))
    else:
        torch.save(oracle.state_dict(), path)
    sd = load_clip_text_weights(str(path))
    want = clip_text_state_dict_from_params(jax_load_clip_text_weights(str(path))["params"])
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

    model = clip_text_from_state_dict(sd, heads=HEADS).eval()
    with torch.no_grad():
        torch.testing.assert_close(model(toks), oracle(toks), rtol=1e-4, atol=1e-5)
