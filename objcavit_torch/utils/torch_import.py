"""Reference Lightning checkpoints and the detector's and CLIP's release
files -> the port.

Port of ``objcavit_tpu/utils/torch_import.py``. ``load_torch_checkpoint``: the
port keeps the reference's state-dict names, so a reference ``.ckpt``
(``state_dict`` with the LightningModule's ``model.`` prefix,
GraphBinsLM.py:79-85) loads with ``load_state_dict`` and no conversion
tree. The frozen detector and CLIP weights the reference stores beside the
depth model (``model.detector.*``, ``model.language_model.*``) are skipped,
as the JAX package skips them. The model built from the same params file
(``training/steps.py::build_model``) has every module the checkpoint's
options need (a ``do_final_upscale`` model's
``dense_feature_extractor.decoder.final_upscale._net.{0,1,3,4}`` among
them); a checkpoint of another architecture fails the load, naming its
missing keys.

``load_yolov7_weights``: the LVIS YOLOv7-seg release ``.pt`` (u7 branch,
Yolov7Wrapper.py:37) into the port's ``Yolov7Seg``. Its EMA weights come
first, then ``model``, then a raw state dict (u7's attempt_load). Its keys
are ``model.{i}.<child>``, ``i`` the layer of yolov7-seg.yaml; the tables
below (the JAX package's, ``torch_import.py:366-500``) name the port's
module of each layer, whose names are the JAX package's. ISegment's
ImplicitA and ImplicitM fold into the detect 1x1 convs, exactly.
``load_clip_text_weights``: an OpenAI CLIP release ``.pt`` (a TorchScript
archive, else a state dict) -> the text tower's state dict in the port's
names (CLIPWrapper.py:18-24 reads ``encode_text`` alone).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn as nn

MODEL_PREFIX = "model."
FROZEN_PREFIXES = ("model.detector.", "model.language_model.")


@torch.no_grad()
def load_torch_checkpoint(path: str, model: nn.Module) -> dict:
    """Load a reference Lightning ``.ckpt`` (or one the port saved) into
    ``model`` in place; returns the checkpoint. Every parameter and BN
    statistic must be present (a reference BN may lack
    ``num_batches_tracked``, which eval never reads); entries the model does
    not have are logged and skipped."""
    # a reference checkpoint pickles its hyperparameters beside the tensors,
    # so it is not read weights-only
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k[len(MODEL_PREFIX):]: v for k, v in ckpt.get("state_dict", ckpt).items()
          if k.startswith(MODEL_PREFIX) and not k.startswith(FROZEN_PREFIXES)
          and isinstance(v, torch.Tensor)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path}: {len(missing)} of the model's entries are missing, e.g. "
                       f"{missing[:5]}; was it saved from another architecture or option?")
    if unexpected:
        logging.getLogger(__name__).warning("%s: %d entries the model does not have were "
                                            "skipped, e.g. %s", path, len(unexpected),
                                            unexpected[:5])
    return ckpt


# YOLOv7-seg: the yaml layer of each of the port's modules (inside ``body``)
_YOLO_CONV_IDX = {0: "s0", 1: "s1", 2: "s2", 3: "s3",
                  52: "up4_conv", 54: "lat4", 64: "up3_conv", 66: "lat3"}
# ELAN and ELAN-W blocks: the layers of cv1..cv7 (the concat orders are the
# modules' own)
_YOLO_ELAN_IDX = {
    "elan1": (4, 5, 6, 7, 8, 9, 11), "elan2": (17, 18, 19, 20, 21, 22, 24),
    "elan3": (30, 31, 32, 33, 34, 35, 37), "elan4": (43, 44, 45, 46, 47, 48, 50),
    "elanw4": (56, 57, 58, 59, 60, 61, 63), "elanw3": (68, 69, 70, 71, 72, 73, 75),
    "elanw4b": (81, 82, 83, 84, 85, 86, 88), "elanw5b": (94, 95, 96, 97, 98, 99, 101),
}
# MP downsample blocks: cv1 (after the max-pool), cv2, cv3 (stride 2)
_YOLO_MP_IDX = {"mp1": (13, 14, 15), "mp2": (26, 27, 28), "mp3": (39, 40, 41),
                "down4": (77, 78, 79), "down5": (90, 91, 92)}
_YOLO_SPPCSPC_IDX = 51
_YOLO_REP_IDX = {"rep3": 102, "rep4": 103, "rep5": 104}
_YOLO_HEAD_IDX = 105
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _fuse_implicit_detect(sd: dict, head: str, k: int):
    """ISegment's ImplicitA (added before) and ImplicitM (multiplied after)
    folded into the 1x1 detect conv, exact for a 1x1 conv:
    y = im (W (x + ia) + b) = (im W) x + im (b + W ia)."""
    w, b = sd[f"{head}.m.{k}.weight"], sd[f"{head}.m.{k}.bias"]  # (O, I, 1, 1), (O,)
    if f"{head}.ia.{k}.implicit" in sd:
        b = b + w.reshape(w.shape[0], -1) @ sd[f"{head}.ia.{k}.implicit"].reshape(-1)
    if f"{head}.im.{k}.implicit" in sd:
        im = sd[f"{head}.im.{k}.implicit"].reshape(-1)
        w, b = w * im[:, None, None, None], b * im
    return w, b


def yolov7_state_dict_from_release(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A yolov7-seg (u7) sequential state dict -> the port's ``Yolov7Seg``
    state dict."""
    out: dict[str, np.ndarray] = {}

    def conv(src: str, dst: str) -> None:  # u7 Conv: conv (no bias) + bn
        out[f"{dst}.conv.weight"] = sd[f"{src}.conv.weight"]
        for k in _BN_KEYS:
            out[f"{dst}.bn.{k}"] = sd[f"{src}.bn.{k}"]

    for idx, name in _YOLO_CONV_IDX.items():
        conv(f"model.{idx}", f"body.{name}")
    for blocks, cvs in ((_YOLO_ELAN_IDX, 7), (_YOLO_MP_IDX, 3)):
        for name, idxs in blocks.items():
            for j, idx in zip(range(1, cvs + 1), idxs):
                conv(f"model.{idx}", f"body.{name}.cv{j}")
    for j in range(1, 8):
        conv(f"model.{_YOLO_SPPCSPC_IDX}.cv{j}", f"body.sppcspc.cv{j}")
    for name, idx in _YOLO_REP_IDX.items():
        src, dst = f"model.{idx}", f"body.{name}"
        for branch in ("rbr_dense", "rbr_1x1"):
            out[f"{dst}.{branch}_conv.weight"] = sd[f"{src}.{branch}.0.weight"]
            for k in _BN_KEYS:
                out[f"{dst}.{branch}_bn.{k}"] = sd[f"{src}.{branch}.1.{k}"]
        if f"{src}.rbr_identity.weight" in sd:  # only where cin == cout
            for k in _BN_KEYS:
                out[f"{dst}.rbr_identity_bn.{k}"] = sd[f"{src}.rbr_identity.{k}"]
    head = f"model.{_YOLO_HEAD_IDX}"
    for j in range(1, 4):
        conv(f"{head}.proto.cv{j}", f"proto.cv{j}")
    n_detect = sum(f"{head}.m.{k}.weight" in sd for k in range(4))
    if n_detect != 3:
        raise ValueError(f"expected 3 detect convs in {head}, found {n_detect}")
    for k in range(3):
        out[f"detect{k}.weight"], out[f"detect{k}.bias"] = _fuse_implicit_detect(sd, head, k)
    return out


def _tensors(payload) -> dict[str, np.ndarray]:
    if hasattr(payload, "state_dict"):
        payload = payload.state_dict()
    return {k: v.float().numpy() for k, v in payload.items() if isinstance(v, torch.Tensor)}


@torch.no_grad()
def load_yolov7_weights(checkpoint: str, model: nn.Module) -> nn.Module:
    """Load a YOLOv7-seg release ``.pt`` into ``model`` (the port's
    ``Yolov7Seg``) in place, every entry required; its class count must be
    the model's. Returns the model."""
    # the release pickles the whole model, so it is not read weights-only
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=False)
    payload = ckpt
    if isinstance(ckpt, dict):  # u7 attempt_load: ckpt['ema' if ckpt.get('ema') else 'model']
        payload = ckpt.get("ema") or ckpt.get("model", ckpt)
    sd = yolov7_state_dict_from_release(_tensors(payload))
    nc = sd["detect0.weight"].shape[0] // 3 - 5 - sd["proto.cv3.conv.weight"].shape[0]
    if nc != model.num_classes:
        raise ValueError(f"{checkpoint}: the checkpoint has {nc} classes, the model "
                         f"expects {model.num_classes}")
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{checkpoint}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model


def load_clip_text_weights(path: str) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP release ``.pt`` (a TorchScript archive, else a plain
    state dict) -> the port's ``CLIPTextEncoder`` state dict: the text
    tower's keys (the visual tower and ``logit_scale`` are dropped)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    out = {k: sd[k] for k in ("positional_embedding", "text_projection")}
    out["token_embedding.weight"] = sd["token_embedding.weight"]
    out["ln_final.weight"], out["ln_final.bias"] = sd["ln_final.weight"], sd["ln_final.bias"]
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        src, dst = f"transformer.resblocks.{i}", f"block{i}"
        out[f"{dst}.attn.in_proj.weight"] = sd[f"{src}.attn.in_proj_weight"]
        out[f"{dst}.attn.in_proj.bias"] = sd[f"{src}.attn.in_proj_bias"]
        for a, b in (("attn.out_proj", "attn.out_proj"), ("mlp.c_fc", "mlp_fc"),
                     ("mlp.c_proj", "mlp_proj"), ("ln_1", "ln_1"), ("ln_2", "ln_2")):
            out[f"{dst}.{b}.weight"] = sd[f"{src}.{a}.weight"]
            out[f"{dst}.{b}.bias"] = sd[f"{src}.{a}.bias"]
        i += 1
    return out


def clip_text_from_state_dict(sd: dict[str, torch.Tensor], heads: int | None = None):
    """The port's ``CLIPTextEncoder`` at the sizes of ``sd`` (a
    ``load_clip_text_weights`` dict), loaded; ``heads`` defaults to width
    / 64, as OpenAI's ``build_model`` reads it."""
    from objcavit_torch.models.clip_text import CLIPTextEncoder

    vocab, width = sd["token_embedding.weight"].shape
    layers = sum(k.endswith(".ln_1.weight") for k in sd)
    model = CLIPTextEncoder(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0],
                            width=width, heads=heads or width // 64, layers=layers,
                            embed_dim=sd["text_projection"].shape[1])
    model.load_state_dict(sd)
    return model
