"""JAX variables -> the port's state dict (numpy only).

``state_dict_from_variables`` is the inverse of
``objcavit_tpu/utils/torch_import.py::convert_state_dict``: it reads the JAX
package's unfolded ``{'params', 'batch_stats'}`` tree of a GraphBins model
and writes the reference Lightning state-dict keys without their ``model.``
prefix, which are the port's parameter names. So JAX weights load into the
port with ``load_state_dict``, and so does a released reference ``.ckpt``
once its ``model.`` prefix is stripped. The encoder's keys follow its
family: gen-efficientnet's for the B-series, torchvision's ``features.*``
for V2 (the inverse of ``torch_import.py::_convert_efficientnet_v2``).

``adabins_state_dict_from_variables`` does the same for an AdaBins model
(the inverse of ``torch_import.py::_convert_minivit`` for its miniViT):
``adaptive_bins_layer.patch_transformer.{embedding_convPxP,
positional_encodings, transformer_encoder.layers.i}``,
``adaptive_bins_layer.{conv3x3, regressor.0/2/4}`` and ``conv_out.0``.

Given ``{'params': tree}`` alone, it writes the parameter keys only, so a
JAX gradient tree (``jax.grad`` of a loss over the params) lands in the
port's layout, key by key beside ``param.grad``.

Layouts: conv HWIO -> OIHW (depthwise (kh, kw, 1, C) -> (C, 1, kh, kw));
linear (in, out) -> (out, in); attention in_proj (E, 3E) -> (3E, E);
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

The YOLOv7-seg detector and the CLIP text tower name their modules after
the JAX package's, so ``yolov7_state_dict_from_variables`` and
``clip_text_state_dict_from_params`` are the same walk over the tree
(``flax_state_dict``).
"""

from __future__ import annotations

import numpy as np

from objcavit_torch.models.efficientnet import encoder_spec


class _Reader:
    """Reads leaves of the JAX trees by '/'-path into a flat state dict."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats")
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path: str) -> np.ndarray:
        for part in path.split("/"):
            tree = tree[part]
        return np.asarray(tree)

    def param(self, path: str) -> np.ndarray:
        return self._get(self.params, path)

    def put(self, key: str, value: np.ndarray) -> None:
        self.sd[key] = np.array(value, order="C")  # a copy; keeps 0-d arrays 0-d

    def conv(self, fpath: str, tkey: str, bias: bool = True) -> None:
        # HWIO -> OIHW; a depthwise (kh, kw, 1, C) kernel becomes (C, 1, kh, kw)
        self.put(f"{tkey}.weight", self.param(f"{fpath}/kernel").transpose(3, 2, 0, 1))
        if bias:
            self.put(f"{tkey}.bias", self.param(f"{fpath}/bias"))

    def linear(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.weight", self.param(f"{fpath}/kernel").T)
        self.put(f"{tkey}.bias", self.param(f"{fpath}/bias"))

    def bn(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.weight", self.param(f"{fpath}/bn/scale"))
        self.put(f"{tkey}.bias", self.param(f"{fpath}/bn/bias"))
        if self.stats is None:
            return
        self.put(f"{tkey}.running_mean", self._get(self.stats, f"{fpath}/bn/mean"))
        self.put(f"{tkey}.running_var", self._get(self.stats, f"{fpath}/bn/var"))
        self.put(f"{tkey}.num_batches_tracked", np.zeros((), np.int64))

    def mha(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.in_proj_weight", self.param(f"{fpath}/in_proj_kernel").T)
        self.put(f"{tkey}.in_proj_bias", self.param(f"{fpath}/in_proj_bias"))
        self.put(f"{tkey}.out_proj.weight", self.param(f"{fpath}/out_kernel").T)
        self.put(f"{tkey}.out_proj.bias", self.param(f"{fpath}/out_bias"))

    def transformer(self, fpath: str, tkey: str, layers: int = 4) -> None:
        for i in range(layers):
            f, t = f"{fpath}/layer{i}", f"{tkey}.layers.{i}"
            self.mha(f"{f}/self_attn", f"{t}.self_attn")
            self.linear(f"{f}/linear1", f"{t}.linear1")
            self.linear(f"{f}/linear2", f"{t}.linear2")
            for norm in ("norm1", "norm2"):
                self.put(f"{t}.{norm}.weight", self.param(f"{f}/{norm}/scale"))
                self.put(f"{t}.{norm}.bias", self.param(f"{f}/{norm}/bias"))


def _encoder(r: _Reader, fpath: str, tkey: str, encoder_name: str) -> None:
    spec = encoder_spec(encoder_name)
    if spec.pad_style == "torch":
        _encoder_v2(r, fpath, tkey, spec)
        return
    r.conv(f"{fpath}/stem/conv", f"{tkey}.conv_stem", bias=False)
    r.bn(f"{fpath}/stem/bn", f"{tkey}.bn1")
    for si, (btype, _out, depth, _k, _s, _e) in enumerate(spec.stages):
        for bi in range(depth):
            f, t = f"{fpath}/stage{si}_block{bi}", f"{tkey}.blocks.{si}.{bi}"
            if btype == "ds":
                r.conv(f"{f}/dw_conv", f"{t}.conv_dw", bias=False)
                r.bn(f"{f}/dw_bn", f"{t}.bn1")
                r.conv(f"{f}/se/reduce", f"{t}.se.conv_reduce")
                r.conv(f"{f}/se/expand", f"{t}.se.conv_expand")
                r.conv(f"{f}/project/conv", f"{t}.conv_pw", bias=False)
                r.bn(f"{f}/project/bn", f"{t}.bn2")
            else:
                r.conv(f"{f}/expand/conv", f"{t}.conv_pw", bias=False)
                r.bn(f"{f}/expand/bn", f"{t}.bn1")
                r.conv(f"{f}/dw_conv", f"{t}.conv_dw", bias=False)
                r.bn(f"{f}/dw_bn", f"{t}.bn2")
                r.conv(f"{f}/se/reduce", f"{t}.se.conv_reduce")
                r.conv(f"{f}/se/expand", f"{t}.se.conv_expand")
                r.conv(f"{f}/project/conv", f"{t}.conv_pwl", bias=False)
                r.bn(f"{f}/project/bn", f"{t}.bn3")
    r.conv(f"{fpath}/conv_head", f"{tkey}.conv_head", bias=False)


def _encoder_v2(r: _Reader, fpath: str, tkey: str, spec) -> None:
    """The inverse of ``torch_import.py::_convert_efficientnet_v2``: JAX's
    V2 tree -> torchvision's ``features.*`` keys."""
    feats = f"{tkey}.features"

    def cna(f: str, t: str) -> None:  # a ConvBnAct -> a Conv2dNormActivation
        r.conv(f"{f}/conv", f"{t}.0", bias=False)
        r.bn(f"{f}/bn", f"{t}.1")

    cna(f"{fpath}/stem", f"{feats}.0")
    for si, (btype, _out, depth, _k, _s, expand) in enumerate(spec.stages):
        for bi in range(depth):
            f, t = f"{fpath}/stage{si}_block{bi}", f"{feats}.{si + 1}.{bi}.block"
            if btype == "fused":
                if expand != 1:
                    cna(f"{f}/expand", f"{t}.0")
                    cna(f"{f}/project", f"{t}.1")
                else:
                    cna(f"{f}/project", f"{t}.0")
                continue
            cna(f"{f}/expand", f"{t}.0")
            r.conv(f"{f}/dw_conv", f"{t}.1.0", bias=False)
            r.bn(f"{f}/dw_bn", f"{t}.1.1")
            r.conv(f"{f}/se/reduce", f"{t}.2.fc1")
            r.conv(f"{f}/se/expand", f"{t}.2.fc2")
            cna(f"{f}/project", f"{t}.3")
    cna(f"{fpath}/conv_head", f"{feats}.{len(spec.stages) + 1}")


def _decoder(r: _Reader, fpath: str, tkey: str, do_final_upscale: bool = False) -> None:
    """The decoder's up-stages (``final_upscale`` too with
    ``do_final_upscale``): each ``conv0`` kernel, which JAX's
    ``ConcatSplitConv`` applies split along its input channels, is one
    (3, 3, C + Cs, O) parameter, the concatenated conv's weight."""
    r.conv(f"{fpath}/conv2", f"{tkey}.conv2", bias=False)
    r.put(f"{tkey}.conv2.bias", r.param(f"{fpath}/conv2_bias"))
    for up in ("up1", "up2", "up3", "up4") + (("final_upscale",) if do_final_upscale else ()):
        r.conv(f"{fpath}/{up}/conv0", f"{tkey}.{up}._net.0")
        r.bn(f"{fpath}/{up}/bn0", f"{tkey}.{up}._net.1")
        r.conv(f"{fpath}/{up}/conv1", f"{tkey}.{up}._net.3")
        r.bn(f"{fpath}/{up}/bn1", f"{tkey}.{up}._net.4")
    r.conv(f"{fpath}/conv3", f"{tkey}.conv3")


def _saca(r: _Reader, fpath: str, tkey: str, no_obj_sa: bool) -> None:
    r.transformer(f"{fpath}/image_transformer", f"{tkey}.image_transformer_encoder")
    if not no_obj_sa:
        r.transformer(f"{fpath}/obj_transformer", f"{tkey}.obj_transformer_encoder")
    r.mha(f"{fpath}/cross_attn_obj_im", f"{tkey}.cross_attn_obj_im")
    r.mha(f"{fpath}/cross_attn_im_obj", f"{tkey}.cross_attn_im_obj")


def _objcavit(r: _Reader, fpath: str, tkey: str, pos_strategy: str, no_obj_sa: bool,
              use_2_saca: bool) -> None:
    if pos_strategy.startswith("grid_random"):
        r.put(f"{tkey}.positional_encoder.positional_encodings",
              r.param(f"{fpath}/positional_encoder/positional_encodings"))
    else:  # the learned MLPs: Sequential Linear layers at 0,2,4,6,8
        for i, idx in enumerate((0, 2, 4, 6, 8)):
            r.linear(f"{fpath}/positional_encoder/fc{i}", f"{tkey}.positional_encoder.{idx}")
    r.conv(f"{fpath}/image_embedding_conv", f"{tkey}.image_embedding_convPxP")
    r.linear(f"{fpath}/obj_embedding_layer", f"{tkey}.obj_embedding_layer")
    for saca in ("saca_1", "saca_2") if use_2_saca else ("saca_1",):
        _saca(r, f"{fpath}/{saca}", f"{tkey}.{saca}", no_obj_sa)
    r.conv(f"{fpath}/conv3x3", f"{tkey}.conv3x3")
    for i, idx in enumerate((0, 2, 4)):
        r.linear(f"{fpath}/regressor/fc{i}", f"{tkey}.regressor.{idx}")


def _minivit(r: _Reader, fpath: str, tkey: str) -> None:
    pf, pt = f"{fpath}/patch_transformer", f"{tkey}.patch_transformer"
    r.conv(f"{pf}/embedding_conv", f"{pt}.embedding_convPxP")
    r.put(f"{pt}.positional_encodings", r.param(f"{pf}/positional_encodings"))
    r.transformer(f"{pf}/transformer", f"{pt}.transformer_encoder")
    r.conv(f"{fpath}/conv3x3", f"{tkey}.conv3x3")
    for i, idx in enumerate((0, 2, 4)):
        r.linear(f"{fpath}/regressor/fc{i}", f"{tkey}.regressor.{idx}")


def flax_state_dict(params, stats=None, prefix: str = "") -> dict[str, np.ndarray]:
    """A flax tree whose module names are the port's attribute names ->
    state dict: '/' becomes '.', a conv ``kernel`` HWIO becomes ``weight``
    OIHW, a dense ``kernel`` (in, out) becomes ``weight`` (out, in),
    ``scale`` and ``embedding`` become ``weight``, and a BatchNorm's stats
    (``mean``, ``var``) become ``running_mean``, ``running_var`` (with
    ``num_batches_tracked``); other leaves keep their names."""
    sd: dict[str, np.ndarray] = {}
    for k, v in params.items():
        if hasattr(v, "keys"):
            sub = stats.get(k) if stats is not None and k in stats else None
            sd.update(flax_state_dict(v, sub, f"{prefix}{k}."))
            continue
        a = np.asarray(v)
        if k == "kernel":
            k, a = "weight", a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        elif k in ("scale", "embedding"):
            k = "weight"
        sd[f"{prefix}{k}"] = np.array(a, order="C")
    if stats is not None and "mean" in stats:
        sd[f"{prefix}running_mean"] = np.array(stats["mean"])
        sd[f"{prefix}running_var"] = np.array(stats["var"])
        sd[f"{prefix}num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def yolov7_state_dict_from_variables(variables) -> dict[str, np.ndarray]:
    """JAX ``Yolov7Seg`` variables, unfolded (``{'params', 'batch_stats'}``)
    or folded (``{'params'}``), -> the port's ``Yolov7Seg`` state dict. The
    detect kernels (1, 1, Cin, 3 no) become ``detect{i}.weight`` (3 no, Cin,
    1, 1)."""
    return flax_state_dict(variables["params"], variables.get("batch_stats"))


def clip_text_state_dict_from_params(params) -> dict[str, np.ndarray]:
    """JAX ``CLIPTextEncoder`` params -> the port's ``CLIPTextEncoder`` state
    dict (``positional_embedding`` and ``text_projection`` as they are)."""
    return flax_state_dict(params)


def state_dict_from_variables(
    variables, encoder_name: str, pos_strategy: str = "learned_bbox_wh",
    no_obj_sa: bool = False, use_2_saca: bool = False, do_final_upscale: bool = False,
) -> dict[str, np.ndarray]:
    """Unfolded JAX GraphBins variables -> the port's GraphBins state dict
    (parameters only when ``variables`` has no 'batch_stats'), for ObjCAViT's
    options: the grid strategies' ``positional_encoder.positional_encodings``
    table or the learned MLP; no ``obj_transformer_encoder`` under
    ``no_obj_sa``; ``saca_2`` under ``use_2_saca``; the decoder's
    ``final_upscale`` under ``do_final_upscale``."""
    r = _Reader(variables)
    _encoder(r, "dense_feature_extractor/encoder",
             "dense_feature_extractor.encoder.original_model", encoder_name)
    _decoder(r, "dense_feature_extractor/decoder", "dense_feature_extractor.decoder",
             do_final_upscale)
    _objcavit(r, "objcavit", "objcavit", pos_strategy, no_obj_sa, use_2_saca)
    r.conv("conv_out", "conv_out.0")
    return r.sd


def adabins_state_dict_from_variables(variables, encoder_name: str,
                                      do_final_upscale: bool = False) -> dict[str, np.ndarray]:
    """Unfolded JAX AdaBins variables -> the port's AdaBins state dict
    (parameters only when ``variables`` has no 'batch_stats'); the decoder's
    ``final_upscale`` and a 1200-row positional table under
    ``do_final_upscale``."""
    r = _Reader(variables)
    _encoder(r, "dense_feature_extractor/encoder",
             "dense_feature_extractor.encoder.original_model", encoder_name)
    _decoder(r, "dense_feature_extractor/decoder", "dense_feature_extractor.decoder",
             do_final_upscale)
    _minivit(r, "adaptive_bins_layer", "adaptive_bins_layer")
    r.conv("conv_out", "conv_out.0")
    return r.sd
