"""JAX variables -> the port's state dict (numpy only).

``state_dict_from_variables`` is the inverse of
``objcavit_tpu/utils/torch_import.py::convert_state_dict``: it reads the JAX
package's unfolded ``{'params', 'batch_stats'}`` tree of a GraphBins model
and writes the reference Lightning state-dict keys without their ``model.``
prefix, which are the port's parameter names. So JAX weights load into the
port with ``load_state_dict``, and so does a released reference ``.ckpt``
once its ``model.`` prefix is stripped.

Layouts: conv HWIO -> OIHW (depthwise (kh, kw, 1, C) -> (C, 1, kh, kw));
linear (in, out) -> (out, in); attention in_proj (E, 3E) -> (3E, E);
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np

from objcavit_torch.models.efficientnet import encoder_spec


class _Reader:
    """Reads leaves of the JAX trees by '/'-path into a flat state dict."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
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
    r.conv(f"{fpath}/stem/conv", f"{tkey}.conv_stem", bias=False)
    r.bn(f"{fpath}/stem/bn", f"{tkey}.bn1")
    for si, (btype, _out, depth, _k, _s, _e) in enumerate(encoder_spec(encoder_name).stages):
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


def _decoder(r: _Reader, fpath: str, tkey: str) -> None:
    r.conv(f"{fpath}/conv2", f"{tkey}.conv2", bias=False)
    r.put(f"{tkey}.conv2.bias", r.param(f"{fpath}/conv2_bias"))
    for up in ("up1", "up2", "up3", "up4"):
        r.conv(f"{fpath}/{up}/conv0", f"{tkey}.{up}._net.0")
        r.bn(f"{fpath}/{up}/bn0", f"{tkey}.{up}._net.1")
        r.conv(f"{fpath}/{up}/conv1", f"{tkey}.{up}._net.3")
        r.bn(f"{fpath}/{up}/bn1", f"{tkey}.{up}._net.4")
    r.conv(f"{fpath}/conv3", f"{tkey}.conv3")


def _objcavit(r: _Reader, fpath: str, tkey: str) -> None:
    for i, idx in enumerate((0, 2, 4, 6, 8)):
        r.linear(f"{fpath}/positional_encoder/fc{i}", f"{tkey}.positional_encoder.{idx}")
    r.conv(f"{fpath}/image_embedding_conv", f"{tkey}.image_embedding_convPxP")
    r.linear(f"{fpath}/obj_embedding_layer", f"{tkey}.obj_embedding_layer")
    saca_f, saca_t = f"{fpath}/saca_1", f"{tkey}.saca_1"
    r.transformer(f"{saca_f}/image_transformer", f"{saca_t}.image_transformer_encoder")
    r.transformer(f"{saca_f}/obj_transformer", f"{saca_t}.obj_transformer_encoder")
    r.mha(f"{saca_f}/cross_attn_obj_im", f"{saca_t}.cross_attn_obj_im")
    r.mha(f"{saca_f}/cross_attn_im_obj", f"{saca_t}.cross_attn_im_obj")
    r.conv(f"{fpath}/conv3x3", f"{tkey}.conv3x3")
    for i, idx in enumerate((0, 2, 4)):
        r.linear(f"{fpath}/regressor/fc{i}", f"{tkey}.regressor.{idx}")


def state_dict_from_variables(
    variables, encoder_name: str, pos_strategy: str = "learned_bbox_wh"
) -> dict[str, np.ndarray]:
    """Unfolded JAX GraphBins variables -> the port's GraphBins state dict."""
    if pos_strategy != "learned_bbox_wh":
        raise NotImplementedError(
            f"pos_strategy {pos_strategy!r} is not ported yet (ROADMAP A.5)"
        )
    r = _Reader(variables)
    _encoder(r, "dense_feature_extractor/encoder",
             "dense_feature_extractor.encoder.original_model", encoder_name)
    _decoder(r, "dense_feature_extractor/decoder", "dense_feature_extractor.decoder")
    _objcavit(r, "objcavit", "objcavit")
    r.conv("conv_out", "conv_out.0")
    return r.sd
