"""GraphBins, the full ObjCAViT depth model (reference modules/GraphBins.py).

Port of ``objcavit_tpu/models/graphbins.py``: image ->
DenseFeatureExtractor -> ObjCAViT (objects supplied as padded slots) ->
bins head -> depth. Returns ``{'depth_pred', 'bin_edges'}``.

``model.train()`` and ``model.eval()`` select what the JAX package's
``train`` flag selects: BatchNorm on batch statistics with running-stat
updates, transformer dropout (``dropout_rate``, drawn from the generator
given to ``forward``), and the differentiable routes of the decoder resize
and the bins head (kernel 4 instead of the forward-only kernels 1 and 2).

``conv_out.0`` has the reference's (n_bins, 128, 1, 1) shape, so the image
must give at least 129 patch tokens (the regression token and 128 queries).
``n_queries`` narrows it for images with fewer tokens, as the JAX package's
lazily shaped ``conv_out`` does (tests at 64x96 have 5 queries).
The bins head reads ``conv_out`` in fp32, as the JAX bins head reads its
fp32 parameters; ``cast`` keeps it so. Training keeps every parameter in
fp32 and computes in bf16 through ``params_in``, the JAX package's
``param.astype(dtype)`` at each op. ``attn_impl`` is ObjCAViT's attention
route, ``"plain"`` or ``"kernel"`` (kernel 5); ``encoder_impl`` the
encoder's, ``"plain"`` or ``"kernel"`` (kernels 7 and 8, folded inference
only). ``pos_strategy``, ``no_obj_sa``, ``use_2_saca`` and the
full-resolution ``dims_train``/``dims_test`` (which size ``grid_random``'s
table) are ObjCAViT's options. ``do_final_upscale`` gives ObjCAViT dense
features at the image's full resolution (the decoder's fifth upsample), so
four times the image tokens; ObjCAViT still places the objects on them with
a feature stride of 2, as JAX does. ``drop_path_rate`` is the encoder's
stochastic depth. ``BinsDepthModel`` holds what GraphBins and AdaBins share.
Under a profiler the forward's stages are spans (``utils/profiling.py``):
``model.encoder`` and ``model.decoder`` (``DenseFeatureExtractor``),
``model.attention`` (ObjCAViT; AdaBins' miniViT) and ``model.bins_head``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from objcavit_torch.models.decoder import DenseFeatureExtractor
from objcavit_torch.models.objcavit import ObjCAViT
from objcavit_torch.ops.bins import bins_head_depth_factored
from objcavit_torch.utils.profiling import annotate

N_QUERIES = 128


class BinsDepthModel(nn.Module):
    """What GraphBins and AdaBins share: a fp32 ``conv_out`` beside a model
    in ``dtype``, and the parameters as a forward in a compute dtype reads
    them. Subclasses hold ``conv_out``, ``min_depth``, ``max_depth``,
    ``attn_impl`` (the route of every attention they hold) and
    ``encoder_impl`` (the encoder's route), and name their
    ``transformer_head``, the module between the decoder and the bins head.
    ``takes_objects`` says whether the forward takes the object slots after
    the image (GraphBins) or the image alone (AdaBins). ``do_final_upscale``
    says whether the dense features are at the image's full resolution."""

    takes_objects = False
    do_final_upscale = False

    @property
    def transformer_head(self) -> nn.Module:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        return next(p for n, p in self.named_parameters() if not n.startswith("conv_out")).dtype

    def cast(self, dtype: torch.dtype):
        """Cast to ``dtype``, keeping ``conv_out`` in fp32."""
        self.to(dtype)
        self.conv_out.float()
        return self

    def params_in(self, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """Every parameter as a forward in ``dtype`` reads it, for
        ``torch.func.functional_call``: cast to ``dtype`` (a differentiable
        copy, so gradients reach the fp32 parameter in fp32), except
        ``conv_out``, which the bins head reads in fp32, and the BatchNorm
        affines, which BN applies in fp32 beside its fp32 statistics."""
        out = {}
        for mname, module in self.named_modules():
            keep = isinstance(module, nn.BatchNorm2d) or mname.startswith("conv_out")
            for pname, p in module.named_parameters(recurse=False):
                out[f"{mname}.{pname}" if mname else pname] = p if keep else p.to(dtype)
        return out

    def bins_head(self, widths, feat, queries) -> dict[str, torch.Tensor]:
        conv = self.conv_out[0]
        depth, edges = bins_head_depth_factored(
            widths, feat, queries, conv.weight, conv.bias, self.min_depth, self.max_depth,
            train=self.training,
        )
        return {"depth_pred": depth, "bin_edges": edges}


class GraphBins(BinsDepthModel):
    takes_objects = True

    def __init__(self, encoder_name: str = "efficientnet-b5", n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 embedding_dim: int = 128, obj_feature_dim: int = 512,
                 pos_strategy: str = "learned_bbox_wh", no_obj_sa: bool = False,
                 use_2_saca: bool = False, dims_train: tuple[int, int] = (416, 544),
                 dims_test: tuple[int, int] = (480, 640), do_final_upscale: bool = False,
                 drop_path_rate: float = 0.0, dropout_rate: float = 0.1,
                 n_queries: int = N_QUERIES, attn_impl: str = "plain",
                 encoder_impl: str = "plain"):
        super().__init__()
        self.do_final_upscale = do_final_upscale
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.attn_impl = attn_impl
        self.encoder_impl = encoder_impl
        self.obj_feature_dim = obj_feature_dim
        self.dense_feature_extractor = DenseFeatureExtractor(
            encoder_name, encoder_impl, do_final_upscale, drop_path_rate)
        self.objcavit = ObjCAViT(
            im_feature_dim=128, obj_feature_dim=obj_feature_dim,
            n_query_channels=n_queries, patch_size=16, dim_out=n_bins,
            embed_dim=embedding_dim, pos_strategy=pos_strategy, no_obj_sa=no_obj_sa,
            use_2_saca=use_2_saca, dims_train=dims_train, dims_test=dims_test,
            dropout_rate=dropout_rate, attn_impl=attn_impl,
        )
        # the reference's Sequential(conv, Softmax); the bins head fuses both
        self.conv_out = nn.Sequential(nn.Conv2d(n_queries, n_bins, 1))

    @property
    def transformer_head(self) -> ObjCAViT:
        return self.objcavit

    def forward(self, image, object_features, object_xywh, object_valid, generator=None):
        """image (B, H, W, 3) ImageNet-normalised NHWC; objects as padded
        slots (B, N, F), (B, N, 4), (B, N) bool; ``generator`` feeds the
        dropout and the stochastic depth in training mode."""
        dense = self.dense_feature_extractor(image.to(self.dtype), generator)
        with annotate("model.attention"):
            widths, feat, queries = self.objcavit(
                dense, object_features, object_xywh, object_valid, generator
            )
        with annotate("model.bins_head"):
            return self.bins_head(widths, feat, queries)
