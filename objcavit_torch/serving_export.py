"""Export: serving programs as artifacts that load with no model code.

Port of ``objcavit_tpu/serving_export.py``. A server is traced once with
``torch.export`` and written to a directory that a process can load and
run with ``torch`` and ``objcavit_torch.kernels.ops`` alone: no model
module, no config system, no detector or CLIP source.

    artifact_dir/
      program.pt2    the traced program (``torch.export.save``): its graph,
                     with each kernel as an ``objcavit::`` op and the
                     server's constants (the sentinel objects, the
                     ImageNet mean and std, the resize taps), and no weights
      weights.pt     the weights, a flat dict of tensors (``torch.save``,
                     read with ``torch.load(weights_only=True)``), each
                     with its strides: ``model.*``, and for the fused
                     server ``detector.*`` and ``class_table``
      meta.json      frames and depth shapes and dtypes, the platform, the
                     card, the torch version, the calling convention's
                     version and the ``objcavit::`` ops the graph calls

Every program has one calling convention,

    depth = program(weights, frames_u8)     # (B, H, W, 3) uint8 -> depth

whichever server it came from: ``DepthPipeline`` with its no-detection
sentinel, or ``FusedDepthPipeline`` with its detector, NMS (a
``torch.while_loop``) and class table in the program, returning depth only.
The batch is static: one artifact per served batch size
(``export_artifact``).

Platform: a program exported on the card launches the kernels through
their ops' CUDA implementations and loads only where there is a card; one
exported on the CPU runs the ops' plain versions there.

CLI, on the card (``-o`` and JAX's other flags):

    python -m objcavit_torch.serving_export -o artifact --batch 8
    python -m objcavit_torch.serving_export -o artifact --fused --batch 8 \\
        --yolov7-ckpt yolov7-seg-lvis.pt --clip-ckpt ViT-B-32.pt --bpe bpe.txt.gz
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os

import torch
import torch.nn as nn

from objcavit_torch.kernels.ops import NAMESPACE  # registers the graph's objcavit:: ops

PROGRAM = "program.pt2"
WEIGHTS = "weights.pt"
META = "meta.json"
CALLING_CONVENTION_VERSION = 1


def _meta_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers lie on the meta
    device: a trace that read one of them instead of its weight input
    would fail, rather than bake the weight into the program."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(meta, t.requires_grad) if isinstance(t, nn.Parameter) else meta
    return copy.deepcopy(module, memo)


def _weights(module: nn.Module, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.{name}": t.detach() for name, t in
            itertools.chain(module.named_parameters(), module.named_buffers())}


class _Served(nn.Module):
    """A server's ``serve`` with its modules (and the fused server's class
    table) on the meta device, for ``functional_call`` to fill."""

    def __init__(self, pipeline, fused: bool):
        super().__init__()
        self.pipeline, self.fused = pipeline, fused
        self.model = _meta_copy(pipeline.model)
        if fused:
            self.detector = _meta_copy(pipeline.detector)
            self.register_buffer("class_table", torch.empty_like(pipeline.class_table,
                                                                 device="meta"))

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        pipe = copy.copy(self.pipeline)  # its constants, this module's weights
        pipe.model = self.model
        if not self.fused:
            return pipe.serve(frames_u8)
        pipe.detector, pipe.class_table = self.detector, self.class_table
        return pipe.serve(frames_u8)[0]  # depth; the saturation meta is not served


class _Program(nn.Module):
    """``forward(weights, frames_u8) -> depth``. The served module is kept
    out of this module's registry, so the exported program's only state is
    what ``weights`` brings."""

    def __init__(self, served: _Served):
        super().__init__()
        object.__setattr__(self, "served", served)

    def forward(self, weights: dict[str, torch.Tensor], frames_u8: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.served, weights, (frames_u8,))


def export_pipeline(pipeline, frames_shape):
    """Export a DepthPipeline or FusedDepthPipeline for uint8 frames of
    ``frames_shape`` (B, H, W, 3) on the pipeline's device as (program, a
    ``torch.export.ExportedProgram``; weights, the flat dict it takes)."""
    from objcavit_torch.serving import DepthPipeline, FusedDepthPipeline

    frames_shape = tuple(int(d) for d in frames_shape)
    if len(frames_shape) != 4 or frames_shape[3] != 3:
        raise ValueError(f"frames_shape must be (B, H, W, 3), got {frames_shape}")
    if isinstance(pipeline, FusedDepthPipeline):
        if frames_shape[0] % pipeline.det_stride:
            raise ValueError(f"video det_stride={pipeline.det_stride} needs the batch divisible "
                             f"by it, got {frames_shape[0]}")
        fused = True
        weights = {**_weights(pipeline.model, "model"), **_weights(pipeline.detector, "detector"),
                   "class_table": pipeline.class_table.detach()}
    elif isinstance(pipeline, DepthPipeline):
        if pipeline.provider is not None:
            raise ValueError(
                "DepthPipeline with a host-side object provider cannot be exported as one "
                "program; use FusedDepthPipeline (the on-card detector) or the sentinel/"
                "no-provider pipeline."
            )
        fused = False
        weights = _weights(pipeline.model, "model")
        if pipeline.model.takes_objects:
            pipeline._sentinel_objects(frames_shape[0])  # made here: the program's constants
    else:
        raise TypeError(f"unsupported pipeline type {type(pipeline)!r}")
    frames = torch.zeros(frames_shape, dtype=torch.uint8, device=pipeline.device)
    # under no_grad, as a request runs: the weight packing's own no_grad
    # regions then leave no grad-mode switches in the graph
    with torch.no_grad():
        program = torch.export.export(_Program(_Served(pipeline, fused)), (weights, frames),
                                      strict=False)
    return program, weights


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def graph_ops(program) -> dict[str, int]:
    """{``objcavit::`` op: its nodes in the program's graph and subgraphs}."""
    counts: dict[str, int] = {}
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = node.target
            if node.op == "call_function" and isinstance(target, torch._ops.OpOverload) \
                    and target.namespace == NAMESPACE:
                counts[target.name()] = counts.get(target.name(), 0) + 1
    return dict(sorted(counts.items()))


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def save_artifact(path, program, weights, extra_meta=None) -> None:
    """Write ``program``, ``weights`` and the meta into directory ``path``.
    Drops the program's stored example inputs (the weights again)."""
    os.makedirs(path, exist_ok=True)
    program.example_inputs = None
    torch.export.save(program, os.path.join(path, PROGRAM))
    torch.save(weights, os.path.join(path, WEIGHTS))
    placeholders = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    frames = placeholders[program.graph_signature.user_inputs[-1]].meta["val"]
    out = next(n for n in program.graph.nodes if n.op == "output").args[0][0].meta["val"]
    dev = frames.device
    meta = {
        "frames_shape": list(frames.shape),
        "frames_dtype": _dtype_name(frames.dtype),
        "depth_shape": list(out.shape),
        "depth_dtype": _dtype_name(out.dtype),
        "platforms": [dev.type],
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "torch_version": torch.__version__,
        "calling_convention_version": CALLING_CONVENTION_VERSION,
        "ops": graph_ops(program),
    }
    meta.update(extra_meta or {})
    _write_json(os.path.join(path, META), meta)


def export_artifact(pipeline, path, batch_sizes=(8,), hw=None, *, extra_meta=None) -> list[str]:
    """Export ``pipeline`` for each batch size and save one artifact a size:
    at ``path`` for one size, else under ``path/b{N}`` with a shared
    ``path/meta.json`` indexing them. ``hw``: the frames' (H, W), by default
    the eval size."""
    h, w = hw if hw is not None else pipeline.eval_dims
    dirs = []
    for b in batch_sizes:
        program, weights = export_pipeline(pipeline, (b, h, w, 3))
        sub = os.fspath(path) if len(batch_sizes) == 1 else os.path.join(path, f"b{b}")
        save_artifact(sub, program, weights, extra_meta=extra_meta)
        dirs.append(sub)
    if len(batch_sizes) > 1:
        _write_json(os.path.join(path, META), {
            "batch_sizes": [int(b) for b in batch_sizes],
            "dirs": [os.path.basename(d) for d in dirs],
            "hw": [int(h), int(w)],
            **(extra_meta or {}),
        })
    return dirs


class ServingArtifact:
    """A loaded serving program: ``torch`` and the kernels' ops, no model
    code.

    >>> art = ServingArtifact.load("artifact/")
    >>> depth = art(frames_u8)          # (B, H, W, 3) uint8 -> depth, on the device
    """

    def __init__(self, program, weights: dict[str, torch.Tensor], meta: dict):
        from objcavit_torch.utils.device import card_device

        self.program, self.meta = program, meta
        self.device = card_device(meta["platforms"][0])
        # on the device once, each tensor with the strides it was exported with
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        self._module = program.module()

    @classmethod
    def load(cls, path) -> "ServingArtifact":
        """Read an artifact directory. A CUDA artifact raises where there is
        no card: it never falls back to the CPU."""
        from objcavit_torch.utils.device import card_device

        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        device = card_device(meta["platforms"][0])
        program = torch.export.load(os.path.join(path, PROGRAM))
        weights = torch.load(os.path.join(path, WEIGHTS), map_location=device, weights_only=True)
        return cls(program, weights, meta)

    @property
    def frames_shape(self) -> tuple[int, ...]:
        return tuple(self.meta["frames_shape"])

    def __call__(self, frames_u8) -> torch.Tensor:
        frames = torch.as_tensor(frames_u8)
        if tuple(frames.shape) != self.frames_shape:
            raise ValueError(f"artifact compiled for frames {self.frames_shape}, "
                             f"got {tuple(frames.shape)}")
        if frames.dtype != torch.uint8:
            raise ValueError(f"artifact takes uint8 frames, got {frames.dtype}")
        with torch.inference_mode():
            depth = self._module(self.weights, frames.to(self.device))
        # the program's own check of every input (each weight's shape and
        # dtype) has passed once: the weights stay as they are and the
        # frames are checked above, so later calls skip it (tens of
        # milliseconds of host time a request at B5's ~1000 weights)
        self._module.validate_inputs = False
        return depth


def main(argv=None, device="cuda") -> list[str]:
    """The CLI: export the flagship GraphBins-B5 server (``--fused``: the
    fused uint8 -> detector -> depth server) on ``device``; returns the
    artifact directories."""
    ap = argparse.ArgumentParser(prog="python -m objcavit_torch.serving_export",
                                 description="Export the serving program as an artifact that "
                                             "loads with no model code.")
    ap.add_argument("-o", "--out", required=True, help="artifact directory")
    ap.add_argument("--batch", type=int, nargs="+", default=[8],
                    help="batch size(s) to export; one artifact per size")
    ap.add_argument("--hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="source frame dims (default: eval dims)")
    ap.add_argument("--eval-dims", type=int, nargs=2, default=[480, 640], metavar=("H", "W"))
    ap.add_argument("--fused", action="store_true",
                    help="export the fused uint8->detector->depth program (default: the "
                         "sentinel-objects depth pipeline)")
    ap.add_argument("--yolov7-ckpt", default=None,
                    help="YOLOv7-seg release checkpoint for the fused detector")
    ap.add_argument("--clip-ckpt", default=None, help="CLIP release checkpoint (text tower)")
    ap.add_argument("--bpe", default=None, help="CLIP BPE vocab path")
    args = ap.parse_args(argv)

    from objcavit_torch import serving

    if args.fused:
        clip_model = None
        if args.clip_ckpt:
            from objcavit_torch.utils.torch_import import (
                clip_text_from_state_dict,
                load_clip_text_weights,
            )
            clip_model = clip_text_from_state_dict(load_clip_text_weights(args.clip_ckpt))
        pipe = serving.build_fused_flagship(eval_dims=tuple(args.eval_dims), device=device,
                                            clip_model=clip_model, bpe_path=args.bpe,
                                            yolov7_checkpoint=args.yolov7_ckpt)
    else:
        pipe = serving.build_flagship_pipeline(eval_dims=tuple(args.eval_dims), device=device)
    dirs = export_artifact(pipe, args.out, batch_sizes=tuple(args.batch),
                           hw=tuple(args.hw) if args.hw else None,
                           extra_meta={"pipeline": "fused" if args.fused else "depth"})
    for d in dirs:
        print(f"wrote {d}")
    return dirs


if __name__ == "__main__":
    main()
