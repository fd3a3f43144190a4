"""What a ``--trace 1`` run measures besides the profiler's window, all from
the benchmark's own hooks, registered on the program's modules for the
traced window only and removed after it:

* ``Launches``: every roofline file's launches (``h100bench/rooflines/``),
  their least time summed by kernel kind;
* ``Stages``: CUDA events at the edges of the encoder, the attention stage
  (ObjCAViT or miniViT), the decoder and the model (after the bins head),
  read after the window: device ms an image of each stage (the decoder's
  with the bins head's). The method of ``objcavit_torch/utils/
  profile_stages.py``, over every forward of the window;
* ``flops_per_image``: the model's FLOPs an image, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
  forward on meta tensors at the cell's shapes, the same count whatever
  implements a layer; a train step's is three forwards' (the backward's two
  products a forward product), since the counter's ``convolution_backward``
  counts a grouped (depthwise) convolution as a dense one.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util

from h100bench.common import BENCH_DIR
from h100bench.peaks import bound_s


def roofline_files() -> list:
    mods = []
    for path in sorted((BENCH_DIR / "rooflines").glob("k*.py")):
        spec = importlib.util.spec_from_file_location(f"h100bench_roofline_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return mods


def _class(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


class Launches:
    """While installed, each kernel's launches and their least time."""

    def __init__(self, model):
        self.model = model
        self.bound_s = collections.Counter()
        self.count = collections.Counter()
        self.handles = []

    def install(self) -> None:
        for mod in roofline_files():
            classes = tuple(_class(h) for h in mod.HOOKS)

            def hook(module, args, output, mod=mod):
                for launch in mod.launches(module, args, output):
                    t, _ = bound_s(launch["bytes"], launch.get("bf16", 0.0),
                                   launch.get("fp32", 0.0))
                    self.bound_s[mod.KIND] += t
                    self.count[mod.KIND] += 1

            self.handles += [m.register_forward_hook(hook) for m in self.model.modules()
                             if isinstance(m, classes)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Stages:
    """CUDA events at the stages' edges, for every forward while installed."""

    def __init__(self, model):
        self.model = model
        self.forwards: list[dict] = []
        self.handles = []

    def install(self) -> None:
        import torch

        def mark(name):
            def hook(module, args, *_):
                if name == "model_pre":
                    self.forwards.append({"batch": args[0].shape[0]})
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.forwards[-1][name] = ev
            return hook

        dfe = self.model.dense_feature_extractor
        parts = {"encoder": dfe.encoder["original_model"], "decoder": dfe.decoder,
                 "head": self.model.transformer_head}
        self.handles.append(self.model.register_forward_pre_hook(mark("model_pre")))
        self.handles.append(self.model.register_forward_hook(mark("model_post")))
        for name, module in parts.items():
            self.handles.append(module.register_forward_pre_hook(mark(f"{name}_pre")))
            self.handles.append(module.register_forward_hook(mark(f"{name}_post")))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def ms_per_image(self) -> dict | None:
        """{'encoder', 'attention', 'decoder'}: device ms an image, averaged
        over the forwards (the caller has synchronised)."""
        if not self.forwards:
            return None
        total = collections.Counter()
        images = 0
        for f in self.forwards:
            total["encoder"] += f["encoder_pre"].elapsed_time(f["encoder_post"])
            total["attention"] += f["head_pre"].elapsed_time(f["head_post"])
            total["decoder"] += (f["decoder_pre"].elapsed_time(f["decoder_post"])
                                 + f["head_post"].elapsed_time(f["model_post"]))
            images += f["batch"]
        return {k: v / images for k, v in total.items()}


def flops_per_image(config: dict, batch: int, h: int, w: int, slots: int, train: bool) -> float:
    """The reference model's FLOPs an image at (batch, h, w) with ``slots``
    object slots: the eval forward, or three train forwards."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import model as ref

    with torch.device("meta"):
        model = ref.build(config["model"], config["kwargs"]).train(train)
        inputs = (torch.zeros((batch, h, w, 3)),)
        if model.takes_objects:
            dim = config["kwargs"].get("obj_feature_dim", 512)
            inputs += (torch.zeros((batch, slots, dim)), torch.zeros((batch, slots, 4)),
                       torch.ones((batch, slots), dtype=torch.bool))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(*inputs)
    return counter.get_total_flops() / batch * (3 if train else 1)
