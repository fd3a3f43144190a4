"""The train step: ``objcavit_torch.training.steps.TrainStep.__call__``, one
object built at set-up (the model with fp32 parameters in training mode,
AdamW under the one-cycle schedule, bf16 compute, the device-side
augmentation, the config's losses and clipping), driven from the seed
through its first ``checked_steps`` steps and then through the window.

Traffic keys: ``batch_size``; ``pool_batches`` made at set-up from the
seed on the device, at the config's ``train.dims`` with its ``slots``
(GraphBins only): smooth [0, 1] images, smooth depths in [0.5, 9.5] m with 2% of
pixels missing (0, masked), and object slots (unit-norm features, boxes
inside the image, the first 1-64 slots valid); the checked steps take
batches 0, 1, 2 and the window the pool from there on, over and over;
``trace_lead`` and ``trace_steps``. End to end: ``train_img_per_s``, the
images stepped over the window's wall time, ending in a synchronise.
``attempted`` counts its steps.

The check follows the first ``checked_steps`` steps with the plain
reference (``reference/train.py``) from the same initial weights, batches
and generator seed, in fp32 with TF32 off, once the program is freed. Over
the parameters (leaves), by the median leaf (see ``PERF.md`` for why not
the worst): ``grad_diff_med``, ||g - g_ref|| / max(||g_ref||, the median
leaf's ||g_ref||) of the first step's clipped gradient g as AdamW got it,
worked out from its first moment after step 1 (exp_avg / (1 - beta1));
``step_gap_med``, the gap of the norms of each leaf's change over the
checked steps, over the larger of the reference leaf's and the median
leaf's. Leaves whose reference gradient is under a thousandth of the
median leaf's (a conv bias before a train-mode BatchNorm: nought to
rounding) move by round-off alone and are left out. ``gaps`` also gives
``loss_gap`` (the largest relative gap of a checked step's loss) and
``grad_gap_med`` (the gap of the first gradient's norms), which the limits
file leaves uncompared: no control or fault reading lies far enough above
the program's (``PERF.md``), and the worst leaf's ``grad_diff_max`` and
``step_gap_max`` with their leaves' names, the readings behind the choice
of the median leaf.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

from h100bench.common import Cell, exact_fp32, port_model, reference_model, sync

MOVED = 1e-3  # a leaf moves where its reference gradient is this share of the median's


def make_batches(cell: Cell) -> tuple[list, list]:
    import torch
    import torch.nn.functional as F

    t, c = cell.traffic, cell.config["train"]
    b, n = t["batch_size"], t["pool_batches"]
    h, w = c["dims"]
    g, dev = cell.generator(1), cell.device

    def smooth(channels):
        coarse = torch.rand((b, channels, max(h // 16, 2), max(w // 16, 2)), generator=g,
                            device=dev)
        return F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1).contiguous()

    batches, objects = [], []
    for _ in range(n):
        image = (0.85 * smooth(3) + 0.15 * torch.rand((b, h, w, 3), generator=g, device=dev))
        depth = 0.5 + 9.0 * smooth(1)
        depth = torch.where(torch.rand(depth.shape, generator=g, device=dev) < 0.02, 0.0, depth)
        batches.append({"image": image.contiguous(), "depth": depth})
        if "slots" not in c:
            objects.append(None)
            continue
        s = c["slots"]
        feats = torch.randn((b, s, 512), generator=g, device=dev)
        feats = feats / feats.norm(dim=-1, keepdim=True)
        u = torch.rand((b, s, 4), generator=g, device=dev)
        xywh = torch.stack([u[..., 0] * w, u[..., 1] * h, 8 + 192 * u[..., 2],
                            8 + 192 * u[..., 3]], dim=-1)
        count = torch.randint(1, 65, (b, 1), generator=g, device=dev)
        valid = torch.arange(s, device=dev)[None] < count
        objects.append({"features": feats, "xywh": xywh, "valid": valid})
    return batches, objects


def recipe(cell: Cell) -> dict:
    c = cell.config["train"]
    return {"lr": c["lr"], "wd": c["wd"], "total_steps": c["total_steps"],
            "div_factor": c["div_factor"], "final_div_factor": c["final_div_factor"],
            "clip": c["clip"], "coeffs": tuple(c["losses"][1]),
            "min_depth": cell.config["kwargs"]["min_depth"]}


class Driver:
    def __init__(self, cell: Cell):
        import torch

        from h100bench.common import dtype_of
        from objcavit_torch.losses import LossWrapper
        from objcavit_torch.training.optim import build_optimizer
        from objcavit_torch.training.steps import make_train_step

        self.cell = cell
        c, t = cell.config["train"], cell.traffic
        self.batch, self.checked = t["batch_size"], t["checked_steps"]
        self.attempted = self.failed = 0
        self.batches, self.objects = make_batches(cell)
        reference = reference_model(cell)
        self.state = {k: v.detach().to("cpu", copy=True)
                      for k, v in reference.state_dict().items()}
        model = port_model(cell, reference.state_dict(), c)
        del reference
        self.model = model.to(memory_format=torch.channels_last).train()
        opt, sched = build_optimizer(self.model, c["lr"], c["wd"], c["total_steps"],
                                     c["div_factor"], c["final_div_factor"])
        self.step = make_train_step(
            self.model, opt, sched, LossWrapper(*c["losses"]),
            min_depth=cell.config["kwargs"]["min_depth"], augment_on_device=True,
            gradient_clip_val=c["clip"], compute_dtype=dtype_of(c["compute_dtype"]),
            generator=cell.generator(2))
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        self.losses = []
        for i in range(self.checked):
            beta1 = opt.param_groups[0]["betas"][0]
            self.losses.append(float(self._feed(i)))
            if i == 0:  # AdamW's first moment after one step: (1 - beta1) g
                self.grads = {n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).to("cpu")
                              for n, p in params.items() if p in opt.state}
        self.change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        del start
        sync(cell.device)

    def _feed(self, j: int):
        """The step on the pool's batch ``j`` (cyclically): the checked steps
        take 0, 1, 2, the window's k-th step ``checked_steps + k``."""
        j %= len(self.batches)
        return self.step(self.batches[j], self.objects[j])

    def window(self, seconds: float):
        k = 0
        t0 = time.perf_counter()
        while True:
            self._feed(self.checked + k)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.cell.device)
        t1 = time.perf_counter()
        self.attempted = k
        return ({"train_img_per_s": k * self.batch / (t1 - t0)},
                {"images": k * self.batch, "seconds": t1 - t0, "steps": k})

    def traced(self) -> dict:
        from h100bench.drivers.serving import hooked
        from h100bench.instrument import Launches
        from h100bench.trace import Profiled

        lead, n = self.cell.traffic["trace_lead"], self.cell.traffic["trace_steps"]
        for k in range(lead):
            self._feed(self.checked + k)
        prof, launches = Profiled(self.cell.device), Launches(self.model)
        with hooked(launches):
            prof.start()
            for k in range(lead, lead + n):
                self._feed(self.checked + k)
            prof.stop()
        return {"trace": prof.summary(), "launches": {"bound_s": dict(launches.bound_s)},
                "traced_steps": n}

    def flops_per_image(self) -> float:
        from h100bench.instrument import flops_per_image

        c = self.cell.config["train"]
        return flops_per_image(self.cell.config, self.batch, *c["dims"], c.get("slots", 1),
                               train=True)

    def free_program(self) -> None:
        import torch

        self.step = self.model = None
        gc.collect()
        if torch.device(self.cell.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, control: bool):
        import torch

        from h100bench.reference import model as ref
        from h100bench.reference import train as ref_train
        from h100bench.reference.precision import Fp8Operands

        with torch.device("meta"):
            reference = ref.build(self.cell.config["model"], self.cell.config["kwargs"])
        reference = reference.to_empty(device=self.cell.device)
        reference.load_state_dict(self.state)
        n = self.checked
        with exact_fp32(), (Fp8Operands() if control else contextlib.nullcontext()):
            return ref_train.steps(reference, self.batches[:n], self.objects[:n],
                                   self.cell.generator(2), recipe(self.cell))

    def checks(self, control: bool = False) -> dict:
        want = self.reference_steps(control=False)
        got = (self.reference_steps(control=True) if control
               else (self.losses, self.grads, self.change))
        return gaps(got, want)


def gaps(got, want) -> dict:
    """``got`` and ``want``: (losses, first-step gradients, change norms), by
    parameter name. -> the check's numbers."""
    import torch

    (lg, gg, cg), (lw, gw, cw) = got, want
    norm = {n: float(v.norm()) for n, v in gw.items()}
    med_g = statistics.median(norm.values())
    moved = [n for n, v in norm.items() if v >= MOVED * med_g]
    med_c = statistics.median(cw[n] for n in moved)
    got_g = {n: gg[n].to(gw[n].device, torch.float32) if n in gg else torch.zeros_like(gw[n])
             for n in moved}

    diff = {n: float((got_g[n] - gw[n]).norm()) / max(norm[n], med_g) for n in moved}
    step = {n: abs(cg[n] - cw[n]) / max(cw[n], med_c) for n in moved}
    worst_g, worst_c = max(diff, key=diff.get), max(step, key=step.get)
    return {
        "grad_diff_med": statistics.median(diff.values()),
        "step_gap_med": statistics.median(step.values()),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lg, lw)),
        "grad_gap_med": statistics.median(
            abs(float(got_g[n].norm()) - norm[n]) / max(norm[n], med_g) for n in moved),
        "grad_diff_max": diff[worst_g], "grad_diff_max_leaf": worst_g,
        "step_gap_max": step[worst_c], "step_gap_max_leaf": worst_c,
    }
