"""Optimizer: AdamW under the reference's three schedules.

Port of ``objcavit_tpu/training/optim.py::build_optimizer`` with the natives
the reference used (GraphBinsLM.configure_optimizers, main.py:41-43). The
config's ``optimizer.use_swa`` is a tri-state (GraphBinsLM.py:470):

* absent: ``torch.optim.AdamW`` under ``OneCycleLR`` with pct_start 0.3, cos
  anneal, ``div_factor`` 25 and ``final_div_factor`` 100, beta1 cycled
  0.95 -> 0.85 -> 0.95;
* True: the same, then Lightning's SWA learning-rate switch
  (StochasticWeightAveraging(swa_lrs=1e-2)): from ``swa_start_step`` the LR
  anneals by cos from its value at the switch to ``swa_lrs`` over
  ``swa_anneal_steps`` (SWALR._cosine_anneal), and beta1 stays at its value
  at the switch (``SWAOneCycleLR``). The weights are averaged by the loop;
* False: AdamW at a constant LR, no scheduler, with the encoder's parameters
  in a group at ``lr / slow_encoder``.

One torch quirk is the reference's and is kept: ``OneCycleLR`` with a scalar
``max_lr`` overwrites every group's LR, so the slow encoder's group would
run at the schedule's LR on the two OneCycle paths; there, as in the JAX
package, the port makes one group. The JAX package's fit builds
its constant-LR AdamW without the parameter tree, so there every leaf runs
at ``lr``; the port divides the encoder's LR as the reference does (ROADMAP
§C).

The scheduler steps once per optimizer step, after it, so update k runs at
the schedule's step k, as optax's ``inject_hyperparams`` reads it. A resumed
run rebuilds the schedule for its own total and starts it at the restored
step (``start_step``); the LR of the latest update, the ``lr-AdamW``
scalar, is ``TrainStep.last_lr`` (None without a scheduler, as JAX's
``current_lr``). Gradient clipping by global norm is the train step's
(``training/steps.py``), as it was the trainer's.

Against optax: torch clips by ``max / (norm + 1e-6)`` where optax clips by
``max / norm``, and torch's AdamW skips a parameter without a gradient
(weight decay included) where optax decays every leaf.
"""

from __future__ import annotations

import math
import torch
import torch.nn as nn
from torch.optim.lr_scheduler import OneCycleLR

SWA_LRS = 1e-2  # Lightning StochasticWeightAveraging(swa_lrs=1e-2), main.py:41-43


class SWAOneCycleLR(OneCycleLR):
    """OneCycleLR until ``swa_start``, then SWALR's cos anneal from the LR
    at the switch to ``SWA_LRS`` over ``anneal_steps``, beta1 frozen at its
    value at the switch."""

    def __init__(self, optimizer, swa_start: int, anneal_steps: int, **kwargs):
        self.swa_start = int(swa_start)
        self.anneal_steps = max(int(anneal_steps), 1)
        super().__init__(optimizer, **kwargs)

    def get_lr(self):
        step = self.last_epoch
        if step < self.swa_start:
            return super().get_lr()
        # the cycle read at the switch: its LRs, and it sets beta1 there
        self.last_epoch = self.swa_start
        try:
            at_switch = super().get_lr()
        finally:
            self.last_epoch = step
        t = min(max((step - self.swa_start) / self.anneal_steps, 0.0), 1.0)
        alpha = (1.0 - math.cos(math.pi * t)) / 2.0
        return [lr * (1.0 - alpha) + SWA_LRS * alpha for lr in at_switch]


def _param_groups(model: nn.Module, lr: float, slow_encoder: float) -> list[dict]:
    """The encoder's parameters (a name component 'encoder', as JAX labels
    its tree) in a group at ``lr / slow_encoder``, the rest at ``lr``."""
    named = list(model.named_parameters())
    enc = [p for n, p in named if "encoder" in n.split(".")]
    rest = [p for n, p in named if "encoder" not in n.split(".")]
    return [{"params": rest}, {"params": enc, "lr": lr / slow_encoder}]


def build_optimizer(model: nn.Module, lr: float, weight_decay: float, total_steps: int,
                    div_factor: float = 25.0, final_div_factor: float = 100.0,
                    use_swa: bool | None = None, slow_encoder: float | None = None,
                    swa_start_step: int | None = None, swa_anneal_steps: int = 1,
                    start_step: int = 0):
    """-> (AdamW over ``model``'s parameters, the schedule of ``use_swa`` at
    ``start_step``, None for False). ``swa_start_step`` is required with
    ``use_swa``; ``slow_encoder`` splits the groups on the constant path
    only, where no OneCycle overwrites them."""
    if use_swa is not None and not use_swa:
        params = (_param_groups(model, lr, slow_encoder) if slow_encoder
                  else model.parameters())
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay), None
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)
    kwargs = dict(max_lr=lr, total_steps=total_steps, pct_start=0.3, anneal_strategy="cos",
                  cycle_momentum=True, base_momentum=0.85, max_momentum=0.95,
                  div_factor=div_factor, final_div_factor=final_div_factor)
    if use_swa:
        kwargs.update(swa_start=swa_start_step, anneal_steps=swa_anneal_steps)
    cls = SWAOneCycleLR if use_swa else OneCycleLR
    scheduler = cls(optimizer, **kwargs)
    if start_step:
        # a resumed cycle (torch's last_epoch) reads its bounds from the
        # groups, where the fresh one above wrote this run's
        scheduler = cls(optimizer, last_epoch=start_step - 1, **kwargs)
    return optimizer, scheduler
