"""Optimizer: AdamW with a per-step OneCycle schedule and cycled beta1.

Port of ``objcavit_tpu/training/optim.py::build_optimizer`` on its OneCycle
path (``use_swa`` absent), with the natives the reference used
(GraphBinsLM.configure_optimizers): ``torch.optim.AdamW`` under
``torch.optim.lr_scheduler.OneCycleLR`` with pct_start 0.3, cos anneal,
``div_factor`` 25 and ``final_div_factor`` 100, and beta1 cycled
0.95 -> 0.85 -> 0.95. The scheduler steps once per optimizer step, after
it, so update k runs at the schedule's step k, as optax's
``inject_hyperparams`` reads it. Gradient clipping by global norm is the
train step's (``training/steps.py``), as it was the trainer's.

Against optax: torch clips by ``max / (norm + 1e-6)`` where optax clips by
``max / norm``, and torch's AdamW skips a parameter without a gradient
(weight decay included) where optax decays every leaf.

Not ported yet (ROADMAP A.6, with the fit loop): the SWA learning-rate
switch, and the plain constant-LR AdamW with a slower encoder
(``use_swa=False``).
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(params: Iterable[torch.Tensor], lr: float, weight_decay: float,
                    total_steps: int, div_factor: float = 25.0,
                    final_div_factor: float = 100.0):
    """-> (AdamW, OneCycleLR) over ``params``."""
    optimizer = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=lr, total_steps=total_steps, pct_start=0.3,
        anneal_strategy="cos", cycle_momentum=True, base_momentum=0.85,
        max_momentum=0.95, div_factor=div_factor, final_div_factor=final_div_factor,
    )
    return optimizer, scheduler
