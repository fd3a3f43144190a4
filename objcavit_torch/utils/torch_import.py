"""Reference Lightning checkpoints -> the port.

Port of ``objcavit_tpu/utils/torch_import.py::load_torch_checkpoint``. The
port keeps the reference's state-dict names, so a reference ``.ckpt``
(``state_dict`` with the LightningModule's ``model.`` prefix,
GraphBinsLM.py:79-85) loads with ``load_state_dict`` and no conversion
tree. The frozen detector and CLIP weights the reference stores beside the
depth model (``model.detector.*``, ``model.language_model.*``) are skipped,
as the JAX package skips them; their own release-file loaders are ROADMAP
A.3a. Options the port lacks raise where the model is built
(``training/steps.py::build_model``); a checkpoint of another architecture
fails the load, naming its missing keys.
"""

from __future__ import annotations

import logging

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
