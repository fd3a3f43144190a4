"""Checkpoints: last and best by abs_rel, in the reference's Lightning layout.

Port of ``objcavit_tpu/training/checkpoint.py``, after the reference's
ModelCheckpoint(monitor='metrics/abs_rel', save_last=True, save_top_k=1,
mode='min') (main.py:120) and its hparams.yaml, whose ``args:`` layout
``config.load_args`` reads (main.py:162-163). ``checkpoints/last.ckpt``
and ``best.ckpt`` are ``torch.save`` files laid out as a Lightning
checkpoint: ``state_dict`` under ``model.`` keys, beside
``optimizer_states``, ``lr_schedulers`` and ``global_step``. So one loader
(``utils/torch_import.py``) reads a reference checkpoint and the port's, the
reference's ``*last.ckpt`` rule (``config.get_latest_checkpoint``) finds
them, and the JAX package's ``restore_checkpoint`` reads them too. The best
metric lives in ``checkpoints/meta.json``, written atomically, so a
restarted run does not let a worse validation replace ``best.ckpt``. The
SWA average's save and restore come with ``fit``.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn as nn

from objcavit_torch.config import Config, save_config
from objcavit_torch.utils.torch_import import MODEL_PREFIX, load_torch_checkpoint


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def checkpoint_dict(model: nn.Module, optimizer=None, scheduler=None, step: int = 0) -> dict:
    """The Lightning layout of a model (and its optimizer and scheduler)."""
    ckpt = {"state_dict": {MODEL_PREFIX + k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "global_step": int(step)}
    if optimizer is not None:
        ckpt["optimizer_states"] = [optimizer.state_dict()]
    if scheduler is not None:
        ckpt["lr_schedulers"] = [scheduler.state_dict()]
    return ckpt


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.best_metric = float(self._meta().get("best_metric", float("inf")))

    def _meta_path(self) -> str:
        return os.path.join(self.ckpt_dir, "meta.json")

    def _meta(self) -> dict:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_meta(self, **updates) -> None:
        # atomic: a truncated meta.json would read as {} and reset the best
        # metric to inf, letting a worse validation replace best.ckpt
        meta = {**self._meta(), **updates}
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def save_hparams(self, args: Config) -> None:
        save_config(Config({"args": args.to_dict()}), os.path.join(self.run_dir, "hparams.yaml"))

    def save(self, model: nn.Module, optimizer=None, scheduler=None, step: int = 0,
             abs_rel: float | None = None) -> None:
        """``last.ckpt`` always; ``best.ckpt`` when ``abs_rel`` beats the best so far."""
        ckpt = checkpoint_dict(model, optimizer, scheduler, step)
        _save_atomic(ckpt, os.path.join(self.ckpt_dir, "last.ckpt"))
        if abs_rel is not None and abs_rel < self.best_metric:
            self.best_metric = float(abs_rel)
            _save_atomic(ckpt, os.path.join(self.ckpt_dir, "best.ckpt"))
            self._write_meta(best_metric=float(abs_rel))


def restore_checkpoint(path: str, model: nn.Module, optimizer=None, scheduler=None) -> int:
    """Load a ``.ckpt`` (the reference's or the port's) into ``model`` and,
    where the checkpoint has them, into ``optimizer`` and ``scheduler``;
    returns its step (0 for a checkpoint without one)."""
    ckpt = load_torch_checkpoint(path, model)
    if optimizer is not None and ckpt.get("optimizer_states"):
        optimizer.load_state_dict(ckpt["optimizer_states"][0])
    if scheduler is not None and ckpt.get("lr_schedulers"):
        scheduler.load_state_dict(ckpt["lr_schedulers"][0])
    return int(ckpt.get("global_step", 0))
