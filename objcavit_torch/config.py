"""Config tree and the reference CLI's argument rules.

The port's own copy of ``objcavit_tpu/config.py`` (yaml only). The
reference reads OmegaConf YAML trees as ``args.basic.dataset`` and
``args[args.model.name]`` (main.py:161-186, misc_utils.py:10-50).
``Config`` is a small dict wrapper with that access surface (attributes,
items, ``get``, ``in``, ``keys``), which reads the reference's params files
unchanged, with the ``args:`` unwrap of a saved hparams.yaml
(main.py:162-163).

``check_and_validate_args`` is misc_utils.py:10-50: the name defaults to
the config file's, the required sections are checked, an eval run finds the
newest ``*last.ckpt`` under the run dir, and the nyu/kitti sections come
from params/basicParams.yaml.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterator

import yaml


class Config:
    """Attribute and item access over a nested dict (OmegaConf-alike)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self[k] = v

    def __getattr__(self, key: str):
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value):
        self[key] = value

    def __getitem__(self, key: str):
        return self._data[key]

    def __setitem__(self, key: str, value):
        if isinstance(value, dict):
            value = Config(value)
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def setdefault(self, key: str, value):
        if key not in self._data:
            self[key] = value
        return self._data[key]

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self._data.items()}

    def merge(self, other: "Config | dict") -> None:
        """Deep merge ``other`` into self (other wins)."""
        for k, v in other.items():
            if k in self._data and isinstance(self._data[k], Config) and isinstance(v, (Config, dict)):
                self._data[k].merge(v)
            else:
                self[k] = v.to_dict() if isinstance(v, Config) else v


def load_config(path: str | Path) -> Config:
    with open(path, "r", encoding="utf-8") as f:
        return Config(yaml.safe_load(f) or {})


def save_config(cfg: Config, path: str | Path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def apply_dotlist(cfg: Config, overrides: list[str]) -> None:
    """OmegaConf-style 'a.b.c=value' overrides."""
    for item in overrides:
        key, _, raw = item.partition("=")
        value = yaml.safe_load(raw)
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value


def get_latest_checkpoint(args: Config, directory: str | None = None) -> str:
    """The newest '*last.ckpt' file under the run dir (misc_utils.py:62-72)."""
    dir_to_check = (directory if directory is not None
                    else os.path.join(args.paths.run_dir, args.basic.name))
    candidates = [p for p in Path(dir_to_check).rglob("*last.ckpt") if p.is_file()]
    if not candidates:
        sys.exit("Error: no checkpoints found for this parameter file.")
    return str(max(candidates, key=lambda p: p.stat().st_ctime))


def check_and_validate_args(args: Config,
                            basic_params_path: str = "params/basicParams.yaml") -> Config:
    """The reference's misc_utils.check_and_validate_args."""
    if "name" not in args.basic or args.basic.get("name") in (None, "None", "none", ""):
        args.basic.name = os.path.splitext(os.path.basename(args.config_file))[0]

    for key in ("basic", "paths", "loss", "hardware"):
        if key not in args:
            raise ValueError(f"config {args.config_file} has no '{key}' section")
    if args.basic.dataset not in args:
        raise ValueError(f"config {args.config_file} has no '{args.basic.dataset}' section")

    if args.get("validate") or args.get("inference"):
        from_hparams = os.path.basename(args.config_file) == "hparams.yaml"
        if args.basic.get("val_checkpoint") is None:
            args.basic.val_checkpoint = get_latest_checkpoint(
                args, directory=os.path.dirname(args.config_file) if from_hparams else None)
        if from_hparams:
            args.val_output_dir = os.path.dirname(args.config_file)
        else:
            args.val_output_dir = os.path.dirname(os.path.dirname(args.basic.val_checkpoint))
        if args.get("inference"):
            args.predict_output_dir = os.path.join(args.val_output_dir, "predict_output")
            os.makedirs(args.predict_output_dir, exist_ok=True)
        # the dataset sections always come from basicParams (misc_utils.py:41-48)
        if os.path.exists(basic_params_path):
            override = load_config(basic_params_path)
            args.nyu = override.nyu
            args.kitti = override.kitti
    return args


def load_args(config_file: str, **cli_flags) -> Config:
    """Load a params file as main.py does, with the hparams.yaml unwrap."""
    args = load_config(config_file)
    if "args" in args:
        args = args.args  # a saved hparams.yaml nests everything under 'args'
    args.config_file = config_file
    for k, v in cli_flags.items():
        args[k] = v
    return args
