"""Split-file NYU/KITTI eval datasets with a synthetic fallback.

Port of the eval half of ``objcavit_tpu/data/dataset.py`` (datasets/NYUD2.py,
datasets/KITTI.py and the path handling of datasets/dataloader.py:96-135):
a split line is ``image_path depth_path focal``, leading slashes are
stripped, and a KITTI eval sample whose GT file is missing is dropped from
``filenames`` and the same index read again, so ``len()`` shrinks during an
epoch. Without the dataset root (no NYU or KITTI data is in the repository)
``make_dataset`` returns ``SyntheticDepthDataset``, seeded by index, with
the same sample contract. The train branches come with the train half of
the data layer.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from objcavit_torch.data import preprocess as pp

# the vendored split files are resolved against the repository root when the
# cwd-relative path of basicParams.yaml is absent
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def remove_leading_slash(s: str) -> str:
    return s[1:] if s and s[0] in ("/", "\\") else s


class DepthDataset:
    """The eval split ('online_eval') of one dataset, from its split file."""

    def __init__(self, args: Any, mode: str):
        if mode != "online_eval":
            raise NotImplementedError(
                f"dataset mode {mode!r} is not ported yet (ROADMAP A.3c); ported: online_eval")
        self.args = args
        self.mode = mode
        self.dataset = args.basic.dataset
        self.dcfg = args[self.dataset]
        split_file = self.dcfg.filenames_file_eval
        if not os.path.isabs(split_file) and not os.path.exists(split_file):
            cand = os.path.join(_REPO_ROOT, split_file)
            if os.path.exists(cand):
                split_file = cand
        with open(split_file, "r") as f:
            self.filenames = [ln for ln in f.read().splitlines() if ln.strip()]

        base = os.path.join(args.paths.data_dir, self.dcfg.base_path)
        if self.dataset == "kitti":
            self.data_path = os.path.join(base, self.dcfg.data_path)
            self.gt_path = os.path.join(base, self.dcfg.gt_path)
        else:
            self.data_path = os.path.join(base, self.dcfg.eval_path)
            self.gt_path = self.data_path

    def __len__(self) -> int:
        return len(self.filenames)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        """{'image' HWC fp32 ImageNet-normalised, 'depth' HW1 fp32 metres,
        'focal', 'image_path', 'depth_path' (as the split line gives them)}."""
        from PIL import Image

        line = self.filenames[idx % len(self.filenames)]
        parts = line.split()
        image_path = os.path.join(self.data_path, remove_leading_slash(parts[0]))
        depth_path = os.path.join(self.gt_path, remove_leading_slash(parts[1]))
        image_u8 = np.asarray(Image.open(image_path).convert("RGB"))
        if not os.path.exists(depth_path):
            # KITTI's missing-GT convention: drop the sample and read the
            # index again (KITTI.py:81-83, dataloader.py:188-192)
            del self.filenames[idx % len(self.filenames)]
            return self.get(idx, rng)
        depth_raw = np.asarray(Image.open(depth_path), dtype=np.float32)
        image, depth = pp.eval_sample(image_u8, depth_raw, self.dcfg.do_kb_crop,
                                      self.dcfg.image_norm_factor, self.dcfg.depth_norm_factor,
                                      normalize=True)
        return {"image": image, "depth": depth, "focal": float(parts[2]),
                "image_path": parts[0], "depth_path": parts[1]}


class SyntheticDepthDataset:
    """Deterministic fake data with the real sample contract; sample i is
    drawn from ``default_rng(i)``, as in the JAX package."""

    def __init__(self, args: Any, mode: str, length: int = 64):
        self.args = args
        self.mode = mode
        self.dataset = args.basic.dataset
        self.dcfg = args[self.dataset]
        self.length = length
        self.use_old_dl = bool(args.basic.get("use_adabins_dataloader"))
        if mode == "train":
            self.dims = tuple(self.dcfg.dimensions_train)
        elif self.dcfg.do_kb_crop:
            self.dims = (352, 1216)
        else:
            self.dims = tuple(self.dcfg.dimensions_test)

    def __len__(self) -> int:
        return self.length

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        h, w = self.dims
        srng = np.random.default_rng(idx)
        image = srng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
        depth = srng.uniform(self.dcfg.min_depth * 2, self.dcfg.max_depth * 0.9,
                             (h, w, 1)).astype(np.float32)
        if self.mode != "train" or self.use_old_dl:
            image = pp.imagenet_normalize(image)
        return {"image": image, "depth": depth, "focal": 518.8579,
                "image_path": f"synthetic/{idx}.jpg", "depth_path": f"synthetic/{idx}.png"}


def make_dataset(args: Any, mode: str):
    """The real dataset if its split file and data root exist, else
    synthetic (64 samples to train, 16 to evaluate)."""
    dcfg = args[args.basic.dataset]
    split_file = dcfg.filenames_file_train if mode == "train" else dcfg.filenames_file_eval
    root = os.path.join(args.paths.data_dir, dcfg.base_path)
    if os.path.exists(split_file) and os.path.isdir(root):
        return DepthDataset(args, mode)
    return SyntheticDepthDataset(args, mode, length=64 if mode == "train" else 16)
