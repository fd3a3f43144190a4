"""Split-file NYU/KITTI datasets with a synthetic fallback.

Port of ``objcavit_tpu/data/dataset.py`` (datasets/NYUD2.py,
datasets/KITTI.py and the path handling of datasets/dataloader.py:96-135):
a split line is ``image_path depth_path focal`` (a KITTI train line adds the
right camera's paths at 3 and 4), leading slashes are stripped. A train
sample runs the old_dl or the new sampler (``basic.use_adabins_dataloader``,
``preprocess.py``) with the loader's generator, KITTI's ``use_right`` drawn
first; a train sample without its GT file raises. A KITTI eval sample whose
GT file is missing is dropped from ``filenames`` and the same index read
again, so ``len()`` shrinks during an epoch. Without the dataset root (no
NYU or KITTI data is in the repository) ``make_dataset`` returns
``SyntheticDepthDataset``, seeded by index, with the same sample contract.
On the old_dl train path the loader reads whole batches
(``DepthDataset.get_batch``, JAX's): every draw first, in the per-sample
order, then decode and stage A in ``decode_threads`` threads, then the
host core's one threaded pass for the crops, the tail and the stack; the
batch is that of repeated ``get`` calls bit for bit. Elsewhere it reads
sample by sample.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from objcavit_torch.data import native
from objcavit_torch.data import preprocess as pp

# the vendored split files are resolved against the repository root when the
# cwd-relative path of basicParams.yaml is absent
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def remove_leading_slash(s: str) -> str:
    return s[1:] if s and s[0] in ("/", "\\") else s


class DepthDataset:
    """One split ('train' or 'online_eval') of one dataset, from its split file."""

    def __init__(self, args: Any, mode: str):
        if mode not in ("train", "online_eval"):
            raise ValueError(f"dataset mode {mode!r}: want 'train' or 'online_eval'")
        self.args = args
        self.mode = mode
        self.dataset = args.basic.dataset
        self.dcfg = args[self.dataset]
        self.use_old_dl = bool(args.basic.get("use_adabins_dataloader"))
        split_file = (self.dcfg.filenames_file_train if mode == "train"
                      else self.dcfg.filenames_file_eval)
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
            sub = self.dcfg.train_path if mode == "train" else self.dcfg.eval_path
            self.data_path = os.path.join(base, sub)
            self.gt_path = self.data_path
        self.train_dims = tuple(self.dcfg.dimensions_train)
        # get_batch's decode and stage-A threads; None: one a host core (PNG
        # decode is most of the host's cost a batch)
        self.decode_threads: int | None = None

    def __len__(self) -> int:
        return len(self.filenames)

    def _paths(self, line: str, rng: np.random.Generator):
        parts = line.split()
        # KITTI's right camera: drawn for every train line, used where the
        # line has its paths
        use_right = (self.mode == "train" and self.dataset == "kitti"
                     and self.dcfg.get("use_right") is True and rng.random() > 0.5)
        i_img, i_dep = (3, 4) if use_right and len(parts) > 4 else (0, 1)
        image_path = os.path.join(self.data_path, remove_leading_slash(parts[i_img]))
        depth_path = os.path.join(self.gt_path, remove_leading_slash(parts[i_dep]))
        return image_path, depth_path, float(parts[2])

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        """{'image' HWC fp32, 'depth' HW1 fp32 metres, 'focal', 'image_path',
        'depth_path' (as the split line gives them)}. A train image comes out
        ready for the card: ImageNet-normalised on the old_dl path, [0, 1]
        on the new one (the card augments and normalises); an eval image is
        normalised."""
        from PIL import Image

        line = self.filenames[idx % len(self.filenames)]
        image_path, depth_path, focal = self._paths(line, rng)
        image_u8 = np.asarray(Image.open(image_path).convert("RGB"))
        if not os.path.exists(depth_path):
            if self.mode == "train":
                raise FileNotFoundError(f"missing train GT: {depth_path}")
            # KITTI's missing-GT convention: drop the sample and read the
            # index again (KITTI.py:81-83, dataloader.py:188-192)
            del self.filenames[idx % len(self.filenames)]
            return self.get(idx, rng)
        depth_raw = np.asarray(Image.open(depth_path), dtype=np.float32)
        dcfg = self.dcfg
        if self.mode == "train" and self.use_old_dl:
            image, depth = pp.old_dl_train_sample(
                image_u8, depth_raw, self.dataset, dcfg.do_kb_crop, dcfg.do_random_rotate,
                dcfg.degree, self.train_dims, dcfg.depth_norm_factor, rng)
        elif self.mode == "train":
            image, depth = pp.new_train_sample(
                image_u8, depth_raw, self.dataset, dcfg.do_kb_crop, dcfg.do_random_rotate,
                dcfg.degree, self.train_dims, dcfg.image_norm_factor, dcfg.depth_norm_factor,
                rng)
        else:
            image, depth = pp.eval_sample(image_u8, depth_raw, dcfg.do_kb_crop,
                                          dcfg.image_norm_factor, dcfg.depth_norm_factor,
                                          normalize=True)
        parts = line.split()
        return {"image": image, "depth": depth, "focal": focal,
                "image_path": parts[0], "depth_path": parts[1]}

    def _read_train_frame(self, image_path: str, depth_path: str):
        """A train frame's uint8 image and raw depth; no GT file raises, as
        ``get`` does."""
        from PIL import Image

        image_u8 = np.asarray(Image.open(image_path).convert("RGB"))
        if not os.path.exists(depth_path):
            raise FileNotFoundError(f"missing train GT: {depth_path}")
        return image_u8, np.asarray(Image.open(depth_path), dtype=np.float32)

    def get_batch(self, idxs, rng: np.random.Generator):
        """The old_dl train path's batch of ``idxs`` -> ``(batch, meta)``
        ('image', 'depth' stacked; 'focal', 'image_path', 'depth_path'
        lists), or None elsewhere (the loader then calls ``get``). Stage A
        runs per sample, then one pass of the host core crops, augments,
        normalises and stacks (``native.assemble_batch``). The draws keep
        the order of repeated ``get`` calls, so the batch is theirs bit for
        bit. Where stage A's shape does not depend on the frame (NYU, the kb
        crop) and ``decode_threads`` allows more than one, every draw is
        made first and decode and stage A run in a thread pool
        (``_get_batch_parallel``)."""
        if not (self.mode == "train" and self.use_old_dl):
            return None
        n_threads = self.decode_threads or (os.cpu_count() or 1)
        shape_a = pp.old_dl_stage_a_static_shape(self.dataset, self.dcfg.do_kb_crop)
        if n_threads > 1 and len(idxs) > 1 and shape_a is not None:
            return self._get_batch_parallel(idxs, rng, shape_a, n_threads)
        dcfg = self.dcfg
        images, depths, augs, metas = [], [], [], []
        for idx in idxs:
            line = self.filenames[int(idx) % len(self.filenames)]
            image_path, depth_path, focal = self._paths(line, rng)
            image_u8, depth_raw = self._read_train_frame(image_path, depth_path)
            img, dep = pp.old_dl_stage_a(image_u8, depth_raw, self.dataset, dcfg.do_kb_crop,
                                         dcfg.do_random_rotate, dcfg.degree,
                                         dcfg.depth_norm_factor, rng)
            augs.append(pp.old_dl_draw_aug(self.dataset, img.shape, self.train_dims, rng))
            images.append(img)
            depths.append(dep)
            metas.append((focal, *line.split()[:2]))
        return self._assemble(images, depths, augs, metas)

    def _get_batch_parallel(self, idxs, rng: np.random.Generator, shape_a: tuple[int, int],
                            n_threads: int):
        """One serial pass of the draws (each sample's path, angle and
        stage-B draws, in ``get``'s order), then decode and stage A in
        ``n_threads`` threads: PIL's decode and rotate and numpy's casts
        release the GIL. A frame whose stage-A shape is not ``shape_a``
        raises ValueError: its crop was drawn for that shape."""
        dcfg = self.dcfg
        specs, augs, metas = [], [], []
        for idx in idxs:
            line = self.filenames[int(idx) % len(self.filenames)]
            image_path, depth_path, focal = self._paths(line, rng)
            # the draw old_dl_stage_a makes
            angle = (rng.random() - 0.5) * 2 * dcfg.degree if dcfg.do_random_rotate else None
            augs.append(pp.old_dl_draw_aug(self.dataset, shape_a, self.train_dims, rng))
            specs.append((image_path, depth_path, angle))
            metas.append((focal, *line.split()[:2]))

        def load(spec):
            image_path, depth_path, angle = spec
            image_u8, depth_raw = self._read_train_frame(image_path, depth_path)
            img, dep = pp.old_dl_stage_a_apply(image_u8, depth_raw, self.dataset,
                                               dcfg.do_kb_crop, angle, dcfg.depth_norm_factor)
            if img.shape[:2] != shape_a:
                raise ValueError(
                    f"{image_path}: stage A gives {img.shape[:2]}, not {shape_a}: a "
                    f"non-standard source resolution; set the dataset's decode_threads to 1")
            return img, dep

        with ThreadPoolExecutor(n_threads) as ex:
            loaded = list(ex.map(load, specs))
        return self._assemble([a for a, _ in loaded], [d for _, d in loaded], augs, metas)

    def _assemble(self, images: list, depths: list, augs: list, metas: list):
        h, w = self.train_dims
        out_imgs, out_deps = native.assemble_batch(
            images, depths, np.asarray([a["crop_yx"] for a in augs], np.int32),
            np.asarray([a["flip"] for a in augs]), np.asarray([a["do_augment"] for a in augs]),
            np.asarray([a["gamma"] for a in augs], np.float32),
            np.asarray([a["brightness"] for a in augs], np.float32),
            np.stack([a["colors"] for a in augs]), h, w)
        meta = {k: [m[i] for m in metas]
                for i, k in enumerate(("focal", "image_path", "depth_path"))}
        return {"image": out_imgs, "depth": out_deps}, meta


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
