"""Slice 14, the train data: objcavit_torch's train samplers, DepthDataset's
train mode and the loader's shuffle against objcavit_tpu's on the CPU.

The tests write NYU (480x640) and KITTI (375x1242, with the right camera's
paths) frames in the datasets' on-disk layout: random uint8 images and
16-bit depth PNGs. Both packages read them with the same
``np.random.default_rng`` streams, which must stay in step. The port's
samplers run its copy of the C++ host core (``objcavit_torch/data/native.py``),
the JAX package its own where ``csrc/libobjcavit_preprocess.so`` builds
(``native_available()``), so there the samples are equal; where JAX runs
its numpy branches, the native-vs-numpy tolerances of tests/test_native.py
apply, and the tests that hold the port's plain numpy versions state them.
"""

import numpy as np
import pytest
from PIL import Image

from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.data import native
from objcavit_tpu.data.dataset import DepthDataset as JaxDepthDataset
from objcavit_tpu.data.loader import DeviceLoader as JaxDeviceLoader
from objcavit_tpu.data.preprocess import _rotate_bilinear_np, _rotate_nearest_np
from objcavit_tpu.parallel import make_mesh

from objcavit_torch.config import Config
from objcavit_torch.data import preprocess as pp
from objcavit_torch.data.dataset import DepthDataset, make_dataset
from objcavit_torch.data.loader import DeviceLoader
from tests.test_torch_fit import one_torch_thread  # noqa: F401  (a fixture)

TRAIN_DIMS = (64, 96)
# tests/test_native.py's bounds: the C++ bilinear rotate within 1e-4 of
# numpy's on [0, 1] images, the fused augment + normalise within 1e-5 (on
# normalised values, ~4.4x the [0, 1] ones: 5e-5 here). The nearest rotate
# picks another neighbour where a sample point lies within rounding of a
# pixel boundary: 1 of 6144 depth pixels on a KITTI sample (measured), so
# at most 1e-3 of the pixels may differ.
ROTATE_ATOL, AUGMENT_ATOL, NEAREST_MISMATCH = 1e-4, 5e-5, 1e-3


def assert_nearest_close(got, want):
    assert got.shape == want.shape
    assert np.mean(got != want) <= NEAREST_MISMATCH, np.mean(got != want)


def _write_frame(root, image, depth, h, w, rng):
    for rel, arr in ((image, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
                     (depth, rng.integers(1, 20000, (h, w), dtype=np.uint16))):
        if rel is None:
            continue
        path = root / rel.lstrip("/")
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(path)


def train_args(tmp_path, dataset: str, old_dl: bool, n: int = 3, missing_gt: int | None = None,
               **dcfg) -> dict:
    """A config over ``n`` train frames written under ``tmp_path`` (frame
    ``missing_gt`` without its depth file)."""
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    lines = []
    for i in range(n):
        if dataset == "nyu":
            img, dep = f"/kitchen_{i}/rgb_{i:05d}.jpg", f"/kitchen_{i}/sync_depth_{i:05d}.png"
            _write_frame(data / "nyu" / "sync", img, None if i == missing_gt else dep, 480, 640,
                         rng)
            lines.append(f"{img} {dep} 518.8579")
        else:
            left = (f"2011_09_26/d/image_02/data/{i:010d}.png",
                    f"2011_09_26_drive/proj_depth/groundtruth/image_02/{i:010d}.png")
            right = (f"2011_09_26/d/image_03/data/{i:010d}.png",
                     f"2011_09_26_drive/proj_depth/groundtruth/image_03/{i:010d}.png")
            for img, dep in (left, right):
                _write_frame(data / "kitti" / "raw", img, None, 375, 1242, rng)
                if i != missing_gt:
                    _write_frame(data / "kitti" / "gt", None, dep, 375, 1242, rng)
            lines.append(f"{left[0]} {left[1]} 721.5377 {right[0]} {right[1]}")
    split = tmp_path / f"{dataset}_train.txt"
    split.write_text("\n".join(lines) + "\n")
    base = {"nyu": {"base_path": "nyu", "train_path": "sync", "depth_norm_factor": 1000.0,
                    "do_kb_crop": False, "degree": 2.5},
            "kitti": {"base_path": "kitti", "data_path": "raw", "gt_path": "gt",
                      "depth_norm_factor": 256.0, "do_kb_crop": True, "degree": 1.0,
                      "use_right": True}}[dataset]
    return {"basic": {"dataset": dataset, "use_adabins_dataloader": old_dl},
            "paths": {"data_dir": str(data)},
            dataset: {**base, "filenames_file_train": str(split), "image_norm_factor": 255.0,
                      "min_depth": 0.001, "max_depth": 80.0, "do_random_rotate": True,
                      "dimensions_train": list(TRAIN_DIMS), "dimensions_test": [64, 96],
                      **dcfg}}


@pytest.mark.parametrize("old_dl", [True, False], ids=["old_dl", "new"])
@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_train_samples_match_jax(tmp_path, dataset, old_dl):
    """Three train samples of each sampler, read twice each with one
    stream per package: NYU with its boundary crop and rotate, KITTI with
    the kb crop, the rotate and the right camera drawn per line. The images
    agree within the native-vs-numpy bound (old_dl: the fused augment,
    AUGMENT_ATOL; new: the bilinear rotate, ROTATE_ATOL); the depths exactly
    (old_dl: PIL's rotate on both sides) or but NEAREST_MISMATCH of them
    (new: the nearest rotate); the paths exactly; the streams end in step.
    Where JAX runs its C++ core (``native_available()``), the port's runs
    the same code: images and depths equal bit for bit."""
    cfg = train_args(tmp_path, dataset, old_dl)
    ds, jds = DepthDataset(Config(cfg), "train"), JaxDepthDataset(JaxConfig(cfg), "train")
    assert isinstance(make_dataset(Config(cfg), "train"), DepthDataset)
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    atol = AUGMENT_ATOL if old_dl else ROTATE_ATOL
    same_core = native.native_available()
    for idx in (0, 1, 2, 0, 1, 2):
        s, w = ds.get(idx, rng), jds.get(idx, jrng)
        assert s["image"].shape == (*TRAIN_DIMS, 3) and s["depth"].shape == (*TRAIN_DIMS, 1)
        if same_core:
            np.testing.assert_array_equal(s["image"], w["image"])
        else:
            np.testing.assert_allclose(s["image"], w["image"], atol=atol, rtol=0)
        if old_dl or same_core:
            np.testing.assert_array_equal(s["depth"], w["depth"])
        else:
            assert_nearest_close(s["depth"], w["depth"])
        assert (s["focal"], s["image_path"], s["depth_path"]) == (
            w["focal"], w["image_path"], w["depth_path"])
    assert rng.random() == jrng.random()


def test_old_dl_train_sample_is_normalised_and_new_is_not(tmp_path):
    """old_dl normalises on the host (ImageNet statistics: values below 0);
    the new sampler leaves [0, 1] for the card's augmentation."""
    old = DepthDataset(Config(train_args(tmp_path / "a", "nyu", True)), "train")
    new = DepthDataset(Config(train_args(tmp_path / "b", "nyu", False)), "train")
    a = old.get(0, np.random.default_rng(0))["image"]
    b = new.get(0, np.random.default_rng(0))["image"]
    assert a.min() < 0 and 0.0 <= b.min() and b.max() <= 1.0


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_a_train_sample_without_its_gt_raises(tmp_path, dataset):
    """A train frame without its depth file raises FileNotFoundError in both
    packages (an eval frame is dropped instead)."""
    cfg = train_args(tmp_path, dataset, True, n=2, missing_gt=1)
    with pytest.raises(FileNotFoundError, match="missing train GT"):
        DepthDataset(Config(cfg), "train").get(1, np.random.default_rng(0))
    with pytest.raises(FileNotFoundError, match="missing train GT"):
        JaxDepthDataset(JaxConfig(cfg), "train").get(1, np.random.default_rng(0))


def test_rotations_match_jax_numpy_and_native():
    """The port's rotations against JAX's numpy branches, exactly, and
    against its C++ core: bilinear within ROTATE_ATOL, nearest but
    NEAREST_MISMATCH of the pixels."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    for angle in (-2.5, 0.7, 1.9):
        np.testing.assert_array_equal(pp.rotate_bilinear(img, angle),
                                      _rotate_bilinear_np(img, angle))
        np.testing.assert_array_equal(pp.rotate_nearest(img, angle),
                                      _rotate_nearest_np(img, angle))
        np.testing.assert_allclose(pp.rotate_bilinear(img, angle),
                                   native.rotate_bilinear(img, angle), atol=ROTATE_ATOL)
        assert_nearest_close(pp.rotate_nearest(img, angle), native.rotate_nearest(img, angle))


def test_augment_normalize_matches_jax_native():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
    c3 = rng.uniform(0.9, 1.1, 3).astype(np.float32)
    for flip, aug in ((True, True), (False, True), (True, False), (False, False)):
        np.testing.assert_allclose(pp.augment_normalize(img, flip, aug, 1.05, 1.1, c3),
                                   native.augment_normalize(img, flip, aug, 1.05, 1.1, c3),
                                   atol=AUGMENT_ATOL, rtol=0)


# --------------------------------------------------------------------- loader

class _Indexed:
    """Sample i is an image of i plus one draw of the loader's stream."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        v = idx + rng.random()
        return {"image": np.full((2, 2, 3), v, np.float32),
                "depth": np.full((2, 2, 1), idx, np.float32), "focal": 1.0,
                "image_path": f"{idx}.png", "depth_path": f"{idx}.png"}


@pytest.mark.parametrize("n", [20, 15, 16], ids=["pad_final", "pad_one", "full_batches"])
def test_loader_order_padding_and_sample_valid_match_jax(n):
    """n samples at batch size 8, shuffled with seed 42, over two epochs:
    each batch's samples (the index and the stream's draw), its
    sample_valid and the batch count equal JAX's DeviceLoader's. A short
    final batch is padded with the epoch's first samples (4 of them at 20,
    1 at 15); 16 fill two batches."""
    loader = DeviceLoader(_Indexed(n), 8, "cpu", shuffle=True, seed=42, synchronous=True)
    jloader = JaxDeviceLoader(_Indexed(n), 8, make_mesh(), shuffle=True, seed=42,
                              synchronous=True)
    assert len(loader) == len(jloader) == -(-n // 8)
    for _epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for (b, meta), (jb, jmeta) in zip(got, want):
            np.testing.assert_array_equal(b["image"].numpy(), np.asarray(jb["image"]))
            np.testing.assert_array_equal(b["sample_valid"].numpy(),
                                          np.asarray(jb["sample_valid"]))
            assert meta["image_path"] == jmeta["image_path"]
        real = n - 8 * (len(got) - 1)
        last, meta = got[-1]
        assert last["sample_valid"].tolist() == [True] * real + [False] * (8 - real)
        assert meta["image_path"][real:] == got[0][1]["image_path"][:8 - real]
