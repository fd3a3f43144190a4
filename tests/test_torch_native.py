"""Slice 18, the host core and profiling: objcavit_torch's C++ preprocess
core (``data/native.py``, built by ``kernels/build.py::build_host``), the
old_dl train path's ``DepthDataset.get_batch`` and its threaded decode, the
loader over it, and ``utils/profiling.py``, against objcavit_tpu's on the
CPU.

The port's core is a copy of the JAX package's ``csrc/preprocess.cpp``
built with the same compiler and flags, so where the JAX package's core
builds (``native_available()``) every entry point must give its bits;
else (JAX on its numpy branches) tests/test_native.py's bounds apply. Each
entry point is also held against the port's plain numpy version at those
bounds: bilinear 1e-4 and the augment 1e-5 on [0, 1] values (5e-5 on
ImageNet-normalised ones, ~4.4x), nearest with at most 1e-3 of the pixels
moved (a sample point within rounding of a pixel boundary), ``hflip`` and
the crops exact. Frames are written by tests/test_torch_train_data.py's
``train_args``: NYU 480x640 and KITTI 375x1242 (with the right camera).
"""

import os

import numpy as np
import pytest
import torch

from objcavit_tpu.config import Config as JaxConfig
from objcavit_tpu.data import native as jax_native
from objcavit_tpu.data.dataset import DepthDataset as JaxDepthDataset
from objcavit_tpu.data.loader import DeviceLoader as JaxDeviceLoader
from objcavit_tpu.parallel import make_mesh

from objcavit_torch.config import Config
from objcavit_torch.data import native
from objcavit_torch.data import preprocess as pp
from objcavit_torch.data.dataset import DepthDataset
from objcavit_torch.data.loader import DeviceLoader
from objcavit_torch.kernels import build
from objcavit_torch.utils import profiling
from tests.test_torch_train_data import TRAIN_DIMS, train_args

ROTATE_ATOL, AUGMENT_ATOL, NORMALISED_ATOL, NEAREST_MISMATCH = 1e-4, 1e-5, 5e-5, 1e-3


@pytest.fixture(scope="module")
def jax_core() -> bool:
    """Whether the JAX package runs its C++ core here (then the port's
    entry points must give its bits) or its numpy branches."""
    return jax_native.native_available()


def assert_core_equal(got, want, jax_core: bool, atol: float, nearest: bool = False):
    """``got`` (the port's core) against ``want`` (the JAX package's entry
    point): bit for bit where JAX ran its core, else within the bound."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if jax_core:
        np.testing.assert_array_equal(got, want)
    elif nearest:
        assert np.mean(got != want) <= NEAREST_MISMATCH
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def batch_inputs(n=5, hw=(40, 60), out=(24, 32), seed=7):
    """tests/test_native.py's assemble_batch inputs: ``n`` images and
    depths of ``hw``, crops of ``out``, and the per-sample draws."""
    rng = np.random.default_rng(seed)
    (H, W), (h, w) = hw, out
    images = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(n)]
    depths = [rng.uniform(0, 9, (H, W, 1)).astype(np.float32) for _ in range(n)]
    crops = np.stack([rng.integers(0, (H - h + 1, W - w + 1), 2) for _ in range(n)]).astype(
        np.int32)
    draws = (rng.uniform(size=n) > 0.5, rng.uniform(size=n) > 0.5,
             rng.uniform(0.9, 1.1, n).astype(np.float32),
             rng.uniform(0.75, 1.25, n).astype(np.float32),
             rng.uniform(0.9, 1.1, (n, 3)).astype(np.float32))
    return images, depths, crops, draws, h, w


# ----------------------------------------------------------------- the build

def test_the_core_builds_with_gpp_and_rebuilds_on_another_cpu(tmp_path, monkeypatch):
    """build_host compiles csrc/preprocess.cpp with the JAX Makefile's flags
    into the given path and leaves only the library and its stamp there; it
    builds nothing while the stamp matches, and builds again where the host
    CPU differs (``-march=native``) or the stamp does."""
    monkeypatch.delenv("CXX", raising=False)
    lib = tmp_path / "_build" / "libobjcavit_preprocess.so"
    line = build.build_host(lib)
    assert line.split() == ["g++", *build.HOST_CXX_FLAGS, "-o", str(lib), str(build.HOST_SOURCE)]
    stamp = lib.with_suffix(".sha256")
    assert set(os.listdir(lib.parent)) == {lib.name, stamp.name}
    assert build.build_host(lib) == ""
    assert build.host_cpu()
    monkeypatch.setattr(build, "host_cpu", lambda: "another CPU")
    assert build.build_host(lib) == line and build.build_host(lib) == ""
    stamp.write_text("a stamp of another source")
    assert build.build_host(lib) == line


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"], ids=["missing", "failing"])
def test_a_failing_compiler_raises_and_nothing_falls_back(tmp_path, monkeypatch, cxx):
    """With CXX pointed at a missing binary, or at one that fails, the
    build raises RuntimeError naming the compiler line, writes no library,
    and the entry points raise too: no numpy fallback."""
    lib = tmp_path / "libobjcavit_preprocess.so"
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(build, "HOST_LIB_PATH", lib)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="the host core's compiler"):
            build.build_host()
        assert not lib.exists()
        with pytest.raises(RuntimeError, match=cxx):
            native.rotate_bilinear(np.zeros((4, 4, 3), np.float32), 1.0)
    finally:
        native.library.cache_clear()


# ------------------------------------------------------ the core's entry points

@pytest.mark.parametrize("angle", [-2.5, 0.0, 1.3, 0.7])
def test_rotations_match_jax_core_and_the_plain_versions(jax_core, angle):
    """Both rotations against the JAX package's, and against the port's
    plain numpy versions: bilinear within 1e-4, nearest but 1e-3 of the
    pixels."""
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    dep = rng.uniform(0, 10, (37, 53, 1)).astype(np.float32)
    bil, near = native.rotate_bilinear(img, angle), native.rotate_nearest(dep, angle)
    assert_core_equal(bil, jax_native.rotate_bilinear(img, angle), jax_core, ROTATE_ATOL)
    assert_core_equal(near, jax_native.rotate_nearest(dep, angle), jax_core, 0, nearest=True)
    np.testing.assert_allclose(bil, pp.rotate_bilinear(img, angle), atol=ROTATE_ATOL, rtol=0)
    assert np.mean(near != pp.rotate_nearest(dep, angle)) <= NEAREST_MISMATCH


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("do_augment", [True, False])
@pytest.mark.parametrize("do_normalize", [True, False])
def test_augment_normalize_matches_jax_core_and_the_plain_version(jax_core, flip, do_augment,
                                                                  do_normalize):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
    before = img.copy()
    c3 = rng.uniform(0.9, 1.1, 3).astype(np.float32)
    args = (img, flip, do_augment, 1.05, 1.1, c3, do_normalize)
    got = native.augment_normalize(*args)
    np.testing.assert_array_equal(img, before)  # a new array; the input stays
    atol = NORMALISED_ATOL if do_normalize else AUGMENT_ATOL
    assert_core_equal(got, jax_native.augment_normalize(*args), jax_core, atol)
    np.testing.assert_allclose(got, pp.augment_normalize(*args), atol=atol, rtol=0)


def test_hflip_matches_jax_core_and_numpy():
    img = np.random.default_rng(2).uniform(0, 1, (7, 9, 4)).astype(np.float32)
    got = native.hflip(img)
    np.testing.assert_array_equal(got, img[:, ::-1])
    np.testing.assert_array_equal(got, jax_native.hflip(img))
    np.testing.assert_array_equal(native.hflip(got), img)


@pytest.mark.parametrize("n_threads", [1, 3, None])
@pytest.mark.parametrize("do_normalize", [True, False])
def test_assemble_batch_matches_per_sample_and_jax(jax_core, n_threads, do_normalize):
    """The threaded batch pass against the core's per-sample path (crop,
    ``augment_normalize``, the depth's flip, stack) bit for bit, against the
    port's plain ``assemble_batch`` within the augment's bound (the depths
    exactly), and against the JAX package's."""
    images, depths, crops, draws, h, w = batch_inputs()
    got_i, got_d = native.assemble_batch(images, depths, crops, *draws, h, w,
                                         n_threads=n_threads, do_normalize=do_normalize)
    assert got_i.shape == (5, h, w, 3) and got_d.shape == (5, h, w, 1)
    flips, augs, gammas, brights, colors = draws
    want_i, want_d = [], []
    for i in range(len(images)):
        y, x = crops[i]
        want_i.append(native.augment_normalize(images[i][y:y + h, x:x + w], flips[i], augs[i],
                                               gammas[i], brights[i], colors[i], do_normalize))
        dep = depths[i][y:y + h, x:x + w]
        want_d.append(native.hflip(dep) if flips[i] else dep)
    np.testing.assert_array_equal(got_i, np.stack(want_i))
    np.testing.assert_array_equal(got_d, np.stack(want_d))
    plain_i, plain_d = pp.assemble_batch(images, depths, crops, *draws, h, w,
                                         do_normalize=do_normalize)
    atol = NORMALISED_ATOL if do_normalize else AUGMENT_ATOL
    np.testing.assert_allclose(got_i, plain_i, atol=atol, rtol=0)
    np.testing.assert_array_equal(got_d, plain_d)
    jax_i, jax_d = jax_native.assemble_batch(images, depths, crops, *draws, h, w,
                                             n_threads=n_threads, do_normalize=do_normalize)
    assert_core_equal(got_i, jax_i, jax_core, atol)
    np.testing.assert_array_equal(got_d, jax_d)


def test_the_core_checks_what_it_is_given():
    """Shapes and crops are checked in Python before a pointer is passed."""
    images, depths, crops, draws, h, w = batch_inputs(n=2)
    with pytest.raises(ValueError, match="crop"):
        native.assemble_batch(images, depths, crops + 100, *draws, h, w)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native.augment_normalize(np.zeros((4, 4, 1), np.float32), True, True, 1.0, 1.0,
                                 np.ones(3, np.float32))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        native.rotate_bilinear(np.zeros((4, 4), np.float32), 1.0)


# ------------------------------------------------------------- get_batch

def _datasets(cfg: dict, mode: str = "train"):
    return DepthDataset(Config(cfg), mode), JaxDepthDataset(JaxConfig(cfg), mode)


@pytest.mark.parametrize("decode_threads", [1, 4], ids=["serial", "parallel"])
@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_get_batch_matches_serial_get_and_jax(tmp_path, jax_core, dataset, decode_threads):
    """get_batch on the old_dl train path (NYU's boundary crop, KITTI's kb
    crop with the right camera drawn per line, PIL's rotate), serially or
    with 4 decode threads: the batch equals repeated ``get`` calls on the
    same stream bit for bit, and JAX's get_batch of the same seed; the
    metadata equal, the streams end in step."""
    assert jax_core, "JAX's get_batch needs its core (tests/test_native.py builds it)"
    ds, jds = _datasets(train_args(tmp_path, dataset, True))
    ds.decode_threads = jds.decode_threads = decode_threads
    idxs = np.array([0, 1, 2, 1])
    batch, meta = ds.get_batch(idxs, rng := np.random.default_rng(11))
    assert batch["image"].shape == (4, *TRAIN_DIMS, 3)
    assert batch["depth"].shape == (4, *TRAIN_DIMS, 1)
    serial_rng = np.random.default_rng(11)
    samples = [ds.get(int(i), serial_rng) for i in idxs]
    np.testing.assert_array_equal(batch["image"], np.stack([s["image"] for s in samples]))
    np.testing.assert_array_equal(batch["depth"], np.stack([s["depth"] for s in samples]))
    assert meta == {k: [s[k] for s in samples] for k in ("focal", "image_path", "depth_path")}
    jbatch, jmeta = jds.get_batch(idxs, jrng := np.random.default_rng(11))
    np.testing.assert_array_equal(batch["image"], jbatch["image"])
    np.testing.assert_array_equal(batch["depth"], jbatch["depth"])
    assert meta == jmeta
    assert rng.random() == serial_rng.random() == jrng.random()


def test_get_batch_serves_only_the_old_dl_train_path(tmp_path):
    """The new sampler and the eval split read sample by sample, as in JAX."""
    new, _ = _datasets(train_args(tmp_path / "new", "nyu", False))
    assert new.get_batch([0, 1], np.random.default_rng(0)) is None
    cfg = train_args(tmp_path / "eval", "nyu", True)
    cfg["nyu"].update(filenames_file_eval=cfg["nyu"]["filenames_file_train"], eval_path="sync")
    evaluation, _ = _datasets(cfg, "online_eval")
    assert evaluation.get_batch([0, 1], np.random.default_rng(0)) is None


@pytest.mark.parametrize("decode_threads", [1, 4], ids=["serial", "parallel"])
def test_get_batch_without_a_gt_file_raises(tmp_path, decode_threads):
    ds, _ = _datasets(train_args(tmp_path, "nyu", True, n=2, missing_gt=1))
    ds.decode_threads = decode_threads
    with pytest.raises(FileNotFoundError, match="missing train GT"):
        ds.get_batch([0, 1], np.random.default_rng(0))


def test_parallel_get_batch_rejects_a_nonstandard_resolution(tmp_path):
    """The parallel path draws the crops for NYU's 427x565 stage-A shape; a
    frame of another size must raise, not crop wrongly (JAX's rule)."""
    from PIL import Image

    cfg = train_args(tmp_path, "nyu", True, n=2)
    root = tmp_path / "data" / "nyu" / "sync"
    for path in root.rglob("rgb_*.jpg"):
        Image.fromarray(np.zeros((120, 160, 3), np.uint8)).save(path)
    for path in root.rglob("sync_depth_*.png"):
        Image.fromarray(np.ones((120, 160), np.uint16)).save(path)
    cfg["nyu"]["dimensions_train"] = [16, 24]
    ds, jds = _datasets(cfg)
    ds.decode_threads = jds.decode_threads = 4
    for d in (ds, jds):
        with pytest.raises(ValueError, match="non-standard source resolution"):
            d.get_batch([0, 1], np.random.default_rng(0))


@pytest.mark.parametrize("decode_threads", [1, None], ids=["serial", "parallel"])
def test_loader_over_get_batch_yields_jax_loaders_batches(tmp_path, jax_core, decode_threads):
    """The port's DeviceLoader takes get_batch's batches (11 NYU frames at
    batch size 8, shuffled with seed 42, two epochs, the short final batch
    padded with the epoch's first frames): images, depths, sample_valid and
    metadata equal JAX's loader's, and no sample is read alone."""
    assert jax_core, "JAX's get_batch needs its core (tests/test_native.py builds it)"
    cfg = train_args(tmp_path, "nyu", True, n=11)
    ds, jds = _datasets(cfg)
    ds.decode_threads = jds.decode_threads = decode_threads
    ds.get = jds.get = None  # every batch must come from get_batch
    loader = DeviceLoader(ds, 8, "cpu", shuffle=True, seed=42, synchronous=True)
    jloader = JaxDeviceLoader(jds, 8, make_mesh(), shuffle=True, seed=42, synchronous=True)
    for _epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for (b, meta), (jb, jmeta) in zip(got, want):
            for k in ("image", "depth", "sample_valid"):
                assert isinstance(b[k], torch.Tensor)
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
            assert meta == jmeta
        assert got[1][0]["sample_valid"].tolist() == [True] * 3 + [False] * 5


# ------------------------------------------------------------- profiling

def test_trace_writes_a_file_with_the_annotation(tmp_path):
    """On the CPU, ``trace`` writes one Chrome trace into its directory that
    holds an ``annotate`` range's name and the operators inside it."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("slice18_host_core"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    text = (tmp_path / "trace" / files[0]).read_text()
    assert '"slice18_host_core"' in text and "aten::mm" in text
    assert any(e.name == "slice18_host_core" for e in prof.events())


def test_enable_nan_debugging_toggles_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).backward()  # 0/0: the backward's first NaN raises
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_device_memory_stats_is_empty_without_a_card():
    """JAX gives {} for a device without statistics; the port for no card."""
    assert not torch.cuda.is_available()
    assert profiling.device_memory_stats() == {}
