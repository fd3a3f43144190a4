"""ctypes bindings of the host core, ``objcavit_torch/csrc/preprocess.cpp``.

Port of ``objcavit_tpu/data/native.py``. The first call builds the core with
g++ (``kernels/build.py::build_host``) and loads it; a build or a load that
fails raises, and no entry point falls back to numpy. ``preprocess.py``
keeps the plain numpy versions of each entry point (``rotate_bilinear``,
``rotate_nearest``, ``augment_normalize``, ``assemble_batch``), which only
the tests and ``chip_smoke.py`` call. A ctypes call releases the GIL, so
the core runs beside the train thread when the loader's prefetch thread
calls it. Images are HWC float32; each function returns a new array.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from objcavit_torch.kernels import build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64, _INT, _F32 = ctypes.c_int64, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "rotate_bilinear_f32": (_F32P, _F32P, _I64, _I64, _I64, _F32),
    "rotate_nearest_f32": (_F32P, _F32P, _I64, _I64, _I64, _F32),
    "augment_normalize_f32": (_F32P, _I64, _I64, _INT, _INT, _F32, _F32, _F32P, _INT),
    "hflip_f32": (_F32P, _I64, _I64, _I64),
    "assemble_batch_f32": (ctypes.POINTER(_F32P), ctypes.POINTER(_F32P), _I64, _I64P, _I64P,
                           _I64, _I64, _I32P, _I32P, _I32P, _I32P, _F32P, _F32P, _F32P, _INT,
                           _INT, _F32P, _F32P),
}
# assemble_batch's default thread count (the JAX package's): at most 8
MAX_ASSEMBLE_THREADS = 8


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build the core if needed, then load it with every entry point typed."""
    build.build_host()
    lib = ctypes.CDLL(str(build.HOST_LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, kind=_F32P):
    return a.ctypes.data_as(kind)


def _image(img: np.ndarray, channels: int | None = None) -> np.ndarray:
    """``img`` as a C-contiguous float32 (H, W, C) array, checked."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or (channels is not None and img.shape[2] != channels):
        want = f"(H, W, {channels})" if channels else "(H, W, C)"
        raise ValueError(f"want an {want} image, got shape {img.shape}")
    return img


def _rotate(fn: str, img: np.ndarray, angle_deg: float) -> np.ndarray:
    img = _image(img)
    out = np.empty_like(img)
    getattr(library(), fn)(_ptr(img), _ptr(out), *img.shape, float(angle_deg))
    return out


def rotate_bilinear(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """(H, W, C) rotated about its centre by ``angle_deg``, bilinear, zero fill."""
    return _rotate("rotate_bilinear_f32", img, angle_deg)


def rotate_nearest(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """(H, W, C) rotated about its centre by ``angle_deg``, nearest, zero fill."""
    return _rotate("rotate_nearest_f32", img, angle_deg)


def augment_normalize(img: np.ndarray, flip: bool, do_augment: bool, gamma: float,
                      brightness: float, color3: np.ndarray,
                      do_normalize: bool = True) -> np.ndarray:
    """The legacy pipeline's tail on an (H, W, 3) [0, 1] image: flip, then
    (``do_augment``) gamma, brightness and colour clipped to [0, 1], then
    (``do_normalize``) ImageNet normalisation."""
    img = _image(img, 3).copy()
    c3 = np.ascontiguousarray(color3, np.float32).reshape(3)
    h, w, _ = img.shape
    library().augment_normalize_f32(_ptr(img), h, w, int(flip), int(do_augment), float(gamma),
                                    float(brightness), _ptr(c3), int(do_normalize))
    return img


def hflip(img: np.ndarray) -> np.ndarray:
    """(H, W, C) mirrored left to right."""
    img = _image(img).copy()
    library().hflip_f32(_ptr(img), *img.shape)
    return img


def assemble_batch(images: list, depths: list, crops_yx: np.ndarray, flips: np.ndarray,
                   do_augments: np.ndarray, gammas: np.ndarray, brightnesses: np.ndarray,
                   colors3: np.ndarray, out_h: int, out_w: int, n_threads: int | None = None,
                   do_normalize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """A batch's crop, the legacy tail and the stack in one pass of
    ``n_threads`` C++ threads (default: the host's cores, at most
    ``MAX_ASSEMBLE_THREADS``). ``images[i]`` is (H_i, W_i, 3) [0, 1] and
    ``depths[i]`` (H_i, W_i, 1) metres, rotated but not cropped;
    ``crops_yx`` (N, 2) the crops' top-left corners; the rest a sample's
    draws. -> (N, out_h, out_w, 3) images and (N, out_h, out_w, 1) depths,
    bit for bit the per-sample crop, ``augment_normalize`` and stack."""
    n = len(images)
    images = [_image(a, 3) for a in images]
    depths = [_image(a, 1) for a in depths]
    crops = np.ascontiguousarray(crops_yx, np.int32).reshape(n, 2)
    for i, (img, dep) in enumerate(zip(images, depths)):
        y, x = crops[i]
        if (img.shape[:2] != dep.shape[:2] or y < 0 or x < 0 or y + out_h > img.shape[0]
                or x + out_w > img.shape[1]):
            raise ValueError(f"sample {i}: crop {out_h}x{out_w} at ({y}, {x}) of an image "
                             f"{img.shape[:2]} and a depth {dep.shape[:2]}")
    if n_threads is None:
        n_threads = min(MAX_ASSEMBLE_THREADS, os.cpu_count() or 1)
    hs = np.asarray([a.shape[0] for a in images], np.int64)
    ws = np.asarray([a.shape[1] for a in images], np.int64)
    crop_y, crop_x = np.ascontiguousarray(crops[:, 0]), np.ascontiguousarray(crops[:, 1])
    per_sample = [np.ascontiguousarray(v, np.int32).reshape(n) for v in (flips, do_augments)]
    floats = [np.ascontiguousarray(v, np.float32).reshape(n) for v in (gammas, brightnesses)]
    c3 = np.ascontiguousarray(colors3, np.float32).reshape(n, 3)
    out_imgs = np.empty((n, out_h, out_w, 3), np.float32)
    out_deps = np.empty((n, out_h, out_w, 1), np.float32)
    img_ptrs = (_F32P * n)(*[_ptr(a) for a in images])
    dep_ptrs = (_F32P * n)(*[_ptr(a) for a in depths])
    library().assemble_batch_f32(
        img_ptrs, dep_ptrs, n, _ptr(hs, _I64P), _ptr(ws, _I64P), out_h, out_w,
        _ptr(crop_y, _I32P), _ptr(crop_x, _I32P), *(_ptr(v, _I32P) for v in per_sample),
        *(_ptr(v) for v in floats), _ptr(c3), int(do_normalize), int(n_threads),
        _ptr(out_imgs), _ptr(out_deps))
    return out_imgs, out_deps
