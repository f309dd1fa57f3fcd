"""ctypes bindings for the host-side JPEG decoder (`imagen_io.cpp`); counterpart
of `imagen_tpu/native/__init__.py`.

The shared library is built at first use with g++ into
`build/imagen_tpu_torch/` (beside the CUDA library of `ops/_build.py`), not
next to the source. Without g++ or libjpeg, `available()` is False and
`data.Dataset` decodes with PIL, as the JAX package's does. This decodes on
the host for the data loader; it is not a device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'imagen_io.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'imagen_tpu_torch'

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path():
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f'libimagen_io_{digest}.so'


def _build(target):
    """Compile into a temporary file in the build directory and rename it into
    place, so a reader never sees a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / target.name
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', str(SRC), '-o', str(out),
                        '-ljpeg', '-lpthread'], check=True, capture_output=True)
        os.replace(out, target)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = _lib_path()
        try:
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.CalledProcessError):
            return None   # no g++ or no libjpeg: the PIL route
        lib.imagen_io_decode_one.restype = ctypes.c_int
        lib.imagen_io_decode_one.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.imagen_io_decode_batch.restype = ctypes.c_int
        lib.imagen_io_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def jpeg_decode_resize(data: bytes, size: int, hflip: bool = False):
    """One JPEG -> (size, size, 3) float32 in [0, 1], HWC; None if it does not decode."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.float32)
    ok = lib.imagen_io_decode_one(data, len(data), size, int(hflip),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if ok else None


def jpeg_decode_resize_batch(datas, size: int, hflips=None, num_threads=None):
    """JPEG byte strings -> ((n, size, size, 3) float32, the bool mask of those decoded)."""
    lib = _load()
    if lib is None:
        return None, None
    n = len(datas)
    num_threads = num_threads or min(os.cpu_count() or 1, 16)
    ptrs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_int64 * n)(*[len(d) for d in datas])
    flips = (ctypes.c_int32 * n)(*[int(f) for f in (hflips if hflips is not None else [0] * n)])
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    lib.imagen_io_decode_batch(ptrs, lens, n, size, flips, num_threads,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, ok.astype(bool)
