"""ctypes bindings for the native data-path kernels (native/clipgen.cpp).

The port's own binding of the repository's ``native/libclipgen.so`` (the
same library and calls as ``vptr_tpu/data/native.py``), so both packages
take the same path on one machine: the native and Python synthetic
generators draw different trajectories.

Builds the shared library on demand (``make -C native``) and degrades to
pure Python when no toolchain is available. All entry points are optional
accelerations — the Python paths produce equivalent results (the synthetic
generator's trajectories differ between the two, both deterministic).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libclipgen.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists():
            try:
                subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None

        i64 = ctypes.c_int64
        i32 = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.render_clips.argtypes = [fp, i32, i64, i64p, i32, i32, i32,
                                     i32, i32, i32, ctypes.c_float, fp]
        lib.normalize_u8.argtypes = [u8p, fp, i64, i32, fp, fp]
        lib.normalize_f32.argtypes = [fp, fp, i64, i32, fp, fp]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def render_clips(glyphs: np.ndarray, seed: int, indices: np.ndarray,
                 t_total: int, size: int, channels: int,
                 num_digits: int = 2, motion: str = "linear",
                 noise: float = 0.0) -> Optional[np.ndarray]:
    """Batch-render bouncing-glyph clips: returns
    (len(indices), t_total, size, size, channels) float32, or None when the
    native library is unavailable. ``motion``/``noise`` select the linear or
    dynamic (accelerated + colliding + noisy) generator — see
    SyntheticMovingMNIST."""
    lib = _load()
    if lib is None:
        return None
    if motion == "dynamic" and num_digits > 8:
        # the C++ dynamic renderer holds per-digit state in fixed kMaxD=8
        # stack arrays (native/clipgen.cpp) and would silently clamp;
        # route to the Python renderer so both paths stay identical
        return None
    glyphs = np.ascontiguousarray(glyphs, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    n = len(indices)
    out = np.empty((n, t_total, size, size, channels), np.float32)
    lib.render_clips(
        _fptr(glyphs), glyphs.shape[-1], ctypes.c_int64(seed),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, t_total, size, channels, num_digits,
        {"linear": 0, "dynamic": 1}[motion], ctypes.c_float(noise),
        _fptr(out))
    return out


def normalize_u8(frames: np.ndarray, mean, std) -> Optional[np.ndarray]:
    """uint8 (..., C) -> normalized float32, fused (x/255 - mean)/std."""
    lib = _load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.uint8)
    c = frames.shape[-1]
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    out = np.empty(frames.shape, np.float32)
    lib.normalize_u8(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(out),
        ctypes.c_int64(frames.size // c), c, _fptr(mean), _fptr(std))
    return out


def normalize_f32(frames: np.ndarray, mean, std) -> Optional[np.ndarray]:
    """float32 (..., C) in [0,1] -> normalized float32 (x - mean)/std."""
    lib = _load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.float32)
    c = frames.shape[-1]
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    out = np.empty(frames.shape, np.float32)
    lib.normalize_f32(_fptr(frames), _fptr(out),
                      ctypes.c_int64(frames.size // c), c,
                      _fptr(mean), _fptr(std))
    return out
