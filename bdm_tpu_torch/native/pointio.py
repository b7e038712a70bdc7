"""ctypes bindings for pointio.cpp with a numpy fallback
(`bdm_tpu/native/pointio.py`). The library is built into
`bdm_tpu_torch/_build/` (git-ignored), written under a private name and
renamed into place, so concurrent first uses do not load a half-written
file."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "pointio.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "_pointio.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"pointio: native build failed ({e}); using numpy fallback")
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print(f"pointio: load failed ({e}); using numpy fallback")
            return None
        for name in ("pointio_read_npy", "pointio_read_ply"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int64, ctypes.c_uint64]
        lib.pointio_read_many_npy.restype = ctypes.c_int64
        lib.pointio_read_many_npy.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_points(path: str, max_points: int = 0, seed: int = 0) -> np.ndarray:
    """Read an (N, 3) cloud from .npy/.ply; optionally subsample to
    max_points (with replacement, np.random.choice semantics)."""
    lib = _load()
    if lib is not None:
        cap = max_points if max_points > 0 else 1 << 22
        out = np.empty((cap, 3), dtype=np.float32)
        fn = (lib.pointio_read_ply if path.endswith(".ply")
              else lib.pointio_read_npy)
        n = fn(path.encode(), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), max_points, seed)
        if n > 0:
            return out[:n]
        print(f"pointio: native read failed ({n}) for {path}; numpy fallback")
    # fallback
    if path.endswith(".npy"):
        pts = np.load(path).astype(np.float32)
    else:
        from bdm_tpu_torch.utils.io import read_ply
        pts = read_ply(path)
    if max_points > 0:
        rng = np.random.default_rng(seed)
        pts = pts[rng.integers(0, len(pts), max_points)]
    return pts


def read_many_npy(paths: List[str], max_points: int, seed: int = 0,
                  n_threads: int = 0) -> np.ndarray:
    """Parallel-load many .npy clouds, each subsampled to max_points.
    Returns (len(paths), max_points, 3) float32."""
    lib = _load()
    out = np.empty((len(paths), max_points, 3), dtype=np.float32)
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        err = lib.pointio_read_many_npy(
            arr, len(paths),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_points, seed, n_threads)
        if err == 0:
            return out
        print(f"pointio: native batch read failed ({err}); numpy fallback")
    for i, p in enumerate(paths):
        pts = np.load(p).astype(np.float32)
        rng = np.random.default_rng(seed + i)
        out[i] = pts[rng.integers(0, len(pts), max_points)]
    return out
