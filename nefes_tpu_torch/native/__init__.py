"""ctypes bindings for the native (C++) image loader; port of
nefes_tpu/native/__init__.py, over the port's own copy of loader.cpp.

Built with g++ at first use into nefes_tpu_torch/_build/ (libpng and
libjpeg, linked as system libraries). When the library does not build
or load, one line says why and ``available()`` is False; the 7-Scenes
loaders then read through Pillow + OpenCV (data/seven_scenes.py), as the
JAX loaders do. The box downsample equals cv2.INTER_AREA at the integer
ratios the configs use (tests/test_torch_native_loader.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False
_ERROR: str | None = None


def _so_path() -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR / "libnefes_loader.so"


def _build() -> Path:
    so = _so_path()
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    # compile to a temporary name, then rename atomically: an interrupted
    # g++ must not leave a corrupt .so that the mtime check would keep
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-lpng", "-ljpeg", "-pthread", "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = res.stderr.strip().splitlines()
        raise RuntimeError(f"g++ exited {res.returncode}: "
                           f"{lines[0] if lines else ''}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # toolchain, headers, libraries, bad .so
            _ERROR = str(e)
            print(f"[native] loader unavailable ({e}); using PIL path")
            return None
        lib.nefes_load_images.restype = ctypes.c_int
        lib.nefes_load_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the library did not build or load (None if it did)."""
    _load()
    return _ERROR


def load_images_native(paths: list[str], H: int, W: int,
                       n_threads: int = 0) -> np.ndarray:
    """Decode and box-resize to (N, H, W, 3) float32 in [0, 1] on C++
    threads (0: one a core). Raises RuntimeError on a decode failure or if
    the library is absent."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.empty((n, H, W, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    fails = lib.nefes_load_images(
        arr, n, H, W, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads)
    if fails:
        raise RuntimeError(f"native loader failed on {fails}/{n} images")
    return out
