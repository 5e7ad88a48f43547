"""ctypes bridge to the C++ fast ASCII formatter (native/vtu_format.cpp).

Builds the shared library on first use (g++ is baked into the image) and
caches it under build/native/.  Falls back to pure-Python formatting
transparently if the toolchain is unavailable, so the framework stays
importable anywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "native", "libmacroc_io.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            src = os.path.join(_NATIVE_DIR, "vtu_format.cpp")
            if not os.path.exists(src):
                return None
            os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", src,
                 "-o", _LIB_PATH],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.format_doubles.restype = ctypes.c_long
        lib.format_doubles.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.format_longs.restype = ctypes.c_long
        lib.format_longs.argtypes = [
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def format_doubles(
    arr: np.ndarray, fmt: str, row_newline: bool = True
) -> Optional[str]:
    """Format a (rows, cols) float array as the reference's tab tables.
    Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :] if not row_newline else a[:, None]
    rows, cols = a.shape
    cap = rows * cols * 32 + 1024
    buf = ctypes.create_string_buffer(cap)
    n = lib.format_doubles(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows,
        cols,
        fmt.encode(),
        1 if row_newline else 0,
        buf,
        cap,
    )
    if n < 0:
        return None
    return buf.raw[:n].decode()


def format_longs(
    arr: np.ndarray, fmt: str = "%lld", row_newline: bool = False
) -> Optional[str]:
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.int64)
    if a.ndim == 1:
        a = a[None, :]
    rows, cols = a.shape
    cap = a.size * 24 + 1024
    buf = ctypes.create_string_buffer(cap)
    n = lib.format_longs(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        rows,
        cols,
        fmt.encode(),
        1 if row_newline else 0,
        buf,
        cap,
    )
    if n < 0:
        return None
    return buf.raw[:n].decode()
