"""ctypes loader + numpy wrappers for the native C++ host codecs.

Counterpart of the JAX package's ``native/``.  The host runtime pieces that
stay hot (dictionary interning at ingest, page integer codecs) are native
(``src/velox_native.cc``, the port's own copy of the JAX package's source).

The library is compiled with g++ at first use (never at import) into
``build/native/`` beside the package (or ``$VELOX_TORCH_BUILD_DIR/native``),
under a name keyed by a hash of the source, and memoized; every entry point
has a pure-Python fallback that writes the same bytes, so the engine works
without a toolchain (``available()`` reports which path is active;
``VELOX_TORCH_NATIVE=off`` forces the fallback).  These are host codecs, not
device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "velox_native.cc")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fwrapv")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    from ..ops.cuda_build import build_dir

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(build_dir(), "native")
    so_path = os.path.join(out_dir, f"libvelox_native_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so_path)
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("VELOX_TORCH_NATIVE", "on") == "off":
            return None
        so_path = _build()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.vx_intern_strings.restype = ctypes.c_int64
        lib.vx_intern_strings.argtypes = [u8p, i64p, ctypes.c_int64, i32p, i64p, ctypes.c_int64]
        for name in ("vx_encode_i64", "vx_encode_i64_delta"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [i64p, ctypes.c_int64, u8p, ctypes.c_int64]
        for name in ("vx_decode_i64", "vx_decode_i64_delta"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64]
        if lib.vx_abi_version() != 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# String interning


def intern_strings(
    blob: np.ndarray, offsets: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Intern Arrow-layout strings (uint8 blob + int64 offsets[n+1]).

    Returns (codes int32 [n], uniq_idx int64 [n_uniq]); uniq_idx[k] is the row
    of dictionary entry k's first occurrence (entry 0 is "" and may be -1 if
    absent).  None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(offsets) - 1
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    codes = np.empty(n, dtype=np.int32)
    uniq = np.empty(n + 1, dtype=np.int64)
    n_uniq = lib.vx_intern_strings(
        _as_u8p(blob), _as_i64p(offsets), n, _as_i32p(codes), _as_i64p(uniq),
        n + 1,
    )
    if n_uniq < 0:
        return None
    return codes, uniq[:n_uniq]


# ---------------------------------------------------------------------------
# Integer codec (zigzag varint + RLE); pure-python fallbacks for portability.


def encode_i64(values: np.ndarray, delta: bool = False) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int64)
    lib = _load()
    if lib is not None:
        cap = len(values) * 20 + 16
        dst = np.empty(cap, dtype=np.uint8)
        fn = lib.vx_encode_i64_delta if delta else lib.vx_encode_i64
        w = fn(_as_i64p(values), len(values), _as_u8p(dst), cap)
        if w >= 0:
            return dst[:w].tobytes()
    return _py_encode_i64(values, delta)


def decode_i64(data: bytes, n: int, delta: bool = False) -> np.ndarray:
    lib = _load()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        dst = np.empty(n, dtype=np.int64)
        fn = lib.vx_decode_i64_delta if delta else lib.vx_decode_i64
        k = fn(_as_u8p(src), len(src), _as_i64p(dst), n)
        if k != n:
            raise ValueError(f"corrupt i64 stream: decoded {k}, expected {n}")
        return dst
    return _py_decode_i64(data, n, delta)


def _py_encode_i64(values: np.ndarray, delta: bool) -> bytes:
    if delta:
        values = np.diff(values, prepend=np.int64(0))
    out = bytearray()
    i, n = 0, len(values)
    while i < n:
        j = i + 1
        while j < n and values[j] == values[i]:
            j += 1
        for v in (j - i, (int(values[i]) << 1) ^ (int(values[i]) >> 63)):
            v &= (1 << 64) - 1
            while v >= 0x80:
                out.append((v & 0x7F) | 0x80)
                v >>= 7
            out.append(v)
        i = j
    return bytes(out)


def _py_decode_i64(data: bytes, n: int, delta: bool) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    k = 0
    pos = 0
    ln = len(data)

    def varint():
        nonlocal pos
        v, shift = 0, 0
        while pos < ln:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
        raise ValueError("truncated varint")

    while pos < ln:
        run = varint()
        zz = varint()
        v = (zz >> 1) ^ -(zz & 1)
        if k + run > n:
            raise ValueError("corrupt i64 stream")
        out[k : k + run] = v
        k += run
    if k != n:
        raise ValueError(f"corrupt i64 stream: decoded {k}, expected {n}")
    if delta:
        np.cumsum(out, out=out)
    return out
