"""Builds and loads the engine's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers are
involved, so a build takes seconds.  The build happens at first use (never at
import), into ``build/`` beside the package (or ``$VELOX_TORCH_BUILD_DIR``),
under a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

A build or load failure raises; nothing here falls back to another code path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from . import launch_geometry

_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches``: under a lock, since
    grouped execution launches kernels from several threads at once."""
    with _launch_lock:
        wrapper.launches += 1

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--threads", "0",  # one compile job per source file, all started together
)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc time of this process's build, if any

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argument types (every pointer and the stream are c_void_p)
    "velox_selective_sum": [_P, _P, _P, _P, _I, _L, _P, _I, _P],
    "velox_grouped_piece_sums": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P],
    "velox_grouped_int64_sums": [_P, _P, _I, _P, _I, _P, _P],
    "velox_grouped_limits": [_P],
    "velox_dict_like": [_P, _P, _I, _L, _P, _I, _P, _I, _I, _P, _P],
    "velox_hash_build": [_P, _L, _P, _I, _I, _P],
    "velox_hash_probe": [_P, _I, _P, _P, _P, _L, _P, _P, _I, _L, _L, _P, _P, _I, _P],
}


def sources():
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def build_dir() -> str:
    return os.environ.get("VELOX_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build"
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return os.path.join(build_dir(), f"libvelox_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if their library is not there yet; return its path."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        compiled = compiled_limits(lib)
        if compiled != launch_geometry.COMPILED_LIMITS:
            raise RuntimeError(
                f"csrc/grouped_common.cuh was compiled with limits {compiled}, "
                f"ops/launch_geometry.py plans with {launch_geometry.COMPILED_LIMITS}"
            )
        _lib = lib
    return _lib


def compiled_limits(lib: ctypes.CDLL) -> tuple:
    """The limits the grouped-sum kernels were compiled with, in the order of
    ``launch_geometry.COMPILED_LIMITS``."""
    out = (ctypes.c_longlong * len(launch_geometry.COMPILED_LIMITS))()
    check(lib.velox_grouped_limits(ctypes.addressof(out)), "grouped_limits")
    return tuple(out)


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def launch_params(device):
    """(max_blocks, stream) for a launch on ``device``: enough blocks to fill
    every SM several times over, and PyTorch's current stream."""
    sm_count, stream = sm_count_and_stream(device)
    return sm_count * 8, stream


def sm_count_and_stream(device):
    """(multiprocessor count, stream) for a launch whose geometry
    ``launch_geometry.plan_launch`` chooses."""
    import torch

    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, torch.cuda.current_stream(device).cuda_stream
