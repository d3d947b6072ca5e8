"""The ``native`` search backend: the multithreaded exact C++ searcher
``ttamm_torch/csrc/host/flat_index.cpp`` (the JAX package's
``native/flat_index.cpp``, byte for byte), loaded through ctypes.

The library is compiled by ``g++`` at first use with ``native/Makefile``'s
compile flags into ``build/ttamm_torch/``, under a name hashed over the
source, the flags and the CPU features ``-march=native`` turns on (a library
built for one CPU may not run on another). It is linked by a separate
command without ``-ffast-math``: linked with it, GCC adds ``crtfastmath.o``,
whose constructor sets flush-to-zero and denormals-are-zero in the loading
thread's floating-point mode (and so in every thread it starts later),
which would change every later float computation of the process that
loads the library. Nothing falls back: without ``g++``, when the build
fails (its stderr quoted) or when the searcher returns an error, a call
raises.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.kernels import compile_shared_library

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "flat_index.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17", "-pthread")
LINK_FLAGS = ("-shared", "-pthread")  # no -ffast-math: no crtfastmath.o

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_cxx() -> str | None:
    """``g++`` from ``$PATH``."""
    return shutil.which("g++")


def _native_target(cxx: str) -> str:
    """What ``-march=native`` means on this machine: the target options it
    turns on, as the compiler reports them."""
    proc = subprocess.run(
        [cxx, "-march=native", "-Q", "--help=target"], capture_output=True, text=True, check=True,
    )
    return proc.stdout


def build_native_library(build_dir: Path | None = None) -> Path:
    """Compile the searcher (cached by source, flags and CPU features)."""
    cxx = find_cxx()
    return compile_shared_library(
        cxx, CXX_FLAGS, [_SOURCE], stem="libttamm_flat_index",
        salt="" if cxx is None else _native_target(cxx), build_dir=build_dir,
        log_name="build_host.log", link_flags=LINK_FLAGS,
        missing="cannot build the native search library: g++ not found (put g++ on PATH)",
    )


def load_native_library() -> ctypes.CDLL:
    """Build (if needed) and load the searcher, once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native_library()))
            lib.ttamm_flat_topk.restype = ctypes.c_int
            lib.ttamm_flat_topk.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # items [n, d]
                ctypes.c_int64,  # n
                ctypes.c_int32,  # d
                ctypes.POINTER(ctypes.c_float),  # queries [b, d]
                ctypes.c_int64,  # b
                ctypes.c_int32,  # k
                ctypes.POINTER(ctypes.c_float),  # out scores [b, k]
                ctypes.POINTER(ctypes.c_int64),  # out indices [b, k]
                ctypes.c_int32,  # num threads (0 = auto)
            ]
            _lib = lib
        return _lib


def native_flat_search(
    embeddings: np.ndarray, queries: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by inner product on the host, one thread a core:
    (scores f32 [B, k], indices int64 [B, k]), descending."""
    emb = np.ascontiguousarray(embeddings, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32)
    if emb.ndim != 2 or q.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"queries {q.shape} do not match items {emb.shape}")
    lib = load_native_library()
    b = q.shape[0]
    scores = np.empty((b, k), dtype=np.float32)
    indices = np.empty((b, k), dtype=np.int64)
    rc = lib.ttamm_flat_topk(
        emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(emb.shape[0]),
        ctypes.c_int32(emb.shape[1]),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(b),
        ctypes.c_int32(k),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(0),  # one thread a core
    )
    if rc != 0:
        raise RuntimeError(f"ttamm_flat_topk failed with code {rc} (b={b}, k={k}, items {emb.shape})")
    return scores, indices
