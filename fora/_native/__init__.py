"""ctypes bindings for the native (C++) components.

The shared library is never committed: it is built from the sources beside
this file on first use, and rebuilt whenever it is missing or older than
any of them (``ensure_built``), so a machine never loads a binary built
elsewhere.  Host-side numpy paths take over when compilation is
impossible.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).parent
_SO = _DIR / "libfora_native.so"
_SOURCES = ("graph_io.cpp", "radix_sort.cpp", "Makefile")

_lib: Optional[ctypes.CDLL] = None


def ensure_built(directory: Path = _DIR) -> Path:
    """Build ``libfora_native.so`` in ``directory`` if it is missing or
    older than any source file; returns its path.  Raises when the build
    fails."""
    so = directory / _SO.name
    if so.exists():
        built = so.stat().st_mtime
        if all((directory / s).stat().st_mtime <= built for s in _SOURCES):
            return so
    subprocess.run(["make", "-B", "-C", str(directory)], check=True,
                   capture_output=True, timeout=300)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    try:
        ensure_built()
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.fora_count_edges.restype = ctypes.c_int64
    lib.fora_count_edges.argtypes = [ctypes.c_char_p]
    lib.fora_parse_edges.restype = ctypes.c_int64
    lib.fora_parse_edges.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.fora_parse_edges_w.restype = ctypes.c_int64
    lib.fora_parse_edges_w.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.fora_sort_unique_u64.restype = ctypes.c_int64
    lib.fora_sort_unique_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.fora_pack_keys.restype = None
    lib.fora_pack_keys.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # offsets [n]
        ctypes.POINTER(ctypes.c_int64),   # counts [n]
        ctypes.POINTER(ctypes.c_int64),   # cut [n*nq]
        ctypes.POINTER(ctypes.c_int32),   # endpoints [total]
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),  # key_out [total]
        ctypes.c_int64, ctypes.c_int,
    ]
    lib.fora_unpack_keys.restype = None
    lib.fora_unpack_keys.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int,
    ]
    lib.fora_build_alias.restype = ctypes.c_int64
    lib.fora_build_alias.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def _native_parse_edges(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    count = lib.fora_count_edges(path.encode())
    if count < 0:
        raise IOError(f"cannot read {path}")
    src = np.empty(count, dtype=np.int64)
    dst = np.empty(count, dtype=np.int64)
    got = lib.fora_parse_edges(
        path.encode(),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        count,
    )
    if got < 0:
        raise IOError(f"parse failed for {path} (rc={got})")
    return src[:got], dst[:got]


def _native_parse_edges_w(path: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted (3-column) variant; missing third columns read as 1.0."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    count = lib.fora_count_edges(path.encode())
    if count < 0:
        raise IOError(f"cannot read {path}")
    src = np.empty(count, dtype=np.int64)
    dst = np.empty(count, dtype=np.int64)
    w = np.empty(count, dtype=np.float32)
    got = lib.fora_parse_edges_w(
        path.encode(),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        count,
    )
    if got < 0:
        raise IOError(f"parse failed for {path} (rc={got})")
    return src[:got], dst[:got], w[:got]


def _native_build_alias(indptr: np.ndarray, cols: np.ndarray,
                        w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables over a CSR partition (per-slot prob/other)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    m = len(cols)
    prob = np.ones(m, dtype=np.float32)
    other = cols.copy()
    rc = lib.fora_build_alias(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(indptr) - 1,
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        other.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"alias build failed (rc={rc})")
    return prob, other


def _native_sort_unique_u64(keys: np.ndarray, key_bits: int,
                            n_threads: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel radix sort + duplicate-run merge of a packed key array
    (pack_index's host bottleneck — 170 s of numpy argsort at judged
    scale, BUILD_r04).  ``keys`` is DESTROYED (sorted + compacted in
    place).  Returns (unique sorted keys, run multiplicities f32) as
    slices of the input/scratch buffers."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if keys.dtype == np.int64 and keys.flags.c_contiguous:
        keys = keys.view(np.uint64)   # nonneg packed keys: free reinterpret
    else:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
    mult = np.empty(len(keys), dtype=np.float32)
    u = lib.fora_sort_unique_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(keys), int(key_bits),
        mult.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads))
    if u < 0:
        raise MemoryError("radix sort scratch allocation failed")
    return keys[:u], mult[:u]


# Public symbols: None when the native path cannot be used at all.
_available = _load() is not None
native_parse_edges = _native_parse_edges if _available else None
native_parse_edges_w = _native_parse_edges_w if _available else None
native_build_alias = _native_build_alias if _available else None
native_sort_unique_u64 = _native_sort_unique_u64 if _available else None


def _native_pack_keys(offsets, counts, cut, endpoints, nb: int,
                      key_out, n_threads: int = 0) -> None:
    """One parallel pass writing every pool entry's packed
    (bucket, dst, src) sort key (see radix_sort.cpp fora_pack_keys)."""
    lib = _load()
    n, nq = cut.shape
    lib.fora_pack_keys(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cut.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        endpoints.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, nq, int(nb),
        key_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(endpoints), int(n_threads))


def _native_unpack_keys(keys, nb: int, n_threads: int = 0):
    """Sorted unique keys -> (src i32, dst i32, bucket i8) in one pass."""
    lib = _load()
    src = np.empty(len(keys), np.int32)
    dst = np.empty(len(keys), np.int32)
    bucket = np.empty(len(keys), np.int8)
    lib.fora_unpack_keys(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(keys), int(nb),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bucket.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(n_threads))
    return src, dst, bucket


native_pack_keys = _native_pack_keys if _available else None
native_unpack_keys = _native_unpack_keys if _available else None
