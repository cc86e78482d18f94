"""ctypes bindings for the native host runtime (native/zvdb_host.cpp), a copy
of zvdb_tpu/io/native_loader.py.

Builds native/libzvdb_host.so with `make -C native` on first use; when the
toolchain or the library is unavailable every caller gets None and reads or
searches on the host with numpy instead. Both paths run on the host.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = os.path.abspath(os.path.join(_NATIVE_DIR, "libzvdb_host.so"))
        if not os.path.exists(so):
            try:
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.zvdb_read_vecs.restype = ctypes.c_int64
        lib.zvdb_read_vecs.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.zvdb_exact_knn.restype = None
        lib.zvdb_exact_knn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def read_vecs(path: str, dtype, max_rows: Optional[int]) -> Optional[np.ndarray]:
    """Fast fvecs/ivecs read; returns None to signal the numpy reader."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    rows = lib.zvdb_read_vecs(path.encode(), None, max_rows or -1,
                              ctypes.byref(n), ctypes.byref(d))
    if rows < 0:
        return None
    out = np.empty((rows, d.value), np.float32)
    got = lib.zvdb_read_vecs(path.encode(), out.ctypes.data, rows,
                             ctypes.byref(n), ctypes.byref(d))
    if got != rows:
        return None
    if dtype == np.int32:
        return out.view(np.int32)
    return out


def exact_knn_cpu(x: np.ndarray, q: np.ndarray, k: int, metric: str = "l2"):
    """Multithreaded CPU exact kNN; returns (scores, ids) or None if unavailable.

    A host-side oracle for recall at scales where an on-device oracle would
    crowd the index out of device memory.
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    q = np.ascontiguousarray(q, np.float32)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        m = 1
    elif metric == "dot":
        m = 1
    else:
        m = 0
    n, d = x.shape
    nq = q.shape[0]
    kk = min(k, n)
    ids = np.empty((nq, kk), np.int32)
    scores = np.empty((nq, kk), np.float32)
    lib.zvdb_exact_knn(x.ctypes.data, n, q.ctypes.data, nq, d, kk, m,
                       ids.ctypes.data, scores.ctypes.data)
    if metric in ("dot", "cosine"):
        scores = -scores
    return scores, ids
