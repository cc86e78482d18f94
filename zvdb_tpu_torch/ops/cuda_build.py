"""Build a hand-written CUDA kernel source of the port and load it.

Each source under zvdb_tpu_torch/csrc/ has a plain C entry point; it is
compiled with nvcc for sm_90a into a shared library under build/kernels/
(gitignored), named by the hash of the source and flags, and loaded with
ctypes. Nothing is built at import time: a wrapper calls `load` at its first
launch, so the package imports where there is no nvcc. Different sources
build in parallel (one lock per source); one source builds once per process,
and each of its entry points is looked up in the one library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}   # source -> (library, info)
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return path


def load(source: str, symbol: str, argtypes: list) -> tuple:
    """Compile csrc/<source> (once per source text and flags), load it, and
    return its C entry point `symbol` with `argtypes` and an int result.

    Also returns info: the library's path, the seconds this process spent
    building and loading it, and nvcc's ptxas report (empty when the library
    was already on disk)."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source not in _loaded:
            _loaded[source] = _build(source)
        lib, info = _loaded[source]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn, info


def _build(source: str) -> tuple:
    """(library, info) of csrc/<source>, compiled unless already on disk."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"{src.stem}_{key}.so"
    t0 = time.perf_counter()
    report = ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        report = proc.stdout + proc.stderr
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    return lib, dict(path=str(path), seconds=time.perf_counter() - t0, ptxas=report)
