"""Profiling & tracing hooks (port of zvdb_tpu/utils/profiling.py).

Usage:
    from zvdb_tpu_torch.utils.profiling import trace, Phase

    with trace("/tmp/zvdb_trace"):          # torch.profiler trace (chrome://tracing)
        idx.search(q, 10)

    with Phase("build") as p:               # wall-clock phase timing
        idx.build(x)
    print(p.elapsed_s)

    timings = PhaseRecorder()
    with timings.phase("search"):
        ...
    print(timings.report())
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (host ops, and CUDA kernels where a
    card is present), written to `log_dir` as a Chrome trace file."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Phase:
    """Wall-clock phase timer that waits for device work at exit."""

    def __init__(self, name: str, sync: bool = True):
        self.name = name
        self.sync = sync
        self.elapsed_s: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed_s = time.perf_counter() - self._t0
        return False


class PhaseRecorder:
    """Accumulates named phase timings; emits a structured report."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        p = Phase(name, sync=sync)
        with p:
            yield p
        self.records.setdefault(name, []).append(p.elapsed_s)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_s": sum(ts) / len(ts),
                "min_s": min(ts),
                "max_s": max(ts),
            }
        return out


def live_buffer_bytes() -> int:
    """Bytes of live device tensors (the leak check): what PyTorch's CUDA
    allocator holds for tensors. JAX sums its live arrays on any backend;
    PyTorch counts no CPU tensors, so without a card this raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("live_buffer_bytes: counts CUDA tensors only, and no CUDA device "
                           "is present")
    return torch.cuda.memory_allocated()
