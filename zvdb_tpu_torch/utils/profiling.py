"""Profiling & tracing hooks (port of zvdb_tpu/utils/profiling.py), and the
package's own spans and host-wait counters.

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

Inside the package (the names are listed in PERF.md):

    with span("cagra.seeds"):               # a "zvdb cagra.seeds" profiler range
        ...
    with wait("topk_ties"):                 # the host waits on the device here
        rows = mask.nonzero()
    with entry("cagra.search"):             # a public call: a span, counted in
        ...                                 # entry_calls, that its waits name
    mark = Stages(device, "build.")         # a build's stages: mark("kmeans"),
    mark("kmeans"); ...; mark.end()         # mark("assign"), ..., end()

A span, a stage or an entry records a range only while a torch.profiler
records, so it lands in the profiler's trace beside the device's kernels and
copies, on the same clock; otherwise it costs one attribute read, and never
a device sync. `wait` always counts, in `host_waits` by the public call and
the site, the way each op counts its launches.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _AP

# every wait of the process, host_waits[(call, site)]: `call` the public
# call it was made in (the innermost one), None outside any; and the public
# calls by name
host_waits: collections.Counter = collections.Counter()
entry_calls: collections.Counter = collections.Counter()

_NOOP = contextlib.nullcontext()
_local = threading.local()   # .entry: the name of the public call this thread runs
_range = torch._C._profiler._RecordFunctionFast   # a profiler range, made in C++


def span(name: str, recorder=None):
    """A profiler range named "zvdb <name>" while a profiler records, else a
    shared no-op context. With a recorder (PhaseRecorder), also a phase of
    that name, timed up to a device sync."""
    if recorder is not None:
        return _phase_span(name, recorder)
    if not _AP._is_profiler_enabled:
        return _NOOP
    return _range("zvdb " + name)


@contextlib.contextmanager
def _phase_span(name: str, recorder):
    with span(name), recorder.phase(name):
        yield


def wait(site: str, syncs: int = 1):
    """Around a place where the host waits for the device (a value pulled
    to the host, a pageable upload, a sync): counts its `syncs` in
    host_waits[(the running public call or None, site)]; while a profiler
    records, a "zvdb wait.<site>" range. One `with` around each op that
    syncs, so that the counts equal the syncs the CUDA runtime sees."""
    host_waits[getattr(_local, "entry", None), site] += syncs
    if not _AP._is_profiler_enabled:
        return _NOOP
    return _range("zvdb wait." + site)


class entry:
    """The span of a public call ("cagra.search"): counts the call in
    entry_calls[name], and names it in host_waits' keys of the waits made
    inside it and not in a public call nested in it."""

    __slots__ = ("name", "_outer", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        entry_calls[self.name] += 1
        self._outer = getattr(_local, "entry", None)
        _local.entry = self.name
        self._range = span(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _local.entry = self._outer
        return False


class Stages:
    """A build's stage marker: mark(name) ends the running stage and starts
    `name`; end() ends the last. While a profiler records, each stage is a
    "zvdb <prefix><name>" range. With ZVDB_BUILD_TRACE=1 (read when the
    marker is made) each stage's seconds, measured up to a device sync (none
    where a mark passes sync=False), are added to seconds[name], so a stage
    marked once a batch sums over the batches; `report` gives them as text."""

    def __init__(self, device, prefix: str = "", seconds: Optional[dict] = None):
        self.timed = os.environ.get("ZVDB_BUILD_TRACE", "") not in ("", "0")
        self.device = torch.device(device)
        self.prefix = prefix
        self.seconds = {} if seconds is None else seconds
        self._name: Optional[str] = None
        self._range = None
        self._t = 0.0

    def __call__(self, name: str, sync: bool = True) -> None:
        self.end(sync)
        self._name = name
        self._t = time.perf_counter()
        if _AP._is_profiler_enabled:
            self._range = _range("zvdb " + self.prefix + name)
            self._range.__enter__()

    def end(self, sync: bool = True) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.timed and self._name is not None:
            if sync and self.device.type == "cuda":
                with wait("stage_sync"):
                    torch.cuda.synchronize(self.device)
            self.seconds[self._name] = self.seconds.get(self._name, 0.0) + \
                time.perf_counter() - self._t
        self._name = None

    def report(self, label: str) -> str:
        """"[label] total=<s>s  <stage>=<s>s ..." over the stages so far."""
        parts = "  ".join(f"{k}={v:.2f}s" for k, v in self.seconds.items())
        return f"[{label}] total={sum(self.seconds.values()):.2f}s  {parts}"


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
            with wait("phase_sync"):
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
