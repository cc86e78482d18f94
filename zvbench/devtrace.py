"""The traced run's device record: a torch.profiler sub-window kept as a
summary (no Chrome trace is written), and the shapes of kernel H's calls.

The summary holds the union of the device's busy intervals (kernels and
copies), each kernel's events by name, the longest device operations and
the longest idle gaps, each named by what the host was in at its middle. A kernel's time is read as the mean over the events the profiler did
record, never as a sum, which dropped events would shrink.
"""
from __future__ import annotations

import re
import time
from typing import Optional

import torch


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments: "void (anonymous namespace)::approx_fused_kernel<32>(...)"
    -> "approx_fused_kernel"."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("std::enable_if") and ">::type " in s:   # a templated return type
        s = s.split(">::type ", 1)[1]
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(\s]", s, maxsplit=1)[0]
    return s.split("::")[-1] or name


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(dev_events, host_events, window_s: float, top: int = 10) -> dict:
    """dev_events / host_events: (name, start_ns, end_ns) tuples."""
    merged = _union([(s, e) for _, s, e in dev_events])
    busy_ns = sum(e - s for s, e in merged)
    kernels: dict = {}
    for name, s, e in dev_events:
        c, t = kernels.get(base_name(name), (0, 0.0))
        kernels[base_name(name)] = (c + 1, t + (e - s) / 1e9)
    ops = sorted(((n, t) for n, (_, t) in kernels.items()), key=lambda v: -v[1])[:top]
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[_host_doing(host_events, (g0 + g1) // 2), (g1 - g0) / 1e9] for g0, g1 in gaps]
    return dict(busy_s=busy_ns / 1e9, window_s=window_s, kernels=kernels,
                device_ops=[[n, t] for n, t in ops], idle_gaps=idle)


def _host_doing(host_events, t: int) -> str:
    """What the host was in at time t: the innermost operator covering t,
    and the innermost call under it where that is another one (a CUDA
    runtime call, a sync)."""
    covering = sorted((e - s, name) for name, s, e in host_events
                      if s <= t <= e and not name.startswith("zvbench."))
    if not covering:
        return "no host activity"
    inner = covering[0][1]
    op = next((name for _, name in covering if name.startswith("aten::")), None)
    return inner if op is None or op == inner else f"{op} > {inner}"


class DeviceProfile:
    """A torch.profiler sub-window: start(), then stop() -> summary."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self.summary: Optional[dict] = None

    @property
    def on(self) -> bool:
        return self._prof is not None

    def warm(self) -> None:
        """One empty profile, so that the profiler's own start-up (CUPTI)
        falls in set-up and not in the sub-window it is to record."""
        self.start()
        self._prof.__exit__(None, None, None)
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        dev, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            row = (ev.name(), ev.start_ns(), ev.end_ns())
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # a record_function span also shows on the device's timeline
                if not ev.is_user_annotation() and not ev.name().startswith("zvbench."):
                    dev.append(row)
            elif ev.end_ns() > ev.start_ns():
                host.append(row)
        self._prof = None
        self.summary = summarize(dev, host, window_s)
        return self.summary


class CallRecorder:
    """Wraps ops/approx_topk.py:approx_min_k, the port's kernel H entry, to
    record each call's (numel, rows, k) while `recording`. The kernel's
    launch counter (`approx_min_k.launches`, which the module increments on
    whatever its `approx_min_k` names) moves to the wrapper while installed
    and back on `remove`."""

    def __init__(self, module):
        self.module = module
        self.orig = module.approx_min_k
        self.calls: list = []
        self.recording = False

        def wrapped(s, k, recall_target=0.95):
            if self.recording:
                self.calls.append((s.numel(), s.numel() // s.shape[-1], k))
            return self.orig(s, k, recall_target)

        wrapped.launches = self.orig.launches
        module.approx_min_k = wrapped

    def remove(self) -> None:
        self.orig.launches = self.module.approx_min_k.launches
        self.module.approx_min_k = self.orig
