"""The program's spans on the device trace's clock: device time and idle gaps
put down to the "zvdb <name>" ranges that zvdb_tpu_torch/utils/profiling.py
opens while a torch.profiler records.

A kernel belongs to the spans that enclose its launch on the host: its
runtime call (cudaLaunchKernel and the like) shares its correlation id, and
the spans open at that call's start enclose it, outermost first. An idle gap
of the device is a sync's when it begins inside a "zvdb wait.*" range: the
device drained while the host waited for it.

`from_kineto(events)` takes a finished profile's kineto events
(`prof.profiler.kineto_results.events()`) to a record of plain tuples, and
`split(record, window_s)` reads it. Nothing of the program is imported; a
record without spans or kernels reads as None. As a command, one --trace 1
run of a cell with its profiled sub-window also read here, the result line
gaining "zvdb" (needs a CUDA device):

    python3 zvbench/spans.py --workload <cell> --seed <n> [--seconds 20]
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from pathlib import Path
from typing import Optional

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from zvbench.devtrace import _union  # noqa: E402

PREFIX = "zvdb "
WAIT = PREFIX + "wait."
ROOTS = ("zvdb cagra.search", "zvdb ivf.search", "zvdb cagra.build")


def from_kineto(events) -> dict:
    """{"spans": [(name, start_ns, end_ns)] of the program's host ranges,
    "launches": {correlation: start_ns} of the host's runtime calls,
    "kernels": [(name, start_ns, end_ns, correlation)] of the device's
    kernels and copies}."""
    import torch

    spans, launches, kernels = [], {}, []
    for ev in events:
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation() and not name.startswith(("zvbench.", PREFIX)):
                kernels.append((name, s, e, ev.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name, s, e))
        elif ev.correlation_id() and name.startswith("cu"):   # the runtime's calls
            launches[ev.correlation_id()] = s
    return dict(spans=spans, launches=launches, kernels=kernels)


def enclosing(spans, times) -> dict:
    """{t: names of the spans open at t, outermost first} for each time:
    one sweep over the spans by start (a span before one that starts with
    it and ends earlier)."""
    order = sorted(spans, key=lambda v: (v[1], -v[2]))
    out, active, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(order) and order[i][1] <= t:
            active.append(order[i])
            i += 1
        active = [v for v in active if v[2] > t]
        out[t] = [v[0] for v in active]
    return out


def sync_gaps_ns(spans, kernels) -> int:
    """ns of the device's idle gaps that begin inside a wait span."""
    merged = _union([(k[1], k[2]) for k in kernels])
    waits = sorted((s, e) for name, s, e in spans if name.startswith(WAIT))
    starts = [s for s, _ in waits]
    total = 0
    for a, b in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, a[1]) - 1
        if i >= 0 and a[1] < waits[i][1]:
            total += b[0] - a[1]
    return total


def _per_call(spans, times_ns, roots):
    """{(root, span name): ns} of (time, ns) pairs put down to the spans
    open at each time under a root span, and the ns under no root."""
    at = enclosing(spans, [t for t, _ in times_ns])
    under: collections.Counter = collections.Counter()
    outside = 0
    for t, ns in times_ns:
        names = at[t]
        root = next((n for n in names if n in roots), None)
        if root is None:
            outside += ns
            continue
        for name in set(names):
            under[root, name] += ns
    return under, outside


def split(record: dict, window_s: float, roots=ROOTS) -> Optional[dict]:
    """The record read out, or None without spans or kernels:
      sync_idle_pct     idle gaps that begin inside a wait span, % of window_s;
      ms_under          {span name: device ms of the kernels launched inside
                        it, per call of the root span (one of `roots`) that
                        holds them};
      idle_ms_under     {span name: ms of the idle gaps that begin while the
                        host is inside it, per call of its root span};
      idle_outside_pct  idle gaps that begin outside every root span (the
                        caller's own time between calls), % of window_s;
      calls             {root name: spans of it};
      unattributed_pct  % of the kernels' device time launched in no span."""
    spans, kernels = record.get("spans") or [], record.get("kernels") or []
    if not spans or not kernels:
        return None
    launches = record["launches"]
    timed = [(launches[c], e - s) for _, s, e, c in kernels if c in launches]
    total = sum(e - s for _, s, e, _ in kernels)
    at = enclosing(spans, [t for t, _ in timed])
    lost = total - sum(ns for t, ns in timed if at[t])
    under, _ = _per_call(spans, timed, roots)
    merged = _union([(k[1], k[2]) for k in kernels])
    idle, outside = _per_call(spans, [(a[1], b[0] - a[1]) for a, b in zip(merged, merged[1:])],
                              roots)
    calls = collections.Counter(name for name, _, _ in spans if name in roots)
    return dict(sync_idle_pct=100.0 * sync_gaps_ns(spans, kernels) / 1e9 / window_s,
                ms_under={n: ns / 1e6 / calls[r] for (r, n), ns in under.items()},
                idle_ms_under={n: ns / 1e6 / calls[r] for (r, n), ns in idle.items()},
                idle_outside_pct=100.0 * outside / 1e9 / window_s, calls=dict(calls),
                unattributed_pct=100.0 * lost / total if total else None)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="a traced run of a cell, read by spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    from zvbench import devtrace, harness

    got = []

    class SplitProfile(devtrace.DeviceProfile):
        def stop(self) -> dict:
            prof = self._prof
            summary = super().stop()
            got.append(split(from_kineto(prof.profiler.kineto_results.events()),
                             summary["window_s"]))
            return summary

    if not torch.cuda.is_available():
        print("spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    harness.DeviceProfile = SplitProfile
    torch.set_num_threads(2)
    line = harness.run_cell(harness.load_cell(args.workload), args.seed, args.seconds, True,
                            "cuda", t_start=t_start)
    line["zvdb"] = got[-1] if got else None
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
