"""The benchmark of zvdb_tpu_torch: one cell, one run.

A cell (workloads/<cell>.json) names a configuration (configs/<config>.json:
the engine, its config fields, the search arguments, the data's shape, the
guarantees' limits) and a traffic mix (traffic/<mix>.json: the loop and its
parameters). `Run` makes the data from the seed on the device, builds the
index and warms the cell's shapes (set-up), runs the mix's loop for the
window, then frees the index and holds every answer to the plain reference
(reference/). Readers under end_to_end/ and metrics/, one file a metric,
turn the run's record into the result line's metrics; a reader that finds
nothing to read returns None and its metric is left out.

Loops (traffic "loop"):
  closed  batches of `batch` pool queries, `in_flight` dispatched before the
          oldest one's answers are copied back; queries over the window.
  build   whole bulk builds from device rows, each into a fresh index, back to
          back; then the pool is searched once on the last graph.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .devtrace import CallRecorder, DeviceProfile
from .reference import check as CHECK
from .reference import knn as REF
from .reference.data import SEED_MASK, make_data

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zvdb_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> dict:
    """The cell's workload, configuration and traffic files, by name."""
    w = load_json(root / "workloads" / f"{name}.json")
    return dict(name=name, workload=w, config=load_json(root / "configs" / f"{w['config']}.json"),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"))


def readers(kind: str) -> dict:
    """{metric name: module with UNIT and read(record)} for every file of
    end_to_end/ or metrics/."""
    out = {}
    for path in sorted((HERE / kind).glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"zvbench_{kind}_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Run:
    """Set-up of one cell on one seed; `window` runs its loop."""

    def __init__(self, cell: dict, seed: int, device="cuda", control: Optional[str] = None,
                 t_start: Optional[float] = None, trace: bool = False):
        t_start = time.perf_counter() if t_start is None else t_start
        self.cell, self.seed, self.device, self.control = cell, seed, device, control
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.k = int(self.cfg["k"])
        self._ar: Optional[torch.Tensor] = None
        REF.no_tf32()
        self.x, self.pool = make_data(self.cfg["data"], seed, device)
        from zvdb_tpu_torch.ops import approx_topk
        self.ak = approx_topk
        self.engine = self.make_engine()
        loop = self.traffic["loop"]
        with torch.no_grad():
            self.engine.build(self.x)
            if loop == "closed":
                for i in range(int(self.traffic["warm"])):
                    self.search(self._batch(i, int(self.traffic["batch"])))
            elif loop != "build":
                raise ValueError(f"unknown loop {loop!r}")
        if trace:
            DeviceProfile().warm()
        _sync(device)
        self.setup_s = time.perf_counter() - t_start

    def make_engine(self):
        if self.control:
            return REF.ExactIndex(self.control, self.device)
        import zvdb_tpu_torch as Z

        conf = getattr(Z, self.cfg["config_class"])(**self.cfg["config"])
        return getattr(Z, self.cfg["engine"])(conf, device=self.device)

    def search(self, q):
        return self.engine.search(q, self.k, **self.cfg["search"])

    def _rows(self, first: int, count: int) -> np.ndarray:
        return (first + np.arange(count)) % self.pool.shape[0]

    def _batch(self, i: int, b: int) -> torch.Tensor:
        """Pool rows [i*b, (i+1)*b) mod the pool, gathered on the device (a
        host index array would be a pageable copy, which can wait for the
        searches queued before it)."""
        if self._ar is None or self._ar.shape[0] != b:
            self._ar = torch.arange(b, device=self.device)
        return self.pool[(self._ar + i * b) % self.pool.shape[0]]

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        rec = dict(loop=self.traffic["loop"], k=self.k, setup_s=self.setup_s,
                   spans=collections.defaultdict(list), answers=[])
        prof = DeviceProfile()
        recorder = CallRecorder(self.ak) if trace else None
        gc.collect()   # set-up's garbage; the collector stays on in the window
        try:
            with torch.no_grad():
                getattr(self, f"_loop_{rec['loop']}")(rec, seconds, trace, prof, recorder)
        finally:
            if prof.on:
                prof.stop()
            if recorder is not None:
                rec["approx_calls"] = recorder.calls
                recorder.remove()
        rec["profile"] = prof.summary
        return rec

    @staticmethod
    def _over(elapsed: float, seconds: float, trace: bool, prof) -> bool:
        """The window has run its seconds, and a traced run has profiled at
        least one step (a step that overran the profile's start still gets one)."""
        return elapsed >= seconds and not (trace and not prof.on and prof.summary is None)

    def _profile_due(self, elapsed: float, seconds: float, trace: bool, prof, recorder) -> None:
        if trace and not prof.on and prof.summary is None and \
                elapsed >= seconds - float(self.traffic["profile_s"]):
            recorder.recording = True
            prof.start()

    def _loop_closed(self, rec, seconds, trace, prof, recorder):
        b, depth = int(self.traffic["batch"]), int(self.traffic["in_flight"])
        cuda = torch.device(self.device).type == "cuda"
        ring = [None] * (depth + 1)   # pinned host buffers, reused once retired
        inflight = collections.deque()

        def retire():
            j, d_h, i_h, ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
            rec["answers"].append((self._rows(j * b, b), d_h.numpy().copy(), i_h.numpy().copy()))

        t0 = time.perf_counter()
        i = 0
        if trace:   # first half: each search a span ending in a sync
            while time.perf_counter() - t0 < seconds / 2:
                s = time.perf_counter()
                with _span("zvbench.search", True):
                    d, ids = self.search(self._batch(i, b))
                    _sync(self.device)
                rec["spans"]["search"].append(time.perf_counter() - s)
                rec["answers"].append((self._rows(i * b, b), d.cpu().numpy(), ids.cpu().numpy()))
                i += 1
        while True:
            el = time.perf_counter() - t0
            if self._over(el, seconds, trace, prof):
                break
            self._profile_due(el, seconds, trace, prof, recorder)
            with _span("zvbench.search", trace):
                d, ids = self.search(self._batch(i, b))
            slot = i % (depth + 1)
            if ring[slot] is None:
                ring[slot] = (torch.empty(d.shape, dtype=d.dtype, pin_memory=cuda),
                              torch.empty(ids.shape, dtype=ids.dtype, pin_memory=cuda))
            d_h, i_h = ring[slot]
            d_h.copy_(d, non_blocking=cuda)
            i_h.copy_(ids, non_blocking=cuda)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            inflight.append((i, d_h, i_h, ev))
            i += 1
            if len(inflight) >= depth:
                retire()
        while inflight:
            retire()
        rec["window_s"] = time.perf_counter() - t0
        rec["queries"] = sum(len(a[0]) for a in rec["answers"])
        rec["attempted"], rec["failed"] = rec["queries"], 0

    def _loop_build(self, rec, seconds, trace, prof, recorder):
        rows, launches = [], []
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            if rows and self._over(el, seconds, trace, prof):
                break
            self._profile_due(el, seconds, trace, prof, recorder)
            self.engine = None
            eng = self.make_engine()
            l0 = self.ak.approx_min_k.launches
            s = time.perf_counter()
            with _span("zvbench.build", trace):
                eng.build(self.x)
                _sync(self.device)
            rec["spans"]["build"].append(time.perf_counter() - s)
            launches.append(self.ak.approx_min_k.launches - l0)
            rows.append(self.x.shape[0])
            self.engine = eng
        rec["window_s"] = time.perf_counter() - t0
        if prof.on:
            prof.stop()
        rec["builds"] = dict(rows=rows, launches=launches)
        rec["attempted"], rec["failed"] = len(rows), 0
        b = int(self.traffic["search_batch"])
        for lo in range(0, self.pool.shape[0], b):
            d, ids = self.search(self.pool[lo:lo + b])
            rec["answers"].append((np.arange(lo, lo + d.shape[0]), d.cpu().numpy(),
                                   ids.cpu().numpy()))
        gen = torch.Generator().manual_seed(int(self.seed) & SEED_MASK)
        pick = torch.randperm(self.x.shape[0], generator=gen)[:int(self.traffic["edge_sample"])]
        rec["edge_rows"] = pick.to(self.device)
        rec["edges"] = self.graph_edges(rec["edge_rows"])

    def graph_edges(self, rows: torch.Tensor):
        """(neighbour ids, edge distances) of `rows` in the built graph."""
        degree = int(self.cfg["config"]["degree"])
        if hasattr(self.engine, "graph_edges"):
            return self.engine.graph_edges(rows, degree)
        st = self.engine.state
        if st is None:   # nothing built: no edges (the search's answers show it)
            return (torch.full((rows.shape[0], degree), -1, dtype=torch.int32, device=self.device),
                    torch.full((rows.shape[0], degree), float("inf"), device=self.device))
        return st.nbrs[rows.long()].clone(), st.dists[rows.long()].clone()

    # -- after the window -----------------------------------------------------

    def finish(self, rec: dict) -> dict:
        """Frees the index, then holds the window's answers to the reference:
        rec gains `checks` (the compared numbers) and `recall`."""
        self.engine = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        _, gt = REF.exact_knn(self.x, self.pool, self.k)
        if rec["answers"]:
            rows = np.concatenate([a[0] for a in rec["answers"]])
            dists = np.concatenate([np.asarray(a[1]) for a in rec["answers"]])
            ids = np.concatenate([np.asarray(a[2]) for a in rec["answers"]])
            got = CHECK.check_answers(self.x, self.pool, gt, rows, ids, dists, self.k)
        else:
            got = dict(bad_ids=0, unsorted=0, dist_err=0.0, hits=0, answered=0)
        recall = got["hits"] / (got["answered"] * self.k) if got["answered"] else None
        values = dict(bad_ids=got["bad_ids"], unsorted=got["unsorted"], dist_err=got["dist_err"],
                      recall_miss=1.0 - recall if recall is not None else 1.0)
        if "edges" in rec:
            values.update(CHECK.check_edges(self.x, rec["edge_rows"], *rec["edges"]))
            del rec["edges"], rec["edge_rows"]
        rec["checks"] = values
        rec["recall"] = recall
        rec["answers"] = None
        return rec


def device_info(device, count: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=count,
                    memory_peak_bytes=peak)
    return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=peak)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             control: Optional[str] = None, t_start: Optional[float] = None,
             before_window: Optional[Callable] = None) -> dict:
    """One run of a cell -> the result line (a dict; `checks` last).
    before_window(run), where given, is called between set-up and the window
    (calibrate.py plants a fault there)."""
    run = Run(cell, seed, device, control, t_start, trace)
    if before_window is not None:
        before_window(run)
    rec = run.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    rec = run.finish(rec)
    del run
    kind = "metrics" if trace else "end_to_end"
    metrics = {}
    for name, mod in readers(kind).items():
        v = mod.read(rec)
        if v is not None:
            metrics[name] = {"value": v, "unit": mod.UNIT}
    correct, shown = CHECK.judge(rec["checks"], cell["config"]["limits"])
    dev = device_info(device, int(cell["workload"]["chips"]), peak)
    line = dict(correct=correct, attempted=rec["attempted"], failed=rec["failed"],
                metrics=metrics, device=dev)
    if trace and rec["profile"] is not None:
        p = rec["profile"]
        dev.update(busy_s=p["busy_s"], window_s=p["window_s"])
        line["breakdown"] = dict(device_ops=p["device_ops"], idle_gaps=p["idle_gaps"])
    line["checks"] = shown
    return line


def cli(args, t_start: float) -> int:
    """The command's body: no card, no result."""
    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zvbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"zvbench: the run loaded {bad}, which it may not", file=sys.stderr)
        return 3
    for name, v in line["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

