#!/usr/bin/env python3
"""Time kernel G's two routes and their tunables on one GPU.

    python3 hop_route_sweep.py                     # the variants in VARIANTS
    python3 hop_route_sweep.py "" STEPS=2 GSTEPS=1
    python3 hop_route_sweep.py --baseline FILE     # also time FILE's zvdb_hop_scores

A variant sets some of the source's tunables (the ZVDB_HOP_ macros at the top
of zvdb_tpu_torch/csrc/hop_scores.cu, named without the prefix; "" is the
source as it is). Each is built with nvcc -DZVDB_HOP_...=..., all at once,
into build/kernels/, with ptxas's registers and spills printed; its routes
are held against the plain version (within 1e-5 |q| |x|, NaN for ids outside
[0, N)) and its counting pass against `_window_order_plain` (equal) on small
shapes. Then, over a seeded normal 1M x 128d corpus on the card, at six hop
shapes from the cagra_1m hop (B=2048, K=128, 96 live) to B=8192, K=256, and
the experiment's shape over a corpus that fits in L2 (N=49,152), it prints
each shape's distinct rows, expected share of repeats and bound (each
distinct row once, ids, q and output over 3.35 TB/s); each variant's direct
route and grouped route at several window sizes (entry points called
directly, scratch made beforehand; shift 20 puts every pair of a corpus of
up to 2^20 rows in one window, idx's own order) and its counting pass
alone; the wrapper's two routes (each forced by swapping out
`choose_route`); and torch.profiler's device time of each kernel of the
first variant, the grouped route's scorer alone among them. Times are CUDA
events over 20 calls, each beside its share of the bound. --baseline times another source's direct entry point beside them
(for example the parent commit's kernel). The last line is the JSON of
every time. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

VARIANTS = ["", "STEPS=2", "GSTEPS=1"]
SHIFTS = (12, 13, 14, 16, 20)   # 20: one window at N <= 2^20, the scorer in idx's own order
SHAPES = [  # (name, B, K, live, N)
    ("cagra_1m hop", 2048, 128, 96, 1_000_000), ("B=2048 K=256", 2048, 256, None, 1_000_000),
    ("B=3072 K=256", 3072, 256, None, 1_000_000), ("B=4096 K=256", 4096, 256, None, 1_000_000),
    ("experiment", 4992, 256, None, 1_000_000), ("B=8192 K=256", 8192, 256, None, 1_000_000),
    ("experiment, L2-resident corpus", 4992, 256, None, 49_152)]
CASES = [(8, 128, 32), (64, 256, 128), (8, 128, 100), (8, 128, 13)]   # (B, K, D), N=5000


def build(name: str, path: str, flags=()):
    """nvcc the source at `path` into build/kernels/; returns its library and
    ptxas's register and spill lines."""
    from zvdb_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / f"sweep_hop_{name}.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(lib),
                           path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(lib)), ptxas


class Entries:
    """A library's entry points, called on the current stream."""

    def __init__(self, dll, grouped=True):
        self.direct = dll.zvdb_hop_scores
        self.direct.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        self.direct.restype = ctypes.c_int
        if not grouped:
            return
        self.grouped = dll.zvdb_hop_scores_grouped
        self.grouped.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
        self.grouped.restype = ctypes.c_int
        self.order = dll.zvdb_hop_window_order
        self.order.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        self.order.restype = ctypes.c_int
        self.scratch_ints = dll.zvdb_hop_scratch_ints
        self.scratch_ints.argtypes = [ctypes.c_int] * 3
        self.scratch_ints.restype = ctypes.c_longlong

    def run(self, route, idx, q, x, out, shift=None, scratch=None):
        b, k = idx.shape
        n, d = x.shape
        s = torch.cuda.current_stream().cuda_stream
        if route == "direct":
            rc = self.direct(idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k, n,
                             d, s)
        elif route == "grouped":
            rc = self.grouped(idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k,
                              n, d, shift, scratch.data_ptr(), scratch.numel(), s)
        else:
            rc = self.order(idx.data_ptr(), b * k, n, shift, scratch.data_ptr(), scratch.numel(),
                            s)
        if rc != 0:
            raise RuntimeError(f"{route}: CUDA error {rc}")

    def scratch(self, b, k, n, shift):
        need = self.scratch_ints(b * k, n, shift)
        if need < 0:
            raise ValueError(f"no window order for N={n}, shift={shift}")
        return torch.empty(need, dtype=torch.int32, device="cuda")


def check(name, ent, rng):
    """Both routes against the plain version, the counting pass against its
    plain version, on the small cases (duplicated and out-of-range ids)."""
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import hop_scores as HS

    dev = torch.device("cuda")
    for b, k, d in CASES:
        for n in (5000, 7):   # 7 rows: every id repeats many times
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
            idx = torch.from_numpy(CS._hop_ids(rng, b, k, n, live=k // 2)).to(dev)
            idx[0, 0], idx[-1, -1] = -1, n   # outside [0, N): NaN
            want = HS._hop_scores_plain(idx.clamp(0, n - 1), q, x)
            shifts = [s for s in (0, 4, HS.window_shift(n, d, ent.scratch_ints))
                      if ent.scratch_ints(b * k, n, s) >= 0]
            for route, shift in [("direct", None)] + [("grouped", s) for s in shifts]:
                out = torch.full((b, k), 7.0, device=dev)
                scratch = ent.scratch(b, k, n, shift) if shift is not None else None
                ent.run(route, idx, q, x, out, shift, scratch)
                torch.cuda.synchronize()
                if not (bool(torch.isnan(out[0, 0])) and bool(torch.isnan(out[-1, -1]))):
                    raise AssertionError(f"{name} {route}: an id outside [0, N) did not score NaN")
                out[0, 0], out[-1, -1] = want[0, 0], want[-1, -1]
                CS._hop_check(idx.clamp(0, n - 1), q, x, out, want,
                              f"{name} {route} shift={shift} B={b} K={k} N={n} D={d}")
                if route == "grouped":
                    ent.run("order", idx, q, x, out, shift, scratch)
                    pos, ids, _ = HS._window_order_plain(idx, n, shift)
                    got = scratch[:2 * b * k].view(-1, 2)
                    if not (torch.equal(got[:, 0], pos) and torch.equal(got[:, 1], ids)):
                        raise AssertionError(f"{name}: window order differs at shift={shift}, "
                                             f"B={b} K={k} N={n}")
    print(f"  {name}: both routes and the counting pass equal their plain versions", flush=True)


def profile(ent, idx, q, x, out, shift):
    """Device ms a call by kernel of 10 calls of each route (torch.profiler),
    printed and returned."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    scratch = ent.scratch(*idx.shape, x.shape[0], shift)
    res = {}
    for route in ("direct", "grouped"):
        ent.run(route, idx, q, x, out, shift, scratch)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ent.run(route, idx, q, x, out, shift, scratch)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if us and ev.count:
                where = f" (shift {shift})" if route == "grouped" else ""
                res[f"profile {route}{where}: {ev.key[:60]}"] = us / ev.count / 1e3
                print(f"  profile {route}{where}: {ev.key[:60]}: {ev.count} calls, "
                      f"{us / ev.count / 1e3:.4f} ms a call", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=VARIANTS)
    ap.add_argument("--baseline", help="a source whose zvdb_hop_scores is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hop_route_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from zvdb_tpu_torch.ops import hop_scores as HS

    ctx = CS.Ctx(False)
    CS.phase_device(ctx)
    src = os.path.join(ROOT, "zvdb_tpu_torch", "csrc", "hop_scores.cu")
    ents = {}
    with ThreadPoolExecutor(len(args.variants) + 1) as pool:
        futs = {}
        for spec in args.variants:
            sets = [kv for kv in spec.split(",") if kv]
            name = "_".join(kv.replace("=", "") for kv in sets).lower() or "source"
            futs[name] = pool.submit(build, name, src, [f"-DZVDB_HOP_{kv}" for kv in sets])
        if args.baseline:
            futs["baseline"] = pool.submit(build, "baseline", args.baseline)
        for name, fut in futs.items():
            dll, ptxas = fut.result()
            print(f"variant {name}")
            for ln in ptxas:
                print("  ptxas:", ln)
            ents[name] = Entries(dll, grouped=name != "baseline")
    rng = np.random.default_rng(21)
    for name, ent in ents.items():
        if name != "baseline":
            check(name, ent, rng)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((1_000_000, 128), generator=gen, device=dev)
    res = {"card": ctx.card}
    for sname, b, k, live, n in SHAPES:
        x = corpus[:n]
        d = x.shape[1]
        idx = torch.from_numpy(CS._hop_ids(rng, b, k, n, live)).to(dev)
        q = torch.randn((b, d), generator=gen, device=dev)
        out = torch.empty((b, k), device=dev)
        rows = int(torch.unique(idx).numel())
        bound = (rows * d * 4 + 2 * b * k * 4 + b * d * 4) / CS.HBM_BYTES_S * 1e3
        row = {"distinct_rows": rows, "pairs": b * k, "repeat_share": HS.repeat_share(b, k, n),
               "route": HS.choose_route(b, k, n), "bound_ms": bound}
        print(f"shape {sname} (B={b} K={k} N={n} D={d}): {rows} distinct rows of {b * k}, "
              f"expected repeat share {row['repeat_share']:.3f}, bound {bound:.4f} ms, "
              f"route {row['route']}", flush=True)
        for name, ent in ents.items():
            row[f"{name} direct"] = ctx.time_ms(lambda: ent.run("direct", idx, q, x, out), 20)
            if name == "baseline":
                continue
            for shift in SHIFTS:
                scratch = ent.scratch(b, k, n, shift)
                row[f"{name} grouped shift={shift}"] = ctx.time_ms(
                    lambda: ent.run("grouped", idx, q, x, out, shift, scratch), 20)
                row[f"{name} counting pass shift={shift}"] = ctx.time_ms(
                    lambda: ent.run("order", idx, q, x, out, shift, scratch), 20)
        for route in CS.HOP_ROUTES:
            with CS._hop_route(HS, route):
                row[f"wrapper {route}"] = ctx.time_ms(lambda: HS.fused_hop_scores(idx, q, x), 20)
        first = ents[next(iter(ents))]
        row.update(profile(first, idx, q, x, out, HS.window_shift(n, d, first.scratch_ints)))
        for key, ms in row.items():
            if key.endswith(("direct", "wrapper grouped")) or "shift=" in key:
                print(f"  {key}: {ms:.4f} ms ({bound / ms:.1%} of the bound)  [{ctx.card}]",
                      flush=True)
        res[sname] = row
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
