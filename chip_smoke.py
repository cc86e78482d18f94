#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zvdb_tpu_torch) on one GPU.

    python3 chip_smoke.py              # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse   # tiny sizes on the CPU (plain versions, no kernel)

Phases, in order; any failure raises and the script exits non-zero:
  1. device   - the card's name, count and power limit (nvidia-smi);
  2. build    - nvcc builds zvdb_tpu_torch/csrc/flat_scan.cu for sm_90a;
  3. compare  - the kernel against its plain PyTorch version over a grid of
                shapes, every precision and metric, tie-aware;
  4. main     - the flat_1m_pallas configuration (1M x 128d synthetic SIFT
                stand-in, rerank=4, scan="pallas", l_bins=1024) searched in
                batches of 2048 through the kernel, recall@10 against the
                port's exact f32 search, launch counts read; then the
                single-pass kernel path (rerank=0, precision="high");
  5. server   - a SearchServer over that index answers 8 threads' requests
                with the batched search's ids;
  6. times    - kernel, plain version, torch.matmul yardstick, bound, QPS of
                search and of the server, peak device memory.
The last two lines are the kernels' JSON record and the device JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

K = 10
BATCH = 2048
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core rate, operations/s
PEAK_F32 = 67e12       # H100 SXM f32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate


class Ctx:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.device = torch.device("cpu" if rehearse else "cuda")
        # full size on the card; a tiny stand-in when rehearsing on the CPU
        self.n = 20_000 if rehearse else 1_000_000
        self.dim = 16 if rehearse else 128
        self.nq = 600 if rehearse else 10_000
        self.clusters = 200 if rehearse else 10_000
        self.l_bins = 128 if rehearse else 1024
        self.batch = 256 if rehearse else BATCH
        self.card = "cpu rehearsal"

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def time_ms(self, fn, reps: int, warmup: int = 1) -> float:
        """Mean ms per call: CUDA events around `reps` calls after warm-up."""
        for _ in range(warmup):
            fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def report(self, what: str, value):
        print(f"{what}: {value}  [{self.card}]", flush=True)


def phase_device(ctx: Ctx):
    if ctx.rehearse:
        print("device: cpu (rehearsal)")
        return
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ctx.card = smi
    ctx.kind, ctx.count = name, count
    print(f"device: {name} count={count} capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi, flush=True)


def phase_build(ctx: Ctx):
    from zvdb_tpu_torch.ops import flat_scan as FS

    if ctx.rehearse:
        print("build: skipped (rehearsal)")
        return
    FS.build()
    info = FS.build_info
    ctx.report("build seconds", round(info["seconds"], 2))
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


def _rounded_dot64(q, rows, precision):
    """q [b, D] . rows [b, L, D] -> [b, L] in f64, over the operands as
    `precision` rounds them (the exact sum of the rounded products)."""
    from zvdb_tpu_torch.ops import distance as D

    out = 0
    for a, r in D._operand_pairs(q, rows, precision):
        out = out + (a.double()[:, None, :] * r.double()).sum(-1)
    return out


def check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi, label):
    """Tie-aware agreement of kernel bins (ks, ki) with plain bins (ps, pi).

    Scores agree within rtol 1e-5 ("highest") or 1e-3 of the score scale
    (bf16 modes), the largest finite |plain score|: the two sum in other
    orders. Each kernel id lies in its bin and names a valid row, and that
    row's score recomputed in f64 is within the same tolerance of the bin
    minimum the kernel reports. Returns the largest |kernel - plain|."""
    n = x.shape[0]
    f = 2.0 if metric == "l2" else 1.0
    empty_k, empty_p = ki < 0, pi < 0
    if not torch.equal(empty_k, empty_p):
        raise AssertionError(f"{label}: empty bins differ ({int((empty_k != empty_p).sum())})")
    fin = ~empty_p
    if not bool(torch.isinf(ks[empty_k]).all()):
        raise AssertionError(f"{label}: an empty bin has a finite score")
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0

    def tolerance(ref):
        if precision == "highest":
            return 1e-5 * ref.abs() + 1e-6 * scale
        return torch.full_like(ref, 1e-3 * scale)

    diff = (ks - ps).abs()[fin]
    if bool((diff > tolerance(ps[fin])).any()):
        raise AssertionError(f"{label}: bin scores differ by up to {float(diff.max())}")
    bins = torch.arange(l_bins, device=ki.device).expand_as(ki)
    ids = ki.long()
    if not bool(((ids[fin] % l_bins) == bins[fin]).all()) or bool((ids[fin] >= n).any()):
        raise AssertionError(f"{label}: an id lies outside its bin")
    if not bool(torch.isfinite(norms[ids[fin]]).all()):
        raise AssertionError(f"{label}: an id names an invalid row")
    step = max(1, (1 << 18) // l_bins)   # queries per f64 recheck
    for lo in range(0, q.shape[0], step):
        idb = ids[lo:lo + step].clamp(min=0)
        rows = x[idb]                                         # [b, L, D]
        s64 = norms[idb].double() - f * _rounded_dot64(q[lo:lo + step], rows, precision)
        m = fin[lo:lo + step]
        ref = ks[lo:lo + step][m].double()
        gap = (s64[m] - ref).abs()
        if bool((gap > tolerance(ref)).any()):
            raise AssertionError(f"{label}: a chosen row's f64 score is {float(gap.max())} "
                                 "from its bin minimum")
    return float(diff.max()) if diff.numel() else 0.0


def compare_case(ctx, label, q, x, norms, l_bins, metric, precision):
    from zvdb_tpu_torch.ops import flat_scan as FS

    ks, ki = FS.flat_scan_bins(q, x, norms, l_bins=l_bins, chunk=l_bins * 4,
                               metric=metric, precision=precision)
    ps, pi = FS._flat_scan_bins_plain(q, x, norms, l_bins, metric, precision)
    ctx.sync()
    err = check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi, label)
    print(f"  compare {label}: ok, max |kernel - plain| = {err:.3g}", flush=True)
    return err


def phase_compare(ctx: Ctx):
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS

    rng = np.random.default_rng(123)
    dev = ctx.device
    cases = []
    for precision in ("highest", "high", "default"):
        for metric in ("l2", "dot", "cosine"):
            cases.append((37, 5000, 13, 128, metric, precision, torch.float32))
    cases += [
        (1, 3001, 128, 1024, "l2", "default", torch.bfloat16),
        (70, 4099, 128, 100, "l2", "high", torch.bfloat16),
        (8, 2048, 33, 2048, "dot", "highest", torch.float32),
    ]
    if not ctx.rehearse:
        cases.append((BATCH, 200_000, 128, 1024, "l2", "default", torch.float32))

    # the tie rule: rows L..2L-1 repeat rows 0..L-1, so every bin holds two
    # equal scores and the lower row must win, in every precision
    q = torch.from_numpy(rng.standard_normal((65, 40)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((256, 40)).astype(np.float32)).to(dev)
    x = torch.cat([x, x])
    for precision in ("highest", "high", "default"):
        _, ki = FS.flat_scan_bins(q, x, D.sq_norms(x), l_bins=256, chunk=256,
                                  precision=precision)
        if not torch.equal(ki, torch.arange(256, device=dev, dtype=torch.int32).expand(65, -1)):
            raise AssertionError(f"tie rule broken ({precision}): a higher row won a tie")
    print("  compare tie rule (duplicated rows, every precision): ok", flush=True)
    for b, n, d, l_bins, metric, precision, dtype in cases:
        xq = rng.standard_normal((b, d)).astype(np.float32)
        xc = rng.standard_normal((n, d)).astype(np.float32)
        q = D.preprocess_queries(torch.from_numpy(xq).to(dev), metric)
        x, norms = D.preprocess_corpus(torch.from_numpy(xc).to(dev), metric, dtype)
        norms[::7] = float("inf")   # invalid rows
        label = f"B={b} N={n} D={d} L={l_bins} {metric} {precision} {str(dtype)[6:]}"
        compare_case(ctx, label, q, x, norms, l_bins, metric, precision)


def make_workload(ctx: Ctx):
    from zvdb_tpu_torch.io.datasets import synthetic_clustered

    t0 = time.perf_counter()
    x1 = synthetic_clustered(ctx.n, ctx.dim, n_clusters=ctx.clusters, seed=0)
    qrng = np.random.default_rng(777)
    q1 = (x1[qrng.integers(0, ctx.n, ctx.nq)]
          + 0.05 * qrng.standard_normal((ctx.nq, ctx.dim))).astype(np.float32)
    print(f"workload: corpus {x1.shape} queries {q1.shape} made in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return x1, q1


def batched_ids(ctx, index, q1, approx):
    out = [index.search(q1[lo:lo + ctx.batch], K, approx=approx)[1]
           for lo in range(0, q1.shape[0], ctx.batch)]
    return torch.cat(out).cpu().numpy()


def phase_main(ctx: Ctx, x1, q1):
    from zvdb_tpu_torch import FlatConfig, FlatIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops.flat_scan import flat_scan_bins

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are still on")
    dev = ctx.device
    n_batches = -(-q1.shape[0] // ctx.batch)

    t0 = time.perf_counter()
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(x1)
    gt = batched_ids(ctx, oracle, q1, approx=False)
    ctx.sync()
    ctx.report("ground truth seconds (exact f32 tiled search)", round(time.perf_counter() - t0, 2))
    del oracle

    cfg = FlatConfig(dim=ctx.dim, rerank=4, recall_target=0.97, scan="pallas",
                     l_bins=ctx.l_bins, pallas_chunk=4 * ctx.l_bins, pallas_bq=512)
    flp = FlatIndex(cfg, capacity=ctx.n, device=dev)
    flp.add(x1)
    ctx.sync()

    flat_scan_bins.launches = 0
    ids = batched_ids(ctx, flp, q1, approx=True)
    ctx.sync()
    launches = flat_scan_bins.launches
    rec = recall_at_k(ids, gt, K)
    ctx.report("main path flat_1m_pallas recall@10", rec)
    ctx.report("main path flat_1m_pallas kernel launches", f"{launches} for {n_batches} batches")
    if not ctx.rehearse and launches != n_batches:
        raise AssertionError(f"kernel launched {launches} times for {n_batches} batches")
    if rec < 0.95:
        raise AssertionError(f"recall@10 {rec} < 0.95")

    single = FlatIndex(FlatConfig(dim=ctx.dim, rerank=0, precision="high", scan="pallas",
                                  l_bins=ctx.l_bins, pallas_chunk=4 * ctx.l_bins,
                                  pallas_bq=512), capacity=ctx.n, device=dev)
    single.add(x1)
    flat_scan_bins.launches = 0
    ids1 = batched_ids(ctx, single, q1, approx=True)
    ctx.sync()
    launches1 = flat_scan_bins.launches
    rec1 = recall_at_k(ids1, gt, K)
    ctx.report("single-pass kernel path (rerank=0, high) recall@10", rec1)
    ctx.report("single-pass kernel path launches", f"{launches1} for {n_batches} batches")
    if not ctx.rehearse and launches1 != n_batches:
        raise AssertionError(f"kernel launched {launches1} times for {n_batches} batches")
    if rec1 < 0.95:
        raise AssertionError(f"single-pass recall@10 {rec1} < 0.95")
    del single
    return flp, ids, launches


def phase_server(ctx: Ctx, flp, q1, ids):
    from zvdb_tpu_torch import SearchServer

    n_req = 400
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 9, n_req)          # single queries and small batches
    sizes[::2] = 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % (q1.shape[0] - 8)
    results = [None] * n_req

    with SearchServer(flp, k=K, max_batch=ctx.batch, max_wait_ms=2.0,
                      search_kwargs={"approx": True}) as srv:
        def worker(t):
            futs = []
            for r in range(t, n_req, 8):
                lo = int(starts[r])
                qq = q1[lo] if sizes[r] == 1 else q1[lo:lo + sizes[r]]
                futs.append((r, srv.submit(qq)))
            for r, fut in futs:
                results[r] = fut.result(timeout=600)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        if any(th.is_alive() for th in threads):
            raise AssertionError("server workers did not finish")
    bad = 0
    for r in range(n_req):
        lo = int(starts[r])
        got = results[r][1]
        want = ids[lo:lo + sizes[r]]
        bad += int((got != want).any(axis=1).sum())
    ctx.report("server requests answered", f"{n_req} requests, {int(sizes.sum())} queries, "
                                          f"{bad} queries differ from the batched search")
    if bad:
        raise AssertionError(f"{bad} server answers differ from the batched search")


def phase_times(ctx: Ctx, flp, q1):
    from zvdb_tpu_torch import SearchServer
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS

    dev = ctx.device
    st = flp.state
    qs = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), "l2")
    b, d = qs.shape
    n, L = st.vectors.shape[0], ctx.l_bins
    args = dict(l_bins=L, chunk=4 * L, metric="l2")

    # the kernel on the main path's own inputs, held against its plain version
    err = 0.0
    for precision in ("default", "high"):
        ks, ki = FS.flat_scan_bins(qs, st.vectors, st.norms, precision=precision, **args)
        ps, pi = FS._flat_scan_bins_plain(qs, st.vectors, st.norms, L, "l2", precision)
        ctx.sync()
        e = check_bins(qs, st.vectors, st.norms, L, "l2", precision, ks, ki, ps, pi,
                       f"main-path inputs {precision}")
        print(f"  compare main-path inputs B={b} N={n} D={d} L={L} {precision}: ok, "
              f"max |kernel - plain| = {e:.3g}", flush=True)
        if precision == "default":
            err = e
        del ks, ki, ps, pi

    ms = ctx.time_ms(lambda: FS.flat_scan_bins(qs, st.vectors, st.norms,
                                               precision="default", **args), reps=10)
    ms_high = ctx.time_ms(lambda: FS.flat_scan_bins(qs, st.vectors, st.norms,
                                                    precision="high", **args), reps=5)
    plain_ms = ctx.time_ms(lambda: FS._flat_scan_bins_plain(qs, st.vectors, st.norms, L,
                                                            "l2", "default"), reps=3)
    qb = qs.to(torch.bfloat16).float()
    xb = st.vectors.to(torch.bfloat16).float()
    library_ms = ctx.time_ms(lambda: torch.matmul(qb, xb.T), reps=5)
    del qb, xb
    ops = 2.0 * b * n * d
    nbytes = n * d * st.vectors.element_size() + n * 4 + b * d * 4 + b * L * 8
    bound_ops, bound_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    ctx.report("kernel ms (default, B=2048 N=1M D=128 L=1024)", ms)
    ctx.report("kernel ms (high)", ms_high)
    ctx.report("kernel achieved TFLOP/s (default)", ops / (ms * 1e-3) / 1e12)
    ctx.report("plain version ms (default)", plain_ms)
    ctx.report("torch.matmul yardstick ms (bf16-rounded [2048,128]x[128,1M] in f32)", library_ms)
    ctx.report("bound ms (default: bf16 ops / 989 TFLOP/s vs bytes / 3.35 TB/s)",
               f"{bound_ms} (ops {bound_ops}, bytes {bound_bytes})")
    ctx.report("bound ms (high, 3x bf16 ops)", 3 * bound_ops)
    ctx.report("bound ms (highest, f32 ops / 67 TFLOP/s)", ops / PEAK_F32 * 1e3)

    # end-to-end: search() over every query, host clock ending in a sync
    qps_runs = []
    for _ in range(3):
        ctx.sync()
        t0 = time.perf_counter()
        for lo in range(0, q1.shape[0], ctx.batch):
            flp.search(q1[lo:lo + ctx.batch], K, approx=True)
        ctx.sync()
        qps_runs.append(q1.shape[0] / (time.perf_counter() - t0))
    ctx.report("search QPS (batches of 2048, 3 runs)", qps_runs)

    chunk = 16
    with SearchServer(flp, k=K, max_batch=ctx.batch, max_wait_ms=2.0,
                      search_kwargs={"approx": True}) as srv:
        def worker(t, futs):
            for lo in range(t * chunk, q1.shape[0], 8 * chunk):
                futs.append(srv.submit(q1[lo:lo + chunk]))

        ctx.sync()
        t0 = time.perf_counter()
        all_futs = [[] for _ in range(8)]
        threads = [threading.Thread(target=worker, args=(t, all_futs[t])) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        for futs in all_futs:
            for fut in futs:
                fut.result(timeout=900)
        ctx.sync()
        server_qps = q1.shape[0] / (time.perf_counter() - t0)
    ctx.report("server QPS (8 threads, requests of 16 queries)", server_qps)
    if dev.type == "cuda":
        ctx.report("peak device memory GB (max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                max_abs_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; prints no result")
    args = ap.parse_args()
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import zvdb_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    ctx = Ctx(args.rehearse)
    t_start = time.perf_counter()
    phase_device(ctx)
    phase_build(ctx)
    phase_compare(ctx)
    x1, q1 = make_workload(ctx)
    flp, ids, launches = phase_main(ctx, x1, q1)
    phase_server(ctx, flp, q1, ids)
    t = phase_times(ctx, flp, q1)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    record = {"kernels": [{
        "name": "flat_scan_bins",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/flat_scan.cu",
        "replaces": "zvdb_tpu/ops/pallas_topk.py:113",
        "launches": launches,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "operations",
        "library_ms": t["library_ms"],
    }]}
    if ctx.rehearse:
        print(json.dumps(record))
        print("rehearsal finished: no result line (run on a GPU for one)")
        return 0
    print(json.dumps(record))
    print(ctx.card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ctx.kind,
                                             "count": ctx.count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
