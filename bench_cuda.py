#!/usr/bin/env python
"""Headline benchmark on the PyTorch/CUDA port: QPS at recall@10 >= 0.95,
100k x 128d SIFT-like corpus, plus the 1M rows (port of bench.py).

    python bench_cuda.py                    # on an NVIDIA GPU (the default device)
    ZVDB_BENCH_SMOKE=1 python bench_cuda.py --device cpu   # small shapes on the CPU

Workload, rows, configs and protocol are bench.py's, run through
zvdb_tpu_torch: the 100k section (flat, ivf, cagra, hnsw; 10k queries, k=10)
and the 1M section (pq_1m, ivfpq_1m, cagra_1m, flat_1m, flat_1m_pallas), in
bench.py's order, with the cumulative result JSON line printed on stdout
after every section (the last complete line is the result; the line's keys
are bench.py's). Rows that run a hand-written kernel check its launch count
on the card: flat_1m_pallas kernel A, pq_1m kernel B (both on the tensor
cores), ivfpq_1m the pair scan (kernel C's successor, ops/pq_scan.py:
pq_grouped_scan_pairs). Where bench.py's row reaches lax.approx_min_k, the
port's row launches ops/approx_topk.py:approx_min_k under JAX's guards,
counted as "approx": flat and flat_1m once per corpus tile and search call;
cagra and cagra_1m once per block chunk of every build (bench.py's
block_topk="approx") and once per search call (the seed anchors); hnsw once
per block chunk of every build's base layer; ivf once per search call whose
probes or pair-scan cut pass the guard. Kernel D does not run on the graph
rows (block_topk is not "pallas").

Builds are timed warm where bench.py's are (a first build pays each op's
first use; kernels are built once per process before the first row), best
of 2 with both samples; search QPS is best of 2 with both samples
(`timed_qps`). Every timed region ends in a device sync.

Environment switches, as bench.py's: ZVDB_BENCH_SMOKE=1 (20k and 60k rows,
2,000 queries), ZVDB_BENCH_SCALE=<rows> (the chunked 96d scale rows, off by
default) and ZVDB_BENCH_SCALE_ENGINE ("pq", "ivfpq" or both, comma-separated).
A row that fails is logged and the rows after it still run; the run then
exits 1. Without a CUDA device and without --device cpu, the one error JSON
line is printed and the run exits 1.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zvdb_tpu_torch import (HNSW, CagraConfig, CagraIndex, FlatConfig, FlatIndex, HNSWConfig,
                            IVFConfig, IVFIndex, IVFPQConfig, IVFPQIndex, PQConfig, PQFlatIndex)
from zvdb_tpu_torch.bench.harness import (_block_until_ready, _sync, ground_truth_host,
                                          recall_at_k)
from zvdb_tpu_torch.io.datasets import load_dataset, synthetic_clustered
from zvdb_tpu_torch.index.cagra import anchor_count, seed_route
from zvdb_tpu_torch.index.ivf import use_pair_scan
from zvdb_tpu_torch.ops import approx_topk as AK
from zvdb_tpu_torch.ops import block_scan as BS
from zvdb_tpu_torch.ops import flat_scan as FS
from zvdb_tpu_torch.ops import pq_scan as PS

# The Zig CPU reference's measured numbers (BASELINE.md "Measured":
# single-threaded CPU, 100k x 128d); no accelerator's.
REFERENCE_QPS = 2678.13      # search throughput
REFERENCE_BUILD = 8392.22    # insert throughput
TARGET_RECALL = 0.95
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "bench_cache")

# Each row's keys, as bench.py writes them into `results`.
ROW_KEYS = {
    "flat": ("recall", "qps", "qps_runs", "build_pps", "build_runs_pps"),
    "pq_1m": ("recall", "qps", "qps_runs", "build_pps", "build_runs_pps"),
    "ivfpq_1m": ("recall", "qps", "qps_runs", "build_pps", "build_runs_pps", "nprobe",
                 "rerank"),
    "cagra_1m": ("recall", "qps", "qps_runs", "build_pps", "build_pps_hostcorpus", "ef",
                 "build_runs_pps"),
    "ivf": ("recall", "qps", "qps_runs", "build_pps", "build_pps_hostcorpus", "nprobe",
            "build_runs_pps", "build_runs_pps_hostcorpus"),
    "cagra": ("recall", "qps", "qps_runs", "build_pps", "build_pps_hostcorpus", "ef",
              "build_runs_pps", "build_runs_pps_hostcorpus"),
    "hnsw": ("recall", "qps", "qps_runs", "build_pps", "build_pps_hostcorpus", "ef",
             "build_runs_pps", "build_runs_pps_hostcorpus"),
    "flat_1m": ("recall", "qps", "qps_runs", "build_pps", "build_runs_pps"),
    "flat_1m_pallas": ("recall", "qps", "qps_runs"),
}
SCALE_KEYS = ("recall", "qps", "qps_runs", "build_pps")
SCALE_CHUNK = 2_000_000   # rows the scale rows build or add at once (bench.py's chunk)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_qps(search_fn, q, batch, reps=6, device="cuda"):
    """Amortized wall-clock QPS: queue `reps` full passes over the query
    batches, then sync once. The batches are staged on the device first
    (serving pipelines keep queries device-resident). Best of two timing
    passes with BOTH samples returned.

    Searches that wait for the device inside themselves (HNSW's descent
    syncs once a hop) keep those waits in the timed window: users pay them.

    Returns (best_qps, [run1_qps, run2_qps])."""
    staged = [torch.as_tensor(q[lo:lo + batch]).to(device)
              for lo in range(0, q.shape[0], batch)]
    _block_until_ready(staged)
    runs = []
    for _pass in range(2):
        outs = []
        t0 = time.perf_counter()
        for _ in range(reps):
            for qb in staged:
                outs.append(search_fn(qb))
        _block_until_ready(outs)
        dt = time.perf_counter() - t0
        runs.append(round(reps * q.shape[0] / dt, 1))
    return max(runs), runs


def emit(results):
    """Print the cumulative machine-readable result line (stdout, flushed).

    Called after every completed section so a run cut mid-way still leaves
    the last complete snapshot parseable; the final call is the full
    result. Headline = best 100k-protocol engine clearing the recall target
    (1M/scale rows are reported alongside in `engines`)."""
    results_100k = {k2: v2 for k2, v2 in results.items() if "_" not in k2}
    pool = results_100k or results
    best_name, best = max(
        ((name, r) for name, r in pool.items()
         if r["recall"] >= TARGET_RECALL),
        key=lambda kv: kv[1]["qps"],
        default=(None, None),
    )
    if best is None:
        best_name, best = max(pool.items(), key=lambda kv: kv[1]["recall"])

    # build_pps is the device-resident number for the ivf/graph engines;
    # build_pps_hostcorpus keeps the upload in (flat's ingest IS the upload,
    # so flat reports the host number as build_pps).
    out = {
        "metric": "qps_at_recall0.95@10_100k_128d_sift_like",
        "value": round(best["qps"], 1),
        "unit": "qps",
        "vs_baseline": round(best["qps"] / REFERENCE_QPS, 2),
        "engine": best_name,
        "recall": round(best["recall"], 4),
        "build_pts_per_sec": round(best["build_pps"], 1),
        "build_pts_per_sec_hostcorpus": round(
            best.get("build_pps_hostcorpus", best["build_pps"]), 1),
        "build_vs_baseline": round(best["build_pps"] / REFERENCE_BUILD, 2),
        "build_hostcorpus_vs_baseline": round(
            best.get("build_pps_hostcorpus", best["build_pps"])
            / REFERENCE_BUILD, 2),
        "engines": {k2: {k3: (round(v3, 4) if isinstance(v3, float) else v3)
                         for k3, v3 in v2.items()} for k2, v2 in results.items()},
    }
    print(json.dumps(out), flush=True)


def corpus_1m(d, nq, k, n1=1_000_000, device="cuda", cache_dir=CACHE_DIR):
    """1M corpus + self-contained query stream + cached exact GT.

    The query rng is its own stream (seed 777), not a continuation of the
    100k section's, so section order never invalidates the GT cache; the
    cache name carries a corpus fingerprint. The oracle is the exact f32
    flat search (TF32 off)."""
    x1 = synthetic_clustered(n1, d, n_clusters=min(10_000, n1 // 10), seed=0)
    qrng = np.random.default_rng(777)
    q1 = (x1[qrng.integers(0, n1, nq)]
          + 0.05 * qrng.standard_normal((nq, d))).astype(np.float32)
    fp = int(abs(float(x1[::9973].sum())) * 997) % 10**9
    gt1_cache = os.path.join(cache_dir, f"zvdb_torch_gt1m_v3_{n1}_{d}_{nq}_{k}_{fp}.npz")
    if os.path.exists(gt1_cache):
        gt1 = np.load(gt1_cache)["gt"]
    else:
        oracle = FlatIndex(
            FlatConfig(dim=d, precision="highest", tile_n=262144),
            capacity=n1, device=device)
        oracle.add(x1)
        gt1 = search_ids(lambda qq: oracle.search(qq, k), q1, 2048)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(gt1_cache, gt=gt1)
        del oracle
    return x1, q1, gt1


def search_ids(search_fn, q, batch):
    """Ids of search_fn over q in batches, as one host array."""
    return np.concatenate([search_fn(q[lo:lo + batch])[1].cpu().numpy()
                           for lo in range(0, q.shape[0], batch)])


def search_calls(nq, batch, reps):
    """Search calls a row makes: one recall pass plus timed_qps' 2 x reps passes."""
    return math.ceil(nq / batch) * (1 + 2 * reps)


def timed_builds(factory, build, n, device, on_built=None):
    """Two builds of a fresh index, each timed to a device sync; on_built,
    if given, is called with each built index (after its timing).
    Returns (best seconds, [points/s of each], the last index)."""
    best, runs, idx = float("inf"), [], None
    for _ in range(2):
        idx = factory()
        t0 = time.perf_counter()
        build(idx)
        _sync(device)
        dt = time.perf_counter() - t0
        runs.append(round(n / dt, 1))
        best = min(best, dt)
        if on_built is not None:
            on_built(idx)
    return best, runs, idx


def kernel_counts():
    """Launch counters of the kernels a bench row can reach (A, B, C and the
    pair scan, D, approx_min_k)."""
    return {"A": FS.flat_scan_bins.launches, "A_mma": FS.flat_scan_bins.launches_mma,
            "B": PS.pq_scan_bins.launches, "B_mma": PS.pq_scan_bins.launches_mma,
            "C": PS.pq_grouped_scan_bins.launches,
            "C_pairs": PS.pq_grouped_scan_pairs.launches, "D": BS.block_bins.launches,
            "approx": AK.approx_min_k.launches}


def flat_tiles(n, tile_n):
    """Corpus tiles of a flat scan over n rows: approx_min_k launches per
    search call of the flat engine's approximate tiled path."""
    return -(-n // min(tile_n, n))


def graph_build_launches(idx):
    """approx_min_k launches of one graph build (CAGRA, or HNSW's one-shot
    base layer) from its build_stats: one per chunk of cc blocks, when
    block_topk is "approx" and the blocks pass JAX's bcap >= 4 * kk."""
    st = idx.build_stats
    if idx.cfg.block_topk != "approx" or "c_blocks" not in st:   # no cluster-kNN build
        return 0
    if st["bcap"] < 4 * min(st["kc"], st["bcap"]):
        return 0
    return sum(-(-cb // st["cc"]) for cb in st["c_blocks"])


def pass_sizes(nq, batch):
    """The queries of each search call of one pass over nq queries."""
    return [min(batch, nq - lo) for lo in range(0, nq, batch)]


def cagra_seed_launches(idx, sizes):
    """Kernel launches of CAGRA search calls of `sizes` queries each for
    their seed anchors (index/cagra.py:seed_route): approx_min_k once a call
    unless the seeds are exact, and kernel A on the tensor cores once a call
    that takes the "bins" route."""
    a = idx.state.anchors.shape[0]
    routes = [seed_route(b, a, idx.cfg.n_seeds, idx.cfg.seed_approx, idx.cfg.precision,
                         idx.state.anchors.is_cuda) for b in sizes]
    bins = routes.count("bins")
    return {"approx": len(routes) - routes.count("exact"), "A": bins, "A_mma": bins}


def cagra_rows_seed_bins(results, n, nq, n1, d, metric, device):
    """Kernel A launches of `run`'s two CAGRA rows for their seed bins, as
    each row's check_launches held it: cagra_1m's recall pass and 2 x 3
    timed passes over nq queries in batches of 5000; cagra's ef sweep on
    2048 queries up to the ef it chose (results["cagra"]["ef"]) and its
    2 x 3 timed passes."""
    def bins(cfg, rows, sizes):
        anchors = torch.empty(anchor_count(rows, cfg.n_anchors), 0, device=device)
        idx = types.SimpleNamespace(cfg=cfg, state=types.SimpleNamespace(anchors=anchors))
        return cagra_seed_launches(idx, sizes)["A"]

    ef = results["cagra"]["ef"]
    sweep = CAGRA_EFS.index(ef) + 1 if ef in CAGRA_EFS else len(CAGRA_EFS)
    return (bins(cagra_1m_config(n1, d, metric), n1, pass_sizes(nq, 5000) * (1 + 2 * 3))
            + bins(cagra_config(d, metric), n,
                   [min(2048, nq)] * sweep + pass_sizes(nq, 5000) * (2 * 3)))


def ivf_search_launches(idx, b, nprobe, k, rerank=0):
    """approx_min_k launches of one unfiltered IVF-Flat search call of b
    queries: the probes when C >= 4096 and 4 * nprobe <= C, the pair scan's
    cut when it takes the pair scan and cap >= 4 * kk."""
    c, cap = idx.state.blocks.shape[:2]
    p = min(nprobe, c)
    kk = min(k * rerank if rerank else k, cap)
    return int(c >= 4096 and 4 * p <= c) + int(use_pair_scan(c, b, p) and cap >= 4 * kk)


def check_launches(row, device, before, expect):
    """On the card, each counter must have risen since `before` by exactly
    `expect` (0 where not named): the kernel ran, and no plain path took its
    place. On the CPU the wrappers run their plain versions and count nothing."""
    got = {name: v - before[name] for name, v in kernel_counts().items()}
    log(f"{row} kernel launches: {got}")
    if torch.device(device).type != "cuda":
        return
    want = {name: expect.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{row}: kernel launches {got}, expected {want}")


def to_device(x, device):
    xd = torch.from_numpy(x).to(device)
    _sync(device)
    return xd


# ---- the 100k rows -----------------------------------------------------------

def row_flat(x, q, gt, k, metric="l2", device="cuda"):
    """TPU-KNN brute force: the tiled scan at precision "high" (bf16x3),
    each tile's candidates selected by approx_min_k at recall_target 0.97
    (on the card its kernel, once per tile and search call)."""
    n, d = x.shape
    flat_cfg = FlatConfig(dim=d, metric=metric, precision="high",
                          recall_target=0.97, tile_n=131072)
    flat_build_s, flat_build_runs, flat = timed_builds(
        lambda: FlatIndex(flat_cfg, capacity=n, device=device), lambda i: i.add(x), n, device)
    # one batch = one dispatch per pass
    batch = q.shape[0]
    before = kernel_counts()
    fn = lambda qq: flat.search(qq, k, approx=True)
    flat_recall = recall_at_k(search_ids(fn, q, batch), gt, k)
    flat_qps, flat_qps_runs = timed_qps(fn, q, batch, device=device)
    check_launches("flat", device, before,
                   {"approx": search_calls(q.shape[0], batch, 6) * flat_tiles(n, 131072)})
    log(f"flat: recall={flat_recall:.4f} qps={flat_qps:,.0f} build={n/flat_build_s:,.0f} pts/s")
    return dict(recall=flat_recall, qps=flat_qps, qps_runs=flat_qps_runs,
                build_pps=n / flat_build_s, build_runs_pps=flat_build_runs)


def row_ivf(x, q, gt, k, metric="l2", device="cuda"):
    """IVF-Flat: builds from the host corpus and from device rows, the
    nprobe sweep {2, 4, 8} to the recall target; approx_min_k where the
    probes or the pair scan's cut pass JAX's guards."""
    n, d = x.shape
    batch = q.shape[0]
    ivf_cfg = IVFConfig(dim=d, n_clusters=1024, nprobe=8, metric=metric,
                        kmeans_iters=4, kmeans_sample=65536)
    before = kernel_counts()
    warm = IVFIndex(ivf_cfg, device=device)
    warm.build(x)                      # first use of every op
    _sync(device)
    del warm
    ivf_build_s, ivf_host_runs, ivf = timed_builds(
        lambda: IVFIndex(ivf_cfg, device=device), lambda i: i.build(x), n, device)
    xd = to_device(x, device)
    warm = IVFIndex(ivf_cfg, device=device)
    warm.build(xd)
    _sync(device)
    del warm
    ivf_build_dev_s, ivf_dev_runs, _ = timed_builds(
        lambda: IVFIndex(ivf_cfg, device=device), lambda i: i.build(xd), n, device)
    del xd
    best_ivf, calls = None, 0
    for npb in (2, 4, 8):
        calls += ivf_search_launches(ivf, batch, npb, k)
        r = recall_at_k(search_ids(lambda qq: ivf.search(qq, k, nprobe=npb), q, batch), gt, k)
        log(f"ivf nprobe={npb} recall={r:.4f}")
        if r >= TARGET_RECALL:
            best_ivf = (npb, r)
            break
    if best_ivf is None:
        best_ivf = (8, r)
    npb, ivf_recall = best_ivf
    ivf_qps, ivf_qps_runs = timed_qps(
        lambda qq: ivf.search(qq, k, nprobe=npb), q, batch, device=device)
    calls += 2 * 6 * ivf_search_launches(ivf, batch, npb, k)
    check_launches("ivf", device, before, {"approx": calls})
    log(f"ivf: recall={ivf_recall:.4f} qps={ivf_qps:,.0f} "
        f"build={n/ivf_build_dev_s:,.0f} pts/s device-resident "
        f"(host-corpus {n/ivf_build_s:,.0f}) (nprobe={npb})")
    return dict(recall=ivf_recall, qps=ivf_qps, qps_runs=ivf_qps_runs,
                build_pps=n / ivf_build_dev_s, build_pps_hostcorpus=n / ivf_build_s,
                nprobe=npb, build_runs_pps=ivf_dev_runs,
                build_runs_pps_hostcorpus=ivf_host_runs)


def _graph_row(name, factory, efs, ef_fallback, reps, x, q, gt, k, device):
    """The cagra and hnsw rows: a warm build, two host-corpus and two
    device-row builds, the ef sweep on the first 2048 queries, QPS in
    batches of 5000. approx_min_k runs in each build's block cut and, for
    CAGRA, in each search call's seeds (with kernel A's bins in a large
    batch's, `cagra_seed_launches`)."""
    n = x.shape[0]
    before = kernel_counts()
    builds = []                        # approx_min_k launches of each build
    tally = lambda i: builds.append(graph_build_launches(i))
    warm = factory()
    warm.build(x)                      # first use of every op
    _sync(device)
    tally(warm)
    del warm
    host_s, host_runs, idx = timed_builds(factory, lambda i: i.build(x), n, device, tally)
    xd = to_device(x, device)
    dev_s, dev_runs, _ = timed_builds(factory, lambda i: i.build(xd), n, device, tally)
    del xd
    best_ef, sizes = None, []          # the queries of each search call
    for ef in efs:
        sizes.append(min(2048, q.shape[0]))
        r = recall_at_k(idx.search(q[:2048], k, ef_search=ef)[1].cpu().numpy(), gt[:2048], k)
        log(f"{name} ef={ef} recall={r:.4f}")
        if r >= TARGET_RECALL:
            best_ef, recall = ef, r
            break
    if best_ef is None:
        best_ef, recall = ef_fallback, r
    qps, qps_runs = timed_qps(lambda qq: idx.search(qq, k, ef_search=best_ef), q, 5000,
                              reps=reps, device=device)
    sizes += pass_sizes(q.shape[0], 5000) * (2 * reps)
    seeds = cagra_seed_launches(idx, sizes) if isinstance(idx, CagraIndex) else {}
    check_launches(name, device, before,
                   {**seeds, "approx": sum(builds) + seeds.get("approx", 0)})
    log(f"{name}: approx_min_k per build {builds}, in its {len(sizes)} search calls {seeds} "
        "(block_topk='approx'; kernel D did not run)")
    log(f"{name}: recall={recall:.4f} qps={qps:,.0f} "
        f"build={n/dev_s:,.0f} pts/s device-resident "
        f"(host-corpus {n/host_s:,.0f}) (ef={best_ef})")
    return dict(recall=recall, qps=qps, qps_runs=qps_runs, build_pps=n / dev_s,
                build_pps_hostcorpus=n / host_s, ef=best_ef, build_runs_pps=dev_runs,
                build_runs_pps_hostcorpus=host_runs)


CAGRA_EFS = (12, 16, 24, 32, 48, 64, 96)   # the cagra row's ef sweep


def cagra_config(d, metric):
    return CagraConfig(dim=d, degree=32, metric=metric)


def row_cagra(x, q, gt, k, metric="l2", device="cuda"):
    d = x.shape[1]
    return _graph_row(
        "cagra", lambda: CagraIndex(cagra_config(d, metric), device=device),
        CAGRA_EFS, 128, 3, x, q, gt, k, device)


def row_hnsw(x, q, gt, k, metric="l2", device="cuda"):
    d = x.shape[1]
    return _graph_row(
        "hnsw", lambda: HNSW(HNSWConfig(dim=d, m=16, ef_construction=100, metric=metric,
                                        build_batch=8192), device=device),
        (16, 24, 32, 48, 64, 96), 128, 2, x, q, gt, k, device)


# ---- the 1M rows -------------------------------------------------------------

def row_pq_1m(x1, q1, gt1, k, metric="l2", device="cuda"):
    """PQ: 4-bit codes, the fused ADC scan (kernel B int8 on the tensor
    cores), int16 refine store, rerank 12 (PQConfig defaults)."""
    n1, d = x1.shape
    nq = q1.shape[0]
    pq_cfg = PQConfig(dim=d, metric=metric)
    if torch.device(device).type == "cuda" and pq_cfg.scan != "pallas":
        raise AssertionError("PQConfig default must resolve to the fused kernel on the card")
    xd1 = to_device(x1, device)
    warm = PQFlatIndex(pq_cfg, device=device)
    warm.build(xd1)                    # first use of every op
    _sync(device)
    del warm
    pq_build_dev_s, pq_runs, pqi = timed_builds(
        lambda: PQFlatIndex(pq_cfg, device=device), lambda i: i.build(xd1), n1, device)
    del xd1
    before = kernel_counts()
    fn = lambda qq: pqi.search(qq, k)
    rq_ = recall_at_k(search_ids(fn, q1, 2048), gt1, k)
    qpsq, qpsq_runs = timed_qps(fn, q1, 2048, device=device)
    calls = search_calls(nq, 2048, 6)
    check_launches("pq_1m", device, before, {"B": calls, "B_mma": calls})
    log(f"pq 1M: recall={rq_:.4f} qps={qpsq:,.0f} "
        f"build={n1/pq_build_dev_s:,.0f} pts/s device-resident "
        f"(codes+refine {pq_cfg.bytes_per_vector * n1 / 2**30:.2f} GB "
        f"vs {4 * d * n1 / 2**30:.1f} GB f32)")
    return dict(recall=rq_, qps=qpsq, qps_runs=qpsq_runs,
                build_pps=n1 / pq_build_dev_s, build_runs_pps=pq_runs)


def row_ivfpq_1m(x1, q1, gt1, k, metric="l2", device="cuda"):
    """IVF-PQ: pq_1m's codes and refine store, cluster-blocked; each query
    scans its probed clusters through the pair scan (nprobe 8, rerank 12)."""
    n1, d = x1.shape
    nq = q1.shape[0]
    ipq_cfg = IVFPQConfig(dim=d, metric=metric)
    xd1 = to_device(x1, device)
    warm = IVFPQIndex(ipq_cfg, device=device)
    warm.build(xd1)                    # first use of every op
    _sync(device)
    del warm
    ipq_build_dev_s, ipq_runs, ipq = timed_builds(
        lambda: IVFPQIndex(ipq_cfg, device=device), lambda i: i.build(xd1), n1, device)
    del xd1
    npb, rrb = 8, 12
    before = kernel_counts()
    fn = lambda qq: ipq.search(qq, k, nprobe=npb, rerank=rrb)
    ri_ = recall_at_k(search_ids(fn, q1, 2048), gt1, k)
    qpsi, qpsi_runs = timed_qps(fn, q1, 2048, device=device)
    check_launches("ivfpq_1m", device, before, {"C_pairs": search_calls(nq, 2048, 6)})
    log(f"ivfpq 1M: recall={ri_:.4f} qps={qpsi:,.0f} "
        f"build={n1/ipq_build_dev_s:,.0f} pts/s device-resident "
        f"({ipq_cfg.bytes_per_vector * n1 / 2**30:.2f} GB)")
    return dict(recall=ri_, qps=qpsi, qps_runs=qpsi_runs,
                build_pps=n1 / ipq_build_dev_s, build_runs_pps=ipq_runs,
                nprobe=npb, rerank=rrb)


def cagra_1m_config(n1, d, metric):
    return CagraConfig(dim=d, degree=32, metric=metric, n_anchors=min(262144, n1 // 4),
                       search_degree=24, max_iters=4, ef_search=12)


def row_cagra_1m(x1, q1, gt1, k, metric="l2", device="cuda"):
    """CAGRA at 1M: ef 12, search_degree 24, 4 hops, 262,144-capped anchors;
    QPS in batches of 5000 (kernel A's [5000, L] seed bins)."""
    n1, d = x1.shape
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def cg1_factory():
        return CagraIndex(cagra_1m_config(n1, d, metric), device=device)

    before = kernel_counts()
    builds = []                        # approx_min_k launches of each build
    cg1 = cg1_factory()                # first use of every op
    cg1.build(x1)
    _sync(device)
    builds.append(graph_build_launches(cg1))
    t0 = time.perf_counter()           # warm host-corpus rebuild
    cg1 = cg1_factory()
    cg1.build(x1)
    _sync(device)
    cb1 = time.perf_counter() - t0
    builds.append(graph_build_launches(cg1))
    xd1 = to_device(x1, device)
    cb1_dev, cg1_dev_runs, _ = timed_builds(
        cg1_factory, lambda i: i.build(xd1), n1, device,
        lambda i: builds.append(graph_build_launches(i)))
    del xd1
    fn = lambda qq: cg1.search(qq, k, ef_search=12)
    rg = recall_at_k(search_ids(fn, q1, 5000), gt1, k)
    qpsg, qpsg_runs = timed_qps(fn, q1, 5000, reps=3, device=device)
    seeds = cagra_seed_launches(cg1, pass_sizes(q1.shape[0], 5000) * (1 + 2 * 3))
    check_launches("cagra_1m", device, before, {**seeds, "approx": sum(builds) + seeds["approx"]})
    log(f"cagra_1m: approx_min_k per build {builds}, {seeds} in search (the seed anchors; "
        "block_topk='approx', kernel D did not run)")
    if cuda:
        log(f"cagra_1m peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            "(max_memory_allocated, builds + search)")
    log(f"cagra 1M: recall={rg:.4f} qps={qpsg:,.0f} "
        f"build={n1/cb1_dev:,.0f} pts/s device-resident "
        f"(host-corpus {n1/cb1:,.0f})")
    return dict(recall=rg, qps=qpsg, qps_runs=qpsg_runs, build_pps=n1 / cb1_dev,
                build_pps_hostcorpus=n1 / cb1, ef=12, build_runs_pps=cg1_dev_runs)


def row_flat_1m(x1, q1, gt1, k, metric="l2", device="cuda"):
    """Two-pass flat: a bf16 tiled scan keeping rerank*k candidates, each
    tile's selected by approx_min_k at recall_target 0.97 (on the card its
    kernel, once per 500,000-row tile and search call), then an exact f32
    rerank."""
    n1, d = x1.shape
    fl1_cfg = FlatConfig(dim=d, metric=metric, rerank=4,
                         recall_target=0.97, tile_n=500_000)
    b1, fl1_runs, fl1 = timed_builds(
        lambda: FlatIndex(fl1_cfg, capacity=n1, device=device), lambda i: i.add(x1), n1, device)
    before = kernel_counts()
    fn = lambda qq: fl1.search(qq, k, approx=True)
    r1 = recall_at_k(search_ids(fn, q1, 2048), gt1, k)
    qps1, qps1_runs = timed_qps(fn, q1, 2048, device=device)
    check_launches("flat_1m", device, before,
                   {"approx": search_calls(q1.shape[0], 2048, 6) * flat_tiles(n1, 500_000)})
    log(f"flat 1M: recall={r1:.4f} qps={qps1:,.0f} build={n1/b1:,.0f} pts/s")
    return dict(recall=r1, qps=qps1, qps_runs=qps1_runs, build_pps=n1 / b1,
                build_runs_pps=fl1_runs)


def row_flat_1m_pallas(x1, q1, gt1, k, metric="l2", device="cuda"):
    """The fused bf16 scan (kernel A "default" on the tensor cores) + exact
    f32 rerank. pallas_bq is validated and unused by the port."""
    n1, d = x1.shape
    nq = q1.shape[0]
    flp = FlatIndex(
        FlatConfig(dim=d, metric=metric, rerank=4, recall_target=0.97,
                   scan="pallas", l_bins=1024, pallas_chunk=4096,
                   pallas_bq=512),
        capacity=n1, device=device,
    )
    flp.add(x1)
    _sync(device)
    before = kernel_counts()
    fn = lambda qq: flp.search(qq, k, approx=True)
    rp = recall_at_k(search_ids(fn, q1, 2048), gt1, k)
    qpsp, qpsp_runs = timed_qps(fn, q1, 2048, device=device)
    calls = search_calls(nq, 2048, 6)
    check_launches("flat_1m_pallas", device, before, {"A": calls, "A_mma": calls})
    log(f"flat 1M pallas: recall={rp:.4f} qps={qpsp:,.0f}")
    return dict(recall=rp, qps=qpsp, qps_runs=qpsp_runs)


def run_pq_scale(scale_n: int, k: int = 10, engine: str = "pq", device="cuda"):
    """The >=30M single-card scale row: a chunked DEEP-like 96d build with
    the exact GT merged per resident chunk. Returns (results key, row dict).
    Small scale_n values run the same code (chunk shrinks to scale_n).
    engine: "pq" (flat 4-bit scan, linear in N) or "ivfpq" (cluster-blocked
    probes). The build rate includes the exact-GT pass."""
    ds, nqs = 96, 2048
    chunk_n = min(SCALE_CHUNK, scale_n)
    if engine == "ivfpq":
        # expected_rows pre-sizes blocks + refine so chunked adds never repack
        sidx = IVFPQIndex(IVFPQConfig(
            dim=ds, n_sub=48, refine="int16", nprobe=16, rerank=16,
            l_bins=256, chunk=512, train_sample=min(131072, chunk_n),
            expected_rows=scale_n), device=device)
    else:
        sidx = PQFlatIndex(PQConfig(
            dim=ds, n_sub=48, n_codes=16, scan="pallas",
            scan_precision="int8", refine="int16", rerank=16,
            l_bins=1024, per_bin=2,
            train_sample=min(131072, chunk_n)), capacity=scale_n, device=device)
    cents = (np.random.default_rng(4242)
             .standard_normal((32768, ds)).astype(np.float32) * 2.0)

    def s_chunk(i, rows):
        r = np.random.default_rng(9000 + i)
        a = r.integers(0, 32768, rows)
        return (cents[a]
                + 0.25 * r.standard_normal((rows, ds)).astype(np.float32))

    qrng = np.random.default_rng(555)
    c0 = s_chunk(0, chunk_n)
    qs_ = (c0[qrng.integers(0, chunk_n, nqs)]
           + 0.12 * qrng.standard_normal((nqs, ds))).astype(np.float32)
    qsd = to_device(qs_, device)
    gs = np.full((nqs, k), np.inf, np.float32)
    gi = np.full((nqs, k), -1, np.int64)
    t0 = time.perf_counter()
    for i in range(scale_n // chunk_n):
        xc = c0 if i == 0 else s_chunk(i, chunk_n)
        xdc = to_device(xc, device)
        if engine == "ivfpq" and i == 0:
            sidx.build(xdc)          # trains centroids + codebooks
        else:
            sidx.add(xdc)
            if engine == "ivfpq":
                sidx.flush()         # append into pre-sized cluster blocks
        orc = FlatIndex(FlatConfig(dim=ds, precision="highest",
                                   tile_n=250_000), capacity=chunk_n, device=device)
        orc.add(xdc)
        s_c, i_c = (v.cpu().numpy() for v in orc.search(qsd, k))
        del orc, xdc, xc
        alls = np.concatenate([gs, s_c], axis=1)
        alli = np.concatenate(
            [gi, i_c.astype(np.int64) + i * chunk_n], axis=1)
        pos = np.argsort(alls, axis=1, kind="stable")[:, :k]
        gs = np.take_along_axis(alls, pos, axis=1)
        gi = np.take_along_axis(alli, pos, axis=1)
    _sync(device)
    sb = time.perf_counter() - t0
    if engine == "ivfpq":
        rr = 32 if scale_n >= 8_000_000 else 16
        fn = lambda qq: sidx.search(qq, k, nprobe=16, rerank=rr)
    else:
        rr = 128 if scale_n >= 8_000_000 else 16
        fn = lambda qq: sidx.search(qq, k, rerank=rr)
    ids_s = fn(qsd)[1].cpu().numpy()
    rs_ = recall_at_k(ids_s, gi, k)
    qps_s, qps_s_runs = timed_qps(fn, qs_, 2048, device=device)
    log(f"{engine} scale {scale_n:,}: recall={rs_:.4f} qps={qps_s:,.0f} "
        f"build={scale_n/sb:,.0f} pts/s (incl. exact-GT pass)")
    return (f"{engine}_{scale_n // 1_000_000}m",
            dict(recall=rs_, qps=qps_s, qps_runs=qps_s_runs,
                 build_pps=scale_n / sb))


def _try_row(results, failed, name, fn):
    """Run one row into `results`; a failure is logged with its traceback
    and recorded, and the rows after it still run."""
    try:
        results[name] = fn()
    except Exception as e:
        log(f"{name} failed: {e!r}")
        traceback.print_exc()
        failed.append(name)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _prebuild_kernels():
    """Build the four kernel sources the rows launch, one nvcc each, together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(fn) for fn in (FS.build_mma, PS.build_mma, PS.build_pairs,
                                               AK.build)]:
            fut.result()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        "(flat_scan_mma.cu, pq_scan_mma.cu, pq_scan.cu, approx_topk.cu)")


def run(device, n, nq, n1, k=10, scale_n=0, scale_engines=("pq",), cache_dir=CACHE_DIR):
    """Every section in bench.py's order, each followed by `emit`. Returns
    the exit code: 1 if any row (or the 1M corpus) failed, else 0."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _prebuild_kernels()
    x, q, _, metric = load_dataset("sift1m", max_rows=n)
    d = x.shape[1]
    rng = np.random.default_rng(9)
    # query workload: perturbed corpus points (pure random queries have no
    # near neighbors)
    q = (x[rng.integers(0, n, nq)]
         + 0.05 * rng.standard_normal((nq, d))).astype(np.float32)
    gt_cache = os.path.join(cache_dir, f"zvdb_torch_gt_clustered_{n}_{d}_{nq}_{k}.npz")
    t0 = time.time()
    if os.path.exists(gt_cache):
        gt = np.load(gt_cache)["gt"]
    else:
        _, gt = ground_truth_host(x, q, k, metric)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(gt_cache, gt=gt)
    log(f"ground truth in {time.time()-t0:.1f}s")

    results, failed = {}, []
    _try_row(results, failed, "flat", lambda: row_flat(x, q, gt, k, metric, device))
    emit(results)

    # the 1M rows pq_1m, ivfpq_1m and cagra_1m run early, as in bench.py
    x1 = q1 = gt1 = None
    try:
        x1, q1, gt1 = corpus_1m(d, nq, k, n1, device, cache_dir)
        log("1M corpus + gt ready")
    except Exception as e:
        log(f"1M corpus failed: {e!r}")
        traceback.print_exc()
        failed.append("corpus_1m")
    rows_1m = (("pq_1m", row_pq_1m), ("ivfpq_1m", row_ivfpq_1m), ("cagra_1m", row_cagra_1m))
    if x1 is not None:
        for name, row in rows_1m:
            _try_row(results, failed, name, lambda: row(x1, q1, gt1, k, metric, device))
            emit(results)

    for name, row in (("ivf", row_ivf), ("cagra", row_cagra), ("hnsw", row_hnsw)):
        _try_row(results, failed, name, lambda: row(x, q, gt, k, metric, device))
        emit(results)

    if x1 is not None:
        for name, row in (("flat_1m", row_flat_1m), ("flat_1m_pallas", row_flat_1m_pallas)):
            _try_row(results, failed, name, lambda: row(x1, q1, gt1, k, metric, device))
        emit(results)

    for eng in scale_engines if scale_n else ():
        tag = f"{eng}_scale"
        try:
            tag, row = run_pq_scale(scale_n, k, engine=eng, device=device)
            results[tag] = row
        except Exception as e:
            log(f"{eng} scale failed: {e!r}")
            traceback.print_exc()
            failed.append(tag)
        emit(results)
    if failed:
        log(f"failed rows: {', '.join(failed)}")
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu" (small shapes only)')
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": "search_qps_at_recall_0.95",
            "value": 0.0, "unit": "qps", "vs_baseline": 0.0,
            "error": "device backend unavailable: RuntimeError: no CUDA device "
                     "(torch.cuda.is_available() is False)",
        }), flush=True)
        return 1
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        log(f"device: {torch.cuda.get_device_name(device)} ({smi}) torch={torch.__version__} "
            f"cuda={torch.version.cuda}")
    else:
        log(f"device: cpu torch={torch.__version__}")

    # ZVDB_BENCH_SMOKE=1: small shapes for a flow check (section order,
    # per-section JSON emission, engine plumbing), not a performance run.
    smoke = bool(int(os.environ.get("ZVDB_BENCH_SMOKE", "0")))
    n, nq, k = (20_000, 2_000, 10) if smoke else (100_000, 10_000, 10)
    n1 = 60_000 if smoke else 1_000_000
    scale_n = int(os.environ.get("ZVDB_BENCH_SCALE", "0"))
    engines = tuple(e.strip() for e in os.environ.get("ZVDB_BENCH_SCALE_ENGINE", "pq").split(","))
    return run(device, n, nq, n1, k, scale_n, engines)


if __name__ == "__main__":
    sys.exit(main())
