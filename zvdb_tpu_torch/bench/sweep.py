"""Reference-protocol benchmark sweep (port of zvdb_tpu/bench/sweep.py).

Mirrors the reference's drivers (SURVEY.md §3.4 / BASELINE.md): dims
{128, 512, 768, 1024} x k {10, 25, 50, 100}, 100k points, 10k queries, a
fresh index per combination, search timing excluding the build (reference
benchmarks/single_threaded_benchmarks.zig:28-33,
shared_benchmarks.zig:90-113). The flags and the JSON rows are the JAX
package's; `--device` picks the card (default "cuda") or the CPU.

`--devices N` above 1 builds a ShardedHNSW with N shards for `--engine
hnsw`, as the JAX package's sweep does; the shards go to the visible GPUs in
turn (all of them onto one card when there is one) or onto the CPU with
`--device cpu`. A row's `num_devices` is the number of distinct devices the
mesh spans, and the shard count goes to stderr. Every other engine raises
for N above 1: JAX's sweep runs those on one device and still labels their
rows with N devices.

Usage:
    python -m zvdb_tpu_torch.bench.sweep [--points 100000] [--queries 10000]
        [--dims 128,512,768,1024] [--ks 10,25,50,100] [--ef 64]
        [--engine hnsw|flat|ivf|cagra|pq] [--device cuda] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dims", type=str, default="128,512,768,1024")
    ap.add_argument("--ks", type=str, default="10,25,50,100")
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--efc", type=int, default=100)
    ap.add_argument("--build-batch", type=int, default=2048)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--metric", type=str, default="l2")
    ap.add_argument("--recall", action="store_true", help="also measure recall")
    ap.add_argument("--engine", type=str, default="hnsw",
                    choices=["hnsw", "flat", "ivf", "cagra", "pq"])
    ap.add_argument("--pca", type=int, default=0,
                    help="flat engine: PCA-filter the approx scan to this "
                         "many dims + exact rerank (high-dim lever)")
    ap.add_argument("--pq-nsub", type=int, default=16,
                    help="pq engine: subspace count (bytes/vector of codes)")
    ap.add_argument("--opq", action="store_true",
                    help="pq engine: train the OPQ rotation (ops/pq.py)")
    ap.add_argument("--query-mode", type=str, default="dataset",
                    choices=["dataset", "perturb", "mixture", "gaussian"],
                    help="dataset = queries as loaded; perturb = corpus + "
                         "0.05 sigma (easy); mixture = fresh same-mixture "
                         "draws (hard); gaussian = isotropic noise (hardest)")
    ap.add_argument("--dataset", type=str, default=None,
                    help="sift1m | glove | deep10m | synthetic-uniform | "
                         "synthetic-clustered (overrides --dims; real files "
                         "used when present under $ZVDB_DATA)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of every index (default cuda)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.devices > 1 and args.engine != "hnsw":
        raise NotImplementedError(
            f"--devices > 1 shards only --engine hnsw; the port has no sharded {args.engine} "
            "engine for the sweep (ROADMAP.md queue 1 item 2)")

    from zvdb_tpu_torch import (
        HNSW, CagraConfig, CagraIndex, FlatConfig, FlatIndex, HNSWConfig, IVFConfig,
        IVFIndex, PQConfig, PQFlatIndex, exact_ground_truth,
    )
    from zvdb_tpu_torch.bench.harness import (
        ground_truth_host, random_points, run_insertion_benchmark, run_search_benchmark,
    )
    from zvdb_tpu_torch.index.flat import resolve_device
    from zvdb_tpu_torch.io.datasets import load_dataset, make_queries

    device = resolve_device(args.device)
    num_devices = 1
    if args.devices > 1:
        from zvdb_tpu_torch import ShardedHNSW, make_mesh

        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" and device.index is None else [device])
        mesh = make_mesh(n_shards=args.devices, devices=devices)
        num_devices = mesh.n_devices
        print(f"sharded: {args.devices} shards over {num_devices} device(s): {mesh}",
              file=sys.stderr, flush=True)
    dims = [int(v) for v in args.dims.split(",")]
    ks = [int(v) for v in args.ks.split(",")]
    rng = np.random.default_rng(1234)
    sink = open(args.out, "a") if args.out else None
    results = []

    datasets = []
    if args.dataset:
        x, q, _, metric = load_dataset(args.dataset, max_rows=args.points)
        datasets.append((x, q[: args.queries], metric))
    else:
        for d in dims:
            datasets.append((random_points(rng, args.points, d),
                             random_points(rng, args.queries, d), args.metric))
    if args.query_mode != "dataset":
        datasets = [(x, make_queries(x, args.queries, mode=args.query_mode), metric)
                    for x, q, metric in datasets]

    for x, q, metric in datasets:
        d = x.shape[1]
        gt = None
        if args.recall:
            if x.size > (1 << 25) and device.type == "cuda":
                # the device oracle: the host BLAS one takes minutes per dim at
                # the 100k x 1024d corner of the grid
                gt = exact_ground_truth(x, q, max(ks), metric, device=device)[1]
            else:
                gt = ground_truth_host(x, q, max(ks), metric)[1]

        if args.engine == "flat":
            factory = lambda: FlatIndex(
                FlatConfig(dim=d, metric=metric, precision="high",
                           pca_dim=args.pca, rerank=16 if args.pca else 0),
                capacity=x.shape[0], device=device)
        elif args.engine == "ivf":
            factory = lambda: IVFIndex(IVFConfig(dim=d, metric=metric), device=device)
        elif args.engine == "cagra":
            factory = lambda: CagraIndex(CagraConfig(dim=d, metric=metric), device=device)
        elif args.engine == "pq":
            n_sub = args.pq_nsub if d % args.pq_nsub == 0 else (16 if d % 16 == 0 else 8)
            factory = lambda: PQFlatIndex(
                PQConfig(dim=d, metric=metric, n_sub=n_sub, opq=args.opq), device=device)
        elif args.devices > 1:
            factory = lambda: ShardedHNSW(
                HNSWConfig(dim=d, m=args.m, ef_construction=args.efc, metric=metric,
                           build_batch=args.build_batch), mesh=mesh)
        else:
            factory = lambda: HNSW(
                HNSWConfig(dim=d, m=args.m, ef_construction=args.efc, metric=metric,
                           build_batch=args.build_batch), device=device)

        idx, ins = run_insertion_benchmark(factory, x, num_devices=num_devices)
        print(ins, file=sys.stderr, flush=True)
        results.append(ins)
        if sink:
            sink.write(ins.to_json() + "\n")

        if args.engine in ("flat", "pq"):
            search_fn = lambda qq, kk: idx.search(qq, kk, approx=True)
        elif args.engine == "ivf":
            search_fn = lambda qq, kk: idx.search(qq, kk)
        elif args.engine == "cagra":
            search_fn = lambda qq, kk: idx.search(qq, kk, ef_search=args.ef)
        else:
            search_fn = None

        for k in ks:
            _, sr = run_search_benchmark(idx, q, k, args.ef, gt=gt, num_devices=num_devices,
                                         warmup=1, search_fn=search_fn)
            print(sr, file=sys.stderr, flush=True)
            results.append(sr)
            if sink:
                sink.write(sr.to_json() + "\n")
                sink.flush()

    # one JSON object on stdout, the last search row
    print(results[-1].to_json())
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
