"""zvdb_tpu_torch.bench.harness against zvdb_tpu/bench/harness.py, case for
case with tests/test_harness.py (result schema, host ground truth, recall,
random points), plus the timed runners over a CPU FlatIndex."""
import json

import numpy as np
import torch

import zvdb_tpu.bench.harness as JH
import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.bench.harness import (
    BenchmarkResult, ground_truth_host, random_points, recall_at_k, run_insertion_benchmark,
    run_search_benchmark, timeit_sync,
)

FIELDS = ("operation", "num_points", "dimensions", "num_queries", "k", "num_devices",
          "total_time_ns", "ops_per_sec", "recall", "ef")


def test_benchmark_result_schema_and_csv():
    kw = dict(operation="search", num_points=1000, dimensions=128, num_queries=100, k=10,
              num_devices=1, total_time_ns=5_000_000, ops_per_sec=20000.0, recall=0.97, ef=64)
    r, j = BenchmarkResult(**kw), JH.BenchmarkResult(**kw)
    d = json.loads(r.to_json())
    for field in FIELDS:
        assert field in d
    csv = r.to_csv()
    assert csv.count(",") == len(d) - 1
    assert "search" in str(r) and "recall@10" in str(r)
    assert (r.to_json(), r.to_csv(), str(r)) == (j.to_json(), j.to_csv(), str(j))


def test_ground_truth_host_matches_numpy(rng):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    s, ids = ground_truth_host(x, q, 5)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(d, 1, kind="stable")[:, :5])
    np.testing.assert_allclose(s, np.sort(d, 1)[:, :5], rtol=1e-4)
    js, jids = JH.ground_truth_host(x, q, 5)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(s, js)


def test_ground_truth_host_cosine(rng):
    x = rng.standard_normal((200, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    s, ids = ground_truth_host(x, q, 3, metric="cosine")
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(ids, np.argsort(-(qn @ xn.T), 1, kind="stable")[:, :3])
    assert (np.diff(s, axis=1) <= 1e-6).all()  # similarity descending


def test_recall_at_k_and_random_points(rng):
    gt = np.array([[1, 2, 3], [4, 5, 6]])
    ids = np.array([[1, 2, 9], [4, 5, 6]])
    assert abs(recall_at_k(ids, gt, 3) - 5 / 6) < 1e-9
    p = random_points(rng, 10, 4)
    assert p.shape == (10, 4) and p.dtype == np.float32
    assert (p >= 0).all() and (p < 1).all()  # reference uses uniform [0,1)
    np.testing.assert_array_equal(random_points(np.random.default_rng(5), 10, 4),
                                  JH.random_points(np.random.default_rng(5), 10, 4))


def test_timeit_sync():
    out, ns = timeit_sync(lambda a: (a * 2, [a + 1]), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0)) and isinstance(ns, int) and ns >= 0


def test_insertion_and_search_benchmarks_on_a_cpu_flat_index(rng):
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    idx, res = run_insertion_benchmark(lambda: ZT.FlatIndex(ZT.FlatConfig(dim=16), device="cpu"),
                                       x)
    assert len(idx) == 500
    assert (res.operation, res.num_points, res.dimensions, res.k) == ("insertion", 500, 16, 0)
    assert res.total_time_ns > 0 and res.ops_per_sec > 0
    _, gt = ground_truth_host(x, q, 10)
    ids, res = run_search_benchmark(idx, q, 10, ef=0, gt=gt, batch=16,
                                    search_fn=lambda qq, kk: idx.search(qq, kk), reps=2)
    assert ids.shape == (40, 10) and res.recall == 1.0
    d = json.loads(res.to_json())
    assert tuple(d) == FIELDS
    assert (d["operation"], d["num_points"], d["num_queries"], d["k"], d["ef"]) == \
        ("search", 500, 40, 10, 0)
    assert d["total_time_ns"] > 0 and d["ops_per_sec"] > 0
