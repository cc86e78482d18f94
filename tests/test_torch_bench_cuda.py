"""bench_cuda.py (the port's headline benchmark) against bench.py: the same
result line for the same results, the same 1M corpus, queries and ground
truth, bench.py's keys on every row, and its failure contract. Runs on the
CPU at small sizes."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_cuda
from zvdb_tpu_torch.bench.harness import ground_truth_host
from zvdb_tpu_torch.io.datasets import synthetic_clustered

REPO = Path(__file__).resolve().parent.parent
K = 10


def _bench_py_row_keys():
    """{row: keys} of every `results["row"] = dict(...)` in bench.py, and the
    keys of run_pq_scale's row."""
    rows, scale = {}, None
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "results"
                and isinstance(node.targets[0].slice, ast.Constant)
                and isinstance(node.value, ast.Call)):
            rows[node.targets[0].slice.value] = tuple(kw.arg for kw in node.value.keywords)
        if isinstance(node, ast.FunctionDef) and node.name == "run_pq_scale":
            ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)][0]
            scale = tuple(kw.arg for kw in ret.value.elts[1].keywords)
    return rows, scale


def test_row_keys_are_bench_py_keys():
    rows, scale = _bench_py_row_keys()
    assert rows == bench_cuda.ROW_KEYS
    assert scale == bench_cuda.SCALE_KEYS


def _row(recall, qps, build, **extra):
    r = dict(recall=recall, qps=qps, qps_runs=[qps * 0.9, qps], build_pps=build,
             build_runs_pps=[build * 0.8, build])
    r.update(extra)
    return r


EMIT_CASES = {
    "100k rows present": {
        "flat": _row(0.99871, 412345.6789, 1.234e7),
        "pq_1m": _row(0.9984, 135012.34, 2.5e6),
        "ivf": _row(0.95, 250000.123456, 1.7e6, build_pps_hostcorpus=1.1e6, nprobe=2,
                    build_runs_pps_hostcorpus=[1.0e6, 1.1e6]),
        "cagra": _row(0.991, 300000.5, 6.3e5, build_pps_hostcorpus=5.9e5, ef=12,
                      build_runs_pps_hostcorpus=[5.8e5, 5.9e5]),
        "hnsw": _row(0.9499, 900000.0, 4.1e5, build_pps_hostcorpus=4e5, ef=16,
                     build_runs_pps_hostcorpus=[3.9e5, 4e5]),
        "flat_1m_pallas": {"recall": 0.99509, "qps": 412500.04,
                           "qps_runs": [400000.1, 412500.04]},
    },
    "only 1M rows": {
        "pq_1m": _row(0.9984, 135012.34, 2.5e6),
        "ivfpq_1m": _row(0.99923, 66400.0, 9.1e5, nprobe=8, rerank=12),
        "cagra_1m": _row(0.99401, 113000.77, 6.3e5, build_pps_hostcorpus=5.5e5, ef=12),
    },
    "no row at 0.95": {
        "flat": _row(0.9, 1000.0, 2000.0),
        "ivf": _row(0.93, 5000.0, 3000.0, build_pps_hostcorpus=2500.0, nprobe=8,
                    build_runs_pps_hostcorpus=[2400.0, 2500.0]),
        "pq_1m": _row(0.2, 9e9, 9e9),
    },
}


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
def test_emit_prints_what_bench_py_prints(case, capsys):
    bench.emit(EMIT_CASES[case])
    want = capsys.readouterr().out
    bench_cuda.emit(EMIT_CASES[case])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["engines"].keys() == EMIT_CASES[case].keys()


class _NoSave:
    """bench.py's numpy with np.savez recording its path instead of writing."""

    def __init__(self):
        self.saved = []

    def __getattr__(self, name):
        return getattr(np, name)

    def savez(self, path, **arrays):
        self.saved.append(path)


def _tied_equal(x, q, got, want, k):
    """Row by row, the same ids, or ids whose exact distances tie at the k-th."""
    for r in range(q.shape[0]):
        if set(got[r]) == set(want[r]):
            continue
        dg = np.sort(((x[got[r]].astype(np.float64) - q[r]) ** 2).sum(1))
        dw = np.sort(((x[want[r]].astype(np.float64) - q[r]) ** 2).sum(1))
        np.testing.assert_allclose(dg, dw, rtol=1e-6, err_msg=f"query {r}")


def test_corpus_1m_equals_bench_py(monkeypatch, tmp_path):
    n1, d, nq = 4_000, 32, 300
    fake = _NoSave()
    monkeypatch.setattr(bench, "np", fake)
    x_j, q_j, gt_j = bench.corpus_1m(d, nq, K, n1)
    x_t, q_t, gt_t = bench_cuda.corpus_1m(d, nq, K, n1, device="cpu", cache_dir=str(tmp_path))
    assert np.array_equal(x_t, x_j) and x_t.dtype == x_j.dtype == np.float32
    assert np.array_equal(q_t, q_j) and q_t.dtype == np.float32
    assert gt_t.shape == gt_j.shape == (nq, K)
    _tied_equal(x_t, q_t, gt_t, np.asarray(gt_j), K)
    # bench.py's cache write was caught; bench_cuda's went to its own directory
    assert all(not os.path.exists(p) for p in fake.saved)
    cached = list(tmp_path.iterdir())
    assert [p.name.startswith("zvdb_torch_gt1m_v3_") for p in cached] == [True]
    _, _, gt_again = bench_cuda.corpus_1m(d, nq, K, n1, device="cpu", cache_dir=str(tmp_path))
    assert np.array_equal(gt_again, gt_t)


def test_timed_qps_calls_and_samples():
    calls = []

    def fn(qb):
        calls.append(qb.shape[0])
        return torch.zeros(qb.shape[0]), torch.zeros(qb.shape[0], dtype=torch.int32)

    q = np.zeros((10, 4), np.float32)
    best, runs = bench_cuda.timed_qps(fn, q, 4, reps=3, device="cpu")
    assert calls == [4, 4, 2] * 6      # 2 passes x 3 reps x 3 batches
    assert len(runs) == 2 and best == max(runs) > 0
    assert bench_cuda.search_calls(10, 4, 3) == 3 + len(calls)   # a recall pass + timed_qps


@pytest.fixture(scope="module")
def small_workload():
    # small, but past ivf's 1024 clusters (bench.py's configs, unchanged)
    n, d, nq = 2048, 16, 64
    x = synthetic_clustered(n, d, n_clusters=50, seed=0)
    rng = np.random.default_rng(9)
    q = (x[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q, ground_truth_host(x, q, K)[1]


@pytest.mark.parametrize("name", sorted(bench_cuda.ROW_KEYS))
def test_row_on_cpu_returns_bench_py_keys(name, small_workload):
    torch.set_num_threads(2)
    x, q, gt = small_workload
    row = getattr(bench_cuda, f"row_{name}")(x, q, gt, K, "l2", "cpu")
    assert tuple(row) == bench_cuda.ROW_KEYS[name]
    assert row["recall"] >= 0.9 and row["qps"] > 0 and len(row["qps_runs"]) == 2


@pytest.mark.parametrize("engine", ["pq", "ivfpq"])
def test_scale_row_on_cpu(engine, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(bench_cuda, "timed_qps", lambda *a, **kw: (1.0, [1.0, 0.5]))
    tag, row = bench_cuda.run_pq_scale(1024, K, engine=engine, device="cpu")
    assert tag == f"{engine}_0m"
    assert tuple(row) == bench_cuda.SCALE_KEYS
    assert 0.0 < row["recall"] <= 1.0 and row["build_pps"] > 0


def test_ivfpq_scale_row_in_two_chunks_on_cpu(monkeypatch):
    """The scale row's chunked path (build on chunk 0, then add + flush),
    cut to two chunks of 1,024 rows through SCALE_CHUNK."""
    torch.set_num_threads(2)
    monkeypatch.setattr(bench_cuda, "timed_qps", lambda *a, **kw: (1.0, [1.0, 0.5]))
    monkeypatch.setattr(bench_cuda, "SCALE_CHUNK", 1024)
    flushes = []
    flush = bench_cuda.IVFPQIndex.flush
    monkeypatch.setattr(bench_cuda.IVFPQIndex, "flush",
                        lambda self: flushes.append(len(self._pending)) or flush(self))
    tag, row = bench_cuda.run_pq_scale(2048, K, engine="ivfpq", device="cpu")
    assert tag == "ivfpq_0m" and tuple(row) == bench_cuda.SCALE_KEYS
    assert flushes == [1]                       # chunk 1 appended by a flush
    assert 0.0 < row["recall"] <= 1.0 and row["build_pps"] > 0


def test_failed_row_exits_nonzero_after_its_line(monkeypatch, capsys, tmp_path):
    def fake(name):
        def row(*args):
            if name == "cagra":
                raise RuntimeError("row broke")
            return {key: 0.97 if key == "recall" else 1.0 for key in bench_cuda.ROW_KEYS[name]}
        return row

    for name in bench_cuda.ROW_KEYS:
        monkeypatch.setattr(bench_cuda, f"row_{name}", fake(name))
    rc = bench_cuda.run("cpu", n=1_000, nq=50, n1=2_000, cache_dir=str(tmp_path))
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert [sorted(line["engines"]) for line in lines] == [
        ["flat"], ["flat", "pq_1m"], ["flat", "ivfpq_1m", "pq_1m"],
        ["cagra_1m", "flat", "ivfpq_1m", "pq_1m"],
        ["cagra_1m", "flat", "ivf", "ivfpq_1m", "pq_1m"],
        ["cagra_1m", "flat", "ivf", "ivfpq_1m", "pq_1m"],     # cagra failed, its line printed
        ["cagra_1m", "flat", "hnsw", "ivf", "ivfpq_1m", "pq_1m"],
        ["cagra_1m", "flat", "flat_1m", "flat_1m_pallas", "hnsw", "ivf", "ivfpq_1m", "pq_1m"]]


def test_no_cuda_device_prints_the_error_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_cuda.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and line["metric"] == "search_qps_at_recall_0.95"
    assert line["error"].startswith("device backend unavailable")
