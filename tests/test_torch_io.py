"""zvdb_tpu_torch.io (datasets, native loader) against zvdb_tpu.io, case for
case with tests/test_io.py. The generators are numpy copies, so the same
seeds must give byte-equal arrays; the readers must agree file for file."""
import struct

import numpy as np
import pytest

from zvdb_tpu.io import datasets as JD
from zvdb_tpu_torch.io import datasets
from zvdb_tpu_torch.io.native_loader import exact_knn_cpu


def _write_fvecs(path, x):
    with open(path, "wb") as f:
        for row in x:
            f.write(struct.pack("<i", x.shape[1]))
            f.write(np.asarray(row, np.float32).tobytes())


def _write_ivecs(path, x):
    with open(path, "wb") as f:
        for row in x:
            f.write(struct.pack("<i", x.shape[1]))
            f.write(np.asarray(row, np.int32).tobytes())


def test_fvecs_roundtrip(tmp_path, rng):
    x = rng.standard_normal((50, 24)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    _write_fvecs(p, x)
    np.testing.assert_array_equal(datasets.read_fvecs(p), x)
    np.testing.assert_array_equal(datasets.read_fvecs(p, max_rows=10), x[:10])
    np.testing.assert_array_equal(datasets.read_fvecs(p), JD.read_fvecs(p))


def test_ivecs_roundtrip(tmp_path, rng):
    x = rng.integers(0, 1000, (30, 10)).astype(np.int32)
    p = str(tmp_path / "x.ivecs")
    _write_ivecs(p, x)
    np.testing.assert_array_equal(datasets.read_ivecs(p), x)
    np.testing.assert_array_equal(datasets.read_ivecs(p, max_rows=4), JD.read_ivecs(p, max_rows=4))


def test_bvecs_roundtrip(tmp_path, rng):
    x = rng.integers(0, 256, (20, 8)).astype(np.uint8)
    p = str(tmp_path / "x.bvecs")
    with open(p, "wb") as f:
        for row in x:
            f.write(struct.pack("<i", 8))
            f.write(row.tobytes())
    np.testing.assert_array_equal(datasets.read_bvecs(p), x)
    np.testing.assert_array_equal(datasets.read_bvecs(p, max_rows=3), JD.read_bvecs(p, max_rows=3))


def test_synthetic_determinism():
    a = datasets.synthetic_clustered(100, 16, seed=3)
    b = datasets.synthetic_clustered(100, 16, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (100, 16) and a.dtype == np.float32


@pytest.mark.parametrize("name,args,kw", [
    ("synthetic_uniform", (300, 12), dict(seed=4)),
    ("synthetic_clustered", (300, 12), dict(n_clusters=20, seed=4)),
    ("mixture_queries", (50, 12), dict(n_clusters=20, seed=4, q_seed=2)),
    ("synthetic_lowlid", (300, 12), dict(subdim=3, n_clusters=10, seed=4)),
    ("lowlid_queries", (50, 12), dict(subdim=3, n_clusters=10, seed=4, q_seed=2)),
])
def test_generators_byte_equal_to_jax_package(name, args, kw):
    a, b = getattr(datasets, name)(*args, **kw), getattr(JD, name)(*args, **kw)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode", ["perturb", "mixture", "gaussian"])
def test_make_queries_byte_equal_to_jax_package(mode):
    x = datasets.synthetic_clustered(400, 8, n_clusters=20, seed=1)
    a = datasets.make_queries(x, 30, mode=mode, n_clusters=20, corpus_seed=1)
    assert a.tobytes() == JD.make_queries(x, 30, mode=mode, n_clusters=20, corpus_seed=1).tobytes()
    with pytest.raises(ValueError):
        datasets.make_queries(x, 3, mode="bogus")


def test_load_dataset_fallback(tmp_path):
    # no files present -> synthetic stand-in with the right shape/metric
    x, q, gt, metric = datasets.load_dataset("sift1m", data_dir=str(tmp_path), max_rows=500)
    assert x.shape == (500, 128) and metric == "l2" and gt is None
    jx, jq, _, jm = JD.load_dataset("sift1m", data_dir=str(tmp_path), max_rows=500)
    assert x.tobytes() == jx.tobytes() and q.tobytes() == jq.tobytes() and jm == metric
    x, q, gt, metric = datasets.load_dataset("glove", data_dir=str(tmp_path), max_rows=200)
    assert x.shape == (200, 100) and metric == "cosine"
    x, _, _, metric = datasets.load_dataset("deep10m", data_dir=str(tmp_path), max_rows=50)
    assert x.shape == (50, 96) and metric == "l2"
    for name in ("synthetic-uniform", "synthetic-clustered"):
        x, q, gt, metric = datasets.load_dataset(name, max_rows=64, seed=2)
        jx, jq, _, _ = JD.load_dataset(name, max_rows=64, seed=2)
        assert x.tobytes() == jx.tobytes() and q.tobytes() == jq.tobytes()
    with pytest.raises(ValueError):
        datasets.load_dataset("nope")


def test_load_dataset_real_files(tmp_path, rng):
    x = rng.standard_normal((40, 128)).astype(np.float32)
    q = rng.standard_normal((5, 128)).astype(np.float32)
    _write_fvecs(str(tmp_path / "sift_base.fvecs"), x)
    _write_fvecs(str(tmp_path / "sift_query.fvecs"), q)
    g = rng.integers(0, 40, (5, 10)).astype(np.int32)
    _write_ivecs(str(tmp_path / "sift_groundtruth.ivecs"), g)
    xb, qb, gt, metric = datasets.load_dataset("sift1m", data_dir=str(tmp_path))
    np.testing.assert_allclose(xb, x)
    np.testing.assert_allclose(qb, q)
    np.testing.assert_array_equal(gt, g)
    _, _, gt, _ = datasets.load_dataset("sift1m", data_dir=str(tmp_path), max_rows=10)
    assert gt is None   # a cut corpus has no valid ground truth, as in JAX


def test_native_exact_knn_matches_numpy(rng):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    res = exact_knn_cpu(x, q, 5)
    if res is None:  # toolchain unavailable — the numpy path is tested elsewhere
        return
    s, i = res
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i, np.argsort(d, axis=1, kind="stable")[:, :5])
    for metric in ("dot", "cosine"):
        s, i = exact_knn_cpu(x, q, 5, metric=metric)
        sim = q @ x.T if metric == "dot" else \
            (q / np.linalg.norm(q, axis=1, keepdims=True)) @ \
            (x / np.linalg.norm(x, axis=1, keepdims=True)).T
        np.testing.assert_array_equal(i, np.argsort(-sim, axis=1, kind="stable")[:, :5])


def test_lowlid_generator_and_lid_estimator():
    """The low-LID mixture must read a Levina-Bickel MLE far below ambient
    dim and below the isotropic stand-in, deterministically; the estimator
    equals the JAX package's (both numpy on the host)."""
    x = datasets.synthetic_lowlid(8000, 64, subdim=8, n_clusters=40, seed=5)
    assert x.shape == (8000, 64) and x.dtype == np.float32
    np.testing.assert_array_equal(
        x, datasets.synthetic_lowlid(8000, 64, subdim=8, n_clusters=40, seed=5))
    lid_low = datasets.estimate_lid(x, k=20, n_sample=400)
    iso = datasets.synthetic_clustered(8000, 64, n_clusters=40, seed=5)
    lid_iso = datasets.estimate_lid(iso, k=20, n_sample=400)
    assert lid_low < 16, lid_low          # reads near subdim, not ambient 64
    assert lid_low < 0.6 * lid_iso, (lid_low, lid_iso)
    assert lid_low == JD.estimate_lid(x, k=20, n_sample=400)
    q = datasets.lowlid_queries(32, 64, subdim=8, n_clusters=40, seed=5)
    assert q.shape == (32, 64) and q.dtype == np.float32
