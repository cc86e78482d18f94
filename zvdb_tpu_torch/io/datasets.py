"""Dataset loaders + synthetic workload generators (numpy only), copied from
zvdb_tpu/io/datasets.py so the port needs nothing of the JAX package: the same
seeds give byte-equal arrays.

The reference benchmarks only uniform-random vectors
(reference benchmarks/shared_benchmarks.zig:53-59); BASELINE.json additionally
names SIFT1M (fvecs), GloVe (cosine) and DEEP (96d). This module parses the
standard TEXMEX binary formats (fvecs/ivecs/bvecs) and provides deterministic
synthetic stand-ins (uniform and clustered) for air-gapped environments.

A native C++ mmap loader (native/zvdb_host.cpp, io/native_loader.py) speeds up
parsing when it builds; otherwise the host reads the file with numpy.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# TEXMEX binary formats: each record is [int32 dim][dim * elt]


def read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    return _read_vecs(path, np.float32, max_rows)


def read_ivecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    return _read_vecs(path, np.int32, max_rows)


def read_bvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), np.uint8)
    dim = int(np.frombuffer(raw[:4].tobytes(), np.int32)[0])
    rec = 4 + dim
    n = raw.size // rec
    if max_rows is not None:
        n = min(n, max_rows)
    mat = raw[: n * rec].reshape(n, rec)
    return mat[:, 4:]


def _read_vecs(path: str, dtype, max_rows: Optional[int]) -> np.ndarray:
    try:
        from . import native_loader

        arr = native_loader.read_vecs(path, dtype, max_rows)
        if arr is not None:
            return arr
    except Exception:
        pass
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype)
    dim = int(raw[0])
    rec = dim + 1
    n = raw.size // rec
    if max_rows is not None:
        n = min(n, max_rows)
    mat = raw[: n * rec].reshape(n, rec)[:, 1:]
    return mat.view(np.float32).astype(dtype, copy=False) if dtype == np.float32 \
        else mat.astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# synthetic workloads (deterministic; air-gapped stand-ins for SIFT/GloVe/DEEP)


def synthetic_uniform(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """Uniform [0,1) points — exactly the reference's workload
    (shared_benchmarks.zig:53-59)."""
    return np.random.default_rng(seed).random((n, dim), dtype=np.float32)


def synthetic_clustered(
    n: int, dim: int, n_clusters: int = 1000, spread: float = 0.15, seed: int = 0
) -> np.ndarray:
    """Gaussian-mixture points: closer to SIFT/DEEP geometry than uniform
    (real descriptor datasets are strongly clustered)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    pts = centers[assign] + spread * rng.standard_normal((n, dim)).astype(np.float32)
    return pts.astype(np.float32)


def mixture_queries(
    n_q: int, dim: int, n_clusters: int = 1000, spread: float = 0.15,
    seed: int = 0, q_seed: int = 1,
) -> np.ndarray:
    """Fresh draws from the SAME Gaussian mixture as synthetic_clustered(seed).

    Harder than the perturbed-corpus-point protocol: a query's nearest corpus
    points are genuine mixture neighbors, not the query's own source point."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    qrng = np.random.default_rng(q_seed + 77_000)
    assign = qrng.integers(0, n_clusters, n_q)
    pts = centers[assign] + spread * qrng.standard_normal((n_q, dim))
    return pts.astype(np.float32)


def estimate_lid(x: np.ndarray, k: int = 20, n_sample: int = 2000,
                 max_corpus: int = 200_000, seed: int = 0) -> float:
    """Local intrinsic dimensionality, Levina-Bickel MLE (mean over a sample).

    lid(x) = -[ (1/(k-1)) * sum_{j<k} log(T_j(x) / T_k(x)) ]^{-1}
    with T_j the j-th nearest-neighbor distance. Published MLE estimates put
    real SIFT1M around 9-12, while isotropic 128d Gaussian mixtures read near
    the ambient dimension: this makes the synthetic protocol's difficulty
    measurable.

    Exact brute-force kNN on a subsample in numpy on the host, as the JAX
    package computes it — O(n_sample * max_corpus * D)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    corpus = x
    if n > max_corpus:
        corpus = x[rng.choice(n, max_corpus, replace=False)]
    sel = rng.choice(corpus.shape[0], min(n_sample, corpus.shape[0]),
                     replace=False)
    q = corpus[sel].astype(np.float32)
    c = corpus.astype(np.float32)
    cn = (c * c).sum(1)
    lids = []
    for lo in range(0, q.shape[0], 256):
        qb = q[lo:lo + 256]
        d2 = (qb * qb).sum(1)[:, None] + cn[None, :] - 2.0 * (qb @ c.T)
        d2 = np.maximum(d2, 0.0)
        # k+1 smallest: slot 0 is the point itself (distance ~0)
        part = np.partition(d2, k, axis=1)[:, : k + 1]
        part.sort(axis=1)
        d = np.sqrt(part[:, 1: k + 1])
        tk = d[:, -1:]
        ok = (d[:, :-1] > 0).all(axis=1) & (tk[:, 0] > 0)
        ratio = np.log(d[:, :-1] / tk)
        est = -1.0 / np.mean(ratio, axis=1)
        lids.append(est[ok])
    return float(np.mean(np.concatenate(lids)))


def _lowlid_bases(rng, n_clusters: int, dim: int, subdim: int) -> np.ndarray:
    """Per-cluster orthonormal [dim, subdim] bases via QR of Gaussian draws."""
    bases = np.empty((n_clusters, dim, subdim), np.float32)
    for c0 in range(n_clusters):
        g = rng.standard_normal((dim, subdim))
        qmat, _ = np.linalg.qr(g)
        bases[c0] = qmat.astype(np.float32)
    return bases


def synthetic_lowlid(
    n: int, dim: int, subdim: int = 12, n_clusters: int = 1000,
    spread: float = 0.15, ambient_noise: float = 0.01, seed: int = 0,
) -> np.ndarray:
    """Low-LID Gaussian mixture: SIFT-like LOCAL geometry, not just global
    clustering.

    Each cluster's points live on its own random `subdim`-dimensional
    subspace (center + B_c z, B_c a [dim, subdim] orthonormal basis,
    z ~ N(0, spread^2)), plus tiny isotropic ambient noise. The cluster
    population (n/n_clusters) must exceed estimate_lid's k, else the k-th
    neighbor jumps clusters and the estimate collapses."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    bases = _lowlid_bases(rng, n_clusters, dim, subdim)
    assign = rng.integers(0, n_clusters, n)
    z = spread * rng.standard_normal((n, subdim)).astype(np.float32)
    pts = centers[assign]
    pts = pts + np.einsum("ndr,nr->nd", bases[assign], z)
    pts = pts + ambient_noise * rng.standard_normal((n, dim)).astype(np.float32)
    return pts.astype(np.float32)


def lowlid_queries(
    n_q: int, dim: int, subdim: int = 12, n_clusters: int = 1000,
    spread: float = 0.15, ambient_noise: float = 0.01, seed: int = 0,
    q_seed: int = 1,
) -> np.ndarray:
    """Fresh same-manifold draws from synthetic_lowlid(seed)'s mixture
    (the hard protocol: answers are genuine manifold neighbors)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    bases = _lowlid_bases(rng, n_clusters, dim, subdim)
    qrng = np.random.default_rng(q_seed + 77_000)
    assign = qrng.integers(0, n_clusters, n_q)
    z = spread * qrng.standard_normal((n_q, subdim)).astype(np.float32)
    pts = centers[assign] + np.einsum("ndr,nr->nd", bases[assign], z)
    pts = pts + ambient_noise * qrng.standard_normal((n_q, dim)).astype(np.float32)
    return pts.astype(np.float32)


def make_queries(
    corpus: np.ndarray, n_q: int, mode: str = "perturb", noise: float = 0.05,
    seed: int = 9, n_clusters: int = 1000, spread: float = 0.15,
    corpus_seed: int = 0,
) -> np.ndarray:
    """Query workload generator for the bench protocols.

    perturb  — corpus points + noise*sigma (ANN-benchmark style correlation;
               the easiest realistic protocol)
    mixture  — fresh same-mixture draws (hard: see mixture_queries)
    gaussian — isotropic standard normal (hardest: most queries fall between
               clusters; recall measures the engine's behavior far from data)
    """
    rng = np.random.default_rng(seed)
    d = corpus.shape[1]
    if mode == "perturb":
        sel = rng.integers(0, corpus.shape[0], n_q)
        return (corpus[sel] + noise * rng.standard_normal((n_q, d))
                ).astype(np.float32)
    if mode == "mixture":
        return mixture_queries(n_q, d, n_clusters=n_clusters, spread=spread,
                               seed=corpus_seed, q_seed=seed)
    if mode == "gaussian":
        return rng.standard_normal((n_q, d)).astype(np.float32)
    raise ValueError(f"unknown query mode {mode!r}")


# name -> (base file, query file, ground-truth file, synthetic rows, dim, metric)
_DATASETS = {
    "sift1m": ("sift_base.fvecs", "sift_query.fvecs", "sift_groundtruth.ivecs",
               1_000_000, 128, "l2"),
    "glove": ("glove_base.fvecs", "glove_query.fvecs", "glove_groundtruth.ivecs",
              1_183_514, 100, "cosine"),
    "deep10m": ("deep10m_base.fvecs", "deep10m_query.fvecs", "deep10m_groundtruth.ivecs",
                10_000_000, 96, "l2"),
}


def load_dataset(
    name: str,
    data_dir: Optional[str] = None,
    max_rows: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], str]:
    """Returns (corpus, queries, ground_truth_or_None, metric).

    Known names: sift1m, glove, deep10m, synthetic-uniform, synthetic-clustered.
    File-based datasets look in data_dir (default $ZVDB_DATA or ./data) and fall
    back to a synthetic stand-in of matching shape if files are absent.
    """
    data_dir = data_dir or os.environ.get("ZVDB_DATA", "data")
    if name in _DATASETS:
        base, query, gt, n_syn, dim, metric = _DATASETS[name]
        base, query, gt = (os.path.join(data_dir, f) for f in (base, query, gt))
        if os.path.exists(base):
            g = read_ivecs(gt) if os.path.exists(gt) and max_rows is None else None
            return read_fvecs(base, max_rows), read_fvecs(query), g, metric
        return (
            synthetic_clustered(max_rows or n_syn, dim, seed=seed),
            synthetic_clustered(10_000, dim, seed=seed + 1),
            None,
            metric,
        )
    if name == "synthetic-uniform":
        n = max_rows or 100_000
        return synthetic_uniform(n, 128, seed), synthetic_uniform(10_000, 128, seed + 1), None, "l2"
    if name == "synthetic-clustered":
        n = max_rows or 100_000
        return (
            synthetic_clustered(n, 128, seed=seed),
            synthetic_clustered(10_000, 128, seed=seed + 1),
            None,
            "l2",
        )
    raise ValueError(f"unknown dataset {name!r}")
