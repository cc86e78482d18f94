"""Deterministic synthetic workloads (numpy only), copied from
zvdb_tpu/io/datasets.py so the port needs nothing of the JAX package."""
from __future__ import annotations

import numpy as np


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
