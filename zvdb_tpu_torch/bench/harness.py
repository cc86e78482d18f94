"""Recall helpers on the host (numpy only), copied from
zvdb_tpu/bench/harness.py, whose module imports jax."""
from __future__ import annotations

import numpy as np


def ground_truth_host(
    x: np.ndarray, q: np.ndarray, k: int, metric: str = "l2", chunk: int = 2048
):
    """Exact kNN on the host via BLAS sgemm + argpartition.
    Returns (scores, ids) like the flat oracle."""
    x = np.ascontiguousarray(x, np.float32)
    q = np.ascontiguousarray(q, np.float32)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    xn = (x * x).sum(1) if metric == "l2" else None
    nq = q.shape[0]
    kk = min(k, x.shape[0])
    ids = np.empty((nq, kk), np.int32)
    scores = np.empty((nq, kk), np.float32)
    for lo in range(0, nq, chunk):
        qc = q[lo:lo + chunk]
        dots = qc @ x.T
        s = (xn[None, :] - 2.0 * dots) if metric == "l2" else -dots
        part = np.argpartition(s, kk - 1, axis=1)[:, :kk]
        ps = np.take_along_axis(s, part, axis=1)
        order = np.argsort(ps, axis=1, kind="stable")
        ids[lo:lo + chunk] = np.take_along_axis(part, order, axis=1)
        srt = np.take_along_axis(ps, order, axis=1)
        if metric == "l2":
            srt = srt + (qc * qc).sum(1)[:, None]
        else:
            srt = -srt
        scores[lo:lo + chunk] = srt
    return scores, ids


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    hits = 0
    for r in range(ids.shape[0]):
        hits += len(set(ids[r, :k].tolist()) & set(gt[r, :k].tolist()))
    return hits / (ids.shape[0] * k)
