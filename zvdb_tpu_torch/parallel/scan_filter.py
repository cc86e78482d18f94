"""Sharded masked exact scan: the filtered-search path of the sharded graph
engines (port of zvdb_tpu/parallel/scan_filter.py).

Per shard: a masked brute-force scan over the shard's stored rows and a
local top-k; then one [B, S*k] merge of the candidates and the user-facing
scores. A masked scan is exact at every selectivity, where a candidate
pool's filtering collapses on selective filters.
"""
from __future__ import annotations

import torch

from ..index.hnsw import torch_precision
from ..ops import distance as D
from ..ops import topk as T
from .sharded import merge_span, run_shards

_INF = float("inf")


def make_sharded_masked_scan(mesh, n_data: int, metric: str, precision: str, k: int,
                             recorder=None):
    """The scan: (vectors, norms_bias, scales, ext_ids, q) -> (user scores
    [B, k], global ids [B, k]) on the mesh's merge device. The first four
    are per-shard lists of [cap, D] / [cap] tensors on each shard's device;
    norms_bias carries +inf for blocked, dead and padding rows, and rows
    with ext_ids < 0 never surface. With n_data > 1 the queries are split
    over the mesh's data axis (B must divide evenly, as JAX's shard_map
    asks). `precision` takes the JAX names ("float32" is "highest").
    `recorder`: an optional utils.profiling.PhaseRecorder for the shards'
    and the merge's times."""
    prec = torch_precision(precision)

    def local(si, v, nn, sc, ii, q):
        qp = D.preprocess_queries(q, metric)
        s = D.pairwise_scores(qp, v, nn, metric, precision=prec, x_scales=sc)
        s = torch.where(ii[None, :] >= 0, s, _INF)
        kk = min(k, s.shape[-1])
        ts, ti = T.smallest_k(s, ii[None, :].expand(s.shape), kk)
        ti = torch.where(torch.isfinite(ts), ti, -1)
        if kk < k:
            ts = torch.cat([ts, ts.new_full((ts.shape[0], k - kk), _INF)], dim=1)
            ti = torch.cat([ti, ti.new_full((ti.shape[0], k - kk), -1)], dim=1)
        return ts, ti

    def run(vectors, norms_bias, scales, ext_ids, q):
        ts, ti = run_shards(mesh, local, list(zip(vectors, norms_bias, scales, ext_ids)), q,
                            recorder, split_data=n_data > 1)
        with merge_span(recorder):
            b = ts.shape[0]
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), k)
            qp = D.preprocess_queries(q.to(ms.device), metric)
            user = D.finalize_scores(ms, qp, metric)
            user = torch.where(mi >= 0, user, _INF if metric == "l2" else -_INF)
        return user, mi

    return run
