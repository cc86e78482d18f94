"""Device-resident k-means (port of zvdb_tpu/index/knn_graph.py:_kmeans_device).

The rest of the cluster-kNN graph build is not ported yet. The sample and the
initial centroids come from a torch.Generator, which cannot reproduce the
JAX package's PRNG: the two packages start k-means from different rows of
the same corpus.
"""
from __future__ import annotations

import torch

from ..ops import distance as D
from .ivf import _assign, _update_centroids


def _kmeans_device(xj: torch.Tensor, c: int, iters: int, gen: torch.Generator,
                   sample: int = 65536) -> torch.Tensor:
    """Lloyd k-means of xj [N, D] f32 into c centroids, on xj's device: a
    sample of `sample` rows without replacement, c of them as the initial
    centroids (with replacement only when the sample has fewer than c rows),
    then `iters` rounds of assignment and update. Returns [c, D] f32."""
    n = xj.shape[0]
    xs = xj
    if n > sample:
        xs = xj[torch.randperm(n, generator=gen)[:sample].to(xj.device)]
    m = xs.shape[0]
    if m < c:
        init = torch.randint(0, m, (c,), generator=gen)
    else:
        init = torch.randperm(m, generator=gen)[:c]
    cent = xs[init.to(xj.device)].float()
    xn = D.sq_norms(xs)
    for _ in range(iters):
        a = _assign(xs, xn, cent, D.sq_norms(cent))
        cent = _update_centroids(xs, a, cent)
    return cent
