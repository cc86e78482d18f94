"""IVF building blocks the IVF-PQ engine needs (port of parts of
zvdb_tpu/index/ivf.py): the k-means assignment and centroid update, the
batched two-means split of oversized clusters, and the exact range scan over
a flat (rows, norms, ids, scales) view. The IVF-Flat engine itself is not
ported yet.

Every float product here is plain f32; on the card that assumes
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import distance as D
from ..ops import topk as T
from .flat import _pad_k

_INF = float("inf")


def _assign(x: torch.Tensor, xn: torch.Tensor, cent: torch.Tensor, cn: torch.Tensor,
            tile: int = 16384) -> torch.Tensor:
    """argmin_c ||x - c||^2 for every row, tiled over N: the argmin of
    cn - 2 x.c in f32, the first minimum on a tie. xn is unused (kept for the
    JAX signature). Returns [N] int32."""
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], tile):
        d = cn[None, :] - 2.0 * (x[lo:lo + tile].float() @ cent.T)
        out[lo:lo + tile] = torch.argmin(d, dim=-1).to(torch.int32)
    return out


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, cent: torch.Tensor,
                      tile: int = 16384) -> torch.Tensor:
    """Lloyd update: each centroid becomes the mean of its rows rounded to
    bf16, summed in f32 (the JAX package's bf16 one-hot product). Empty
    clusters keep their centroid. The sums are one-hot products over row
    tiles, not an index_add (whose atomics on the card sum in no fixed
    order), so the result is deterministic."""
    c = cent.shape[0]
    xb = x.to(torch.bfloat16).float()
    sums = torch.zeros_like(cent, dtype=torch.float32)
    for lo in range(0, x.shape[0], tile):
        oh = F.one_hot(assign[lo:lo + tile].long(), c).float()
        sums += oh.T @ xb[lo:lo + tile]
    counts = torch.bincount(assign.long(), minlength=c).float()
    new = sums / counts.clamp(min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, cent)


def _batched_two_means(xd: torch.Tensor, members: torch.Tensor, iters: int = 4):
    """Two-means over many clusters at once: members [O, M] int (-1 pad).
    Returns (c0 [O, D], c1 [O, D], side0 [O, M] bool). The init is
    deterministic (the first member against the count//2-th); a degenerate
    one-sided split falls back to an index-halves split."""
    valid = members >= 0
    pts = xd[members.clamp(min=0).long()].float()             # [O, M, D]
    o, m, d = pts.shape
    counts = valid.sum(1)
    rows = torch.arange(o, device=pts.device)
    c0 = pts[:, 0]
    c1 = pts[rows, torch.clamp(counts // 2, min=1)]
    iota = torch.arange(m, device=pts.device)[None, :]
    m0 = valid & (iota % 2 == 0)

    def centers(m0):
        n0 = m0.sum(1).clamp(min=1).float()
        n1 = (valid & ~m0).sum(1).clamp(min=1).float()
        return (torch.einsum("om,omd->od", m0.float(), pts) / n0[:, None],
                torch.einsum("om,omd->od", (valid & ~m0).float(), pts) / n1[:, None])

    for _ in range(iters):
        d0 = ((pts - c0[:, None]) ** 2).sum(-1)
        d1 = ((pts - c1[:, None]) ** 2).sum(-1)
        m0 = (d0 <= d1) & valid
        c0, c1 = centers(m0)
    deg = (m0.sum(1) == counts) | (m0.sum(1) == 0)
    pos = torch.cumsum(valid.int(), dim=1) - 1
    half = valid & (pos < (counts // 2)[:, None])
    m0 = torch.where(deg[:, None], half, m0)
    # split centroids for the final sides, so probe routing sees their centers
    c0, c1 = centers(m0)
    return c0, c1, m0


def split_oversized_device(xd: torch.Tensor, cent: np.ndarray, assign: np.ndarray, cap: int):
    """Split every cluster holding more than `cap` rows in two (batched
    two-means on the device), round after round until all fit. Returns
    (centroids [C', D] f32 numpy, assignment [N] int64 numpy); split halves
    keep the old cluster's index and append the new one. Deterministic: the
    same (xd, cent, assign, cap) give the JAX package's result."""
    cent = [c for c in np.asarray(cent, np.float32)]
    assign = assign.astype(np.int64).copy()

    def pow2(v):
        return 1 << max(int(np.ceil(np.log2(max(v, 1)))), 3)

    while True:
        counts = np.bincount(assign, minlength=len(cent))
        over = np.nonzero(counts > cap)[0]
        if len(over) == 0:
            break
        order = torch.argsort(torch.as_tensor(assign, dtype=torch.int32, device=xd.device),
                              stable=True).cpu().numpy()
        sa = assign[order]
        starts = np.searchsorted(sa, over, side="left")
        ends = np.searchsorted(sa, over, side="right")
        sizes = ends - starts
        by_size = np.argsort(-sizes, kind="stable")
        # member tables of at most 2**22 entries, padded to powers of two
        budget = 1 << 22
        pos = 0
        while pos < len(over):
            mmax = pow2(sizes[by_size[pos]])
            sel = by_size[pos: pos + max(1, budget // mmax)]
            pos += len(sel)
            members = np.full((pow2(len(sel)), mmax), -1, np.int32)
            for j, oi in enumerate(sel):
                members[j, : sizes[oi]] = order[starts[oi]:ends[oi]]
            c0, c1, side0 = (t.cpu().numpy() for t in _batched_two_means(
                xd, torch.from_numpy(members).to(xd.device)))
            for j, oi in enumerate(sel):
                mem = members[j]
                cent[over[oi]] = c0[j]
                cent.append(c1[j])
                assign[mem[(mem >= 0) & ~side0[j]]] = len(cent) - 1
    return np.asarray(cent, np.float32), assign


def _ivf_range(cb: torch.Tensor, bn: torch.Tensor, bi: torch.Tensor, bs: torch.Tensor,
               q: torch.Tensor, radius: float, metric: str, max_results: int,
               precision: str = "float32", tile: int = 65536):
    """Exact range query over a flat (rows, norms, ids, scales) view, in
    tiles of `tile` rows with a running top-R. Rows with an id < 0 or a norm
    of +inf never count. Returns user-facing (scores [B, R], ids [B, R],
    counts [B]): squared L2 <= radius for l2, similarity >= radius
    otherwise; counts is exact, the ids the R best in range."""
    prec = {"float32": "highest"}.get(precision, precision)
    qp = D.preprocess_queries(q, metric)
    b = qp.shape[0]
    is_l2 = metric == "l2"
    rows = cb.shape[0]
    kt = min(max_results, min(tile, rows))
    run_s = torch.full((b, max_results), _INF, dtype=torch.float32, device=qp.device)
    run_i = torch.full((b, max_results), -1, dtype=torch.int32, device=qp.device)
    counts = torch.zeros(b, dtype=torch.int32, device=qp.device)
    for lo in range(0, rows, tile):
        ids = bi[lo:lo + tile]
        s = D.pairwise_scores(qp, cb[lo:lo + tile], bn[lo:lo + tile], metric, precision=prec,
                              x_scales=bs[lo:lo + tile])
        s = torch.where(ids[None, :] >= 0, s, _INF)
        user = D.finalize_scores(s, qp, metric)
        in_r = torch.isfinite(s) & ((user <= radius) if is_l2 else (user >= radius))
        counts += in_r.sum(-1, dtype=torch.int32)
        ts, ti = T.smallest_k(s, ids[None, :].expand_as(s), min(kt, s.shape[1]))
        ts, ti = _pad_k(ts, ti, kt)
        run_s, run_i = T.merge_topk(run_s, run_i, ts, ti, max_results)
    user = D.finalize_scores(run_s, qp, metric)
    in_r = (run_i >= 0) & ((user <= radius) if is_l2 else (user >= radius))
    run_i = torch.where(in_r, run_i, -1)
    user = torch.where(in_r, user, _INF if is_l2 else -_INF)
    return user, run_i, counts
