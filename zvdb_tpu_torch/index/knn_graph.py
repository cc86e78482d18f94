"""Approximate kNN-graph construction by spilled clustering (port of
zvdb_tpu/index/knn_graph.py).

The whole graph comes from dense products, with no beam searches:

  1. k-means the corpus into C clusters of ~`block` points (on a sample);
  2. assign every point to its `spill` nearest clusters;
  3. pack the clusters into blocks and score each block against itself: its
     rows' nearest blockmates become candidates ("exact" top-k, "binfold",
     or "pallas": the block scorer kernel, ops/block_scan.py);
  4. repeat for `passes` clusterings (different boundaries; the union
     repairs what one view misses);
  5. dedupe, diversity-prune to `degree`, add reverse edges, then stamp a
     cluster-chain edge and `n_long` random long-range edges into each row.

Differences from the JAX package, by design:
  * random draws (the k-means sample and initial centroids, the long-range
    edges) come from one torch.Generator, which cannot reproduce JAX's PRNG:
    one seed builds a different graph in each package. The deterministic
    stages take their inputs as arguments and equal JAX's on equal inputs.
  * sel="approx" (JAX: lax.approx_min_k, the TPU's hardware top-k) runs
    ops/approx_topk.py:approx_min_k when bcap >= 4 * kk, as JAX does: the
    binned kernel on the card, the exact top-k on the CPU, as JAX's
    approx_min_k there.
  * products take their precision by name (`precision`); JAX runs the build
    under an ambient jax.default_matmul_precision. As in JAX, sel="pallas"
    scores at "high" whatever the build's precision.
  * buffers are updated in place where JAX donates and copies; "drop"
    scatters are masked writes.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import approx_topk as AK
from ..ops import distance as D
from ..ops import topk as T
from ..ops.block_scan import block_bins
from ..utils.profiling import Stages, wait
from .build import _reverse_pass, _reverse_pass_bulk, select_neighbors
from .flat import resolve_device
from .ivf import _assign, _update_centroids

_INF = float("inf")


class VecStore(NamedTuple):
    """Stand-in for an engine state in select_neighbors (vectors, norms and
    q_scale are the only fields it reads)."""
    vectors: torch.Tensor
    norms: torch.Tensor
    q_scale: float


def _kmeans_device(xj: torch.Tensor, c: int, iters: int, gen: torch.Generator,
                   sample: int = 65536) -> torch.Tensor:
    """Lloyd k-means of xj [N, D] f32 into c centroids, on xj's device: a
    sample of `sample` rows without replacement, c of them as the initial
    centroids (with replacement only when the sample has fewer than c rows),
    then `iters` rounds of assignment and update. Returns [c, D] f32."""
    n = xj.shape[0]
    xs = xj
    if n > sample:
        pick = torch.randperm(n, generator=gen)[:sample]
        with wait("kmeans_sample"):   # pageable uploads
            pick = pick.to(xj.device)
        xs = xj[pick]
    m = xs.shape[0]
    if m < c:
        init = torch.randint(0, m, (c,), generator=gen)
    else:
        init = torch.randperm(m, generator=gen)[:c]
    with wait("kmeans_init"):
        init = init.to(xj.device)
    cent = xs[init].float()
    xn = D.sq_norms(xs)
    for _ in range(iters):
        a = _assign(xs, xn, cent, D.sq_norms(cent))
        cent = _update_centroids(xs, a, cent)
    return cent


# ---------------------------------------------------------------------------
# assignment + packing


def _assign_spill(x, xn, cent, cn, spill: int, metric: str, tile: int = 16384,
                  precision: Optional[str] = None):
    """Per point: its `spill` nearest clusters (ties to the lower cluster)
    and the rank-0 score. Returns (assign [N, spill] int32, best_score [N] f32)."""
    n = x.shape[0]
    a = torch.empty((n, spill), dtype=torch.int32, device=x.device)
    s0 = torch.empty((n,), dtype=torch.float32, device=x.device)
    for lo in range(0, n, tile):
        s = D.pairwise_scores(x[lo:lo + tile], cent, cn, metric, precision=precision)
        ts, idx = T.smallest_k_dense(s, spill)
        a[lo:lo + tile] = idx.to(torch.int32)
        s0[lo:lo + tile] = ts[:, 0]
    return a, s0


def _pack_blocks(assign: np.ndarray, c: int, bcap: int):
    """Pack (point, rank) pairs into per-cluster blocks, rank-0 first (host
    numpy).

    When a cluster overflows `bcap`, the dropped pairs are its highest-rank
    spill assignments. Points dropped from every block go, grouped by their
    rank-0 cluster, into extra presence-overflow blocks. Returns (block_pts
    [C', bcap] int32 -1-padded, block_occ [C', bcap] int32 spill-rank of each
    slot, n_dropped)."""
    n, spill = assign.shape
    cluster = assign.reshape(-1)
    rank = np.tile(np.arange(spill, dtype=np.int64), n)
    point = np.repeat(np.arange(n, dtype=np.int64), spill)
    order = np.lexsort((rank, cluster))
    sc, sr, sp = cluster[order], rank[order], point[order]
    first = np.searchsorted(sc, np.arange(c), side="left")
    pos_in_cluster = np.arange(n * spill) - first[sc]
    keep = pos_in_cluster < bcap
    block_pts = np.full((c, bcap), -1, np.int32)
    block_occ = np.zeros((c, bcap), np.int32)
    block_pts[sc[keep], pos_in_cluster[keep]] = sp[keep].astype(np.int32)
    block_occ[sc[keep], pos_in_cluster[keep]] = sr[keep].astype(np.int32)

    present = np.zeros(n, bool)
    present[block_pts[block_pts >= 0]] = True
    missing = np.nonzero(~present)[0]
    if missing.size:
        order = np.argsort(assign[missing, 0], kind="stable")
        mm = missing[order].astype(np.int32)
        rows = -(-mm.size // bcap)
        extra = np.full((rows, bcap), -1, np.int32)
        extra.reshape(-1)[: mm.size] = mm
        block_pts = np.concatenate([block_pts, extra], axis=0)
        block_occ = np.concatenate([block_occ, np.zeros((rows, bcap), np.int32)], axis=0)
    return block_pts, block_occ, int((~keep).sum())


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by keys[0], then keys[1], ... (like np.lexsort of
    the reversed keys): stable sorts from the last key to the first."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _pack_core(assign: torch.Tensor, c: int, bcap: int, spill: int):
    """Device-side _pack_blocks: the same (point, rank) -> per-cluster block
    tables from one stable sort. Returns (block_pts [c, bcap], block_occ
    [c, bcap], n_missing (a 0-dim int32 tensor), morder [n] int32), where
    morder orders points by (present, rank-0 cluster), so its first
    n_missing entries are the host pack's presence-overflow set in its
    order. Writes of dropped pairs go to the trash row c, as in JAX."""
    n, sp_w = assign.shape
    dev = assign.device
    cluster = assign.reshape(-1).to(torch.int32)
    rank = torch.arange(sp_w, dtype=torch.int32, device=dev).repeat(n)
    point = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(sp_w)
    order = torch.argsort(cluster * sp_w + rank, stable=True)
    sc, sr, sp = cluster[order], rank[order], point[order]
    first = torch.searchsorted(sc, torch.arange(c, dtype=torch.int32, device=dev), side="left")
    pos = torch.arange(n * sp_w, device=dev) - first[sc.long()]
    keep = pos < bcap
    wp = torch.where(keep, sc.long(), c)
    wpos = pos.clamp(0, bcap - 1)
    block_pts = torch.full((c + 1, bcap), -1, dtype=torch.int32, device=dev)
    block_pts[wp, wpos] = torch.where(keep, sp, -1)
    block_occ = torch.zeros((c + 1, bcap), dtype=torch.int32, device=dev)
    block_occ[wp, wpos] = torch.where(keep, sr, 0)
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    with wait("pack_present"):   # a boolean mask's size
        kept = sp[keep]
    with wait("pack_present"):   # a host scalar written into device rows
        present[kept.long()] = True
    n_missing = (~present).sum().to(torch.int32)
    # absent points first, grouped by their rank-0 cluster (stable)
    morder = _stable_order(present.to(torch.int32), assign[:, 0]).to(torch.int32)
    return block_pts[:c], block_occ[:c], n_missing, morder


def _reps_chain_device(assign0: torch.Tensor, s0: torch.Tensor, c: int, reps: int):
    """Representative rows per cluster, spread along the cluster's
    distance-to-centroid order (slot 0 = medoid), and the cluster chain:
    each point's successor in that order (wrapping), -1 for a singleton.
    Returns (c_rows [c, reps] int32, chain [n] int32)."""
    n = assign0.shape[0]
    dev = assign0.device
    order = _stable_order(assign0, s0)
    sa0 = assign0[order].contiguous()
    cl = torch.arange(c, dtype=sa0.dtype, device=dev)
    starts = torch.searchsorted(sa0, cl, side="left")
    ends = torch.searchsorted(sa0, cl, side="right")
    span = torch.clamp(ends - starts, min=1)
    has = ends > starts
    cols = []
    for r in range(reps):
        frac = r / max(reps, 1)
        pos = starts + torch.minimum((frac * span.float()).to(torch.int64),
                                     torch.clamp(ends - starts - 1, min=0))
        pos = pos.clamp(0, n - 1)
        cols.append(torch.where(has, order[pos], 0))
    c_rows = torch.stack(cols, dim=1).to(torch.int32)
    idx = torch.arange(n, device=dev)
    pos_next = idx + 1
    sl = sa0.long()
    pos_next = torch.where(pos_next >= ends[sl], starts[sl], pos_next)
    chain = torch.zeros(n, dtype=torch.int64, device=dev)
    chain[order] = order[pos_next]
    chain = torch.where(chain == idx, -1, chain)      # singleton clusters
    return c_rows, chain.to(torch.int32)


# ---------------------------------------------------------------------------
# per-block brute-force kNN + candidate scatter


def _block_knn_scatter(x, xn, block_pts, block_occ, occ_base: int, cand_s, cand_i, kc: int,
                       metric: str, sel: str = "exact", precision: Optional[str] = None):
    """One chunk of clusters: each block's rows scored against the block ->
    top-kc per row -> each slot's candidate list into its point's occurrence
    lane of cand_s / cand_i ([N+1, O, kc], row N = trash), IN PLACE.

    sel: "exact" (top-kc, ties to the lower column), "approx" (approx_min_k
    over each row when bcap >= 4 * kk, else exact), "binfold" (modular-bin
    minima, then a (score, id) sort over the bins), "pallas" (the block
    scorer kernel at "high", then the same sort). Returns (cand_s, cand_i)."""
    cc, bcap = block_pts.shape
    safe = block_pts.clamp(min=0).long()
    v = x[safe]                                          # [cc, B, D]
    vn = xn[safe]                                        # [cc, B]
    valid = block_pts >= 0
    nbias = torch.where(valid, vn if metric == "l2" else torch.zeros_like(vn), _INF)
    kk = min(kc, bcap)
    if sel == "pallas" and bcap >= 4 * kk and 128 >= 2 * kk:
        L = 128
        bin_s, bin_i = block_bins(v.float(), nbias, l_bins=L, bq=256, metric=metric,
                                  precision="high")
        ts, tp = T.sort_smallest_k(bin_s.reshape(cc * bcap, L), bin_i.reshape(cc * bcap, L), kk)
    else:
        f = 2.0 if metric == "l2" else 1.0
        dots = D._sum_products(D._operand_pairs(v, v, precision),
                               lambda a, b: torch.bmm(a, b.transpose(1, 2)))
        # validity rides the neighbor norm column; self-pairs are the diagonal
        # (a block never holds a point twice); invalid SOURCE rows scatter
        # to the trash row below
        s = nbias[:, None, :] - f * dots
        s.diagonal(dim1=1, dim2=2).fill_(_INF)
        del dots
        if sel == "binfold" and bcap >= 4 * kk:
            L = min(bcap, max(4 * kk, 32))
            bin_s, col = AK.fold_bins(s, L)
            ts, tp = T.sort_smallest_k(bin_s.reshape(cc * bcap, L), col.reshape(cc * bcap, L), kk)
        elif sel == "approx" and bcap >= 4 * kk:
            # candidate generation only: the views' union, the prune and the
            # reverse pass absorb the few per-view misses, as in JAX
            ts, tp = AK.approx_min_k(s, kk)
        else:
            ts, tp = T.smallest_k_dense(s, kk)
    ts = ts.reshape(cc, bcap, kk)
    tp = tp.reshape(cc, bcap, kk).clamp(0, bcap - 1).long()
    tids = torch.gather(block_pts[:, None, :].expand(cc, bcap, bcap), -1, tp)
    tids = torch.where(torch.isfinite(ts), tids, -1)
    if kk < kc:
        ts = torch.cat([ts, ts.new_full((cc, bcap, kc - kk), _INF)], dim=-1)
        tids = torch.cat([tids, tids.new_full((cc, bcap, kc - kk), -1)], dim=-1)
    npts = cand_s.shape[0] - 1
    wp = torch.where(valid, block_pts, npts).reshape(-1).long()
    wo = (occ_base + block_occ).reshape(-1).long()
    cand_s[wp, wo] = ts.reshape(-1, kc)
    cand_i[wp, wo] = tids.reshape(-1, kc).to(cand_i.dtype)
    return cand_s, cand_i


# ---------------------------------------------------------------------------
# merge + diversity prune


def _prune_chunk(x, xn, rows, cand_s, cand_i, alpha: float, degree: int, metric: str,
                 prune_cap: int = 0, precision: Optional[str] = None):
    """Dedupe one chunk's merged candidates and diversity-prune to `degree`.
    Returns (sel [T, degree] int32, sel_d [T, degree] true distances).
    prune_cap > 0 narrows the pool to the nearest prune_cap first."""
    cs, ci = T.mask_duplicate_ids(cand_s, cand_i)
    store = VecStore(x, xn, 1.0)
    return select_neighbors(store, x[rows], xn[rows], ci, cs, degree, alpha, metric,
                            max_candidates=prune_cap, precision=precision)


def build_knn_graph(
    x,                      # np.ndarray or tensor [N, D] (a tensor is not copied)
    degree: int,
    gen: torch.Generator,
    metric: str = "l2",
    block: int = 1024,
    spill: int = 2,
    passes: int = 2,
    kmeans_iters: int = 5,
    alpha: float = 1.2,
    reverse: bool = True,
    balance_slack: float = 1.6,
    precision: str = "high",
    prune_chunk: int = 8192,
    reverse_chunk: int = 131072,
    reps: int = 4,
    n_long: int = 4,
    kc_per_view: int = 0,
    prune_cap: int = 0,
    block_topk: str = "exact",
    chain: bool = True,
    kmeans_sample: int = 65536,
    segments=None,
    pack: str = "device",
    device=None,
    stats: Optional[dict] = None,
):
    """Build a `degree`-regular approximate kNN graph over x [N, D].

    segments: optional list of tensors whose concatenation replaces x (the
    upload-overlap path; see _build_steps). A numpy x goes to `device`
    (None: "cuda"); a tensor stays where it is. `stats`, if given, receives
    the build's geometry (see _build_steps).

    Returns (nbrs [N+1, degree] int32 -1-padded (row N is the scatter trash
    row), dists [N+1, degree] f32 true distances, centroids [C, D] f32 of the
    last clustering pass, c_norms [C], c_rows [C, reps] int32 representative
    rows per cluster). x must already be metric-preprocessed (cosine:
    normalized); distances are squared L2 for l2, -dot for dot/cosine.
    """
    if segments is None and not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    steps = _build_steps(
        x, degree, gen, metric=metric, block=block, spill=spill, passes=passes,
        kmeans_iters=kmeans_iters, alpha=alpha, reverse=reverse,
        balance_slack=balance_slack, precision=precision, prune_chunk=prune_chunk,
        reverse_chunk=reverse_chunk, reps=reps, n_long=n_long, kc_per_view=kc_per_view,
        prune_cap=prune_cap, block_topk=block_topk, chain=chain,
        kmeans_sample=kmeans_sample, segments=segments, pack=pack, stats=stats)
    try:
        req = next(steps)
        while True:
            req = steps.send(_pull(req))
    except StopIteration as e:
        return e.value


def _pull(req) -> tuple:
    """A build generator's request, pulled to the host: one wait a tensor."""
    out = []
    for a in req:
        with wait("build_pull"):
            out.append(a.cpu().numpy())
    return tuple(out)


def build_knn_graph_multi(xs, degree: int, gens, devices=None, precision: str = "high",
                          stats=None, **kw):
    """Graph builds of several shards, interleaved phase by phase: one
    _build_steps generator a shard (its own torch.Generator, its rows on
    its device), every generator advanced to its next pull before any
    request is pulled to the host, so each shard's device work is queued
    before the host waits on the first pull.

    xs: per-shard corpora (numpy, moved to the shard's device, or tensors,
    moved only when a device is named); gens: one torch.Generator a shard;
    devices: one device a shard (None: "cuda"); stats: optional list of
    dicts, one a shard, as build_knn_graph's `stats`. The rest of the
    keywords are build_knn_graph's. Returns a list of per-shard (nbrs,
    dists, centroids, c_norms, c_rows), each equal to build_knn_graph's on
    that shard's rows with an equally seeded generator."""
    s = len(xs)
    devices = devices if devices is not None else [None] * s
    stats = stats if stats is not None else [None] * s
    steps = []
    for x, gen, dev, st in zip(xs, gens, devices, stats):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(dev))
        elif dev is not None:
            x = x.to(dev)
        steps.append(_build_steps(x, degree, gen, precision=precision, stats=st, **kw))
    results: list = [None] * s
    pending = [(i, None) for i in range(s)]
    while pending:
        reqs = []
        for i, sent in pending:
            try:
                reqs.append((i, next(steps[i]) if sent is None else steps[i].send(sent)))
            except StopIteration as e:
                results[i] = e.value
        pending = [(i, _pull(req)) for i, req in reqs]
    return results


def _build_steps(
    x,
    degree: int,
    gen: torch.Generator,
    metric: str = "l2",
    block: int = 1024,
    spill: int = 2,
    passes: int = 2,
    kmeans_iters: int = 5,
    alpha: float = 1.2,
    reverse: bool = True,
    balance_slack: float = 1.6,
    precision: str = "high",
    prune_chunk: int = 8192,
    reverse_chunk: int = 131072,
    reps: int = 4,
    n_long: int = 4,
    kc_per_view: int = 0,
    prune_cap: int = 0,
    block_topk: str = "exact",
    chain: bool = True,
    kmeans_sample: int = 65536,
    segments=None,
    pack: str = "device",
    stats: Optional[dict] = None,
):
    """Generator form of the graph build: yields tuples of tensors at each
    point where the host needs their values, and expects them back as numpy
    through send() (a multi-shard caller can dispatch other shards' work
    before it pulls). Its stages are spans "build.<stage>"
    (utils.profiling.Stages: kmeans, assign, pack, block_knn each pass;
    reps, prune, reverse, chain, long_edges); with ZVDB_BUILD_TRACE=1 it
    prints each stage's seconds summed over the passes, synchronizing the
    device between stages.

    segments: optional list of tensors whose concatenation is the corpus:
    pass 0 clusters on segment 0 and assigns segment by segment, so that on
    a host whose copies overlap compute the clustering hides under the
    transfer of the later segments; the whole corpus is concatenated after
    that work is queued.

    stats: optional dict that receives what the build did, for callers that
    count kernel launches or replay a chunk: kc, the cluster count c, the
    block capacity bcap, cc blocks per chunk, c_blocks per pass
    (presence-overflow blocks included) and the last pass's first chunk of
    block rows (first_chunk)."""
    def norms_of(t):
        return D.sq_norms(t) if metric == "l2" else \
            torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)

    if segments is not None:
        dev = segments[0].device
        n = sum(int(s.shape[0]) for s in segments)
        xj = xn = None   # materialized after pass-0 assignment is queued
        if n <= max(degree + 1, 32):
            xj = torch.cat([s.float() for s in segments])
            return _tiny_graph(xj, norms_of(xj), n, degree, metric, precision)
    else:
        dev = x.device
        n = x.shape[0]
        xj = x.float()
        xn = norms_of(xj)
        if n <= max(degree + 1, 32):
            return _tiny_graph(xj, xn, n, degree, metric, precision)

    mark = Stages(dev, "build.")
    block = int(min(block, max(64, n)))
    kc = min(kc_per_view if kc_per_view > 0 else degree, block - 1)
    o_total = passes * spill
    cand_s = torch.full((n + 1, o_total, kc), _INF, dtype=torch.float32, device=dev)
    cand_i = torch.full((n + 1, o_total, kc), -1, dtype=torch.int32, device=dev)
    stats = {} if stats is None else stats
    stats.update(kc=kc, c_blocks=[])

    centroids = c_norms = c_rows = chain_t = None
    for p in range(passes):
        c = max(1, int(round(n * spill / block)))
        mark("kmeans")
        if p == 0 and segments is not None:
            seg0 = segments[0].float()
            centj = _kmeans_device(seg0, c, kmeans_iters, gen,
                                   sample=min(int(seg0.shape[0]), kmeans_sample))
            mark("assign", sync=False)   # a sync would stall the overlap
            cn = norms_of(centj)
            per_seg = []
            for seg in segments:
                seg_f = seg.float()
                per_seg.extend(_assign_spill(seg_f, norms_of(seg_f), centj, cn, min(spill, c),
                                             metric, precision=precision))
            xj = torch.cat([s.float() for s in segments])
            xn = norms_of(xj)
            if pack == "device":
                assign = torch.cat(per_seg[0::2])
                s0 = torch.cat(per_seg[1::2])
            else:
                pulled = yield tuple(per_seg)
                assign_np = np.concatenate(pulled[0::2], axis=0)
                s0n = np.concatenate(pulled[1::2], axis=0)
        else:
            centj = _kmeans_device(xj, c, kmeans_iters, gen, sample=min(n, kmeans_sample))
            mark("assign")
            cn = norms_of(centj)
            assign, s0 = _assign_spill(xj, xn, centj, cn, min(spill, c), metric,
                                       precision=precision)
            if pack != "device":
                assign_np, s0n = yield (assign, s0)
        mark("pack")
        bcap = max(8, int(math.ceil(balance_slack * spill * n / c / 8.0)) * 8)
        bcap = min(bcap, n * spill)
        cc = max(1, (1 << 25) // max(bcap * bcap, 1))
        if pack == "device":
            if assign.shape[1] < spill:   # c < spill: replicate the last column
                assign = torch.cat(
                    [assign, assign[:, -1:].expand(n, spill - assign.shape[1])], dim=1)
            bp, bo, nmiss, morder = _pack_core(assign, c, bcap, spill)
            (nm_np,) = yield (nmiss,)
            nm = int(nm_np)
            if nm > 0:
                # presence-overflow blocks: few, shaped on the host
                (morder_np,) = yield (morder,)
                rows = -(-nm // bcap)
                extra = np.full((rows, bcap), -1, np.int32)
                extra.reshape(-1)[:nm] = morder_np[:nm]
                with wait("pack_overflow"):   # a pageable upload
                    extra_t = torch.from_numpy(extra).to(dev)
                bp = torch.cat([bp, extra_t])
                bo = torch.cat([bo, torch.zeros((rows, bcap), dtype=torch.int32, device=dev)])
        else:
            if assign_np.shape[1] < spill:
                assign_np = np.pad(assign_np, ((0, 0), (0, spill - assign_np.shape[1])),
                                   mode="edge")
            bp_np, bo_np, _dropped = _pack_blocks(assign_np, c, bcap)
            with wait("pack_upload"):
                bp = torch.from_numpy(bp_np).to(dev)
            with wait("pack_upload"):
                bo = torch.from_numpy(bo_np).to(dev)
        mark("block_knn")
        # chunks of cc blocks keep the [cc, B, B] score work ~2^25 entries;
        # the last chunk holds what is left (JAX pads it to cc empty blocks
        # for a static shape, which at a small n means thousands of them)
        c_blocks = bp.shape[0]
        stats.update(c=c, bcap=bcap, cc=cc, first_chunk=bp[:cc].clone())
        stats["c_blocks"].append(c_blocks)
        for lo in range(0, c_blocks, cc):
            _block_knn_scatter(xj, xn, bp[lo:lo + cc], bo[lo:lo + cc], p * spill, cand_s, cand_i,
                               kc, metric, sel=block_topk, precision=precision)
        del bp, bo

        if p == passes - 1:
            mark("reps")
            centroids, c_norms = centj, cn
            # representative rows and the cluster chain (see
            # _reps_chain_device): the chain gives every point an in-edge
            # from a cluster-mate, so reaching any point of a cluster makes
            # the whole cluster reachable
            if pack == "device":
                c_rows, chain_t = _reps_chain_device(assign[:, 0], s0, c, reps)
            else:
                c_rows_np, chain_np = _reps_chain_host(assign_np[:, 0], s0n, c, reps)
                with wait("reps_upload"):
                    c_rows = torch.from_numpy(c_rows_np).to(dev)
                with wait("reps_upload"):
                    chain_t = torch.from_numpy(chain_np).to(dev)

    # ---- merge + prune: occurrence lanes flattened; the final chunk re-covers the tail
    cand_s = cand_s.reshape(n + 1, o_total * kc)
    cand_i = cand_i.reshape(n + 1, o_total * kc)
    mark("prune")
    nbrs = torch.full((n + 1, degree), -1, dtype=torch.int32, device=dev)
    dists = torch.full((n + 1, degree), _INF, dtype=torch.float32, device=dev)
    pc = min(prune_chunk, n)
    for lo in range(0, n, pc):
        lo = min(lo, n - pc)
        rows = torch.arange(lo, lo + pc, device=dev)
        sel, sel_d = _prune_chunk(xj, xn, rows, cand_s[lo:lo + pc], cand_i[lo:lo + pc], alpha,
                                  degree, metric, prune_cap=prune_cap, precision=precision)
        nbrs[lo:lo + pc] = sel
        dists[lo:lo + pc] = sel_d
    del cand_s, cand_i

    # ---- reverse edges
    if reverse:
        mark("reverse")
        if n * degree <= (1 << 25) and not os.environ.get("ZVDB_OLD_REVERSE"):
            nbrs, dists = _reverse_pass_bulk(nbrs, dists, n_rows=n, degree=degree)
        else:
            rc = min(reverse_chunk, n)
            for lo in range(0, n, rc):
                lo = min(lo, n - rc)
                rows = torch.arange(lo, lo + rc, dtype=torch.int32, device=dev)
                _reverse_pass(nbrs, dists, rows, nbrs[lo:lo + rc].clone(),
                              dists[lo:lo + rc].clone(), degree)

    # ---- chain edges (the slot before the long-range block)
    if chain and n > degree + 1 and degree - n_long >= 2:
        mark("chain")
        _stamp_chain_edges(xj, xn, nbrs, dists, chain_t, metric, slot=degree - n_long - 1)

    # ---- random long-range edges (after the reverse pass, whose distance
    # merges would evict them)
    mark("long_edges")
    if n_long > 0 and n > degree + 1:
        ids = torch.randint(0, n, (n, n_long), generator=gen, dtype=torch.int32)
        with wait("long_edges"):   # a pageable upload
            ids = ids.to(dev)
        _stamp_long_edges(xj, xn, nbrs, dists, ids, metric, precision=precision)
    mark.end()
    if mark.timed:
        print(mark.report(f"build_knn_graph n={n}"), flush=True)
    return nbrs, dists, centroids, c_norms, c_rows


def _reps_chain_host(a0: np.ndarray, s0n: np.ndarray, c: int, reps: int):
    """_reps_chain_device on the host (the pack="host" path)."""
    n = a0.shape[0]
    order = np.lexsort((s0n, a0))
    sa0 = a0[order]
    starts = np.searchsorted(sa0, np.arange(c), side="left")
    ends = np.searchsorted(sa0, np.arange(c), side="right")
    c_rows = np.zeros((c, reps), np.int32)
    for r in range(reps):
        frac = r / max(reps, 1)
        pos = starts + np.minimum((frac * np.maximum(ends - starts, 1)).astype(np.int64),
                                  np.maximum(ends - starts - 1, 0))
        pos = np.clip(pos, 0, n - 1)
        c_rows[:, r] = np.where(ends > starts, order[pos], 0)
    idx_n = np.arange(n)
    pos_next = idx_n + 1
    pos_next = np.where(pos_next >= ends[sa0], starts[sa0], pos_next)
    chain = np.full(n, -1, np.int64)
    chain[order] = order[pos_next]
    chain[chain == idx_n] = -1   # singleton clusters
    return c_rows, chain.astype(np.int32)


def _stamp_chain_edges(xj, xn, nbrs, dists, succ, metric: str, slot: int):
    """Overwrite one slot of each row with the cluster-chain edge, IN PLACE
    (row N, the trash row, keeps its padding). The distance is an
    elementwise f32 sum, as in JAX, not a product."""
    valid = succ >= 0
    safe = succ.clamp(min=0).long()
    dots = (xj * xj[safe]).sum(-1)
    d = xn + xn[safe] - 2.0 * dots if metric == "l2" else -dots
    nbrs[:-1, slot] = torch.where(valid, succ, nbrs[:-1, slot])
    dists[:-1, slot] = torch.where(valid, d, dists[:-1, slot])
    return nbrs, dists


def _stamp_long_edges(xj, xn, nbrs, dists, ids, metric: str, precision: Optional[str] = None):
    """Overwrite each row's last n_long slots with the long-range edges
    `ids` [N, n_long] (drawn uniformly by the caller; a self-edge moves to
    the next row), IN PLACE; the trash row's slots become -1 / +inf. The
    distances are one [N, n_long, D] gather and a product at `precision`."""
    n = xj.shape[0]
    n_long = ids.shape[1]
    degree = nbrs.shape[1]
    rows = torch.arange(n, dtype=ids.dtype, device=ids.device)[:, None]
    ids = torch.where(ids == rows, (ids + 1) % n, ids)
    safe = ids.long()
    v = xj[safe]                                                   # [N, L, D]
    dots = D._sum_products(D._operand_pairs(xj, v, precision),
                           lambda a, b: torch.einsum("nd,nld->nl", a, b))
    del v
    d = xn[:, None] + xn[safe] - 2.0 * dots if metric == "l2" else -dots
    nbrs[:n, degree - n_long:] = ids.to(nbrs.dtype)
    dists[:n, degree - n_long:] = d
    nbrs[n, degree - n_long:] = -1
    dists[n, degree - n_long:] = _INF
    return nbrs, dists


def _tiny_graph(xj, xn, n: int, degree: int, metric: str, precision: Optional[str] = None):
    """n <= degree+1-ish: the exact dense graph from one product."""
    s = D.pairwise_scores(xj, xj, xn, metric, precision=precision)
    s.diagonal().fill_(_INF)
    kk = min(degree, max(n - 1, 1))
    ts, idx = T.smallest_k_dense(s, kk)
    if metric == "l2":
        ts = ts + xn[:, None]
    ids = torch.where(torch.isfinite(ts), idx.to(torch.int32), -1)
    ts = torch.where(ids >= 0, ts, _INF)
    if kk < degree:
        ids = torch.cat([ids, ids.new_full((n, degree - kk), -1)], dim=1)
        ts = torch.cat([ts, ts.new_full((n, degree - kk), _INF)], dim=1)
    nbrs = torch.cat([ids, ids.new_full((1, degree), -1)])
    dists = torch.cat([ts, ts.new_full((1, degree), _INF)])
    cent = xj.mean(0, keepdim=True)
    cn = D.sq_norms(cent) if metric == "l2" else torch.zeros(1, device=xj.device)
    return nbrs, dists, cent, cn, torch.zeros((1, 1), dtype=torch.int32, device=xj.device)
