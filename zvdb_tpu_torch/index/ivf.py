"""IVF-Flat index: the corpus grouped into k-means clusters stored as
contiguous blocks (port of zvdb_tpu/index/ivf.py).

A search scores each query against the centroids, takes its nprobe nearest
clusters, and scores the probed blocks densely: when clusters outnumber the
probe pairs (C * 8 > B * P) each (query, probe) pair gathers its block (the
pair scan); otherwise the pairs are slotted per cluster and every block is
read once and scored against all its probing queries in one batched product
(the grouped scan). Each pair keeps its block's kk best rows; the P * kk pool
is filtered by an allowlist if one is given, optionally re-scored exactly
against the shadow store (`rerank`), and cut to k.

Blocks hold f32 or bf16 rows, or int8 codes of the residual to the row's
centroid with a per-row scale (`dtype="int8"`); q.x is then q.centroid (from
the probe scores) plus the scaled code product.

No Pallas kernel runs here, in either package: both scans are plain
products (f32 `torch.bmm`, TF32 off, at the config's precision). Where the
JAX package selects with `lax.approx_min_k` (the probes when C >= 4096 and
4 * nprobe <= C; the pair scan's cut when cap >= 4 * kk), the port calls
ops/approx_topk.py:approx_min_k under the same guards: the binned kernel on
the card, the exact top-k on the CPU, as JAX's approx_min_k there.

Entry points take `device=None`, which means "cuda"; without a CUDA device
they raise unless the caller asks for "cpu". The k-means draws from a
torch.Generator seeded by cfg.seed, which cannot reproduce the JAX
package's PRNG; the host split's numpy streams (`default_rng(seed + 1)`,
`seed + 2`) are the JAX package's. `IVFIndex.from_numpy`, `load` and
`resume_build` carry JAX-built state across.

Every float product here names its precision; "float32" (the config's
default) is plain f32, which on the card assumes
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import approx_topk as AK
from ..ops import distance as D
from ..ops import topk as T
from ..utils.filter_policy import resolve_filter_mode
from ..utils.masks import allowed_mask
from ..utils.profiling import Stages, entry, span, wait
from .flat import _pad_k, masked_exact_search, resolve_device, tensor_from_numpy

_INF = float("inf")

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _prec(precision: Optional[str]) -> Optional[str]:
    """A JAX precision name as ops/distance.py names it ("float32" is f32)."""
    return {"float32": "highest"}.get(precision, precision)


def _products(a: torch.Tensor, b: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """Batched a [N, M, D] @ b [N, D, K] -> [N, M, K] f32 at `precision`."""
    return D._sum_products(D._operand_pairs(a, b, precision), torch.bmm)


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    """Config for the IVF-Flat engine (the JAX package's fields, defaults and
    validation, so save files and checkpoints load in both)."""

    dim: int
    n_clusters: Optional[int] = None      # default: ~4*sqrt(N), pow2-rounded
    nprobe: int = 16
    metric: str = "l2"
    dtype: str = "float32"                # block storage dtype
    kmeans_iters: int = 12
    kmeans_sample: int = 131072           # max points used for Lloyd iterations
    # block capacity before the split = factor * (N / C), a multiple of 8
    max_cluster_factor: float = 2.0
    precision: str = "float32"
    # Exact rerank: rerank*k candidates of the scan re-scored against the
    # full-precision shadow store, top-k of those returned. 0 = off.
    rerank: int = 0
    rerank_dtype: str = "float32"
    # Block capacity packed after the split = headroom * the largest cluster
    # (rounded up to 8); the spare room is where add() appends in O(new).
    block_headroom: float = 1.25
    seed: int = 0

    def __post_init__(self):
        if self.metric not in ("l2", "dot", "cosine"):
            raise ValueError(f"bad metric {self.metric!r}")

    @property
    def storage_dtype(self) -> torch.dtype:
        # int8: symmetric per-vector residual codes + f32 scales (state.b_scales)
        return _STORAGE[self.dtype]


@dataclasses.dataclass
class IVFState:
    """Device-resident IVF-Flat state (the JAX package's IVFState fields)."""

    centroids: torch.Tensor     # [C, D] f32
    c_norms: torch.Tensor       # [C] f32 (squared norms for l2; zeros otherwise)
    blocks: torch.Tensor        # [C, cap, D] storage dtype (f32/bf16/int8 codes)
    b_norms: torch.Tensor       # [C, cap] f32, +inf padding
    b_scales: torch.Tensor      # [C, cap] f32 dequant scales (1.0 for float dtypes)
    b_ids: torch.Tensor         # [C, cap] int32 ext ids; -1 pad, -2-id tombstone
    counts: torch.Tensor        # [C] int32
    n: int                      # rows ingested (tombstones included); a host int
    rerank_vecs: torch.Tensor   # [rcap, D] shadow rows in ext-id order ([0, D] = off)
    rerank_norms: torch.Tensor  # [rcap] f32 exact squared norms (l2; zeros otherwise)


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(IVFState))


# ---------------------------------------------------------------------------
# k-means (device)


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
    with wait("kmeans_counts", syncs=2):   # bincount checks a min and sizes by a max
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


# ---------------------------------------------------------------------------
# device pack (in place: the JAX versions donate their carries and return copies)


def _quantize_residual(xo: torch.Tensor, centv: torch.Tensor):
    """int8 codes of xo - centv with a per-row scale. The scale multiplies by
    f32(1 / 127): the JAX package divides inside jit, which XLA compiles to
    that multiplication. The codes divide by the scale."""
    resid = xo - centv
    scl = torch.clamp(resid.abs().amax(dim=-1), min=1e-12) * (1.0 / 127.0)
    stored = torch.clamp(torch.round(resid / scl[:, None]), -127, 127).to(torch.int8)
    return stored, scl


def _pack_segment(xd, cent, order_seg, sa_seg, slot_seg, blocks, b_norms, b_scales, b_ids,
                  dtype_name: str, metric: str) -> None:
    """Write the rows order_seg of xd into (cluster sa_seg, slot slot_seg) of
    the blocks, in place. Segments are never padded here, so every row is
    written, and every (cluster, slot) target is distinct."""
    o = order_seg.long()
    xo = xd[o]
    norms = D.sq_norms(xo) if metric == "l2" else xo.new_zeros(xo.shape[0])
    if dtype_name == "int8":
        stored, scl = _quantize_residual(xo, cent[sa_seg.long()])
    else:
        stored = xo.to(_STORAGE[dtype_name])
        scl = torch.ones(xo.shape[0], dtype=torch.float32, device=xd.device)
    wa, ws = sa_seg.long(), slot_seg.long()
    blocks[wa, ws] = stored
    b_norms[wa, ws] = norms
    b_scales[wa, ws] = scl
    b_ids[wa, ws] = order_seg.to(torch.int32)


def _shadow_segment(seg, rr, rrn, lo: int, metric: str) -> None:
    """Shadow rows [lo, lo + len(seg)) and their f32 squared norms, in place."""
    rr[lo:lo + seg.shape[0]] = seg.to(rr.dtype)
    if metric == "l2":
        rrn[lo:lo + seg.shape[0]] = D.sq_norms(seg)


def _pack_device(xd: torch.Tensor, cent: torch.Tensor, order: np.ndarray, sa: np.ndarray,
                 slot: np.ndarray, c: int, cap: int, dtype_name: str, metric: str,
                 rerank: int, rerank_dtype: str, rcap: int,
                 segment: int = 2_000_000) -> IVFState:
    """IVFState on xd's device from the (order, cluster, slot) triples: rows
    order[i] go to (sa[i], slot[i]). The scatter runs in corpus segments, so
    transient buffers stay segment-sized."""
    dev = xd.device
    n, dim = xd.shape
    blocks = torch.zeros((c, cap, dim), dtype=_STORAGE[dtype_name], device=dev)
    b_norms = torch.full((c, cap), _INF, dtype=torch.float32, device=dev)
    b_scales = torch.ones((c, cap), dtype=torch.float32, device=dev)
    b_ids = torch.full((c, cap), -1, dtype=torch.int32, device=dev)
    order_t, sa_t, slot_t = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                             for a in (order, sa, slot))
    for lo in range(0, n, segment):
        _pack_segment(xd, cent, order_t[lo:lo + segment], sa_t[lo:lo + segment],
                      slot_t[lo:lo + segment], blocks, b_norms, b_scales, b_ids,
                      dtype_name, metric)
    counts = torch.bincount(sa_t.long(), minlength=c)[:c].to(torch.int32)

    if rerank:
        rr = torch.zeros((rcap, dim), dtype=_STORAGE[rerank_dtype], device=dev)
        rrn = torch.zeros(rcap, dtype=torch.float32, device=dev)
        for lo in range(0, n, segment):
            _shadow_segment(xd[lo:lo + segment], rr, rrn, lo, metric)
    else:
        rr = torch.zeros((0, dim), dtype=torch.bfloat16, device=dev)
        rrn = torch.zeros(0, dtype=torch.float32, device=dev)
    return IVFState(
        centroids=cent, c_norms=D.sq_norms(cent) if metric == "l2" else cent.new_zeros(c),
        blocks=blocks, b_norms=b_norms, b_scales=b_scales, b_ids=b_ids, counts=counts, n=n,
        rerank_vecs=rr, rerank_norms=rrn)


# ---------------------------------------------------------------------------
# balanced block assignment (host; numpy, as in the JAX package)


def _two_means(sub: np.ndarray, rng: np.random.Generator, iters: int = 4):
    """Tiny 2-means for cluster splitting (numpy; sub is one cluster's points)."""
    n = sub.shape[0]
    sel = rng.choice(n, 2, replace=False)
    c0, c1 = sub[sel[0]].copy(), sub[sel[1]].copy()
    for _ in range(iters):
        d0 = ((sub - c0) ** 2).sum(-1)
        d1 = ((sub - c1) ** 2).sum(-1)
        m0 = d0 <= d1
        if m0.all() or (~m0).all():
            m0 = np.arange(n) < n // 2
        c0 = sub[m0].mean(0)
        c1 = sub[~m0].mean(0)
    return c0, c1


def split_oversized(x: np.ndarray, cent: np.ndarray, assign: np.ndarray,
                    cap: int, rng: np.random.Generator):
    """Split clusters that exceed `cap` into two local sub-clusters until all
    fit (host two-means from `rng`). Splitting keeps every point under a
    centroid that represents it, so probe order stays meaningful. Returns
    (centroids, assign) with len(centroids) grown."""
    cent = [c for c in cent]
    assign = assign.astype(np.int64).copy()
    while True:
        counts = np.bincount(assign, minlength=len(cent))
        over = np.where(counts > cap)[0]
        if len(over) == 0:
            break
        for c in over:
            pts = np.where(assign == c)[0]
            c0, c1 = _two_means(x[pts], rng)
            d0 = ((x[pts] - c0) ** 2).sum(-1)
            d1 = ((x[pts] - c1) ** 2).sum(-1)
            m0 = d0 <= d1
            if m0.all() or (~m0).all():
                m0 = np.arange(len(pts)) < len(pts) // 2
            cent[c] = c0
            cent.append(c1)
            assign[pts[~m0]] = len(cent) - 1
    return np.asarray(cent, np.float32), assign


# ---------------------------------------------------------------------------
# search


def _slot_pairs(probes: torch.Tensor, b: int, p: int, c: int, q_cap: int):
    """(query, cluster) probe pairs -> per-cluster slots, rank-ordered.

    Sorted stably by (cluster, probe rank): when a hot cluster overflows its
    q_cap slots, the dropped pairs are its highest-rank probes. Dropped pairs
    land in a trash row c that is cut off (duplicate writes happen only
    there). Returns (qslot, pslot) [C, q_cap] int32, -1 empty."""
    dev = probes.device
    pair_c = probes.reshape(-1).long()
    pair_q = torch.arange(b, device=dev).repeat_interleave(p)
    pair_p = torch.arange(p, device=dev).repeat(b)
    order = torch.argsort(pair_c * p + pair_p, stable=True)
    sc_, sq_, sp_ = pair_c[order], pair_q[order], pair_p[order]
    rank = torch.arange(b * p, device=dev) - torch.searchsorted(sc_, sc_, side="left")
    ok = rank < q_cap
    wc = torch.where(ok, sc_, c)
    wr = torch.where(ok, rank, 0)
    qslot = torch.full((c + 1, q_cap), -1, dtype=torch.int32, device=dev)
    pslot = torch.full((c + 1, q_cap), -1, dtype=torch.int32, device=dev)
    qslot[wc, wr] = sq_.to(torch.int32)
    pslot[wc, wr] = sp_.to(torch.int32)
    return qslot[:c], pslot[:c]


def _q_dot_centroid(cs_pairs: torch.Tensor, c_norms_pairs: torch.Tensor, metric: str):
    """q.centroid recovered from the probe scores: l2's cs = ||c||^2 - 2 q.c,
    dot/cosine's cs = -q.c; a non-finite score gives 0."""
    qdotc = 0.5 * (c_norms_pairs - cs_pairs) if metric == "l2" else -cs_pairs
    return torch.where(torch.isfinite(qdotc), qdotc, 0.0)


def use_pair_scan(c: int, b: int, p: int) -> bool:
    """The pair scan when clusters outnumber the probe pairs (C * 8 > B * P):
    the grouped scan then scores mostly empty slots."""
    return c * 8 > b * p


def group_q_cap(b: int, p: int, c: int, group_slack: float) -> int:
    """Query slots per cluster of the grouped scan: slack * B * P / C, at
    least 8 and at most B * P."""
    return min(max(8, int(group_slack * b * p / max(c, 1))), b * p)


def ivf_search_impl(state: IVFState, q: torch.Tensor, k: int, nprobe: int, metric: str,
                    precision: str = "float32", group_slack: float = 4.0,
                    residual: bool = False, rerank: int = 0,
                    allowed: Optional[torch.Tensor] = None, filter_widen: int = 1,
                    c_mask: Optional[torch.Tensor] = None,
                    id_map: Optional[torch.Tensor] = None):
    """Batched IVF search. Returns (user scores [B, k], ext ids [B, k]).

    Probe scores -> each query's top-p clusters (exact, ties to the lower
    cluster, or approx_min_k under JAX's guard) -> the pair or grouped scan
    -> a [B, P * kk] pool -> the allowlist (on the whole pool) -> the exact
    rerank against the shadow store, or the pool's top-k. A sharded wrapper
    passes `c_mask` ([C] bool: its padded cluster slots are never probed)
    and `id_map` ([rcap] int32: b_ids, the shadow rows and `allowed` are
    then indexed by local id, mapped to global ids after the rerank), as in
    the JAX package. Spans (utils.profiling): "ivf.probes", "ivf.scan" (the
    pair or grouped scan whole), "ivf.final"."""
    prec = _prec(precision)
    qp = D.preprocess_queries(q, metric)
    b = qp.shape[0]
    c, bcap, _ = state.blocks.shape
    p = nprobe
    with span("ivf.probes"):
        cs = D.pairwise_scores(qp, state.centroids, state.c_norms, metric, precision=prec)
        if c_mask is not None:
            cs = torch.where(c_mask[None, :], cs, _INF)
        if c >= 4096 and p * 4 <= c:   # JAX's guard for its hardware top-k
            _, probes = AK.approx_min_k(cs, p)                              # [B, P]
        else:
            _, probes = T.smallest_k_dense(cs, p)
    # filtered search widens each probe's pool so enough rows survive the allowlist
    kk = min((k * rerank if rerank else k) * max(filter_widen, 1), bcap)
    with span("ivf.scan"):
        if use_pair_scan(c, b, p):
            merged_s, merged_i = _pair_scan(state, qp, cs, probes, kk, metric, residual, prec)
        else:
            merged_s, merged_i = _grouped_scan(state, qp, cs, probes, kk, metric, residual,
                                               group_slack, prec)
    with span("ivf.final"):
        if allowed is not None:
            ok = allowed[merged_i.clamp(min=0).long()] & (merged_i >= 0)
            merged_s = torch.where(ok, merged_s, _INF)
            merged_i = torch.where(ok, merged_i, -1)
        if rerank:
            cand_s, cand_i = T.smallest_k(merged_s, merged_i,
                                          min(k * rerank, merged_s.shape[-1]))
            cand_s, cand_i = T.mask_duplicate_ids(cand_s, cand_i)
            safe = cand_i.clamp(min=0).long()
            ex = D.gathered_scores(qp, state.rerank_vecs[safe], state.rerank_norms[safe],
                                   metric, precision=prec)
            ex = torch.where(cand_i >= 0, ex, _INF)
            best_s, best_i = T.smallest_k(ex, cand_i, k)
        else:
            best_s, best_i = T.smallest_k(merged_s, merged_i, k)
        user = D.finalize_scores(best_s, qp, metric)
        user = torch.where(best_i >= 0, user, _INF if metric == "l2" else -_INF)
        if id_map is not None:
            best_i = torch.where(best_i >= 0, id_map[best_i.clamp(min=0).long()], -1)
    return user, best_i


def _pair_scan(state: IVFState, qp, cs, probes, kk: int, metric: str, residual: bool,
               precision: Optional[str] = None):
    """One block gather per (query, probe) pair: [B, P] probes -> (scores,
    ids) [B, P * kk]. The gather holds B * P * cap rows in f32."""
    b = qp.shape[0]
    p = probes.shape[1]
    pc = probes.reshape(-1).long()                                          # [BP]
    blk = state.blocks[pc]                                                  # [BP, cap, D]
    qv = qp.repeat_interleave(p, dim=0)                                     # [BP, D]
    dots = _products(blk, qv[:, :, None], precision)[..., 0]                # [BP, cap]
    dots = dots * state.b_scales[pc]
    if residual:
        dots = dots + _q_dot_centroid(cs.gather(1, probes).reshape(-1), state.c_norms[pc],
                                      metric)[:, None]
    s = state.b_norms[pc] - 2.0 * dots if metric == "l2" else -dots
    bi = state.b_ids[pc]
    s = torch.where(bi >= 0, s, _INF)
    if s.shape[1] >= 4 * kk:
        ts, tpos = AK.approx_min_k(s, kk)
    else:
        ts, tpos = T.smallest_k_dense(s, kk)
    ti = torch.gather(bi, -1, tpos)
    ti = torch.where(torch.isfinite(ts), ti, -1)
    return ts.reshape(b, p * kk), ti.reshape(b, p * kk)


def _grouped_scan(state: IVFState, qp, cs, probes, kk: int, metric: str, residual: bool,
                  group_slack: float, precision: Optional[str] = None):
    """Probe pairs slotted per cluster, every block scored once against its
    slotted queries in one batched product -> (scores, ids) [B, P * kk].
    Pairs past a cluster's q_cap slots are dropped, its highest-rank probes
    first."""
    b = qp.shape[0]
    c, bcap, _ = state.blocks.shape
    p = probes.shape[1]
    qslot, pslot = _slot_pairs(probes, b, p, c, group_q_cap(b, p, c, group_slack))
    live = qslot >= 0
    qsafe = qslot.clamp(min=0).long()
    qv = qp[qsafe]                                                          # [C, Qcap, D]
    dots = _products(qv, state.blocks.transpose(1, 2), precision)           # [C, Qcap, cap]
    dots = dots * state.b_scales[:, None, :]
    if residual:
        qd = torch.gather(cs.T, 1, qsafe)                                   # [C, Qcap]
        dots = dots + _q_dot_centroid(qd, state.c_norms[:, None], metric)[:, :, None]
    s = state.b_norms[:, None, :] - 2.0 * dots if metric == "l2" else -dots
    s = torch.where(state.b_ids[:, None, :] >= 0, s, _INF)
    s = torch.where(live[:, :, None], s, _INF)
    ts, tpos = T.smallest_k_dense(s, kk)                                    # [C, Qcap, kk]
    ti = torch.gather(state.b_ids[:, None, :].expand(s.shape), -1, tpos)
    ti = torch.where(torch.isfinite(ts), ti, -1)

    # back to per-query probe slots: every live (query, probe) target is
    # distinct; empty slots all land in trash row b, cut off below
    out_s = torch.full((b + 1, p, kk), _INF, dtype=torch.float32, device=qp.device)
    out_i = torch.full((b + 1, p, kk), -1, dtype=torch.int32, device=qp.device)
    wq = torch.where(live, qslot, b).long()
    wp = pslot.clamp(min=0).long()
    out_s[wq, wp] = ts
    out_i[wq, wp] = ti
    return out_s[:b].reshape(b, p * kk), out_i[:b].reshape(b, p * kk)


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


# ---------------------------------------------------------------------------
# incremental append (device)


def _ivf_append(state: IVFState, x: torch.Tensor, assign: torch.Tensor, valid: torch.Tensor,
                ext0: int, metric: str, dtype_name: str, rerank: bool) -> IVFState:
    """Append a batch into spare per-cluster block capacity, in place: O(batch),
    not O(N). x [B, D] f32 is preprocessed (cosine rows normalized); valid is
    a prefix (padding only at the end); x[i] gets external id ext0 + i. The
    batch is cluster-sorted (stably); a row's slot is its cluster's count
    plus its rank within the cluster. Padding rows are not written to the
    blocks; the caller guarantees no cluster overflows and that the padded
    batch fits the shadow store."""
    b = x.shape[0]
    c, bcap, _ = state.blocks.shape
    dev = x.device
    key = torch.where(valid, assign.long(), c)
    order = torch.argsort(key, stable=True)
    sa = key[order]
    rank = torch.arange(b, device=dev) - torch.searchsorted(sa, sa, side="left")
    counts_ext = torch.cat([state.counts.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    slot = counts_ext[sa] + rank
    xo = x[order]
    vo = valid[order]
    ext = ext0 + order
    wc = sa.clamp(max=c - 1)
    if dtype_name == "int8":
        stored, scl = _quantize_residual(xo, state.centroids[wc])
    else:
        stored = xo.to(state.blocks.dtype)
        scl = torch.ones(b, dtype=torch.float32, device=dev)
    norms = D.sq_norms(xo) if metric == "l2" else xo.new_zeros(b)
    w = vo & (slot < bcap)                 # JAX drops the rest as out-of-range writes
    wcw, wsw = wc[w], slot[w]
    state.blocks[wcw, wsw] = stored[w]
    state.b_norms[wcw, wsw] = norms[w]
    state.b_scales[wcw, wsw] = scl[w]
    state.b_ids[wcw, wsw] = ext[w].to(torch.int32)
    state.counts += torch.bincount(wc[vo], minlength=c)[:c].to(torch.int32)
    state.n += int(vo.sum())
    if rerank:
        # shadow rows live at their external id; the whole padded batch is
        # written (the next append overwrites the padding rows)
        if ext0 + b > state.rerank_vecs.shape[0]:
            raise ValueError(f"append of {b} rows at {ext0} overruns the shadow store "
                             f"({state.rerank_vecs.shape[0]} rows)")
        state.rerank_vecs[ext0:ext0 + b] = x.to(state.rerank_vecs.dtype)
        if metric == "l2":
            state.rerank_norms[ext0:ext0 + b] = D.sq_norms(x)
    return state


def state_from_numpy(cfg: IVFConfig, arrays, device) -> IVFState:
    """The JAX package's IVFState arrays, as numpy (a save file's or a
    live state's), -> the port's state on `device`. bf16 arrays arrive as
    ml_dtypes.bfloat16 (a live JAX state) or as f32 (a save file); blocks
    take cfg.dtype and the shadow store cfg.rerank_dtype, as JAX's load
    casts them."""
    t = {f: tensor_from_numpy(arrays[f], device) for f in _STATE_FIELDS
         if f not in ("blocks", "rerank_vecs", "n")}
    for f in ("centroids", "c_norms", "b_norms", "b_scales", "rerank_norms"):
        t[f] = t[f].float()
    blocks = tensor_from_numpy(arrays["blocks"], device, bf16=cfg.dtype == "bfloat16")
    rr = tensor_from_numpy(arrays["rerank_vecs"], device,
                           bf16=np.asarray(arrays["rerank_vecs"]).dtype.itemsize == 2)
    return IVFState(blocks=blocks.to(cfg.storage_dtype),
                    rerank_vecs=rr.to(_STORAGE[cfg.rerank_dtype]),
                    n=int(np.asarray(arrays["n"])), **t)


# ---------------------------------------------------------------------------
# public class


class IVFIndex:
    """IVF-Flat index: build/add/search/remove/compact/get/save/load, filtered
    search via `allowed`, exact search_range."""

    def __init__(self, cfg: IVFConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Optional[IVFState] = None
        # k-means draws advance this generator build after build, as the JAX
        # package splits its key
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._dead: set[int] = set()   # tombstoned external ids

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else self.state.n
            return n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    def _check_dim(self, x) -> None:
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    # -- build ------------------------------------------------------------

    def build(self, x, checkpoint_path: Optional[str] = None) -> None:
        """Bulk build: k-means, assignment and the block pack on the device;
        the host keeps only the int32 cluster/slot bookkeeping. x is numpy or
        a tensor (moved to the index's device; no host copy). Oversized
        clusters split on the host (numpy two-means from default_rng(seed +
        1)) for a numpy corpus under 500k rows, else on the device.

        checkpoint_path: after the randomized phases (k-means, assignment,
        split), snapshot the build plan (centroids, the order/cluster/slot
        triples, the corpus) in the JAX package's format; resume_build(path)
        then reruns only the deterministic pack, so a resumed index equals
        the direct build. Its stages are spans "ivf.build.<stage>"
        (utils.profiling.Stages); with ZVDB_BUILD_TRACE=1 it prints each
        stage's seconds."""
        from .knn_graph import _kmeans_device

        mark = Stages(self.device, "ivf.build.")
        on_device = isinstance(x, torch.Tensor)
        if not on_device:
            x = np.asarray(x, np.float32)
        n = x.shape[0]
        with self._lock:
            self._pending = []
            self._n_inserted = n
            self._dead = set()
            self.state = None
            if n == 0:   # empty corpus -> empty index
                return
            self._check_dim(x)
            mark("kmeans")
            cfg = self.cfg
            if on_device:
                x = x.to(device=self.device, dtype=torch.float32)
                if cfg.metric == "cosine":
                    x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
                xd = x
            else:
                if cfg.metric == "cosine":
                    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
            c = cfg.n_clusters or max(8, 1 << int(round(math.log2(4 * math.sqrt(max(n, 1))))))
            c = min(c, max(8, n))
            xn = D.sq_norms(xd) if cfg.metric == "l2" else xd.new_zeros(n)
            cent = _kmeans_device(xd, c, cfg.kmeans_iters, self._gen,
                                  sample=min(n, cfg.kmeans_sample))
            mark("assign")
            # l2 geometry drives the assignment for every metric (cosine rows
            # are normalized; dot uses the same Voronoi cells)
            assign = _assign(xd, xn, cent, D.sq_norms(cent))
            with wait("ivf_assign_pull"):
                assign = assign.cpu().numpy().astype(np.int64)
            mark("split")

            cap_split = int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
            cap_split = max(cap_split, 8)
            rng = np.random.default_rng(cfg.seed + 1)
            if n >= 500_000 or on_device:
                cent_np, assign = split_oversized_device(xd, cent.cpu().numpy(), assign,
                                                         cap_split)
            else:
                cent_np, assign = split_oversized(x, cent.cpu().numpy(), assign, cap_split, rng)
            mark("order")
            cap = self._occupancy_cap(assign, len(cent_np))
            if n >= 500_000:
                order = torch.argsort(torch.as_tensor(assign, dtype=torch.int32,
                                                      device=self.device),
                                      stable=True).cpu().numpy().astype(np.int32)
            else:
                order = np.argsort(assign, kind="stable").astype(np.int32)
            sa = assign[order].astype(np.int32)
            first = np.searchsorted(sa, np.arange(len(cent_np)), side="left")
            slot = (np.arange(n) - first[sa]).astype(np.int32)
            mark("pack")
            rcap = max(1024, -(-n // 1024) * 1024 + 1024) if cfg.rerank else 0
            if checkpoint_path:
                np.savez_compressed(
                    checkpoint_path,
                    meta=json.dumps(dict(kind="ivf_plan", cfg=dataclasses.asdict(cfg),
                                         cap=cap, rcap=rcap)),
                    corpus=xd.cpu().numpy() if on_device else np.asarray(x),
                    cent=cent_np.astype(np.float32), order=order, sa=sa, slot=slot)
            self.state = self._pack_from_plan(xd, cent_np, order, sa, slot, cap, rcap)
            mark.end()
            if mark.timed:
                print(mark.report(f"ivf build n={n}"), flush=True)

    def _pack_from_plan(self, xd, cent_np, order, sa, slot, cap: int, rcap: int) -> IVFState:
        cfg = self.cfg
        return _pack_device(
            xd, torch.as_tensor(np.asarray(cent_np, np.float32), device=self.device),
            order, sa, slot, c=len(cent_np), cap=cap, dtype_name=cfg.dtype,
            metric=cfg.metric, rerank=cfg.rerank, rerank_dtype=cfg.rerank_dtype, rcap=rcap)

    @classmethod
    def resume_build(cls, checkpoint_path: str, device=None) -> "IVFIndex":
        """Finish a crashed bulk build from its plan checkpoint (written by
        either package). The pack is deterministic given the plan, so the
        result equals the direct build."""
        with np.load(checkpoint_path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("kind") != "ivf_plan":
                raise ValueError(f"not an IVF build checkpoint: {checkpoint_path}")
            idx = cls(IVFConfig(**meta["cfg"]), device=device)
            x = z["corpus"]
            idx._n_inserted = x.shape[0]
            idx.state = idx._pack_from_plan(
                torch.from_numpy(np.asarray(x, np.float32)).to(idx.device), z["cent"],
                z["order"], z["sa"], z["slot"], meta["cap"], meta["rcap"])
        return idx

    def _occupancy_cap(self, assign: np.ndarray, c: int) -> int:
        """Block capacity from the measured occupancy: headroom * the largest
        cluster, rounded up to 8 (the spare room is where add() appends)."""
        max_count = int(np.bincount(assign, minlength=c).max()) if len(assign) else 1
        cap = int(math.ceil(self.cfg.block_headroom * max(max_count, 1) / 8.0)) * 8
        return max(cap, 8)

    def _nearest_assign(self, x: np.ndarray, cent) -> np.ndarray:
        """Nearest centroid of every row by cfg.metric's scores (tiled, on the
        device; ties to the lower cluster)."""
        cent = torch.as_tensor(cent, dtype=torch.float32, device=self.device)
        cn = D.sq_norms(cent)
        out = []
        for lo in range(0, x.shape[0], 16384):
            xt = torch.from_numpy(np.ascontiguousarray(x[lo:lo + 16384])).to(self.device)
            cs = D.pairwise_scores(xt, cent, cn, self.cfg.metric)
            out.append(torch.argmin(cs, dim=-1).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    def _pack(self, x: np.ndarray, cent: np.ndarray, assign: np.ndarray, cap: int) -> IVFState:
        """The host repack (numpy, as in the JAX package), uploaded."""
        cfg = self.cfg
        dev = self.device
        n = x.shape[0]
        c = cent.shape[0]
        blocks = np.zeros((c, cap, cfg.dim), np.float32)
        b_ids = np.full((c, cap), -1, np.int32)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        first_pos = np.searchsorted(sa, np.arange(c), side="left")
        slot = np.arange(n) - first_pos[sa]
        blocks[sa, slot] = x[order]
        b_ids[sa, slot] = order.astype(np.int32)
        counts = np.bincount(assign, minlength=c).astype(np.int32)
        b_norms = (blocks ** 2).sum(-1).astype(np.float32) if cfg.metric == "l2" \
            else np.zeros((c, cap), np.float32)
        b_norms[b_ids < 0] = np.inf
        if cfg.dtype == "int8":
            # residual codes; this path divides in numpy, as the JAX package's does
            resid = blocks - cent[:, None, :]
            resid[b_ids < 0] = 0.0
            amax = np.abs(resid).max(axis=-1)
            b_scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
            stored = np.clip(np.round(resid / b_scales[..., None]), -127, 127).astype(np.int8)
        else:
            b_scales = np.ones((c, cap), np.float32)
            stored = blocks
        centt = torch.from_numpy(np.asarray(cent, np.float32)).to(dev)
        if cfg.rerank:
            # shadow rows by external id, padded so add() appends in place
            rcap = max(1024, -(-n // 1024) * 1024 + 1024)
            rr_np = np.zeros((rcap, cfg.dim), np.float32)
            rr_np[:n] = x
            rr = torch.from_numpy(rr_np).to(dev).to(_STORAGE[cfg.rerank_dtype])
            rrn_np = np.zeros((rcap,), np.float32)
            if cfg.metric == "l2":
                rrn_np[:n] = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
            rrn = torch.from_numpy(rrn_np).to(dev)
        else:
            rr = torch.zeros((0, cfg.dim), dtype=torch.bfloat16, device=dev)
            rrn = torch.zeros(0, dtype=torch.float32, device=dev)
        return IVFState(
            centroids=centt,
            c_norms=D.sq_norms(centt) if cfg.metric == "l2" else centt.new_zeros(c),
            blocks=torch.from_numpy(stored).to(dev).to(cfg.storage_dtype),
            b_norms=torch.from_numpy(b_norms).to(dev), b_scales=torch.from_numpy(b_scales).to(dev),
            b_ids=torch.from_numpy(b_ids).to(dev), counts=torch.from_numpy(counts).to(dev),
            n=n, rerank_vecs=rr, rerank_norms=rrn)

    # -- incremental add --------------------------------------------------

    def add(self, x) -> None:
        """Buffered incremental insert (centroids frozen once trained); the
        flush appends in O(new) or, on overflow, repacks."""
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        self._check_dim(x)
        with self._lock:
            self._pending.append(x)
            self._n_inserted += x.shape[0]

    insert = add

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        cfg = self.cfg
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        base = self._n_inserted - new.shape[0]   # first new external id
        st = self.state
        c, bcap, _ = st.blocks.shape
        assign = self._nearest_assign(new, st.centroids)
        counts = st.counts.cpu().numpy()
        addc = np.bincount(assign, minlength=c)
        # the batch is padded to a power of two (at least 1024), as in JAX
        bsz = new.shape[0]
        chunk = 1 << max(10, int(math.ceil(math.log2(max(bsz, 1)))))
        overflow = int((counts + addc).max()) > bcap
        if cfg.rerank and base + chunk > st.rerank_vecs.shape[0]:
            # the padded extent must fit the shadow store: the repack regrows it
            overflow = True
        if overflow:
            self._repack_with_new(new, base)
            return
        dev = self.device
        xb = torch.zeros((chunk, cfg.dim), dtype=torch.float32, device=dev)
        xb[:bsz] = torch.from_numpy(new).to(dev)
        ab = torch.zeros(chunk, dtype=torch.int64, device=dev)
        ab[:bsz] = torch.from_numpy(assign.astype(np.int64)).to(dev)
        vb = torch.zeros(chunk, dtype=torch.bool, device=dev)
        vb[:bsz] = True
        self.state = _ivf_append(st, xb, ab, vb, base, cfg.metric, cfg.dtype,
                                 rerank=bool(cfg.rerank))

    def _reconstruct_all(self) -> np.ndarray:
        """Stored vectors of every row, by external id [n, D]: the shadow
        store, the float blocks, or (int8 without a shadow store) the
        dequantized residual codes plus their centroid."""
        st, cfg = self.state, self.cfg
        n = st.n
        if cfg.rerank:
            return st.rerank_vecs[:n].float().cpu().numpy()
        ids = st.b_ids.cpu().numpy()
        ids = np.where(ids <= -2, -2 - ids, ids)   # decode tombstones
        mask = ids >= 0
        blocks = st.blocks.float().cpu().numpy()
        if cfg.dtype == "int8":
            blocks = blocks * st.b_scales.cpu().numpy()[..., None] \
                + st.centroids.cpu().numpy()[:, None, :]
        out = np.empty((n, blocks.shape[-1]), np.float32)
        out[ids[mask]] = blocks[mask]
        return out

    def _repack_with_new(self, new: np.ndarray, base: int) -> None:
        """Overflow path: repack the stored vectors (in external-id order, so
        every returned id stays valid) and the new rows against the existing
        centroids, splitting clusters that no longer fit; tombstones are
        re-marked after."""
        x_all = np.concatenate([self._reconstruct_all(), new], axis=0)
        self._rebuild_with_centroids(x_all, self.state.centroids.cpu().numpy())
        self._apply_tombstones()

    def _tombstone(self, cc: np.ndarray, ss: np.ndarray, ids: np.ndarray) -> None:
        """Mark slots (cc, ss) holding ext ids `ids` deleted (b_ids = -2 - id,
        which every scan masks), in place."""
        self.state.b_ids[torch.from_numpy(cc).to(self.device),
                         torch.from_numpy(ss).to(self.device)] = torch.from_numpy(
            (-2 - ids).astype(np.int32)).to(self.device)

    def _apply_tombstones(self) -> None:
        if not self._dead or self.state is None:
            return
        ids_np = self.state.b_ids.cpu().numpy()
        dec = np.where(ids_np <= -2, -2 - ids_np, ids_np)
        hit = np.isin(dec, np.asarray(sorted(self._dead), np.int64)) & (dec >= 0) & (ids_np >= 0)
        if hit.any():
            cc, ss = np.nonzero(hit)
            self._tombstone(cc, ss, dec[cc, ss])

    # -- delete -------------------------------------------------------------

    def remove(self, ids) -> int:
        """Tombstone by external id (ids never renumber; the slot stays
        occupied until compact()). Returns the number newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else self.state.n
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            new = [int(i) for i in ids if int(i) not in self._dead]
            if not new:
                return 0
            self._dead.update(new)
            ids_np = self.state.b_ids.cpu().numpy()
            cc, ss = np.nonzero(np.isin(ids_np, np.asarray(new, np.int64)))
            self._tombstone(cc, ss, ids_np[cc, ss])
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without tombstoned rows; survivors renumber to [0, L) in
        former order. Returns the survivors' old external ids."""
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else self.state.n
            alive = np.ones(n, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or not self._dead:
                return live
            vecs = self._reconstruct_all()[live]
        self.build(vecs)
        return live

    def _rebuild_with_centroids(self, x: np.ndarray, cent: np.ndarray) -> None:
        cfg = self.cfg
        n = x.shape[0]
        c = cent.shape[0]
        cap = int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
        cap = max(cap, 8)
        assign = self._nearest_assign(x, cent)
        rng = np.random.default_rng(cfg.seed + 2)
        cent2, assign = split_oversized(x, cent, assign, cap, rng)
        self.state = self._pack(x, cent2, assign, self._occupancy_cap(assign, len(cent2)))

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids [K, D] f32 numpy (dequantized for
        int8 blocks without a shadow store; normalized for cosine)."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if self.state is None or ids.size == 0:
                return np.zeros((ids.size, self.cfg.dim), np.float32)
            n = self.state.n
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            return self._reconstruct_all()[ids]

    # -- search -----------------------------------------------------------

    def _empty(self, b: int, k: int):
        return (torch.full((b, k), _INF if self.cfg.metric == "l2" else -_INF,
                           dtype=torch.float32, device=self.device),
                torch.full((b, k), -1, dtype=torch.int32, device=self.device))

    def _queries(self, q):
        """(queries [B, D] f32 on the index's device, whether q was one row)."""
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        squeeze = q.ndim == 1
        q = q[None, :] if squeeze else q
        self._check_dim(q)
        return q, squeeze

    def _has_shadows(self) -> bool:
        rr = self.state.rerank_vecs
        return rr.shape[-1] == self.cfg.dim and rr.shape[0] > 1

    def _shadow_ids(self) -> torch.Tensor:
        """int32 [shadow rows]: the row's id if it is ingested and not
        deleted, else -1 (the store is zero-padded past n)."""
        st = self.state
        bi = torch.arange(st.rerank_vecs.shape[0], dtype=torch.int32, device=self.device)
        bi = torch.where(bi < st.n, bi, -1)
        if self._dead:
            bi[torch.from_numpy(np.fromiter(self._dead, np.int64, len(self._dead)))
               .to(self.device)] = -1
        return bi

    def search(self, q, k: int, nprobe: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """Top-k: (scores [B, k], ids [B, k] int32) as tensors on the index's
        device. `allowed` (a bool mask over ids or an id list) filters:
        "scan" is the exact masked scan over the float blocks (int8 blocks:
        over the shadow store; without one, "probe"); "probe" filters the
        probe pool, widened 8x (raise nprobe for selective filters); "auto"
        picks scan unless the corpus is past the crossover and the filter
        passes nearly everything (utils/filter_policy.py)."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock, entry("ivf.search"):
            self._flush_locked()
            if filter_mode == "auto":
                filter_mode = resolve_filter_mode("auto", allowed, self._n_inserted, alt="probe")
            q, squeeze = self._queries(q)
            cfg, st = self.cfg, self.state
            scan_prec = "high" if cfg.precision == "default" else cfg.precision
            if st is None:
                s, i = self._empty(q.shape[0], k)
            elif allowed is not None and filter_mode == "scan" and (
                    cfg.dtype != "int8" or self._has_shadows()):
                av = allowed_mask(allowed, self._n_inserted, max(self._n_inserted, 1),
                                  self.device)
                if cfg.dtype != "int8":
                    bi = st.b_ids.reshape(-1)
                    ok = (bi >= 0) & av[bi.clamp(min=0).long()]
                    s, pos = masked_exact_search(
                        st.blocks.reshape(-1, cfg.dim),
                        torch.where(ok, st.b_norms.reshape(-1), _INF),
                        st.b_scales.reshape(-1), q, k, cfg.metric, precision=scan_prec)
                    i = torch.where(pos >= 0, bi[pos.clamp(min=0).long()], -1)
                else:
                    # residual codes cannot be scanned exactly: the shadow store
                    nr = st.rerank_vecs.shape[0]
                    ok = torch.zeros(nr, dtype=torch.bool, device=self.device)
                    m = min(nr, av.shape[0])
                    ok[:m] = av[:m]
                    ok &= self._shadow_ids() >= 0
                    s, i = masked_exact_search(
                        st.rerank_vecs, torch.where(ok, st.rerank_norms, _INF),
                        torch.ones(nr, dtype=torch.float32, device=self.device), q, k,
                        cfg.metric, precision=scan_prec)
            else:
                allow_t = None
                if allowed is not None:
                    allow_t = allowed_mask(allowed, st.n, max(st.n, 1), self.device)
                s, i = ivf_search_impl(
                    st, q, k, min(nprobe or cfg.nprobe, st.centroids.shape[0]), cfg.metric,
                    cfg.precision, residual=cfg.dtype == "int8", rerank=cfg.rerank,
                    allowed=allow_t, filter_widen=8 if allow_t is not None else 1)
            if squeeze:
                return s[0], i[0]
            return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius`, exact (FlatIndex.search_range's
        contract: squared L2 <= radius for l2, similarity >= radius
        otherwise). A radius cannot be probe-bounded, so this scans the
        float blocks flat (int8 blocks: the shadow store, which it
        requires). Returns (scores [B, R], ids [B, R], counts [B])."""
        with self._lock:
            self._flush_locked()
            q, squeeze = self._queries(q)
            cfg, st = self.cfg, self.state
            if st is None:
                s, i = self._empty(q.shape[0], max_results)
                c = torch.zeros(q.shape[0], dtype=torch.int32, device=self.device)
            elif cfg.dtype != "int8":
                # float blocks are the (permuted, padded) corpus
                cb, bn = st.blocks.reshape(-1, cfg.dim), st.b_norms.reshape(-1)
                bi, bs = st.b_ids.reshape(-1), st.b_scales.reshape(-1)
            elif self._has_shadows():
                cb, bn, bi = st.rerank_vecs, st.rerank_norms, self._shadow_ids()
                bs = torch.ones(cb.shape[0], dtype=torch.float32, device=self.device)
            else:
                raise ValueError(
                    "search_range on an int8 IVF index requires the rerank shadow store "
                    "(IVFConfig(rerank=...)): the blocks hold residual codes, not corpus rows")
            if st is not None:
                s, i, c = _ivf_range(cb, bn, bi, bs, q, float(radius), cfg.metric, max_results,
                                     cfg.precision)
            if squeeze:
                return s[0], i[0], c[0]
            return s, i, c

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format (bf16 arrays as f32);
        tombstones ride in b_ids."""
        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg), n_inserted=self._n_inserted)
            arrays = {}
            if self.state is not None:
                for f in _STATE_FIELDS:
                    v = getattr(self.state, f)
                    if f == "n":
                        arrays[f] = np.asarray(v, np.int32)
                    else:
                        arrays[f] = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, cfg, arrays=None, n_inserted: Optional[int] = None,
                   device=None) -> "IVFIndex":
        """An index over the JAX package's state. `cfg` is an IVFConfig or
        dataclasses.asdict of the JAX package's one; `arrays` maps its
        IVFState's fields to numpy arrays (a save file's contents), None for
        an empty index. Tombstones are read from b_ids (-2-id); n_inserted
        defaults to n."""
        if isinstance(cfg, dict):
            cfg = IVFConfig(**cfg)
        idx = cls(cfg, device=device)
        if arrays is None:
            idx._n_inserted = int(n_inserted or 0)
            return idx
        idx.state = state_from_numpy(cfg, arrays, idx.device)
        enc = np.asarray(arrays["b_ids"])
        idx._dead = set(int(-2 - v) for v in enc[enc <= -2])
        idx._n_inserted = idx.state.n if n_inserted is None else int(n_inserted)
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "IVFIndex":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in _STATE_FIELDS} if "centroids" in z else None
        return cls.from_numpy(meta["cfg"], arrays, n_inserted=meta["n_inserted"],
                              device=device)
