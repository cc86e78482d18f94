"""The graph builds' shared pieces and the HNSW one-shot build (port of
zvdb_tpu/index/build.py): `select_neighbors`, `_reverse_pass`,
`_reverse_pass_bulk`, `sample_levels`, `reorder_rows_diverse`,
`_subset_knn_layer`, `_attach_anchors` and `bulk_build_oneshot`. The batched
HNSW build (`build_batch_impl`, `_run_batches`, `bulk_build`,
`extend_graph`) and the build checkpoints are not ported yet (ROADMAP queue 1
item 1b).

Products take their precision by name (`precision`): the JAX package runs
them under an ambient `jax.default_matmul_precision`, which PyTorch does not
have. "Drop" scatters of the JAX version are masked writes here, and tables
are updated in place where JAX returns copies. The one-shot build draws its
levels, graphs and anchors from one torch.Generator, so one seed builds a
different graph in each package; its deterministic stages equal JAX's on
equal inputs.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops import distance as D
from ..ops import topk as T

_INF = float("inf")
_BIG = 1e30


def select_neighbors(
    state,                       # .vectors [cap, D], .norms [cap], .q_scale
    base_vec: torch.Tensor,      # [R, D] f32
    base_norm: torch.Tensor,     # [R] f32 (squared norms; zeros for dot/cosine)
    cand: torch.Tensor,          # [R, C] int32 candidate rows, -1 invalid, deduped
    cand_scores: torch.Tensor,   # [R, C] surrogate scores base->cand (+inf invalid)
    m_out: int,
    alpha: float,
    metric: str,
    max_candidates: int = 0,
    precision: Optional[str] = None,
):
    """Pick up to m_out diverse neighbors per row -> (ids [R, m_out] (-1 pad),
    true distances [R, m_out] (+inf pad)).

    Relative-neighborhood rule, in parallel: candidate c is pruned if some
    candidate e strictly closer to the base has alpha*d(c, e) < d(base, c).
    Pruned candidates backfill the remaining slots in distance order. The
    candidates' pairwise distances are one batched product at `precision`.
    max_candidates > 0 first narrows the pool to the nearest max_candidates.
    Ties in the final pick go to the lower position, as lax.top_k takes them.
    """
    if max_candidates and max_candidates < cand.shape[-1]:
        cand_scores, cand = T.smallest_k(cand_scores, cand, max_candidates)
    if cand.shape[-1] < m_out:   # tiny pools
        pad = m_out - cand.shape[-1]
        cand = torch.cat([cand, cand.new_full((cand.shape[0], pad), -1)], dim=-1)
        cand_scores = torch.cat(
            [cand_scores, cand_scores.new_full((cand.shape[0], pad), _INF)], dim=-1)
    safe = cand.clamp(min=0).long()
    c_vecs = state.vectors[safe].float() * state.q_scale     # [R, C, D] dequantized
    c_norms = state.norms[safe]                               # [R, C]
    valid = cand >= 0
    d_b = cand_scores + base_norm[:, None] if metric == "l2" else cand_scores
    d_b = torch.where(valid, d_b, _INF)
    dots = D._sum_products(D._operand_pairs(c_vecs, c_vecs, precision),
                           lambda a, b: torch.bmm(a, b.transpose(1, 2)))
    if metric == "l2":
        d_cc = c_norms[:, :, None] + c_norms[:, None, :] - 2.0 * dots
    else:
        d_cc = -dots
    earlier = d_b[:, None, :] < d_b[:, :, None]               # [R, c, e]: e closer than c
    close = (alpha * d_cc) < d_b[:, :, None]                  # e too close to c
    pruned = (earlier & close & valid[:, None, :]).any(-1)
    keep = valid & ~pruned
    priority = torch.where(keep, d_b, d_b + _BIG)
    priority = torch.where(valid, priority, _INF)
    _, pos = T.smallest_k_dense(priority, m_out)
    sel = torch.gather(cand, -1, pos)
    sel_d = torch.gather(d_b, -1, pos)
    sel = torch.where(torch.isfinite(sel_d), sel, -1)
    sel_d = torch.where(sel >= 0, sel_d, _INF)
    return sel, sel_d


def _shifted(a: torch.Tensor, j: int, fill) -> torch.Tensor:
    """a[j:] followed by j copies of `fill`."""
    if not j:
        return a
    return torch.cat([a[j:], a.new_full((j,), fill)])


def _reverse_pass(
    nbr_table: torch.Tensor,    # [cap+1, degree] adjacency (row cap = trash)
    dist_table: torch.Tensor,   # [cap+1, degree] true edge distances
    src_rows: torch.Tensor,     # [B] batch rows
    fwd: torch.Tensor,          # [B, m] forward-selected neighbors (-1 pad)
    fwd_d: torch.Tensor,        # [B, m] true distances of those edges
    degree: int,
):
    """Add reverse edges src->tgt for every forward edge, keeping each touched
    target row's `degree` nearest edges (gather-free: an edge's distance is
    stored beside it). Edges are sorted by target only (stable, batch order
    within a target) and at most min(degree, 16) sources per target join the
    merge. Updates the tables IN PLACE (JAX returns copies) and returns them.

    JAX lets every non-first edge of a target write its merged row to the
    trash row; here only each target's first edge writes (a masked write),
    so the trash row keeps its -1 / +inf padding."""
    b, m = fwd.shape
    p = b * m
    rev_window = max(1, min(degree, 16, p))
    tgt = fwd.reshape(p)
    src = src_rows.to(torch.int32).repeat_interleave(m)
    d = fwd_d.reshape(p)
    valid = tgt >= 0
    key = torch.where(valid, tgt, 2**30)
    order = torch.argsort(key, stable=True)
    st, ss, sd, sv = tgt[order], src[order], d[order], valid[order]
    prev = torch.cat([st.new_full((1,), -2), st[:-1]])
    first = sv & (st != prev)

    # windows of up to rev_window sources per target, as shifted copies
    st_w = torch.stack([_shifted(st, j, -9) for j in range(rev_window)], dim=1)      # [P, W]
    ss_w = torch.stack([_shifted(ss, j, -1) for j in range(rev_window)], dim=1)
    sd_w = torch.stack([_shifted(sd, j, _INF) for j in range(rev_window)], dim=1)
    same = (st_w == st[:, None]) & sv[:, None]
    rev = torch.where(same, ss_w, -1)
    rev_d = torch.where(same, sd_w, _INF)

    st_safe = st.clamp(min=0).long()
    cand = torch.cat([nbr_table[st_safe], rev], dim=-1)            # [P, degree + W]
    cand_d = torch.cat([dist_table[st_safe], rev_d], dim=-1)
    cand_d = torch.where(cand >= 0, cand_d, _INF)
    new_d, new_rows = T.sort_smallest_k(cand_d, cand, degree, dedupe=True)
    rows = st[first].long()
    nbr_table[rows] = new_rows[first]
    dist_table[rows] = new_d[first]
    return nbr_table, dist_table


def _reverse_pass_bulk(
    nbr_table: torch.Tensor,    # [cap+1, degree] adjacency (forward edges set)
    dist_table: torch.Tensor,   # [cap+1, degree] true edge distances
    n_rows: int,                # forward edges come from rows [0, n_rows)
    degree: int,
    rev_window: int = 0,        # 0 -> min(degree, 16)
):
    """Whole-graph reverse pass: the merge runs once per TARGET row.

    1. stable sort of the P = n_rows*degree (target, dist, src) triples by
       target only (row-major (src, slot) order within a target);
    2. each target's first position into a [cap+1] table (a masked write;
       JAX's "drop" scatter sends the others to the trash row's slot, which
       no target reads);
    3. each target's first <= W reverse sources by a [cap+1, W] gather;
    4. merge + id-dedupe against the existing rows with one
       sort_smallest_k over [cap+1, degree+W], written densely.
    Returns new (nbr_table, dist_table)."""
    cap1 = nbr_table.shape[0]
    dev = nbr_table.device
    w = rev_window if rev_window > 0 else max(1, min(degree, 16))
    p = n_rows * degree
    tgt = nbr_table[:n_rows].reshape(p)
    d = dist_table[:n_rows].reshape(p)
    src = torch.arange(n_rows, dtype=torch.int32, device=dev).repeat_interleave(degree)
    valid = tgt >= 0
    key = torch.where(valid, tgt, 2**30)
    order = torch.argsort(key, stable=True)
    st = key[order]
    sd = torch.where(valid, d, _INF)[order]
    ss = src[order]
    del order, tgt, d, src, valid, key

    prev = torch.cat([st.new_full((1,), -2), st[:-1]])
    first = (st != prev) & (st < 2**30)
    pos0 = torch.full((cap1,), p, dtype=torch.int32, device=dev)
    pos0[st[first].long()] = torch.arange(p, dtype=torch.int32, device=dev)[first]
    del prev, first

    idx = torch.clamp(pos0[:, None] + torch.arange(w, dtype=torch.int32, device=dev)[None, :],
                      max=p - 1).long()                                   # [cap1, W]
    has = pos0 < p
    same = has[:, None] & (st[idx] == torch.arange(cap1, dtype=torch.int32, device=dev)[:, None])
    rev = torch.where(same, ss[idx], -1)
    rev_d = torch.where(same, sd[idx], _INF)
    del idx, same, st, sd, ss

    cand = torch.cat([nbr_table, rev], dim=-1)                            # [cap1, deg+W]
    cand_d = torch.cat([dist_table, rev_d], dim=-1)
    cand_d = torch.where(cand >= 0, cand_d, _INF)
    new_d, new_rows = T.sort_smallest_k(cand_d, cand, degree, dedupe=True)
    # rows without reverse edges merge against all-invalid candidates: the
    # result is the row itself, distance-sorted
    return new_rows, new_d


# ---------------------------------------------------------------------------
# the HNSW one-shot build


def sample_levels(gen: torch.Generator, n: int, m: int, levels_cap: int,
                  ml: Optional[float]) -> np.ndarray:
    """Geometric level sampling, level = floor(-ln(U) * mL), mL = 1/ln(m),
    U uniform on [1e-9, 1) in f32, clipped to [0, levels_cap]."""
    mlv = ml if ml is not None else 1.0 / math.log(max(m, 2))
    u = torch.clamp(torch.rand(n, generator=gen, dtype=torch.float32), min=1e-9)
    lv = torch.floor(-torch.log(u) * mlv).to(torch.int32)
    return torch.clamp(lv, 0, levels_cap).numpy()


def reorder_rows_diverse(state, cfg):
    """Reorder every base-layer adjacency row diversity-first, IN PLACE.

    Rows end up nearest-first after the reverse-edge merges, so a
    truncated-degree search (SearchConfig.search_degree) would read only
    intra-cluster edges. This pass re-runs the diversity rule per row and
    stores the kept (diverse) edges first, in tiles of 8192 rows, at the
    build's precision ("default" takes "high"). Rows of unused slots keep
    theirs. Returns the state."""
    from .hnsw import torch_precision

    cap = state.vectors.shape[0]
    deg = state.nbr0.shape[1]
    prec = torch_precision(cfg.precision if cfg.precision != "default" else "high")
    tile = 8192
    for lo in range(0, cap, tile):
        hi = min(lo + tile, cap)
        nbr, dst = state.nbr0[lo:hi], state.dist0[lo:hi]
        base_vec = state.vectors[lo:hi].float() * state.q_scale
        base_norm = state.norms[lo:hi]
        # select_neighbors takes surrogate scores; the stored dists are true ones
        scores = dst - base_norm[:, None] if cfg.metric == "l2" else dst
        new_ids, new_d = select_neighbors(state, base_vec, base_norm, nbr, scores, deg,
                                          cfg.alpha, cfg.metric, precision=prec)
        live = (state.levels[lo:hi] >= 0)[:, None]
        state.nbr0[lo:hi] = torch.where(live, new_ids, nbr)
        state.dist0[lo:hi] = torch.where(live, new_d, dst)
    return state


def _subset_knn_layer(xj: torch.Tensor, rows: np.ndarray, degree: int, alpha: float,
                      metric: str, gen: torch.Generator):
    """Navigable graph over a subset of rows (one upper HNSW layer): the
    cluster-kNN builder (reverse edges, random long-range links; exact
    per-block top-k at its default "high" precision, as JAX's call takes
    it) over xj[rows]. Upper layers route the greedy descent, and an exact
    kNN graph over clustered data has no long edges. Returns (nbrs [S,
    degree] int32 GLOBAL row ids, dists [S, degree])."""
    from .knn_graph import build_knn_graph

    s = rows.shape[0]
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=xj.device)
    nbrs_l, dists_l, *_ = build_knn_graph(xj[rows_t], degree, gen, metric=metric,
                                          alpha=max(alpha, 1.1))
    local = nbrs_l[:s]
    glob = torch.where(local >= 0, rows_t[local.clamp(min=0).long()], -1).to(torch.int32)
    return glob, dists_l[:s]


def _attach_anchors(state, n: int, gen: torch.Generator):
    """Sample a = 2^clamp(ceil(log2(n/12)), 10, 15) rows (all rows when that
    is n or more) as the dense anchor seed table, IN PLACE: dequantized
    copies of the stored rows, their norms and their row ids."""
    if n <= 0:
        return state
    a = 1 << max(10, min(15, int(math.ceil(math.log2(max(n, 2) / 12.0)))))
    dev = state.vectors.device
    if a >= n:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        rows = torch.randperm(n, generator=gen)[:a].to(torch.int32).to(dev)
    state.anchors = state.vectors[rows.long()].float() * state.q_scale
    state.a_norms = state.norms[rows.long()]
    state.a_rows = rows
    return state


def bulk_build_oneshot(x, cfg, gen: torch.Generator, capacity: Optional[int] = None,
                       device=None, stats: Optional[dict] = None):
    """One-shot HNSW construction from dense products, no beam loops.
    Returns (state, capacity, levels_cap).

    The base layer is the cluster-kNN graph (knn_graph.build_knn_graph at
    degree M0 with cfg's kc_per_view, prune_cap, block_topk and
    build_kmeans_iters: with block_topk="pallas" its block scoring runs
    kernel D); each upper layer is a kNN graph over the nodes reaching it.
    Capacity rounds up to a multiple of build_batch, as in JAX. x is numpy
    (uploaded to `device`, None: "cuda") or a tensor (used on its device).
    `stats`, if given, receives the base-layer graph's geometry (knn_graph)
    and, with ZVDB_BUILD_TRACE=1, the stages' seconds under "stages" (a sync
    before each mark)."""
    from .flat import resolve_device
    from .hnsw import init_state, max_level_for, torch_precision
    from .knn_graph import build_knn_graph

    trace = os.environ.get("ZVDB_BUILD_TRACE", "") not in ("", "0")
    stats = {} if stats is None else stats
    n = x.shape[0]
    bsz = min(cfg.build_batch, max(n, 1))
    cap_min = -(-max(n, 1) // bsz) * bsz
    cap = max(capacity, cap_min) if capacity is not None else cap_min
    levels_cap = cfg.max_level if cfg.max_level is not None else max_level_for(cap, cfg.m)
    on_device = isinstance(x, torch.Tensor)
    dev = x.device if on_device else resolve_device(device)
    state = init_state(cap, cfg, levels_cap, dev)
    if n == 0:
        return state, cap, levels_cap
    marks = [("start", time.perf_counter())]

    def mark(name):
        if trace:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append((name, time.perf_counter()))

    if on_device:
        xs = x.float()
        if cfg.metric == "cosine":
            xs = xs / torch.clamp(torch.linalg.norm(xs, dim=1, keepdim=True), min=1e-12)
        amax = float(xs.abs().max()) if cfg.dtype == "int8" else 1.0
    else:
        xs = np.asarray(x, np.float32)
        if cfg.metric == "cosine":   # the JAX package's host normalization, bit for bit
            xs = xs / np.maximum(np.linalg.norm(xs, axis=1, keepdims=True), 1e-12)
        amax = float(np.abs(xs).max()) if cfg.dtype == "int8" else 1.0
        xs = torch.from_numpy(np.ascontiguousarray(xs)).to(dev)
    if cfg.dtype == "int8":
        state.q_scale = float(np.float32(max(amax, 1e-12) / 127.0))
    prec = torch_precision(cfg.precision if cfg.precision != "default" else "high")
    levels = sample_levels(gen, n, cfg.m, levels_cap, cfg.ml)

    # ---- ingest
    if cfg.dtype == "int8":
        stored, norms = D.quantize_corpus_global(xs, cfg.metric, state.q_scale)
    else:
        stored, norms = D.preprocess_corpus(xs, cfg.metric, cfg.storage_dtype)
    state.vectors[:n] = stored
    state.norms[:n] = norms
    state.levels[:n] = torch.from_numpy(levels).to(dev)
    state.ext_ids[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    del xs, stored, norms
    # the graph is built over what the index searches: the dequantized rows
    xj = state.vectors[:n] if cfg.dtype == "float32" else \
        state.vectors[:n].float() * state.q_scale
    mark("ingest")

    # ---- base layer
    nbrs, dists, *_ = build_knn_graph(
        xj, cfg.base_degree, gen, metric=cfg.metric, alpha=cfg.alpha, precision=prec,
        kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap, block_topk=cfg.block_topk,
        kmeans_iters=cfg.build_kmeans_iters, stats=stats)
    state.nbr0[:n] = nbrs[:n]
    state.dist0[:n] = dists[:n]
    del nbrs, dists
    mark("base")

    # ---- upper layers
    for ell in range(1, levels_cap + 1):
        rows = np.nonzero(levels >= ell)[0]
        if rows.size < 2:
            break
        glob, gd = _subset_knn_layer(xj, rows, cfg.m, cfg.alpha, cfg.metric, gen)
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        state.nbrU[ell - 1, rows_t] = glob
        state.distU[ell - 1, rows_t] = gd
    del xj
    state.entry = int(np.argmax(levels))
    state.max_level = int(levels.max())
    state.n = n
    mark("upper")
    _attach_anchors(state, n, gen)
    mark("anchors")
    if cfg.diverse_rows:
        reorder_rows_diverse(state, cfg)
    mark("reorder")
    if trace:
        stages = {name: t1 - t0 for (_, t0), (name, t1) in zip(marks, marks[1:])}
        stats["stages"] = stages
        print(f"[hnsw oneshot n={n}] total={marks[-1][1] - marks[0][1]:.2f}s  "
              + "  ".join(f"{k}={v:.2f}s" for k, v in stages.items()), flush=True)
    return state, cap, levels_cap
