"""The HNSW builds and the graph builds' shared pieces (port of
zvdb_tpu/index/build.py): `select_neighbors`, `_reverse_pass`,
`_reverse_pass_bulk`, `sample_levels`, `reorder_rows_diverse`,
`_subset_knn_layer`, `_attach_anchors`; the one-shot build
(`bulk_build_oneshot`, `resume_build_oneshot`); the batched frozen-prefix
build (`build_batch_step`, `_run_batches`, `bulk_build`, `extend_graph`,
the insert path's flush) and its checkpoints (`save_build_checkpoint`,
`resume_build`).

Products take their precision by name (`precision`): the JAX package runs
them under an ambient `jax.default_matmul_precision`, which PyTorch does not
have. "Drop" scatters of the JAX version are masked writes here, and tables
are updated in place where JAX returns copies. The builds draw their
levels, graphs and anchors from a torch.Generator, so one seed builds a
different graph in each package; their deterministic stages equal JAX's on
equal inputs, and checkpoint files cross between the packages.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import HNSWConfig
from ..utils.profiling import Stages, wait

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
    with wait("reverse_first"):   # boolean masks' sizes, one wait each
        rows = st[first].long()
    with wait("reverse_first"):
        nbr_table[rows] = new_rows[first]
    with wait("reverse_first"):
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
    with wait("reverse_first"):   # boolean masks' sizes, one wait each
        at = torch.arange(p, dtype=torch.int32, device=dev)[first]
    with wait("reverse_first"):
        pos0[st[first].long()] = at
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




# ---------------------------------------------------------------------------
# shared by the builds


def _prepared(x, metric: str):
    """The corpus as f32, rows normalized for cosine: numpy stays numpy (the
    JAX package's host normalization, bit for bit), a tensor stays on its
    device."""
    if isinstance(x, torch.Tensor):
        xs = x.float()
        if metric == "cosine":
            xs = xs / torch.clamp(torch.linalg.norm(xs, dim=1, keepdim=True), min=1e-12)
        return xs
    xs = np.asarray(x, np.float32)
    if metric == "cosine":
        xs = xs / np.maximum(np.linalg.norm(xs, axis=1, keepdims=True), 1e-12)
    return xs


def _int8_scale(xs) -> float:
    """The per-tensor int8 scale of a prepared corpus, an f32 value."""
    amax = float(abs(xs).max()) if xs.shape[0] else 1.0
    return float(np.float32(max(amax, 1e-12) / 127.0))


def _capacity(n: int, cfg, capacity: Optional[int]):
    """(capacity, levels_cap) of a build over n rows: the capacity rounds up
    to whole build batches, as in JAX (whose batch writes clamp a start
    that runs out of bounds)."""
    from .hnsw import max_level_for

    bsz = min(cfg.build_batch, max(n, 1))
    cap_min = -(-max(n, 1) // bsz) * bsz
    cap = max(capacity, cap_min) if capacity is not None else cap_min
    return cap, cfg.max_level if cfg.max_level is not None else max_level_for(cap, cfg.m)


# ---------------------------------------------------------------------------
# the HNSW one-shot build


def bulk_build_oneshot(x, cfg, gen: torch.Generator, capacity: Optional[int] = None,
                       device=None, stats: Optional[dict] = None,
                       checkpoint_path: Optional[str] = None):
    """One-shot HNSW construction from dense products, no beam loops.
    Returns (state, capacity, levels_cap).

    The base layer is the cluster-kNN graph (knn_graph.build_knn_graph at
    degree M0 with cfg's kc_per_view, prune_cap, block_topk and
    build_kmeans_iters: with block_topk="pallas" its block scoring runs
    kernel D); each upper layer is a kNN graph over the nodes reaching it.
    Capacity rounds up to a multiple of build_batch, as in JAX. x is numpy
    (uploaded to `device`, None: "cuda") or a tensor (used on its device).

    The build first draws a uint32[2] key from `gen`; the levels and the
    base layer then draw from `gen`, and the epilogue (upper layers,
    anchors) from a generator seeded with the key. checkpoint_path: once
    the base layer is built, an npz snapshot in the JAX package's format
    (kind "hnsw_oneshot": the prepared corpus, levels, key, base edges);
    resume_build_oneshot reruns only the epilogue from it, so resumed ==
    direct. `stats`, if given, receives the base-layer graph's geometry
    (knn_graph) and, with ZVDB_BUILD_TRACE=1, the stages' seconds under
    "stages"."""
    return _oneshot_impl(x, cfg, gen, capacity, device, stats, checkpoint_path, resume=None)


def resume_build_oneshot(path: str, device=None):
    """Finish a one-shot build from its base-layer checkpoint, written by
    either package (a JAX key seeds the port's epilogue generator). Returns
    (state, capacity, levels_cap, cfg)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("kind") != "hnsw_oneshot":
            raise ValueError(f"not a oneshot build checkpoint: {path}")
        cfg = HNSWConfig(**meta["cfg"])
        resume = (z["lv"], z["nbrs"], z["dists"], z["key"])
        state, cap, levels_cap = _oneshot_impl(z["corpus"], cfg, None, meta["capacity"], device,
                                               None, None, resume)
    return state, cap, levels_cap, cfg


def _oneshot_impl(x, cfg, gen, capacity, device, stats, checkpoint_path, resume):
    from .flat import resolve_device
    from .hnsw import init_state, torch_precision
    from .knn_graph import build_knn_graph

    stats = {} if stats is None else stats
    n = x.shape[0]
    cap, levels_cap = _capacity(n, cfg, capacity)
    on_device = isinstance(x, torch.Tensor)
    dev = x.device if on_device else resolve_device(device)
    state = init_state(cap, cfg, levels_cap, dev)
    if n == 0:
        return state, cap, levels_cap
    stages = {}
    mark = Stages(dev, "hnsw.build.", stages)
    mark("ingest")
    xs = _prepared(x, cfg.metric)
    if cfg.dtype == "int8":
        state.q_scale = _int8_scale(xs)
    xs_host = None
    if checkpoint_path and resume is None:
        xs_host = xs.cpu().numpy() if on_device else xs
    if not on_device:
        xs = torch.from_numpy(np.ascontiguousarray(xs)).to(dev)
    prec = torch_precision(cfg.precision if cfg.precision != "default" else "high")
    if resume is None:
        key = torch.randint(0, 2**32, (2,), generator=gen, dtype=torch.int64).numpy()
        key = key.astype(np.uint32)
        levels = sample_levels(gen, n, cfg.m, levels_cap, cfg.ml)
    else:
        key = np.asarray(resume[3], np.uint32).reshape(-1)
        levels = np.asarray(resume[0], np.int32)
    epilogue = torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))

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

    # ---- base layer
    mark("base")
    if resume is None:
        nbrs, dists, *_ = build_knn_graph(
            xj, cfg.base_degree, gen, metric=cfg.metric, alpha=cfg.alpha, precision=prec,
            kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap, block_topk=cfg.block_topk,
            kmeans_iters=cfg.build_kmeans_iters, stats=stats)
        state.nbr0[:n] = nbrs[:n]
        state.dist0[:n] = dists[:n]
        del nbrs, dists
    else:
        state.nbr0[:n] = torch.from_numpy(np.asarray(resume[1], np.int32)).to(dev)
        state.dist0[:n] = torch.from_numpy(np.asarray(resume[2], np.float32)).to(dev)
    if xs_host is not None:
        mark("checkpoint")
        np.savez_compressed(
            checkpoint_path,
            meta=json.dumps(dict(kind="hnsw_oneshot", cfg=dataclasses.asdict(cfg), capacity=cap)),
            corpus=xs_host, lv=levels, key=key, nbrs=state.nbr0[:n].cpu().numpy(),
            dists=state.dist0[:n].cpu().numpy())

    # ---- upper layers
    mark("upper")
    for ell in range(1, levels_cap + 1):
        rows = np.nonzero(levels >= ell)[0]
        if rows.size < 2:
            break
        glob, gd = _subset_knn_layer(xj, rows, cfg.m, cfg.alpha, cfg.metric, epilogue)
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        state.nbrU[ell - 1, rows_t] = glob
        state.distU[ell - 1, rows_t] = gd
    del xj
    state.entry = int(np.argmax(levels))
    state.max_level = int(levels.max())
    state.n = n
    mark("anchors")
    _attach_anchors(state, n, epilogue)
    mark("reorder")
    if cfg.diverse_rows:
        reorder_rows_diverse(state, cfg)
    mark.end()
    if mark.timed:
        stats["stages"] = stages
        print(mark.report(f"hnsw oneshot n={n}"), flush=True)
    return state, cap, levels_cap


# ---------------------------------------------------------------------------
# one batch of the frozen-prefix build


def build_batch_step(state, xb: torch.Tensor, lb: np.ndarray, extb: np.ndarray,
                     valid: np.ndarray, cfg, levels_cap: int, seed_anchors: int = 0,
                     mark=None):
    """Insert one batch into the graph, IN PLACE; returns the state.

    xb [B, D] f32 raw rows on the state's device; lb [B] levels, extb [B]
    external ids and valid [B] as host numpy (padding rows: valid False).
    The batch takes rows [n, n+B): capacity must hold them.

      1. ingest (int8: clipped to the state's q_scale);
      2. beams over the frozen prefix (rows < n): by default a greedy
         descent through the upper layers and one ef_construction beam at
         the base, upper-layer candidates being the base beam's rows that
         reach the layer plus the descent's row there; cfg.upper_beam runs
         an ef_construction_upper beam at every upper layer instead.
         seed_anchors > 0 adds the best seed_anchors rows of the state's
         anchor table (when it has one) to the base beam's seeds, as
         search does; JAX seeds from the descent alone (seed_anchors=0),
         which on micro-clustered data strands rows in a far cluster;
      3. intra-batch brute-force candidates (rows of one batch cannot see
         each other through the graph yet);
      4. select_neighbors (m diverse forward edges per row and layer), the
         rows written and _reverse_pass merging the reverse edges;
      5. the bookkeeping (entry promotion, max_level, n), on the host.
    An upper layer no batch row reaches is skipped by a host `if` (JAX's
    lax.cond). Every product takes cfg.precision. `mark`: the build's
    utils.profiling.Stages (None: one of its own)."""
    from .hnsw import _greedy_layer, _scores_to, anchor_seeds, beam_layer, torch_precision

    b = xb.shape[0]
    dev = state.vectors.device
    mark = mark or Stages(dev, "hnsw.build.")
    mark("ingest")
    m, m0, metric = cfg.m, cfg.base_degree, cfg.metric
    prec = torch_precision(cfg.precision)
    valid = np.asarray(valid, bool)
    lb_m = np.where(valid, np.asarray(lb, np.int32), -1)
    base = prefix_n = state.n
    rows = torch.arange(base, base + b, dtype=torch.int32, device=dev)
    lb_t = torch.from_numpy(lb_m).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)

    # ---- 1. ingest
    xb = xb.to(dev, torch.float32)
    if cfg.dtype == "int8":
        stored, norms = D.quantize_corpus_global(xb, metric, state.q_scale)
    else:
        stored, norms = D.preprocess_corpus(xb, metric, cfg.storage_dtype)
    state.vectors[base:base + b] = stored
    state.norms[base:base + b] = norms
    state.levels[base:base + b] = lb_t
    state.ext_ids[base:base + b] = torch.from_numpy(
        np.where(valid, np.asarray(extb, np.int32), -1)).to(dev)
    # build queries: the dequantized stored rows (cosine rows normalized at ingest)
    q = stored.float() * state.q_scale
    qn = D.sq_norms(q)

    # ---- 2. frozen-prefix beams
    mark("descent")
    def with_anchors(seed_r, seed_s):
        """The base beam's seeds [B, S] and, with seed_anchors, the best
        anchor rows (all in the prefix: anchors are sampled from built rows)."""
        a = anchor_seeds(state, q, seed_anchors, metric, prec)
        if a is None:
            return seed_r, seed_s
        return torch.cat([seed_r, a[0]], dim=1), torch.cat([seed_s, a[1]], dim=1)

    entry = state.entry if state.entry < prefix_n else -1   # the entry must be in the prefix
    ep = torch.full((b,), entry, dtype=torch.int32, device=dev)
    ep_s = _scores_to(state, q, ep[:, None], metric, prec)[:, 0]
    if cfg.upper_beam:
        beams = {}
        seed_r, seed_s = ep[:, None], ep_s[:, None]
        for ell in range(levels_cap, 0, -1):
            bs, br = beam_layer(state, q, seed_r, seed_s, state.nbrU[ell - 1],
                                cfg.ef_construction_upper, metric, expand=cfg.build_expand,
                                limit_n=prefix_n, precision=prec)
            beams[ell] = (bs, br)
            better = bs[:, :1] < seed_s[:, :1]
            seed_r = torch.where(better & (br[:, :1] >= 0), br[:, :1], seed_r)
            seed_s = torch.where(better, bs[:, :1], seed_s)
        mark("base beam")
        seed_r, seed_s = with_anchors(seed_r, seed_s)
        beams[0] = beam_layer(state, q, seed_r, seed_s, state.nbr0, cfg.ef_construction, metric,
                              expand=cfg.build_expand, limit_n=prefix_n, precision=prec)

        def layer_cands(ell):
            return beams[ell]
    else:
        # a layer above the prefix's max_level has no edges: the walk would
        # not move there, so it is skipped (JAX walks it)
        seed_r, seed_s = ep, ep_s
        path = {}
        for ell in range(levels_cap, 0, -1):
            if ell <= state.max_level:
                seed_r, seed_s = _greedy_layer(state, q, seed_r, seed_s, state.nbrU[ell - 1],
                                               metric, 32, prec)
            path[ell] = (seed_s, seed_r)
        mark("base beam")
        bs0, br0 = beam_layer(state, q, *with_anchors(seed_r[:, None], seed_s[:, None]),
                              state.nbr0, cfg.ef_construction, metric,
                              expand=cfg.build_expand, limit_n=prefix_n, precision=prec)
        cand_lv = state.levels[br0.clamp(min=0).long()]

        def layer_cands(ell):
            """The base beam's rows that reach layer ell, after the descent's
            row there if it reaches it (the entry seed may sit lower)."""
            if ell == 0:
                return bs0, br0
            ok = (br0 >= 0) & (cand_lv >= ell)
            ps, pr = path[ell]
            p_ok = (pr >= 0) & (state.levels[pr.clamp(min=0).long()] >= ell)
            return (torch.cat([torch.where(p_ok, ps, _INF)[:, None],
                               torch.where(ok, bs0, _INF)], dim=-1),
                    torch.cat([torch.where(p_ok, pr, -1)[:, None],
                               torch.where(ok, br0, -1)], dim=-1))

    # ---- 3. intra-batch brute-force candidates
    mark("intra")
    intra = D.pairwise_scores(q, q, torch.where(valid_t, qn, _INF), metric, precision=prec)
    intra.fill_diagonal_(_INF)
    intra.masked_fill_(~valid_t[None, :], _INF)

    def layer_edges(ell, degree, k_intra):
        """Forward selection for one layer -> (fwd ids, fwd dists, the rows
        padded to `degree`). The intra pool is as wide as the layer's beam,
        so a first batch (intra candidates only) sees as rich a pool."""
        active = valid_t & (lb_t >= ell)
        i_s, i_c = T.smallest_k_dense(torch.where(active[None, :], intra, _INF), k_intra)
        i_rows = torch.where(torch.isfinite(i_s), base + i_c.to(torch.int32), -1)
        i_s = torch.where(i_rows >= 0, i_s, _INF)
        g_s, g_r = layer_cands(ell)
        c_s, c_r = T.mask_duplicate_ids(torch.cat([g_s, i_s], dim=-1),
                                        torch.cat([g_r, i_rows], dim=-1))
        fwd, fwd_d = select_neighbors(state, q, qn, c_r, c_s, m, cfg.alpha, metric,
                                      max_candidates=cfg.select_cap, precision=prec)
        fwd = torch.where(active[:, None], fwd, -1)
        fwd_d = torch.where(fwd >= 0, fwd_d, _INF)
        if degree > m:
            return fwd, fwd_d, torch.cat([fwd, fwd.new_full((b, degree - m), -1)], dim=-1), \
                torch.cat([fwd_d, fwd_d.new_full((b, degree - m), _INF)], dim=-1)
        return fwd, fwd_d, fwd[:, :degree], fwd_d[:, :degree]

    # ---- 4. the base layer: forward edges and the reverse merge
    mark("base select+reverse")
    fwd0, fwd0_d, row_ids, row_ds = layer_edges(0, m0, min(b, cfg.ef_construction))
    state.nbr0[base:base + b] = row_ids
    state.dist0[base:base + b] = row_ds
    _reverse_pass(state.nbr0, state.dist0, rows, fwd0, fwd0_d, m0)

    # ---- the upper layers a batch row reaches (level-sorted builds: the first batches)
    mark("upper layers")
    k_intra_u = min(b, cfg.ef_construction_upper)
    for ell in range(1, levels_cap + 1):
        if not (lb_m >= ell).any():
            continue
        fwd, fwd_d, row_ids, row_ds = layer_edges(ell, m, k_intra_u)
        tab, dtab = state.nbrU[ell - 1], state.distU[ell - 1]
        tab[base:base + b] = row_ids
        dtab[base:base + b] = row_ds
        _reverse_pass(tab, dtab, rows, fwd, fwd_d, m)
    mark.end()

    # ---- 5. bookkeeping, on the host
    if valid.any():
        batch_max = int(lb_m.max())
        if state.entry < 0 or batch_max > state.max_level:
            state.entry = base + int(np.argmax(lb_m))
        state.max_level = max(state.max_level, batch_max)
    state.n += int(valid.sum())
    return state


# ---------------------------------------------------------------------------
# the batched build: orchestration and checkpoints


def _run_batches(state, x, levels, ext, cfg, levels_cap, start_batch: int = 0, on_batch=None,
                 stages: Optional[dict] = None, seed_anchors: int = 0):
    """Batches of min(build_batch, n) rows of x (numpy, uploaded a batch at
    a time, or a tensor, padded on its device) through build_batch_step,
    from batch `start_batch`; on_batch(state, t, nb) after each. `stages`
    collects the steps' traced seconds; seed_anchors goes to each step."""
    n = x.shape[0]
    bsz = min(cfg.build_batch, max(n, 1))
    nb = -(-n // bsz)
    dev = state.vectors.device
    mark = Stages(dev, "hnsw.build.", {} if stages is None else stages)
    for t in range(start_batch, nb):
        lo, hi = t * bsz, min((t + 1) * bsz, n)
        if isinstance(x, torch.Tensor):
            xb = x.new_zeros((bsz, cfg.dim))
            xb[:hi - lo] = x[lo:hi]
        else:
            xb = np.zeros((bsz, cfg.dim), np.float32)
            xb[:hi - lo] = x[lo:hi]
            xb = torch.from_numpy(xb).to(dev)
        lb = np.full(bsz, -1, np.int32)
        lb[:hi - lo] = levels[lo:hi]
        eb = np.full(bsz, -1, np.int32)
        eb[:hi - lo] = ext[lo:hi]
        vb = np.arange(bsz) < hi - lo
        build_batch_step(state, xb, lb, eb, vb, cfg, levels_cap, seed_anchors, mark)
        if on_batch is not None:
            mark("checkpoint")
            on_batch(state, t, nb)
            mark.end()
    return state


def save_build_checkpoint(path: str, state, x, levels, ext, cfg, levels_cap: int,
                          next_batch: int, capacity: int) -> None:
    """Snapshot a partly built batched build and the work left, in the JAX
    package's npz format (meta JSON; corpus, lv, ext; the state's fields,
    host scalars as 0-d arrays), so either package resumes it."""
    meta = dict(cfg=dataclasses.asdict(cfg), levels_cap=levels_cap, next_batch=next_batch,
                capacity=capacity)
    from .hnsw import state_to_numpy

    np.savez_compressed(path, meta=json.dumps(meta), corpus=np.asarray(x), lv=levels, ext=ext,
                        **state_to_numpy(state))


def resume_build(path: str, device=None):
    """Continue a checkpointed batched build, written by either package.
    Returns (state, capacity, levels_cap, cfg). The epilogue is bulk_build's:
    anchors (from a generator seeded 0, where JAX uses PRNGKey(0); they do
    not touch the graph) and the diversity reorder."""
    from .flat import resolve_device
    from .hnsw import state_from_numpy

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        cfg = HNSWConfig(**meta["cfg"])
        state = state_from_numpy(cfg, {f: z[f] for f in z.files}, resolve_device(device))
        x, levels, ext = z["corpus"], z["lv"], z["ext"]
    _run_batches(state, x, levels, ext, cfg, meta["levels_cap"], start_batch=meta["next_batch"])
    _attach_anchors(state, x.shape[0], torch.Generator().manual_seed(0))
    if cfg.diverse_rows:
        reorder_rows_diverse(state, cfg)
    return state, meta["capacity"], meta["levels_cap"], cfg


def bulk_build(x, cfg, gen: torch.Generator, sort_by_level: bool = True,
               capacity: Optional[int] = None, checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 0, device=None, stats: Optional[dict] = None):
    """The batched build of a fresh index over x [N, D] (numpy, uploaded a
    batch at a time to `device`, or a tensor, kept on its device). Returns
    (state, capacity, levels_cap).

    Rows go in level-descending order (sort_by_level), so the frozen prefix
    holds every node of an equal or higher level and the entry is right
    from the first batch; external ids are the rows' positions in x. int8:
    the scale comes from the whole corpus. checkpoint_path with
    checkpoint_every > 0: a save_build_checkpoint after every
    checkpoint_every-th batch but the last. Then anchors from `gen` and the
    diversity reorder. `stats` receives "batches" and, with
    ZVDB_BUILD_TRACE=1, the steps' stage seconds summed over the batches."""
    from .flat import resolve_device
    from .hnsw import init_state

    stats = {} if stats is None else stats
    n = x.shape[0]
    cap, levels_cap = _capacity(n, cfg, capacity)
    on_device = isinstance(x, torch.Tensor)
    dev = x.device if on_device else resolve_device(device)
    state = init_state(cap, cfg, levels_cap, dev)
    if cfg.dtype == "int8":
        # later extend_graph batches clip to this scale
        state.q_scale = _int8_scale(_prepared(x, cfg.metric))
    if n == 0:
        return state, cap, levels_cap
    levels = sample_levels(gen, n, cfg.m, levels_cap, cfg.ml)
    order = np.argsort(-levels, kind="stable") if sort_by_level else np.arange(n)
    if on_device:
        xs = x.float()[torch.from_numpy(order).to(dev)]
    else:
        xs = np.asarray(x, np.float32)[order]
    ls, ext = levels[order], order.astype(np.int32)
    on_batch = None
    if checkpoint_path and checkpoint_every > 0:
        xs_host = xs.cpu().numpy() if on_device else xs

        def on_batch(st, t, nb):
            if (t + 1) % checkpoint_every == 0 and t + 1 < nb:
                save_build_checkpoint(checkpoint_path, st, xs_host, ls, ext, cfg, levels_cap,
                                      t + 1, cap)
    stages = {}
    _run_batches(state, xs, ls, ext, cfg, levels_cap, on_batch=on_batch, stages=stages)
    del xs
    mark = Stages(dev, "hnsw.build.", stages)
    mark("anchors+reorder")
    _attach_anchors(state, n, gen)
    if cfg.diverse_rows:
        reorder_rows_diverse(state, cfg)
    mark.end()
    stats["batches"] = -(-n // min(cfg.build_batch, n))
    if mark.timed:
        stats["stages"] = stages
        print(mark.report(f"hnsw batched n={n}"), flush=True)
    return state, cap, levels_cap


def _grown(state, capacity: int, new_cap: int, cfg, levels_cap: int):
    """A copy of the state at capacity new_cap (the trash rows not copied)."""
    from .hnsw import init_state

    g = init_state(new_cap, cfg, levels_cap, state.vectors.device)
    for f in ("vectors", "norms", "levels", "ext_ids"):
        getattr(g, f)[:capacity] = getattr(state, f)
    g.nbr0[:capacity] = state.nbr0[:-1]
    g.dist0[:capacity] = state.dist0[:-1]
    g.nbrU[:, :capacity] = state.nbrU[:, :-1]
    g.distU[:, :capacity] = state.distU[:, :-1]
    for f in ("entry", "max_level", "n", "q_scale", "anchors", "a_norms", "a_rows"):
        setattr(g, f, getattr(state, f))
    return g


def extend_graph(state, capacity: int, levels_cap: int, x: np.ndarray, cfg, gen: torch.Generator,
                 ext_id_start: int, device=None, stats: Optional[dict] = None,
                 seed_anchors: int = 0):
    """Append rows x [N, D] (numpy) to a graph in arrival order, external
    ids from ext_id_start: the insert path's flush. Returns (state,
    capacity); the state is updated in place unless it grows or is None.

    state None: a bulk_build at capacity max(N, 1024), ids shifted.
    Otherwise the state grows to max(need, 2 * capacity) when the batches'
    whole windows [n, n + batches * B) pass the capacity (as JAX, whose
    batch writes clamp), levels come from one sample_levels draw, and the
    rows go through _run_batches, their base beams seeded with the best
    seed_anchors anchors beside the descent (build_batch_step; HNSW's flush
    passes SearchConfig.seed_anchors). `stats` receives "grow_s" (host
    seconds of a growth, after a sync), "batches" and, with
    ZVDB_BUILD_TRACE=1, the steps' stage seconds."""
    stats = {} if stats is None else stats
    n_new = x.shape[0]
    if state is None:
        st, cap, _ = bulk_build(x, cfg, gen, sort_by_level=True, capacity=max(n_new, 1024),
                                device=device, stats=stats)
        st.ext_ids = torch.where(st.ext_ids >= 0, st.ext_ids + ext_id_start, -1).to(torch.int32)
        return st, cap
    bsz = min(cfg.build_batch, max(n_new, 1))
    nb = -(-n_new // bsz)
    need = state.n + nb * bsz
    if need > capacity:
        t0 = time.perf_counter()
        new_cap = max(need, 2 * capacity)
        state = _grown(state, capacity, new_cap, cfg, levels_cap)
        if state.vectors.device.type == "cuda":
            with wait("grow_sync"):
                torch.cuda.synchronize(state.vectors.device)
        stats["grow_s"] = time.perf_counter() - t0
        capacity = new_cap
    levels = sample_levels(gen, n_new, cfg.m, levels_cap, cfg.ml)
    ext = np.arange(ext_id_start, ext_id_start + n_new, dtype=np.int32)
    stages = {}
    _run_batches(state, np.asarray(x, np.float32), levels, ext, cfg, levels_cap, stages=stages,
                 seed_anchors=seed_anchors)
    stats["batches"] = nb
    if stages:
        stats["stages"] = stages
    return state, capacity
