"""Diversity pruning and reverse-edge merges of the graph builds (port of the
shared part of zvdb_tpu/index/build.py: `select_neighbors`, `_reverse_pass`,
`_reverse_pass_bulk`). The HNSW batch build and level sampling are not
ported yet.

Products take their precision by name (`precision`): the JAX package runs
them under an ambient `jax.default_matmul_precision`, which PyTorch does not
have. "Drop" scatters of the JAX version are masked writes here, and tables
are updated in place where JAX returns copies.
"""
from __future__ import annotations

from typing import Optional

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
