"""Batched beam search over one graph layer (port of
zvdb_tpu/index/hnsw.py:beam_layer_fn). The CAGRA engine searches its single
layer with it; the rest of the HNSW engine is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import topk as T

_INF = float("inf")


def beam_layer_fn(
    score_rows,                   # rows [B, C] -> surrogate scores [B, C]
    seed_rows: torch.Tensor,      # [B, S] initial candidate rows (-1 ok)
    seed_scores: torch.Tensor,    # [B, S]
    nbrs: torch.Tensor,           # [cap+1, deg] adjacency of this layer
    ef: int,
    expand: int = 1,
    max_iters: Optional[int] = None,
    limit_n: Optional[int] = None,
    use_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
    expand_fn=None,
):
    """Batched best-first beam search on one layer's graph.

    Returns (beam_scores [B, ef], beam_rows [B, ef]) sorted ascending by
    score. `limit_n`: rows >= limit_n are treated as nonexistent (the frozen
    prefix of an incremental build). `use_degree`: expand only the first
    use_degree neighbors of each row. `expand_fn`: optional override of the
    adjacency gather + score step, sel_r [B, E] -> (cand_ids, cand_scores)
    with invalid slots (-1, +inf). The visited set is implicit: candidates
    are deduped against the beam, and beam entries carry an expanded flag.

    JAX's while_loop stops once every query is done; this loop always runs
    max_iters iterations and never reads `done` on the host, so a batch on
    the GPU costs no device-to-host sync per hop. The two return the same
    beam: once every query is done, every entry is expanded, so an iteration
    selects no row (sel_r all -1), scores only invalid candidates (-1/+inf)
    and its merge keeps the beam as it was.
    """
    b, s_width = seed_rows.shape
    e = expand
    deg = nbrs.shape[-1]
    if max_iters is None:
        max_iters = max(ef // max(e, 1), 1) + 8

    pad = ef - s_width
    if pad < 0:
        seed_scores, seed_rows = T.smallest_k(seed_scores, seed_rows, ef)
        pad = 0
    beam_s = torch.cat([seed_scores, seed_scores.new_full((b, pad), _INF)], dim=1)
    beam_r = torch.cat([seed_rows, seed_rows.new_full((b, pad), -1)], dim=1)
    beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
    beam_s, beam_r = T.smallest_k(beam_s, beam_r, ef)
    expanded = beam_r < 0   # invalid slots count as expanded
    done = torch.zeros(b, dtype=torch.bool, device=beam_s.device)

    for _ in range(max_iters):
        unexp_s = torch.where(expanded, _INF, beam_s)
        _, pos = T.smallest_k_dense(unexp_s, e)                        # [B, E]
        sel_s = torch.gather(unexp_s, -1, pos)
        sel_r = torch.where(torch.isfinite(sel_s), torch.gather(beam_r, -1, pos), -1)

        # termination: best unexpanded no better than the worst beam slot
        done = done | (sel_s[:, 0] >= beam_s.amax(-1))

        onehot = torch.zeros_like(expanded).scatter_(1, pos, True) & torch.isfinite(unexp_s)
        expanded = expanded | onehot

        if expand_fn is not None:
            cand, c_s = expand_fn(sel_r)
        else:
            cand = nbrs[sel_r.clamp(min=0).long()]                     # [B, E, deg]
            if use_degree is not None and use_degree < deg:
                cand = cand[:, :, :use_degree]
            cand = torch.where((sel_r >= 0)[:, :, None], cand, -1).reshape(b, -1)
            if limit_n is not None:
                cand = torch.where(cand < limit_n, cand, -1)
            c_s = score_rows(cand)
        if dedupe_candidates:
            c_s, cand = T.mask_duplicate_ids(c_s, cand)
        c_s, cand = T.mask_ids_in(c_s, cand, beam_r)

        # merge into the beam, carrying expanded flags (new entries unexpanded)
        all_s = torch.cat([beam_s, c_s], dim=-1)
        all_r = torch.cat([beam_r, cand], dim=-1)
        all_e = torch.cat([expanded, torch.zeros_like(cand, dtype=torch.bool)], dim=-1)
        _, top = T.smallest_k_dense(all_s, ef)
        beam_s = torch.gather(all_s, -1, top)
        beam_r = torch.gather(all_r, -1, top)
        # done queries keep everything expanded, so they do no further work
        expanded = torch.gather(all_e, -1, top) | (beam_r < 0) | done[:, None]
    return beam_s, beam_r
