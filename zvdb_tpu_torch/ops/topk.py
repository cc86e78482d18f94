"""Top-k primitives, smallest score first (port of zvdb_tpu/ops/topk.py).

Convention everywhere: scores are "smaller is better" surrogates (see
ops/distance.py); invalid entries carry +inf and ids carry -1.

`lax.top_k` takes equal scores in position order. `torch.topk` promises no
order and may pick any of several entries tied at the k-th score, so the
selection is repaired here: rows with such a finite tie are re-selected by
a stable sort, and the result is ordered by (score, position). Among +inf
entries the pick stays torch's; every caller maps those to id -1.
"""
from __future__ import annotations

import torch


def smallest_k_dense(scores: torch.Tensor, k: int):
    """k smallest over the last axis of a dense score matrix -> (scores, indices)."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds the last axis ({scores.shape[-1]})")
    lead = scores.shape[:-1]
    flat = scores.reshape(lead.numel(), scores.shape[-1])
    vals, pos = torch.topk(flat, k, dim=-1, largest=False, sorted=False)
    if k:
        kth = vals.amax(dim=-1, keepdim=True)
        tied = (((flat == kth).sum(-1) > (vals == kth).sum(-1))
                & torch.isfinite(kth[:, 0])).nonzero()[:, 0]
        if tied.numel():   # a boundary tie: take the lowest positions, as lax.top_k does
            sv, sp = torch.sort(flat[tied], dim=-1, stable=True)
            vals[tied], pos[tied] = sv[:, :k], sp[:, :k]
    pos, perm = torch.sort(pos, dim=-1)
    vals = torch.gather(vals, -1, perm)
    vals, perm = torch.sort(vals, dim=-1, stable=True)
    pos = torch.gather(pos, -1, perm)
    return vals.reshape(*lead, k), pos.reshape(*lead, k)


def smallest_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row k smallest of (scores [..., C], ids [..., C]) -> ([..., k], [..., k]).

    Invalid slots (+inf / id -1) sort last; a +inf score always has id -1.
    """
    out_scores, pos = smallest_k_dense(scores, k)
    out_ids = torch.gather(ids, -1, pos)
    out_ids = torch.where(torch.isinf(out_scores), -1, out_ids)
    return out_scores, out_ids


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two per-row top-k lists into one top-k list (no dedupe)."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    return smallest_k(s, i, k)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor, *carried: torch.Tensor):
    """Order the last axis by (primary, secondary): a stable sort by the
    second key, then a stable sort by the first. Returns every input in
    that order."""
    _, p = torch.sort(secondary, dim=-1, stable=True)
    _, p2 = torch.sort(torch.gather(primary, -1, p), dim=-1, stable=True)
    p = torch.gather(p, -1, p2)
    return [torch.gather(a, -1, p) for a in (primary, secondary, *carried)]


def sort_smallest_k(scores: torch.Tensor, ids: torch.Tensor, k: int, dedupe: bool = False):
    """Per-row k smallest of (scores [..., C], ids [..., C]) ordered by
    (score, id), as the JAX package's lax.sort over two keys orders them:
    equal scores go to the lower id (not the lower position), and invalid
    slots (+inf / -1) sort last. -0.0 and +0.0 compare equal on both sides.

    dedupe=True keeps only the first of entries with the same id (the one
    with the smallest score): a sort by (id, score) makes them adjacent."""
    idkey = torch.where(ids < 0, 2**30, ids)
    if dedupe:
        sk, ss, si = _lexsort(idkey, scores, ids)
        dup = (sk[..., 1:] == sk[..., :-1]) & (si[..., 1:] >= 0)
        dup = torch.cat([torch.zeros_like(dup[..., :1]), dup], dim=-1)
        scores = torch.where(dup, float("inf"), ss)
        idkey = torch.where(dup, 2**30, sk)
        ids = torch.where(dup, -1, si)
    ss, _, si = _lexsort(scores, idkey, ids)
    out_s, out_i = ss[..., :k], si[..., :k]
    return torch.where(out_i >= 0, out_s, float("inf")), out_i


def bitonic_smallest_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row k smallest via a bitonic sorting network over the last axis
    (padded to a power of two): log^2(C) stages of a fixed lane permutation
    plus compare/select. Exact; ties go to the smaller id, and invalid slots
    (+inf / -1) sort last."""
    c = scores.shape[-1]
    cp = 1 << max(1, (max(c, k) - 1).bit_length())
    if cp > c:
        pad = scores.shape[:-1] + (cp - c,)
        scores = torch.cat([scores, scores.new_full(pad, float("inf"))], dim=-1)
        ids = torch.cat([ids, ids.new_full(pad, -1)], dim=-1)
    idkey = torch.where(ids < 0, 2**30, ids)
    col = torch.arange(cp, device=scores.device)
    size = 2
    while size <= cp:
        stride = size // 2
        while stride >= 1:
            partner = col ^ stride
            take_min = (col < partner) == ((col & size) == 0)
            ps = scores.index_select(-1, partner)
            pi = ids.index_select(-1, partner)
            pk = idkey.index_select(-1, partner)
            less = (scores < ps) | ((scores == ps) & (idkey < pk))
            keep_self = torch.where(take_min, less, ~less)
            scores = torch.where(keep_self, scores, ps)
            ids = torch.where(keep_self, ids, pi)
            idkey = torch.where(keep_self, idkey, pk)
            stride //= 2
        size *= 2
    out_s, out_i = scores[..., :k], ids[..., :k]
    return torch.where(out_i >= 0, out_s, float("inf")), out_i


def mask_duplicate_ids(scores: torch.Tensor, ids: torch.Tensor):
    """Invalidate all but the first occurrence (by position) of each id per
    row; ids [..., C] (-1 = already invalid). An O(C^2) equality matrix: C is
    a beam or candidate width."""
    c = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]                       # [..., C, C]
    earlier = torch.ones((c, c), dtype=torch.bool, device=ids.device).tril(-1)
    dup = (eq & earlier).any(-1) & (ids >= 0)
    return torch.where(dup, float("inf"), scores), torch.where(dup, -1, ids)


def mask_ids_in(scores: torch.Tensor, ids: torch.Tensor, banned: torch.Tensor):
    """Invalidate entries whose id appears in `banned` ([..., K] per-row id list)."""
    hit = (ids[..., :, None] == banned[..., None, :]).any(-1) & (ids >= 0)
    return torch.where(hit, float("inf"), scores), torch.where(hit, -1, ids)
