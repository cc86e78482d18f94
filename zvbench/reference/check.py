"""The comparison that decides `correct`, and recall@k.

Every answer the timed path returned is held to the configuration's
guarantees against the plain reference (knn.py):

- `bad_ids`: slots that are not k distinct row ids in [0, N) (limit 0);
- `unsorted`: answers whose returned distances are not nearest first
  (limit 0);
- `dist_err`: the widest gap between a returned distance and the returned
  row's exact squared distance (float64), over ||q|| ||x||, the scale at
  which a product's rounding shows;
- `recall_miss`: 1 - recall@k over every answer, the share of the
  reference's exact k nearest that the answers left out: the returned rows
  have to be near neighbours, not only valid rows at exact distances.

A graph build's edges are held the same way: `bad_edges` (ids outside
[-1, N); -1 pads a short row) and `edge_err` (a stored edge distance against
the exact one). recall@k counts the returned ids that are among the
reference's exact k nearest. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .knn import pair_distances


def _scaled_gap(x, q, ids, dist, valid):
    """max |dist - exact| / (||q|| ||x||) over the valid slots."""
    safe = torch.where(valid, ids, 0)
    exact = pair_distances(x, q, safe)
    qn = q.double().pow(2).sum(-1, keepdim=True)
    xn = x[safe.long()].double().pow(2).sum(-1)
    gap = (dist.double() - exact).abs() / torch.sqrt(qn * xn).clamp(min=1e-30)
    gap = torch.where(valid, gap, torch.zeros_like(gap))
    return float(gap.max()) if gap.numel() else 0.0


def check_answers(x: torch.Tensor, pool: torch.Tensor, gt: torch.Tensor, rows, ids, dists,
                  k: int, block: int = 65536) -> dict:
    """Answers [A, k] (host or device) to the pool queries `rows` [A] ->
    dict(bad_ids, unsorted, dist_err, hits, answered). gt: [P, k] exact ids."""
    n, dev = x.shape[0], x.device
    out = dict(bad_ids=0, unsorted=0, dist_err=0.0, hits=0, answered=0)
    for lo in range(0, len(rows), block):
        r = torch.as_tensor(rows[lo:lo + block], device=dev).long()
        i = torch.as_tensor(ids[lo:lo + block], device=dev).long()
        d = torch.as_tensor(dists[lo:lo + block], device=dev)
        valid = (i >= 0) & (i < n)
        srt = torch.sort(torch.where(valid, i, -1 - torch.arange(k, device=dev)), dim=1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        short = k - i.shape[1]
        out["bad_ids"] += int((~valid).sum()) + int(dup.sum()) + max(short, 0) * i.shape[0]
        out["unsorted"] += int((d[:, 1:] < d[:, :-1]).any(1).sum())
        out["dist_err"] = max(out["dist_err"], _scaled_gap(x, pool[r], i, d, valid))
        out["hits"] += int((i[:, :, None] == gt[r][:, None, :]).any(-1).sum())
        out["answered"] += i.shape[0]
    return out


def check_edges(x: torch.Tensor, rows: torch.Tensor, nbrs: torch.Tensor,
                dists: torch.Tensor) -> dict:
    """A graph's edges of `rows` -> dict(bad_edges, edge_err)."""
    n = x.shape[0]
    nbrs = nbrs.long()
    bad = int(((nbrs < -1) | (nbrs >= n)).sum())
    valid = (nbrs >= 0) & (nbrs < n)
    return dict(bad_edges=bad, edge_err=_scaled_gap(x, x[rows.long()], nbrs, dists, valid))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every value at or under its limit, {name: {value, limit}}); every
    value needs a limit, and a limit without a value (a check this loop
    does not make) is left out."""
    shown = {name: {"value": v, "limit": limits[name]} for name, v in values.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
