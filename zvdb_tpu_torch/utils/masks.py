"""Allowlist normalization for filtered search (port of zvdb_tpu/utils/masks.py).

An allowlist is the complement of a per-call tombstone mask, so the engine
filters it at the same point it filters deletes.
"""
from __future__ import annotations

import numpy as np
import torch


def allowed_mask(allowed, n_total: int, cap: int, device) -> torch.Tensor:
    """Normalize a user allowlist to a bool[cap] tensor on `device` (True = eligible).

    `allowed`: either a bool mask over external ids (length n_total or cap)
    or an integer array/list of eligible external ids.
    """
    if isinstance(allowed, torch.Tensor):
        allowed = allowed.cpu().numpy()
    a = np.asarray(allowed)
    if a.dtype == bool:
        if a.shape[0] not in (n_total, cap):
            raise ValueError(
                f"allowed mask length {a.shape[0]} != corpus size {n_total}")
        out = np.zeros(cap, bool)
        out[: a.shape[0]] = a
    else:
        a = a.astype(np.int64).ravel()
        if a.size and ((a < 0).any() or (a >= n_total).any()):
            raise IndexError(f"allowed ids must be in [0, {n_total})")
        out = np.zeros(cap, bool)
        out[a] = True
    return torch.from_numpy(out).to(device)
