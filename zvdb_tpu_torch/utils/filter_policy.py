"""Auto filter-mode routing: masked exact scan vs beam/probe by regime (port
of zvdb_tpu/utils/filter_policy.py).

``filter_mode="auto"`` (the engine default) routes per call:

    scan   unless  n >= N_CROSSOVER  and  selectivity >= SEL_NEAR_ALL

The exact masked scan wins at every selectivity <= 50% on the corpora the
JAX package measured; the sublinear beam/probe path is kept for near-all-pass
filters on very large corpora, where filtering is almost a no-op. The corpus
size gate is checked first, so below the crossover no selectivity estimate
(and no device sync) happens. Above it, a bool tensor on the device costs one
scalar `.item()`; host numpy masks and id allowlists are free.

The two constants are copied from the JAX package as provisional: they were
never measured there, and have not been measured on the GPU either.
"""
from __future__ import annotations

import numpy as np
import torch

N_CROSSOVER: int = 4_000_000
SEL_NEAR_ALL: float = 0.90


def mask_selectivity(allowed, n: int) -> float:
    """Fraction of the n live ids the allowlist passes (estimate in [0, 1]).

    allowed: bool mask over ids (numpy or a tensor on any device) or an int
    id array. A bool tensor costs one scalar `.item()`, never a transfer of
    the mask."""
    if n <= 0:
        return 1.0
    if isinstance(allowed, (list, tuple)):
        allowed = np.asarray(allowed)
    if isinstance(allowed, torch.Tensor):
        if allowed.dtype == torch.bool:
            m = allowed[:n]
            return float(m.float().mean().item()) if m.numel() else 1.0
        return min(1.0, allowed.numel() / n)
    a = np.asarray(allowed)
    if a.dtype == np.bool_:
        m = a[:n]
        return float(m.mean()) if m.size else 1.0
    return min(1.0, a.size / n)


def resolve_filter_mode(filter_mode: str, allowed, n: int, alt: str = "beam") -> str:
    """Resolve "auto" to "scan" or the engine's sublinear mode (alt).

    alt is "beam" for the graph engines, "probe" for IVF/IVF-PQ. Explicit
    modes pass through unchanged; callers validate membership themselves.
    """
    if filter_mode != "auto":
        return filter_mode
    if allowed is None or n < N_CROSSOVER:
        return "scan"
    if mask_selectivity(allowed, n) >= SEL_NEAR_ALL:
        return alt
    return "scan"
