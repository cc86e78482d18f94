"""Index statistics & memory accounting (port of zvdb_tpu/utils/stats.py).

The reference's benchmark notes estimate HNSW memory overhead at ~1.4% over raw
vectors (reference benchmarks/benchmark.md:121-144) without ever measuring it;
these helpers report the actual numbers for any engine state.

The port's states are dataclasses of tensors with a host-int `n` (and, for
CAGRA and HNSW, a host-float `q_scale`; HNSW's `entry` and `max_level` are
host ints too) where JAX keeps device scalars. Each such host
scalar counts 4 bytes, as JAX's int32 / f32 scalars do, so the totals agree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _state_bytes(state) -> Dict[str, int]:
    out = {}
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        if isinstance(v, torch.Tensor):
            out[field.name] = v.numel() * v.element_size()
        elif isinstance(v, (int, float)):
            out[field.name] = 4   # JAX's int32 / f32 device scalar
        else:
            out[field.name] = 0
    return out


def index_stats(index: Any) -> Dict[str, Any]:
    """Engine-agnostic stats: memory by component, overhead vs raw vectors,
    and (for the graph engines) degree and level distributions."""
    st = getattr(index, "state", None)
    if st is None:
        return {"n": len(index), "total_bytes": 0}
    comp = _state_bytes(st)
    total = sum(comp.values())
    stats: Dict[str, Any] = {
        "n": len(index),
        "total_bytes": total,
        "component_bytes": comp,
    }

    raw = None
    if "vectors" in comp:
        raw = comp["vectors"]
    elif "blocks" in comp:
        raw = comp["blocks"]
    if raw:
        stats["overhead_vs_raw"] = (total - raw) / max(raw, 1)

    # graph structure (HNSW nbr0 and levels, CAGRA nbrs)
    if hasattr(st, "nbr0") or hasattr(st, "nbrs"):
        n = int(st.n)
        table = st.nbr0 if hasattr(st, "nbr0") else st.nbrs
        nbr0 = table[:n].cpu().numpy()
        deg = (nbr0 >= 0).sum(axis=1)
        stats["degree"] = {
            "mean": float(deg.mean()) if n else 0.0,
            "min": int(deg.min()) if n else 0,
            "max": int(deg.max()) if n else 0,
            "isolated": int((deg == 0).sum()),
        }
        if hasattr(st, "levels"):
            lv = st.levels[:n].cpu().numpy()
            lv = lv[lv >= 0]
            stats["levels_hist"] = np.bincount(lv).tolist() if lv.size else []
            stats["max_level"] = int(st.max_level)
    if hasattr(st, "counts"):  # IVF
        counts = st.counts.cpu().numpy()
        # as in JAX: IVF-PQ's state has no `blocks`, so this raises
        # AttributeError for it (a fault of the reference, kept)
        cap = st.blocks.shape[-2]
        stats["clusters"] = {
            "count": int(counts.shape[0]),
            "fill_mean": float(counts.mean()),
            "fill_max": int(counts.max()) if counts.size else 0,
            "capacity": int(cap),
            "pad_waste": 1.0 - float(counts.sum()) / max(counts.shape[0] * cap, 1),
        }
    return stats
