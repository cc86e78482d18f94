"""HNSW index persistence (port of zvdb_tpu/io/persist.py).

The whole index state (vectors, neighbor tables, levels, entry point,
configs) round-trips through one .npz file with the JAX package's keys,
`meta` JSON and FORMAT_VERSION, so a file written by either package loads in
the other. bf16 vectors are stored as f32 (npz cannot cast its raw bf16
bytes back); tombstones travel as `dead_ext`, sorted external ids.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

FORMAT_VERSION = 1


def save_hnsw(path: str, index) -> None:
    from ..index.hnsw import state_to_numpy

    meta = {
        "format_version": FORMAT_VERSION,
        "cfg": dataclasses.asdict(index.cfg),
        "search_cfg": dataclasses.asdict(index.search_cfg),
        "capacity": index.capacity,
        "levels_cap": index.levels_cap,
        "n_inserted": index._n_inserted,
    }
    arrays = {}
    if index.state is not None:
        arrays = state_to_numpy(index.state)
        if index._dead:
            arrays["dead_ext"] = np.asarray(sorted(index._dead), np.int64)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_hnsw(path: str, device=None):
    """An HNSW index from a save file of either package, on `device`
    (None: "cuda")."""
    from ..index.hnsw import HNSW

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(f"unsupported index format {meta['format_version']}")
        arrays = {f: z[f] for f in z.files if f != "meta"}
    return HNSW.from_numpy(meta["cfg"], arrays, search_cfg=meta["search_cfg"],
                           capacity=meta["capacity"], levels_cap=meta["levels_cap"],
                           n_inserted=meta["n_inserted"], dead_ext=arrays.get("dead_ext"),
                           device=device)
