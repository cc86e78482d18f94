"""zvdb-tpu on PyTorch and CUDA: the port of `zvdb_tpu` to an NVIDIA H100.

The JAX package `zvdb_tpu` stays the reference; this package imports none of
it and no JAX. It holds the flat, PQ, IVF-PQ, CAGRA, HNSW and IVF-Flat engines
(HNSW whole: insert and flush, the one-shot and batched builds with their
checkpoints, search, persistence), the server in front of them, the engine
router, the host tools (bench harness, datasets and native loader, stats,
profiling), the sweep CLI (`python -m zvdb_tpu_torch.bench.sweep`) and the
sharded engines over a device mesh (`make_mesh`, `make_hybrid_mesh`,
`ShardedFlat`, `ShardedHNSW`, `ShardedPQFlat`, `ShardedIVFPQ`, `ShardedIVF`,
`ShardedCagra`, imported on first use).

    from zvdb_tpu_torch import (HNSW, CagraConfig, CagraIndex, FlatConfig, FlatIndex,
                                HNSWConfig, HNSWState, IVFConfig, IVFIndex, IVFPQConfig,
                                IVFPQIndex,
                                PQConfig, PQFlatIndex, SearchConfig, SearchServer,
                                exact_ground_truth, relative_contrast, suggest_engine)

Entry points run on the GPU (device=None means "cuda") and raise without one
unless the caller passes device="cpu".
"""

from .utils.config import FlatConfig, HNSWConfig, PQConfig, SearchConfig
from .index.hnsw import HNSW, HNSWState
from .index.cagra import CagraConfig, CagraIndex
from .index.flat import FlatIndex, exact_ground_truth
from .index.ivf import IVFConfig, IVFIndex
from .index.ivfpq import IVFPQConfig, IVFPQIndex
from .index.pqflat import PQFlatIndex
from .serve import SearchServer
from .utils.router import relative_contrast, suggest_engine

__all__ = ["HNSW", "CagraConfig", "CagraIndex", "FlatConfig", "FlatIndex", "HNSWConfig",
           "HNSWState", "IVFConfig", "IVFIndex", "IVFPQConfig", "IVFPQIndex", "PQConfig",
           "PQFlatIndex", "SearchConfig", "SearchServer", "exact_ground_truth",
           "make_hybrid_mesh", "relative_contrast", "suggest_engine"]

def __getattr__(name):
    # the sharded engines and the meshes import on first use
    if name in ("make_mesh", "make_hybrid_mesh"):
        from .parallel import mesh

        return getattr(mesh, name)
    if name == "ShardedFlat":
        from .parallel.sharded_flat import ShardedFlat

        return ShardedFlat
    if name == "ShardedHNSW":
        from .parallel.sharded import ShardedHNSW

        return ShardedHNSW
    if name == "ShardedPQFlat":
        from .parallel.sharded_pq import ShardedPQFlat

        return ShardedPQFlat
    if name == "ShardedIVFPQ":
        from .parallel.sharded_ivfpq import ShardedIVFPQ

        return ShardedIVFPQ
    if name == "ShardedIVF":
        from .parallel.sharded_ivf import ShardedIVF

        return ShardedIVF
    if name == "ShardedCagra":
        from .parallel.sharded_cagra import ShardedCagra

        return ShardedCagra
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
