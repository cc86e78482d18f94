"""zvdb-tpu on PyTorch and CUDA: the port of `zvdb_tpu` to an NVIDIA H100.

The JAX package `zvdb_tpu` stays the reference; this package imports none of
it and no JAX. Ported so far: the flat, PQ, IVF-PQ, CAGRA, HNSW and IVF-Flat engines
(HNSW whole: insert and flush, the one-shot and batched builds with their
checkpoints, search, persistence), the server in front of them, the engine
router, the host tools (bench harness, datasets and native loader, stats,
profiling) and the sweep CLI (`python -m zvdb_tpu_torch.bench.sweep`).

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
           "relative_contrast", "suggest_engine"]
