"""zvdb-tpu on PyTorch and CUDA: the port of `zvdb_tpu` to an NVIDIA H100.

The JAX package `zvdb_tpu` stays the reference; this package imports none of
it and no JAX. Ported so far: the flat, PQ, IVF-PQ and CAGRA engines, the
server in front of them, the engine router, and the host tools (bench
harness, datasets and native loader, stats, profiling).

    from zvdb_tpu_torch import (CagraConfig, CagraIndex, FlatConfig, FlatIndex,
                                IVFPQConfig, IVFPQIndex, PQConfig, PQFlatIndex,
                                SearchServer, exact_ground_truth,
                                relative_contrast, suggest_engine)

Entry points run on the GPU (device=None means "cuda") and raise without one
unless the caller passes device="cpu".
"""

from .utils.config import FlatConfig, PQConfig
from .index.cagra import CagraConfig, CagraIndex
from .index.flat import FlatIndex, exact_ground_truth
from .index.ivfpq import IVFPQConfig, IVFPQIndex
from .index.pqflat import PQFlatIndex
from .serve import SearchServer
from .utils.router import relative_contrast, suggest_engine

__all__ = ["CagraConfig", "CagraIndex", "FlatConfig", "FlatIndex", "IVFPQConfig", "IVFPQIndex",
           "PQConfig", "PQFlatIndex", "SearchServer", "exact_ground_truth", "relative_contrast",
           "suggest_engine"]
