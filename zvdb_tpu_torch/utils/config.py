"""Configuration dataclasses for the PyTorch port.

Field names, defaults and validation match zvdb_tpu/utils/config.py, so the
`dataclasses.asdict(cfg)` JSON that either package writes into a save file
loads in the other. Only the flat engine's config is here so far.
"""
from __future__ import annotations

import dataclasses

import torch

Metric = str  # "l2" | "dot" | "cosine"

_VALID_METRICS = ("l2", "dot", "cosine")


@dataclasses.dataclass(frozen=True)
class FlatConfig:
    """Brute-force index config."""

    dim: int
    metric: Metric = "l2"
    dtype: str = "float32"
    # Tile size over the corpus axis for memory-bounded exact search.
    tile_n: int = 131072
    # Matmul precision for scoring: "highest" (plain f32, the exact oracle),
    # "high" (bf16x3 hi/lo split), "default" (bf16-rounded inputs, f32 sums).
    precision: str = "highest"
    # Kept for save-file parity; the port's approximate path selects exactly,
    # so its selection recall is 1 whatever this says.
    recall_target: float = 0.95
    # Approximate-scan implementation for search(approx=True). The values are
    # the JAX package's, since they are persisted in save files:
    #   "xla"    - the tiled PyTorch scan: score a corpus tile with one matmul,
    #              keep its top-k, merge into the running top-k (default).
    #   "pallas" - the hand-written fused scan kernel (ops/flat_scan.py,
    #              csrc/flat_scan.cu): scoring + bin-parallel partial top-k,
    #              scores never reach device memory. f32/bf16 storage only
    #              (int8 takes the tiled scan). Selection recall
    #              ~= L/k*(1-(1-1/L)^k) via l_bins.
    scan: str = "xla"
    # Fused scan: number of per-query bins (>= k; 256 ~= 0.983 selection
    # recall at k=10). pallas_chunk must be a multiple of l_bins; it and
    # pallas_bq are validated as the JAX package does but do not change
    # results (the CUDA kernel picks its own tiling).
    l_bins: int = 256
    pallas_chunk: int = 2048
    pallas_bq: int = 512
    # Two-pass approx search: scan at `scan_precision` keeping rerank*k
    # candidates, then rescore them against the stored vectors in f32.
    # 0 = off.
    rerank: int = 0
    scan_precision: str = "default"
    # PCA-filtered first pass: scan the corpus projected onto its top pca_dim
    # principal directions, then rerank the survivors exactly in full
    # dimension. Requires rerank > 0; takes the tiled scan. 0 = off.
    pca_dim: int = 0

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.scan not in ("xla", "pallas"):
            raise ValueError(f"scan must be 'xla' or 'pallas', got {self.scan!r}")

    @property
    def storage_dtype(self) -> torch.dtype:
        # int8: symmetric per-vector quantized codes + f32 scales (state.scales)
        return {
            "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
        }[self.dtype]
