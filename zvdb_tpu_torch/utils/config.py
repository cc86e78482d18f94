"""Configuration dataclasses for the PyTorch port.

Field names, defaults and validation match zvdb_tpu/utils/config.py, so the
`dataclasses.asdict(cfg)` JSON that either package writes into a save file
loads in the other. Ported so far: the flat and the PQ engines' configs.
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


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product-quantized flat index config (index/pqflat.py, ops/pq.py).

    The memory-scaling engine: n_sub/2 bytes per vector of nibble-packed
    4-bit PQ codes (against D bytes for int8 and 4D for f32), scanned by the
    fused ADC kernel (ops/pq_scan.py, csrc/pq_scan.cu) on the int8 path when
    a CUDA device is present (scan="auto"), then an int16 refine rerank at
    rerank=12: (n_sub/2 + 2*dim + 8) bytes per vector. refine="int8" is the
    most compact refine store, refine="none" the codes alone.
    n_codes=256 keeps classic one-byte codes (decode scan only)."""

    dim: int
    metric: Metric = "l2"
    # Subspace count; codes are n_sub bytes per vector (n_sub/2 nibble-packed).
    n_sub: int = 16
    # Codewords per subspace. <= 16 stores two codes per byte and allows the
    # fused scan (scan="pallas"); 256 keeps one-byte codes (decode scan only).
    n_codes: int = 16
    # Corpus rows per decode-scan tile: the decode materializes [tile, D].
    tile_n: int = 16384
    # Matmul precision of the decode scan ("highest" | "high" | "default").
    precision: str = "high"
    # Kept for save-file parity; the port's decode scan selects exactly.
    recall_target: float = 0.95
    # Refine store for the exact rerank pass: "int16" (2D+4 bytes per vector,
    # per-vector symmetric at +-32767 levels), "bfloat16" (2D), "float32"
    # (4D, exact), "int8" (D+4), "none" (codes only).
    refine: str = "int16"
    # Candidates per result entering the refine rerank (refine != "none").
    rerank: int = 12
    # Codebook training: sample size and Lloyd iterations. Codebooks are
    # trained on the first build/add and frozen; later adds encode against them.
    train_sample: int = 32768
    kmeans_iters: int = 8
    # OPQ: learn an orthogonal rotation before the subspace split
    # (ops/pq.py:train_opq); the refine rerank stays in the original space.
    opq: bool = False
    opq_iters: int = 8
    seed: int = 0
    # Scan implementation for the codes pass. The values are the JAX
    # package's, since save files persist them:
    #   "auto"   - "pallas" when a CUDA device is present and the config suits
    #              the kernel, else "xla"; resolved once, at construction.
    #   "xla"    - the tiled decode scan (any n_codes), exact selection.
    #   "pallas" - the fused ADC kernel (ops/pq_scan.py): LUT sums over the
    #              packed codes and a per-bin top-1/top-2 fold. Requires
    #              n_codes <= 16 and n_sub % 8 == 0. On CPU tensors it runs
    #              the kernel's plain PyTorch version.
    scan: str = "auto"
    # Fused scan precision: "int8" (per-query symmetric LUT quantization,
    # exact integer sums), "default" (bf16-rounded LUT, f32 sums), "high"
    # (hi/lo bf16 split of the LUT, two f32 sums).
    scan_precision: str = "int8"
    # Fused scan: bins per query (>= k*rerank so the refine pool survives),
    # rows kept per bin (1 or 2), and corpus rows per segment pool (a
    # multiple of pallas_chunk; 0 = one pool). pallas_chunk must be a multiple
    # of l_bins; it and pallas_bq are validated as the JAX package does but
    # do not change results (the CUDA kernel picks its own tiling).
    l_bins: int = 1024
    pallas_chunk: int = 1024
    pallas_bq: int = 512
    per_bin: int = 2
    seg_rows: int = 1_048_576

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.dim % self.n_sub != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by n_sub ({self.n_sub})")
        if not 2 <= self.n_codes <= 256:
            raise ValueError("n_codes must be in [2, 256] (codes are uint8)")
        if self.refine not in ("none", "int8", "int16", "float32", "bfloat16"):
            raise ValueError(f"invalid refine {self.refine!r}")
        if self.scan not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"scan must be 'auto', 'xla' or 'pallas', got {self.scan!r}")
        if self.scan == "auto":
            # the resolved value is what dataclasses.asdict persists
            ok = (self.n_codes <= 16 and self.n_sub % 8 == 0
                  and self.pallas_chunk % self.l_bins == 0
                  and self.per_bin in (1, 2)
                  and (self.seg_rows == 0
                       or self.seg_rows % self.pallas_chunk == 0))
            object.__setattr__(
                self, "scan", "pallas" if ok and torch.cuda.is_available() else "xla")
        if self.scan == "pallas":
            if self.n_codes > 16:
                raise ValueError("scan='pallas' requires n_codes <= 16")
            if self.n_sub % 8 != 0:
                raise ValueError("scan='pallas' requires n_sub % 8 == 0")
            if self.pallas_chunk % self.l_bins != 0:
                raise ValueError("pallas_chunk must be a multiple of l_bins")
            if self.per_bin not in (1, 2):
                raise ValueError("per_bin must be 1 or 2")
            if self.seg_rows and self.seg_rows % self.pallas_chunk != 0:
                raise ValueError(
                    "seg_rows must be 0 or a multiple of pallas_chunk")

    @property
    def packed(self) -> bool:
        """Nibble-packed code storage: two 4-bit codes per byte, stored
        transposed [n_sub/2, cap] so a scan reads each code byte row
        contiguously."""
        return self.n_codes <= 16 and self.n_sub % 2 == 0

    @property
    def codes_width(self) -> int:
        return self.n_sub // 2 if self.packed else self.n_sub

    @property
    def dsub(self) -> int:
        return self.dim // self.n_sub

    @property
    def refine_dtype(self) -> torch.dtype:
        return {"int8": torch.int8, "int16": torch.int16, "float32": torch.float32,
                "bfloat16": torch.bfloat16, "none": torch.float32}[self.refine]

    @property
    def bytes_per_vector(self) -> int:
        """Device bytes per vector (codes + norm + refine store)."""
        refine = {"none": 0, "int8": self.dim + 4, "int16": 2 * self.dim + 4,
                  "float32": 4 * self.dim, "bfloat16": 2 * self.dim}[self.refine]
        return self.codes_width + 4 + refine
