"""Configuration dataclasses for the PyTorch port.

Field names, defaults and validation match zvdb_tpu/utils/config.py, so the
`dataclasses.asdict(cfg)` JSON that either package writes into a save file
loads in the other. Ported so far: the flat, PQ and HNSW engines' configs
and the HNSW search knobs (SearchConfig).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Metric = str  # "l2" | "dot" | "cosine"

_VALID_METRICS = ("l2", "dot", "cosine")

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Parameters of the HNSW engine (index/hnsw.py, index/build.py)."""

    dim: int
    m: int = 16                    # max neighbors per node per upper layer
    ef_construction: int = 100     # build-time beam width (the batched build's)
    metric: Metric = "l2"
    # Degree of the base layer; canonical HNSW uses 2*M. None -> 2*m.
    m0: Optional[int] = None
    # Level sampling: level = floor(-ln(U) * mL), mL = 1/ln(m) unless set.
    ml: Optional[float] = None
    # Hard cap on hierarchy height. None -> derived from capacity at build time.
    max_level: Optional[int] = None
    # Diversity pruning relaxation (alpha >= 1.0; 1.0 = strict RNG rule).
    alpha: float = 1.0
    # Storage dtype for vectors: float32 | bfloat16 | int8 (per-tensor
    # symmetric codes and one dequant scale, HNSWState.q_scale).
    dtype: str = "float32"
    # Build batch size; the one-shot build rounds capacity up to a multiple.
    build_batch: int = 1024
    # Beam width of the batched build's upper-layer candidate searches.
    ef_construction_upper: int = 32
    # Precision of the products, by the JAX package's names: "high" (bf16x3
    # split), "float32" (plain f32, the port's "highest"), "default" (bf16
    # inputs; the build and the filtered scan take "high" for it).
    precision: str = "high"
    # The batched build's beam expansion width.
    build_expand: int = 8
    # Cap on the candidate pool entering the batched build's pruning. 0 = none.
    select_cap: int = 0
    # Reorder base-layer rows diversity-first after a bulk build, so a
    # truncated-degree search (SearchConfig.search_degree) reads a diverse
    # subgraph instead of the nearest (intra-cluster) edges only.
    diverse_rows: bool = True
    # Bulk-build strategy: "oneshot" (cluster-kNN base layer, kNN graphs over
    # the upper layers' nodes), "batched" (frozen-prefix beam batches, with
    # mid-build checkpoints), "auto" (oneshot unless a checkpoint is asked for).
    build_mode: str = "auto"
    # The batched build's beam at every upper layer (else greedy descent).
    upper_beam: bool = False
    # One-shot build knobs (knn_graph.build_knn_graph): candidates per
    # clustering view, the merged-pool cap entering the prune, the per-block
    # top-k ("approx": ops/approx_topk.py:approx_min_k, the binned kernel on
    # the card and exact on the CPU; "exact"; "binfold"; "pallas": the block
    # scorer kernel) and the Lloyd iterations.
    kc_per_view: int = 16
    prune_cap: int = 64
    block_topk: str = "approx"
    build_kmeans_iters: int = 3

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.m < 2:
            raise ValueError("m must be >= 2")

    @property
    def base_degree(self) -> int:
        return self.m0 if self.m0 is not None else 2 * self.m

    @property
    def storage_dtype(self) -> torch.dtype:
        return _STORAGE[self.dtype]

    @property
    def packed(self) -> bool:
        """One-gather packed (vector | squared norm) search layout: l2 + f32
        only (bf16 would round the norm column; int8 codes cannot carry it)."""
        return self.metric == "l2" and self.dtype == "float32"


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """HNSW search-time knobs."""

    ef_search: int = 64
    # Beam entries expanded per hop.
    expand: int = 8
    # Hops of the layer-0 beam; None -> ef/expand + 8 (hnsw.beam_layer_fn).
    max_iters: Optional[int] = None
    # Max greedy hops per upper layer.
    max_upper_iters: int = 32
    # Expand only the first `search_degree` neighbors of a row (rows are
    # diversity-first with HNSWConfig.diverse_rows); None = the full row.
    search_degree: Optional[int] = 24
    # Exact in-hop candidate dedupe; results are deduped either way.
    dedupe_candidates: bool = True
    # Anchor rows unioned into the layer-0 beam seeds (one [B, A] product
    # against the index's anchor table); 0 = descent-only seeding.
    seed_anchors: int = 16


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
    # Selection recall target of search(approx=True)'s tiled scan: sets the
    # bin count of ops/approx_topk.py:approx_min_k, as of JAX's
    # lax.approx_min_k (on the CPU the selection is exact, as JAX's there).
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
        return _STORAGE[self.dtype]


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
    # Selection recall target of the decode scan under search(approx=True):
    # the bin count of ops/approx_topk.py:approx_min_k (exact on the CPU).
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
