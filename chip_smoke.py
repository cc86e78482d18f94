#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zvdb_tpu_torch) on one GPU.

    python3 chip_smoke.py              # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse   # tiny sizes on the CPU (plain versions, no kernel)

Phases, in order; any failure raises and the script exits non-zero:
  1. device     - the card's name, count and power limit (nvidia-smi);
  2. build      - nvcc builds the nine sources under zvdb_tpu_torch/csrc/
                  for sm_90a, all at once: flat_scan_mma.cu (kernel A
                  "default"/"high" on the tensor cores), flat_scan.cu (A's
                  and D's "highest" on the CUDA cores), pq_scan.cu (B's
                  CUDA-core route and C), pq_scan_mma.cu (B int8 on the
                  tensor cores), scan_topk_mma.cu (E and F, their
                  tensor-core filters and exact re-scoring), scan_topk.cu
                  (the CUDA-core E and F), hop_scores.cu (G), block_bins.cu
                  (D on the tensor cores) and approx_topk.cu
                  (lax.approx_min_k), each with its ptxas registers and
                  spills;
  3. compare    - each kernel against its plain PyTorch version: flat_scan
                  over a grid of shapes, every precision and metric, f32
                  and bf16 storage, tie-aware ("default" and "high" on the
                  tensor cores, launches_mma counted), the tie rule in
                  every precision; pq_scan over every precision x {l2, dot} x
                  per_bin {1, 2} x {one pool, segment pools}, invalid rows,
                  ragged N, B=1 and duplicated codes, int8 also at n_sub 8,
                  32 and 64, L=100 and L < 64 (int8 on the tensor cores,
                  launches_mma counted: equal ids and scores; default/high
                  on the CUDA cores: tie-aware); pq_grouped_scan over
                  every precision x {l2, dot} x per_bin {1, 2}, cap no
                  multiple of L, tombstoned rows, empty slots and empty slot
                  tiles, qcap 32 and 64, B=1, a 64 KB table, duplicated
                  codes, and the main path's geometry; pq_grouped_scan_pairs
                  (the IVF-PQ search's scan into per-query pools) over every
                  precision x {l2, dot} x per_bin {1, 2} on the engine's slot
                  tables with a hot cluster past q_cap, slot windows, B=1,
                  cap < L, an unstaged cluster and the ivfpq_1m geometry
                  ("int8" pools equal with torch.equal; every precision read
                  back into slots and held tie-aware to kernel C's plain
                  bins; uncovered pools all +inf / -1);
  4. main       - the flat_1m_pallas configuration (1M x 128d synthetic SIFT
                  stand-in, rerank=4, scan="pallas", l_bins=1024) searched in
                  batches of 2048 through the kernel, recall@10 against the
                  port's exact f32 search, launch counts read; then the
                  single-pass kernel path (rerank=0, precision="high"); on
                  both, launches == launches_mma == batches (every batch
                  through the tensor-core kernel);
  5. server     - a SearchServer over that index answers 8 threads' requests
                  with the batched search's ids;
  6. times      - kernel A on the main path's inputs against its plain
                  version and against the CUDA-core kernel (called
                  directly) in "default" and "high"; 100 calls each of both
                  routes in both precisions, the plain version, the f32 and
                  bf16 torch.matmul yardsticks and the three bf16 products
                  of "high", the bound with its operation, fold and byte
                  terms; QPS of search and of the server, peak device
                  memory, and a torch.profiler breakdown of a search batch;
  7. pq main    - the pq_1m configuration (the same corpus and queries,
                  PQConfig(dim=128) defaults: 4-bit n_sub=16 codes, int8 ADC
                  scan through the kernel, int16 refine, rerank=12) built
                  (points/s, peak device memory) and searched in batches of
                  2048, launch counts (every batch through the tensor-core
                  kernel: launches_mma == batches) and recall@10 read; the
                  kernel on the main path's own inputs against its plain
                  version, and int8 against the CUDA-core kernel;
  8. pq server  - a SearchServer over the PQ index, as in phase 5;
  9. pq times   - the PQ kernel in every precision over 100 calls each
                  (int8 on the tensor cores and, called directly, on the CUDA
                  cores), its plain version, the torch._int_mm and bf16
                  matmul yardsticks, bound (with the fold's term), search and
                  server QPS, and a torch.profiler breakdown of a search
                  batch (kernel time by name, the device's busy share);
 10. ivfpq main - the ivfpq_1m configuration (the same corpus and queries,
                  IVFPQConfig(dim=128) defaults: ~4096 clusters, 4-bit
                  n_sub=16 codes, int8 pair scan, int16 refine; search
                  nprobe=8, rerank=12) built (points/s, peak device memory,
                  a traced build's stages) and searched in batches of 2048,
                  launch counts (the pair scan once per batch, nothing else)
                  and recall@10 read; the pair scan on the main path's own
                  table and slots against its plain version in every
                  precision, kernel C there in int8, and the pair scan with
                  a cluster past q_cap (4 x q_cap queries probe it);
 11. ivfpq server - a SearchServer over the IVF-PQ index, as in phase 5;
 12. ivfpq times - the previous route (kernel C + the slot scatter) driven
                  over every batch (kernel C's launches), the pair scan and
                  kernel C in every precision on the first batch's inputs,
                  the previous route, both plain versions, the torch.bmm
                  yardstick, the bound recounted by what the batch needs
                  (pools, stored rows, table, slots; live int8 operations)
                  beside the TPU's count, peak device bytes of the pair
                  scan, the previous route and a search batch, profiles of
                  the pair scan's and the previous route's parts, search
                  and server QPS, and a torch.profiler breakdown of a search
                  batch;
 13. block compare - kernel D (block_bins, the graph build's block scorer:
                  "high" and "default" on the tensor cores, block_bins.cu;
                  "highest" on the CUDA cores, the second entry point of
                  flat_scan.cu) against its plain
                  version over every precision x {l2, dot} with invalid
                  slots and a ragged B, B < L, the tie rule (duplicated
                  rows: the lower column wins, the own column never) and the
                  main path's shape [12, 1640, 128], tie-aware;
 14. cagra main - the cagra_1m configuration (the same corpus and queries,
                  CagraConfig(dim=128, degree=32, n_anchors=250000,
                  search_degree=24, max_iters=4, ef_search=12,
                  block_topk="pallas")) built from rows on the device
                  (points/s, peak device memory, kernel D's launches per
                  build against ceil(c_blocks/cc) summed over the passes,
                  all of them on the tensor cores, a traced build's
                  stages) and searched in batches of 2048
                  (recall@10 >= 0.95, approx_min_k once a batch for the
                  seed anchors over kernel A's bins, A once a batch on the
                  tensor cores, no other kernel, an ef sweep); kernel A
                  on the index's own seed operand (a batch of 2048 by the
                  250,000 anchors at approx_min_k's L) against its plain
                  version at "high" and "default"; kernel D on the
                  build's own first chunk against its plain version in
                  every precision;
 15. cagra server - a SearchServer over the CAGRA index, as in phase 5
                  (answers may differ from the batched search on near-ties
                  only: cuBLAS picks its kernels by batch size);
 16. cagra times - kernel D in every precision at the build's shape, the
                  previous kernel D (CUDA cores) at "high" and "default"
                  called directly, its plain version, the torch.bmm
                  yardsticks (one bf16 product, the three of the split),
                  achieved TFLOP/s, bound, search and
                  server QPS, one beam hop's scoring as CAGRA runs it (the
                  packed [N, 129] table gathered at [2048, 96] rows, at the
                  config's precision), and a torch.profiler breakdown of a
                  search batch;
 17. scan compare - kernels E and F (the exact flat top-k scans
                  flat_topk_pallas and flat_topk_pallas2, both on the tensor
                  cores, csrc/scan_topk_mma.cu) against their plain version
                  over {l2, dot} x chunk {256, 2048} x k {1, 10, 100}, a
                  ragged N, B=1, N < k, N < chunk, k=256 at chunk=4096,
                  D=1024, D=33 on a misaligned x, B=17, an overflowing
                  candidate list (600 duplicates of query 0's nearest row and
                  100 rows 1 ulp away, k=100), rows of norm ~1e3 around a
                  query near the origin, and the main path's width,
                  tie-aware; on every case E == F == the CUDA-core E == the
                  CUDA-core F (called uncounted) with torch.equal, and both
                  filters' counts on the overflow (where a list of each must
                  overflow), far and k=256 cases; the 40-equal-rows tie probe
                  id for id;
 18. scan main  - the exact top-10 of every query over the 1M x 128d corpus
                  through E, then F, in batches of 2048 at their defaults:
                  launches == launches_mma == batches for E and for F, E ==
                  F bit for bit, recall@10 >= 0.999 against phase 4's exact
                  search (every other id a near-tie), each kernel on the
                  first batch against its plain version and its CUDA-core
                  form bit for bit; ms per batch of E (100 calls) and the
                  CUDA-core E (100), F (20) with its pre-pass, pairs pass
                  (filter and select passes) and fold apart, the CUDA-core F
                  (10) with its two passes, E and F at B=128 (20 each), the
                  pre-pass's share, both filters' counts, the corpus bytes
                  the query tiles read, the plain version, the product +
                  selection yardstick, the bounds (the f32 function; E's and
                  F's own work);
 19. hop        - kernel G (fused_hop_scores, csrc/hop_scores.cu), both
                  routes (direct; grouped: the counting pass into row-window
                  order, then the scorer) against the plain version (gather +
                  einsum) at small shapes with duplicated ids, two ids
                  outside [0, N) (NaN) and corpora of 5000 and 7 rows, and
                  the counting pass (window_order) equal to its plain
                  version; then over the corpus at the experiment's shape
                  (B=4992, K=256) and the cagra_1m hop (B=2048, K=128 of
                  which 96 live), each through the route the wrapper chooses:
                  launches == hops and the grouped count == the hops routed
                  there; each route's ms (20 calls, through the wrapper and
                  its entry point alone) and share of the bound (the bytes of
                  each distinct row once, ids, q and output), the counting
                  pass's entry point alone, the shipped route beside the old
                  kernel's times (PERF.md), plain and gather alone;
 20. hnsw main  - the hnsw_1m configuration (the same corpus and queries,
                  HNSWConfig(dim=128, m=16, ef_construction=100,
                  build_batch=8192, block_topk="pallas"), SearchConfig()
                  defaults) built by the one-shot build from rows on the
                  device: kernel D's launches for the build (all on the
                  tensor cores, equal to the base layer's sum of
                  ceil(c_blocks/cc); none during search), peak device
                  memory, the level histogram and max_level, an ef sweep
                  over {16, 24, 32, 48, 64, 96} on the first 2048 queries
                  (the first ef with recall@10 >= 0.95, else 128, as
                  bench.py's hnsw row), recall over all queries; two timed
                  builds and a traced one (stage seconds); kernel D on the
                  base layer's own first chunk against its plain version;
 21. hnsw server - a SearchServer over the HNSW index, as in phase 15;
 22. hnsw times - search and server QPS at that ef, one batch taken apart
                  (the greedy descent with a host check after every hop and
                  with all 32 hops unsynced, the anchor seeds, the beam), a
                  torch.profiler breakdown of a search batch, 1% of ids
                  removed (none may come back), a filter on even ids in
                  "scan" (equal to the masked exact search) and "beam"
                  modes, and a save/load round trip of a 100k-row index
                  (ids equal after load);
 23. hnsw insert - the one-shot build over the first 99% of the corpus,
                  then the last 1% (10,000 rows, external ids = corpus
                  rows) through insert() in requests of 100: the
                  build_batch threshold flushes once (two batch steps and
                  a capacity growth, 991,232 -> 1,982,464), an explicit
                  flush() traced takes the rest (one batch: its stage
                  seconds); insert rows/s, each flush's seconds with the
                  growth apart, peak device memory, recall@10 over all
                  queries at phase 20's ef beside phase 20's, the recall of
                  the queries drawn from inserted rows, self-hit@1 of the
                  inserted rows (>= 0.95), search QPS; no kernel launched
                  by insert or flush, no isolated node, len == 1M;
 24. hnsw batched - the hnsw_1m configuration with build_mode="batched"
                  over every row on the device, built once and traced:
                  points/s beside phase 20's one-shot, the stage seconds
                  summed over the batches (descent, base beam, intra,
                  base select + reverse, upper layers), levels, peak device
                  memory, the ef sweep and recall over all queries (>= 0.95
                  at some ef <= 128); no kernel launched, no isolated node;
 25. hnsw checkpoint - at 100k rows, the batched build direct, with a
                  checkpoint every 4 batches and resumed from it (nbr0
                  equal in all three), and the one-shot build direct,
                  with its base-layer checkpoint and resumed (nbr0, nbrU,
                  a_rows, levels, entry, max_level equal); seconds and
                  file sizes (written under build/ and deleted);
 26. ivf carry  - a 4,000-row IVF index built on the CPU and carried by
                  from_numpy onto the card and onto the CPU: ids equal from
                  both, f32 blocks and int8 + rerank, at B=8 (the pair scan)
                  and B=512 (the grouped scan); the pair scan's cut runs
                  approx_min_k on the card where cap >= 4 kk, and the CPU
                  side then selects with its plain version;
 27. ivf main   - the ivf_1m configuration (the bench.py ivf row at 1M:
                  IVFConfig(dim=128, n_clusters=1024, nprobe=8,
                  kmeans_iters=4, kmeans_sample=65536), f32 blocks): builds
                  from host and from device rows (points/s, 2 runs each
                  after a warm-up, then one traced each), the nprobe sweep
                  {2, 4, 8} (recall@10, the scan taken, QPS, peak device
                  memory; the first with recall >= 0.95 is kept;
                  approx_min_k once a pair-scan call whose cap >= 4 kk, no
                  other kernel), the pair (its cut taken exactly) and
                  grouped scans held together on the same probes at each
                  nprobe (the share q_cap drops), a
                  torch.profiler breakdown, a server, filtered search (1%
                  and 50% allowlists, scan and probe modes) and search_range
                  against the flat oracle, and 1% of the rows added to an
                  index over the rest through the O(new) append (rows/s,
                  recall, self-hit@1 >= 0.95);
 28. ivf int8   - the ivf_1m_int8 configuration (IVFConfig(dim=128,
                  dtype="int8", rerank=4, kmeans_iters=6), clusters by the
                  default rule): build, the nprobe sweep {4, 8, 16}
                  (approx_min_k for the probes, C >= 4096, and the pair
                  scan's cut, counted), both scans held together, a
                  profile, 1% removed (none comes back) and compact, timed;
 29. ivf checkpoint + sweep - at 100k rows, the int8 + rerank build direct,
                  with its plan checkpoint and resumed (every field equal)
                  and a save/load round trip (ids equal; files under build/
                  and deleted); then `python -m zvdb_tpu_torch.bench.sweep`
                  at d=128, 100k points, 10k queries for --engine ivf (k 10,
                  25, 50, 100), flat and hnsw (k 10), their JSON rows;
 30. sharded flat - sharded_flat_1m: ShardedFlat(FlatConfig(dim=128,
                  precision="highest")) over 4 shards placed on the one card
                  (make_mesh cycles the devices), built from host rows
                  (seconds, live_buffer_bytes after the build): approx=False
                  ids equal to the single-chip exact FlatIndex's up to ties
                  over every query; approx=True (the default: approx_min_k
                  a shard, 4 launches a batch) against its own run with
                  the kernel's plain version (scores, ids up to ties),
                  each id's f64 distance against its score, and recall@10
                  against approx=False at the bins' bar; QPS and each
                  shard's and the merge's ms a batch (synced utils/profiling
                  phases) for both, in turns, torch.profiler breakdowns of
                  both; then 1% removed and a 10% allowlist against the
                  oracle with the same tombstones (approx=False; approx=True
                  held as above), and search_range counts bracketed by the
                  oracle's; no other kernel launched;
 31. sharded hnsw - sharded_hnsw_1m: hnsw_1m's HNSWConfig(dim=128, m=16,
                  ef_construction=100, build_batch=8192) over 4 shards on
                  the card, built by the batched step (points/s beside
                  phases 24 and 20), the ef sweep {16, ..., 96} over all
                  queries (recall@10, QPS; the first ef with recall >= 0.95
                  is kept, else the phase fails), QPS, the per-shard and
                  merge ms, one batch under utils/profiling.trace (each
                  span's wall and busy ms, the device's idle share); phase
                  30's 1% removed (none comes back) and a 10% allowlist in
                  filter_mode="scan" (the sharded masked scan) against the
                  exact FlatIndex up to ties; then a build over 99% of the
                  rows and the last 1% inserted in requests of 100, flushed
                  with anchor seeding (self-hit@1 >= 0.95) and with JAX's
                  descent-only seeding (seed_anchors=0); no kernel launched;
 32. sharded persist + sweep - ShardedHNSW and ShardedFlat at 100k over 4
                  shards: save/load round trips (ids equal; files under
                  build/ and deleted); `python -m zvdb_tpu_torch.bench.sweep
                  --engine hnsw --devices 4` at d=128, 100k points, 10k
                  queries (its rows count one device); and
                  utils/router.suggest_engine on 20,000 corpus rows (its
                  answer must follow its contrast);
 33. sharded pq - sharded_pq_1m: pq_1m's PQConfig over 4 shards on the card
                  (codes nibble-packed a shard, as kernel B reads them),
                  built from host rows (points/s, live_buffer_bytes);
                  searched in batches: kernel B exactly 4 launches a batch,
                  all on the tensor cores, nothing else launched; recall@10
                  >= 0.95 and >= phase 7's minus 0.005; QPS, the per-shard
                  and merge ms, one traced batch (the idle share); kernel B
                  on shard 0's own inputs against its plain version in
                  every precision, int8 also against the CUDA-core kernel;
                  1% removed (none comes back) and a 10% allowlist;
 34. sharded ivfpq - sharded_ivfpq_1m: ivfpq_1m's IVFPQConfig over 4
                  shards (one single-chip build, then the clusters placed
                  largest first on the least-loaded shard), the build timed
                  whole and in its two parts; searched at nprobe=8,
                  rerank=12: the pair scan exactly 4 launches a batch and
                  nothing else; recall@10 >= 0.95 and >= phase 10's minus
                  0.005; QPS, per-shard and merge ms, one traced batch; the
                  pair scan on shard 0's own slots, blocks and table against
                  its plain version in every precision; a 1% allowlist in "scan" (the exact masked scan,
                  against the masked truth up to ties) and "probe" modes;
                  remove 1% and compact, timed; 10,000 and 1,000 rows added
                  to a build over 99% (rows/s, the path taken, self-hit@1 >=
                  0.95);
 35. sharded pq persist - both engines at 100k: save/load round trips
                  (ids equal; files under build/ and deleted), each file
                  loaded onto CPU devices too (the plain kernels: ids equal
                  to the card's up to ties), and ShardedIVFPQ == the
                  single-chip IVFPQIndex on an exhaustive pool on the card
                  (the single chip's filtered scan selecting exactly);
 36. sharded ivf - sharded_ivf_1m: ivf_1m's IVFConfig over 4 shards (one
                  single-chip build, then the clusters placed largest first
                  on the least-loaded shard), the build timed whole and in
                  its two parts; global nprobe {2, 4, 8}: recall@10, QPS,
                  the local probes, the scan each shard takes (pair or
                  grouped) and the probe pairs the grouped scan's q_cap
                  drops, per-shard and merge ms; one traced batch (the idle
                  share); no kernel launched (every shard takes the grouped
                  scan, C_loc < 4096); recall@10 >= 0.95 and >=
                  phase 27's minus 0.005 at nprobe 8; a 1% allowlist in
                  "scan" (against the exact filtered truth up to ties) and
                  "probe"; remove 1% (none comes back) and compact, timed;
                  1,000 and 10,000 rows added to builds over 99% (rows/s,
                  the path taken, the host routing's seconds, self-hit@1 >=
                  0.95); then sharded_ivf_1m_int8 (phase 28's config) at
                  nprobe 4: recall@10 >= 0.95, QPS, the probe filter,
                  approx_min_k once a shard a call (the pair scan's cut);
 37. sharded cagra - sharded_cagra_1m: cagra_1m's CagraConfig over 4 x
                  250,000 rows, the shards' graphs built together by
                  build_knn_graph_multi (seconds, points/s beside phase
                  14's, peak device memory; kernel D's launches equal to
                  the shards' sum of ceil(c_blocks/cc), all on the tensor
                  cores), D on shard 0's own first chunk against its plain
                  version in every precision; searched in batches of 2048
                  (recall@10 >= 0.95 beside phase 14's, QPS, per-shard and
                  merge ms, a traced batch, approx_min_k and kernel A
                  once a shard a call for the seed anchors, no other
                  kernel), kernel A on shard 0's seed operand against its
                  plain version as in phase 14; 1% removed
                  (none comes back), a 10% allowlist in "scan" (against the
                  exact FlatIndex with the same tombstones, up to ties) and
                  "beam"; the last 1% inserted in requests of 100 into a
                  build over the rest (rows/s, the growth and the reseed if
                  they happen, self-hit@1 >= 0.95);
 38. sharded ivf/cagra persist - both engines at 100k: save/load round
                  trips (files under build/ and deleted), each file loaded
                  onto CPU devices too (ids equal to the card's up to
                  ties; the CPU's approx_min_k sites take its plain
                  version), ShardedIVF == the single-chip IVFIndex on an
                  exhaustive pool (the single chip's filtered scan selecting
                  exactly, as the sharded masked scan does), and
                  build_knn_graph_multi ==
                  build_knn_graph shard by shard (nbrs equal), on the card;
 39. bench_cuda - bench_cuda.py's rows (bench.py's nine: flat, pq_1m,
                  ivfpq_1m, cagra_1m, ivf, cagra, hnsw, flat_1m,
                  flat_1m_pallas) at ZVDB_BENCH_SMOKE sizes (20k and 60k rows
                  at 128d, 2,000 queries) through its `run`: exit code 0,
                  every row with bench.py's keys in the last emitted line,
                  recall@10 >= 0.99 on flat_1m and flat_1m_pallas and, on
                  flat, approx_min_k's expected selection recall less 4
                  standard errors; kernels A and B (launches_mma) and the
                  pair scan (launches) risen by their rows' search calls
                  (A also by the CAGRA rows' seed bins,
                  bench_cuda.cagra_rows_seed_bins),
                  approx_min_k by what each row checked, C, D, E and F not
                  at all;
 40. approx     - approx_min_k (ops/approx_topk.py, csrc/approx_topk.cu)
                  against its plain version, positions and value bits
                  equal, over a grid (ties, +-0.0, +inf rows, N <= 128,
                  k = L = N, rank 3, rows whose windows split over blocks,
                  L up to 11,776) and at nine site operands at full size
                  (CAGRA's seeds twice: the [B, A] scores and the bins),
                  each timed beside torch.topk and smallest_k_dense with its
                  byte bound; bench.py's flat row (100k x 128d, 10,000
                  queries in one batch) as the main path: one launch,
                  recall@10 against the exact f32 search, QPS with the
                  kernel and with exact selection in turns, a profile, the
                  kernel on the batch's own tile; the flat_1m row the same
                  way; then each site's launches where JAX's guard holds
                  and none where it fails (flat tiles and two-pass,
                  ShardedFlat, the PQ and sharded PQ decode scans, IVF's
                  probes and pair cut, CAGRA's block cut and seeds, with
                  kernel A's bins under them at "high" and not at
                  "highest").
The last two lines are the kernels' JSON record and the device JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

K = 10
BATCH = 2048
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core rate, operations/s
PEAK_INT8 = 1979e12    # H100 SXM dense int8 tensor-core rate, operations/s
PEAK_F32 = 67e12       # H100 SXM f32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
CUDA_CORE_INSTR_S = PEAK_F32 / 2   # lane-instructions/s outside the tensor cores (132 SMs x 128 lanes x 1.98 GHz)
FOLD_INSTR = 9         # CUDA-core instructions per score of kernel B's fold (per_bin=2)
FOLD_INSTR_A = 5       # per score of kernel A's fold: fma, compare, two selects, the row id


class Ctx:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.device = torch.device("cpu" if rehearse else "cuda")
        # full size on the card; a tiny stand-in when rehearsing on the CPU
        self.n = 20_000 if rehearse else 1_000_000
        self.dim = 16 if rehearse else 128
        self.nq = 600 if rehearse else 10_000
        self.clusters = 200 if rehearse else 10_000
        self.l_bins = 128 if rehearse else 1024
        self.batch = 256 if rehearse else BATCH
        self.card = "cpu rehearsal"
        self.pairs_unstaged = None   # phase 12's A/B variant of the pair scan (phase_build)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def time_ms(self, fn, reps: int, warmup: int = 1) -> float:
        """Mean ms per call: CUDA events around `reps` calls after warm-up."""
        for _ in range(warmup):
            fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def report(self, what: str, value):
        print(f"{what}: {value}  [{self.card}]", flush=True)


def phase_device(ctx: Ctx):
    if ctx.rehearse:
        print("device: cpu (rehearsal)")
        return
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ctx.card = smi
    ctx.kind, ctx.count = name, count
    print(f"device: {name} count={count} capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi, flush=True)


def phase_build(ctx: Ctx):
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import block_scan as BS
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import hop_scores as HS
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops import scan_topk as ST

    if ctx.rehearse:
        print("build: skipped (rehearsal)")
        return
    t0 = time.perf_counter()
    with ThreadPoolExecutor(10) as pool:   # one nvcc per source, started together
        unstaged = pool.submit(build_pairs_unstaged)
        for fut in [pool.submit(fn) for fn in (FS.build_mma, FS.build, PS.build, PS.build_mma,
                                               ST.build_v1, ST.build_v1_mma, HS.build,
                                               BS.build_mma, AK.build)]:
            fut.result()
        ctx.pairs_unstaged = unstaged.result()
    PS.build_grouped()                    # kernel C: the second entry point of pq_scan.cu
    PS.build_pairs()                      # the pair scan: its third entry point
    BS.build()                            # kernel D "highest": flat_scan.cu's second entry point
    ST.build_v2_mma()                     # kernel F: the second entry point of scan_topk_mma.cu
    ST.build_v2_passes()                  # the CUDA-core F, scan_topk.cu's, for comparison
    ctx.report("build seconds (flat_scan_mma.cu, flat_scan.cu, pq_scan.cu, pq_scan_mma.cu, "
               "scan_topk.cu, scan_topk_mma.cu, hop_scores.cu, block_bins.cu and "
               "approx_topk.cu in parallel, with phase 12's unstaged pair scan; eight kernels, "
               "thirteen entry points)", round(time.perf_counter() - t0, 2))
    for info in (FS.build_info_mma, FS.build_info, PS.build_info, PS.build_info_mma,
                 ST.build_info, ST.build_info_mma, HS.build_info, BS.build_info, AK.build_info):
        print(f"  {os.path.basename(info['path'])}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


def _rounded_dot64(q, rows, precision):
    """q [b, D] . rows [b, L, D] -> [b, L] in f64, over the operands as
    `precision` rounds them (the exact sum of the rounded products)."""
    from zvdb_tpu_torch.ops import distance as D

    out = 0
    for a, r in D._operand_pairs(q, rows, precision):
        out = out + (a.double()[:, None, :] * r.double()).sum(-1)
    return out


def check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi, label):
    """Tie-aware agreement of kernel bins (ks, ki) with plain bins (ps, pi).

    Scores agree within rtol 1e-5 ("highest"), 1e-5 of the score scale
    ("high") or 1e-3 of it ("default"), the scale being the largest finite
    |plain score|: the two sum the same exact products in other orders, and
    "high" is held to f32 sum-order error, far below what dropping its
    hi.lo and lo.hi products would cost. Each kernel id lies in its bin and
    names a valid row, and that row's score recomputed in f64 is within the
    same tolerance of the bin minimum the kernel reports. Returns the
    largest |kernel - plain|."""
    n = x.shape[0]
    f = 2.0 if metric == "l2" else 1.0
    empty_k, empty_p = ki < 0, pi < 0
    if not torch.equal(empty_k, empty_p):
        raise AssertionError(f"{label}: empty bins differ ({int((empty_k != empty_p).sum())})")
    fin = ~empty_p
    if not bool(torch.isinf(ks[empty_k]).all()):
        raise AssertionError(f"{label}: an empty bin has a finite score")
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0

    def tolerance(ref):
        if precision == "highest":
            return 1e-5 * ref.abs() + 1e-6 * scale
        return torch.full_like(ref, (1e-5 if precision == "high" else 1e-3) * scale)

    diff = (ks - ps).abs()[fin]
    if bool((diff > tolerance(ps[fin])).any()):
        raise AssertionError(f"{label}: bin scores differ by up to {float(diff.max())}")
    bins = torch.arange(l_bins, device=ki.device).expand_as(ki)
    ids = ki.long()
    if not bool(((ids[fin] % l_bins) == bins[fin]).all()) or bool((ids[fin] >= n).any()):
        raise AssertionError(f"{label}: an id lies outside its bin")
    if not bool(torch.isfinite(norms[ids[fin]]).all()):
        raise AssertionError(f"{label}: an id names an invalid row")
    step = max(1, (1 << 18) // l_bins)   # queries per f64 recheck
    for lo in range(0, q.shape[0], step):
        idb = ids[lo:lo + step].clamp(min=0)
        rows = x[idb]                                         # [b, L, D]
        s64 = norms[idb].double() - f * _rounded_dot64(q[lo:lo + step], rows, precision)
        m = fin[lo:lo + step]
        ref = ks[lo:lo + step][m].double()
        gap = (s64[m] - ref).abs()
        if bool((gap > tolerance(ref)).any()):
            raise AssertionError(f"{label}: a chosen row's f64 score is {float(gap.max())} "
                                 "from its bin minimum")
    return float(diff.max()) if diff.numel() else 0.0


def compare_case(ctx, label, q, x, norms, l_bins, metric, precision):
    from zvdb_tpu_torch.ops import flat_scan as FS

    before = FS.flat_scan_bins.launches_mma
    ks, ki = FS.flat_scan_bins(q, x, norms, l_bins=l_bins, chunk=l_bins * 4,
                               metric=metric, precision=precision)
    ps, pi = FS._flat_scan_bins_plain(q, x, norms, l_bins, metric, precision)
    ctx.sync()
    if not ctx.rehearse and FS.flat_scan_bins.launches_mma != before + (precision != "highest"):
        raise AssertionError(f"{label}: the tensor-core count did not follow the precision")
    err = check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi, label)
    print(f"  compare {label}: ok, max |kernel - plain| = {err:.3g}", flush=True)
    return err


def phase_compare(ctx: Ctx):
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS

    rng = np.random.default_rng(123)
    dev = ctx.device
    cases = []
    for precision in ("highest", "high", "default"):
        for metric in ("l2", "dot", "cosine"):
            cases.append((37, 5000, 13, 128, metric, precision, torch.float32))
    cases += [
        (1, 3001, 128, 1024, "l2", "default", torch.bfloat16),
        (70, 4099, 128, 100, "l2", "high", torch.bfloat16),
        (70, 4099, 36, 100, "dot", "default", torch.bfloat16),   # bf16 rows, D % 8 != 0
        (8, 2048, 33, 2048, "dot", "highest", torch.float32),
        (8, 2048, 33, 2048, "dot", "high", torch.float32),
        (8, 2048, 33, 2048, "cosine", "default", torch.float32),
    ]
    if not ctx.rehearse:
        cases += [(BATCH, 200_000, 128, 1024, "l2", precision, torch.float32)
                  for precision in ("default", "high")]

    # the tie rule: rows L..2L-1 repeat rows 0..L-1, so every bin holds two
    # equal scores and the lower row must win, in every precision
    q = torch.from_numpy(rng.standard_normal((65, 40)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((256, 40)).astype(np.float32)).to(dev)
    x = torch.cat([x, x])
    for precision in ("highest", "high", "default"):
        _, ki = FS.flat_scan_bins(q, x, D.sq_norms(x), l_bins=256, chunk=256,
                                  precision=precision)
        if not torch.equal(ki, torch.arange(256, device=dev, dtype=torch.int32).expand(65, -1)):
            raise AssertionError(f"tie rule broken ({precision}): a higher row won a tie")
    print("  compare tie rule (duplicated rows, every precision; default and high on the "
          "tensor cores): ok", flush=True)
    for b, n, d, l_bins, metric, precision, dtype in cases:
        xq = rng.standard_normal((b, d)).astype(np.float32)
        xc = rng.standard_normal((n, d)).astype(np.float32)
        q = D.preprocess_queries(torch.from_numpy(xq).to(dev), metric)
        x, norms = D.preprocess_corpus(torch.from_numpy(xc).to(dev), metric, dtype)
        norms[::7] = float("inf")   # invalid rows
        label = f"B={b} N={n} D={d} L={l_bins} {metric} {precision} {str(dtype)[6:]}"
        compare_case(ctx, label, q, x, norms, l_bins, metric, precision)


def make_workload(ctx: Ctx):
    from zvdb_tpu_torch.io.datasets import synthetic_clustered

    t0 = time.perf_counter()
    x1 = synthetic_clustered(ctx.n, ctx.dim, n_clusters=ctx.clusters, seed=0)
    qrng = np.random.default_rng(777)
    q1 = (x1[qrng.integers(0, ctx.n, ctx.nq)]
          + 0.05 * qrng.standard_normal((ctx.nq, ctx.dim))).astype(np.float32)
    print(f"workload: corpus {x1.shape} queries {q1.shape} made in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return x1, q1


APPROX = {"approx": True}   # search keywords of the flat and PQ engines' kernel paths


def batched_ids(ctx, index, q1, **search_kwargs):
    out = [index.search(q1[lo:lo + ctx.batch], K, **search_kwargs)[1]
           for lo in range(0, q1.shape[0], ctx.batch)]
    return torch.cat(out).cpu().numpy()


def phase_main(ctx: Ctx, x1, q1):
    from zvdb_tpu_torch import FlatConfig, FlatIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops.flat_scan import flat_scan_bins

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are still on")
    dev = ctx.device
    n_batches = -(-q1.shape[0] // ctx.batch)

    t0 = time.perf_counter()
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(x1)
    gt = batched_ids(ctx, oracle, q1, approx=False)
    ctx.sync()
    ctx.report("ground truth seconds (exact f32 tiled search)", round(time.perf_counter() - t0, 2))
    del oracle

    cfg = FlatConfig(dim=ctx.dim, rerank=4, recall_target=0.97, scan="pallas",
                     l_bins=ctx.l_bins, pallas_chunk=4 * ctx.l_bins, pallas_bq=512)
    flp = FlatIndex(cfg, capacity=ctx.n, device=dev)
    flp.add(x1)
    ctx.sync()

    flat_scan_bins.launches = flat_scan_bins.launches_mma = 0
    ids = batched_ids(ctx, flp, q1, **APPROX)
    ctx.sync()
    launches, launches_mma = flat_scan_bins.launches, flat_scan_bins.launches_mma
    rec = recall_at_k(ids, gt, K)
    ctx.report("main path flat_1m_pallas recall@10", rec)
    ctx.report("main path flat_1m_pallas kernel launches",
               f"{launches} (on the tensor cores {launches_mma}) for {n_batches} batches")
    if not ctx.rehearse and not launches == launches_mma == n_batches:
        raise AssertionError(f"kernel launched {launches} times ({launches_mma} on the tensor "
                             f"cores) for {n_batches} batches")
    if rec < 0.95:
        raise AssertionError(f"recall@10 {rec} < 0.95")

    single = FlatIndex(FlatConfig(dim=ctx.dim, rerank=0, precision="high", scan="pallas",
                                  l_bins=ctx.l_bins, pallas_chunk=4 * ctx.l_bins,
                                  pallas_bq=512), capacity=ctx.n, device=dev)
    single.add(x1)
    flat_scan_bins.launches = flat_scan_bins.launches_mma = 0
    ids1 = batched_ids(ctx, single, q1, **APPROX)
    ctx.sync()
    launches1, launches1_mma = flat_scan_bins.launches, flat_scan_bins.launches_mma
    rec1 = recall_at_k(ids1, gt, K)
    ctx.report("single-pass kernel path (rerank=0, high) recall@10", rec1)
    ctx.report("single-pass kernel path launches",
               f"{launches1} (on the tensor cores {launches1_mma}) for {n_batches} batches")
    if not ctx.rehearse and not launches1 == launches1_mma == n_batches:
        raise AssertionError(f"kernel launched {launches1} times ({launches1_mma} on the tensor "
                             f"cores) for {n_batches} batches")
    if rec1 < 0.95:
        raise AssertionError(f"single-pass recall@10 {rec1} < 0.95")
    del single
    return flp, ids, launches, gt


def phase_server(ctx: Ctx, flp, q1, ids, label: str = "", search_kwargs=APPROX,
                 max_differ: float = 0.0):
    """400 requests from 8 threads through a SearchServer; each answer must
    equal the batched search's ids, or differ on at most a `max_differ`
    share of the queries."""
    from zvdb_tpu_torch import SearchServer

    n_req = 400
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 9, n_req)          # single queries and small batches
    sizes[::2] = 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % (q1.shape[0] - 8)
    results = [None] * n_req

    with SearchServer(flp, k=K, max_batch=ctx.batch, max_wait_ms=2.0,
                      search_kwargs=search_kwargs) as srv:
        def worker(t):
            futs = []
            for r in range(t, n_req, 8):
                lo = int(starts[r])
                qq = q1[lo] if sizes[r] == 1 else q1[lo:lo + sizes[r]]
                futs.append((r, srv.submit(qq)))
            for r, fut in futs:
                results[r] = fut.result(timeout=600)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        if any(th.is_alive() for th in threads):
            raise AssertionError("server workers did not finish")
    bad = 0
    for r in range(n_req):
        lo = int(starts[r])
        got = results[r][1]
        want = ids[lo:lo + sizes[r]]
        bad += int((got != want).any(axis=1).sum())
    ctx.report(f"{label}server requests answered", f"{n_req} requests, {int(sizes.sum())} "
               f"queries, {bad} queries differ from the batched search")
    if bad > max_differ * sizes.sum():
        raise AssertionError(f"{bad} server answers differ from the batched search")


def search_qps(ctx: Ctx, index, q1, runs: int = 3, search_kwargs=APPROX):
    """End to end: search() over every query in batches, host clock ending
    in a sync; one QPS per run."""
    qps_runs = []
    for _ in range(runs):
        ctx.sync()
        t0 = time.perf_counter()
        for lo in range(0, q1.shape[0], ctx.batch):
            index.search(q1[lo:lo + ctx.batch], K, **search_kwargs)
        ctx.sync()
        qps_runs.append(q1.shape[0] / (time.perf_counter() - t0))
    return qps_runs


def server_qps(ctx: Ctx, index, q1, search_kwargs=APPROX):
    """Every query through a SearchServer: 8 client threads, 16-query requests."""
    from zvdb_tpu_torch import SearchServer

    chunk = 16
    with SearchServer(index, k=K, max_batch=ctx.batch, max_wait_ms=2.0,
                      search_kwargs=search_kwargs) as srv:
        def worker(t, futs):
            for lo in range(t * chunk, q1.shape[0], 8 * chunk):
                futs.append(srv.submit(q1[lo:lo + chunk]))

        ctx.sync()
        t0 = time.perf_counter()
        all_futs = [[] for _ in range(8)]
        threads = [threading.Thread(target=worker, args=(t, all_futs[t])) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        for futs in all_futs:
            for fut in futs:
                fut.result(timeout=900)
        ctx.sync()
        return q1.shape[0] / (time.perf_counter() - t0)


def phase_times(ctx: Ctx, flp, q1):
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS

    dev = ctx.device
    st = flp.state
    qs = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), "l2")
    b, d = qs.shape
    n, L = st.vectors.shape[0], ctx.l_bins
    args = dict(l_bins=L, chunk=4 * L, metric="l2")
    old = None if ctx.rehearse else FS.build()   # the CUDA-core kernel, called directly

    # the kernel on the main path's own inputs, held against its plain version
    # and against the CUDA-core kernel (both tie-aware: other sum orders)
    err = 0.0
    for precision in ("default", "high"):
        ks, ki = FS.flat_scan_bins(qs, st.vectors, st.norms, precision=precision, **args)
        ps, pi = FS._flat_scan_bins_plain(qs, st.vectors, st.norms, L, "l2", precision)
        ctx.sync()
        e = check_bins(qs, st.vectors, st.norms, L, "l2", precision, ks, ki, ps, pi,
                       f"main-path inputs {precision}")
        print(f"  compare main-path inputs B={b} N={n} D={d} L={L} {precision}: ok, "
              f"max |kernel - plain| = {e:.3g}", flush=True)
        if precision == "default":
            err = e
        del ps, pi
        if old is not None:
            os_, oi = FS.launch(old, qs, st.vectors, st.norms, L, "l2", precision)
            ctx.sync()
            e = check_bins(qs, st.vectors, st.norms, L, "l2", precision, ks, ki, os_, oi,
                           f"main-path inputs {precision}, tensor cores vs CUDA cores")
            print(f"  compare main-path inputs {precision}: tensor cores vs CUDA cores ok, "
                  f"max |difference| = {e:.3g}", flush=True)
            del os_, oi
        del ks, ki

    # 100 calls per time on the card: fewer read a host stall after the
    # server phase as kernel time
    reps = 3 if ctx.rehearse else 100
    ms = {p: ctx.time_ms(lambda p=p: FS.flat_scan_bins(qs, st.vectors, st.norms, precision=p,
                                                       **args), reps=reps, warmup=3)
          for p in ("default", "high")}
    old_ms = {p: ctx.time_ms(lambda p=p: FS.launch(old, qs, st.vectors, st.norms, L, "l2", p),
                             reps=reps)
              for p in ("default", "high")} if old is not None else {}
    plain_ms = ctx.time_ms(lambda: FS._flat_scan_bins_plain(qs, st.vectors, st.norms, L,
                                                            "l2", "default"), reps=3)
    # yardsticks, the product part alone: f32 on the bf16-rounded operands
    # (TF32 off), one bf16 product, and the three bf16 products of "high"
    qb, xb = qs.to(torch.bfloat16), st.vectors.to(torch.bfloat16)
    qf, xf = qb.float(), xb.float()
    library_ms = ctx.time_ms(lambda: torch.matmul(qf, xf.T), reps=5)
    qlo = (qs - qf).to(torch.bfloat16)
    xlo = (st.vectors.float() - xf).to(torch.bfloat16)
    del qf, xf
    bf16_ms = ctx.time_ms(lambda: torch.matmul(qb, xb.T), reps=10)
    split_ms = ctx.time_ms(lambda: (torch.matmul(qb, xb.T), torch.matmul(qb, xlo.T),
                                    torch.matmul(qlo, xb.T)), reps=5)
    del qb, xb, qlo, xlo
    ops = 2.0 * b * n * d
    nbytes = n * d * st.vectors.element_size() + n * 4 + b * d * 4 + b * L * 8
    bound_ops, bound_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
    bound_fold = b * n * FOLD_INSTR_A / CUDA_CORE_INSTR_S * 1e3
    bound_ms = max(bound_ops, bound_bytes, bound_fold)
    shape = f"B={b} N={n} D={d} L={L}"
    for p, t in ms.items():
        ctx.report(f"kernel ms ({p}, tensor cores, flat_scan_mma.cu, {shape}, {reps} calls)", t)
    for p, t in old_ms.items():
        ctx.report(f"kernel ms ({p}, CUDA cores, flat_scan.cu called directly, {reps} calls)",
                   f"{t} ({t / ms[p]:.2f}x the tensor-core kernel's time)")
    ctx.report("kernel achieved TFLOP/s (default 1 product, high 3)",
               f"{ops / (ms['default'] * 1e-3) / 1e12} default, "
               f"{3 * ops / (ms['high'] * 1e-3) / 1e12} high")
    ctx.report("plain version ms (default)", plain_ms)
    ctx.report("torch.matmul yardstick ms (bf16-rounded [2048,128]x[128,1M] in f32, TF32 off)",
               library_ms)
    ctx.report("torch.matmul bf16 yardstick ms (one bf16 product, bf16 output)", bf16_ms)
    ctx.report("torch.matmul bf16 yardstick ms (the split's three products hi.hi, hi.lo, "
               "lo.hi)", split_ms)
    ctx.report(f"bound ms (default: max of bf16 ops / 989 TFLOP/s, B*N*{FOLD_INSTR_A} fold "
               "instructions / (132 SMs x 128 lanes x 1.98 GHz), bytes / 3.35 TB/s)",
               f"{bound_ms} (ops {bound_ops}, fold {bound_fold}, bytes {bound_bytes}); share "
               f"of the bound {bound_ms / ms['default']}")
    ctx.report("bound ms (high, 3x bf16 ops)", max(3 * bound_ops, bound_fold, bound_bytes))
    ctx.report("bound ms (highest, f32 ops / 67 TFLOP/s)", ops / PEAK_F32 * 1e3)

    ctx.report("search QPS (batches of 2048, 3 runs)", search_qps(ctx, flp, q1))
    ctx.report("server QPS (8 threads, requests of 16 queries)", server_qps(ctx, flp, q1))
    if dev.type == "cuda":
        ctx.report("peak device memory GB (max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    profile_search(ctx, flp, q1, label="flat_1m_pallas")
    return dict(ms=ms["default"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                max_abs_err=err,
                bound_by="operations" if max(bound_ops, bound_fold) >= bound_bytes else "bytes")


def pq_inputs(rng, b, n, n_sub, metric, dev, invalid_every=0, dup_rows=0):
    """A table of ADC scale, random nibble codes [S/2, N] and 'decoded
    norms'; dup_rows > 0 repeats the first dup_rows rows through the corpus."""
    lut = rng.standard_normal((b, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (n_sub // 2, n), dtype=np.uint8)
    norms = (rng.random(n) * n_sub).astype(np.float32) if metric == "l2" \
        else np.zeros(n, np.float32)
    if dup_rows:
        codes = np.tile(codes[:, :dup_rows], (1, -(-n // dup_rows)))[:, :n].copy()
        norms = np.tile(norms[:dup_rows], -(-n // dup_rows))[:n].copy()
    if invalid_every:
        norms[::invalid_every] = np.inf
    return tuple(torch.from_numpy(a).to(dev) for a in (lut, codes, norms))


def check_pq_bins(lut, codes_t, norms, l_bins, chunk, metric, precision, per_bin, seg_rows,
                  ks, ki, ps, pi, label):
    """Agreement of kernel bins (ks, ki) with plain bins (ps, pi).

    "int8": ids and scores equal (integer sums, the same float steps).
    "default"/"high": tie-aware. The same empty bins; scores within 1e-5 of
    the score scale (the larger of the largest |plain score| and twice the
    largest sum of |table| entries: the two sum in other orders); each kernel
    id on a valid row of its own bin and segment, its score recomputed in f64
    from the rounded table within that tolerance; where a kernel id differs
    from the plain one, the two scores tie within it. Returns the largest
    |kernel - plain|."""
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops.pq import unpack_nibbles

    if precision == "int8":
        if not torch.equal(ki, pi):
            raise AssertionError(f"{label}: {int((ki != pi).sum())} ids differ from plain")
        if not torch.equal(ks, ps):
            raise AssertionError(f"{label}: {int((ks != ps).sum())} scores differ from plain")
        return 0.0
    b, n_sub, _ = lut.shape
    n = codes_t.shape[1]
    f = 2.0 if metric == "l2" else 1.0
    if not torch.equal(ki < 0, pi < 0):
        raise AssertionError(f"{label}: empty bins differ ({int(((ki < 0) != (pi < 0)).sum())})")
    fin = pi >= 0
    if not bool(torch.isinf(ks[~fin]).all()):
        raise AssertionError(f"{label}: an empty bin has a finite score")
    scale = max(float(ps[fin].abs().max()) if bool(fin.any()) else 1.0,
                2.0 * float(lut.abs().amax(-1).sum(-1).max()))
    tol = 1e-5 * scale
    diff = (ks - ps).abs()[fin]
    if bool((diff > tol).any()):
        raise AssertionError(f"{label}: bin scores differ by up to {float(diff.max())}")
    flip = fin & (ki != pi)
    if bool(((ks - ps).abs()[flip] > tol).any()):
        raise AssertionError(f"{label}: an id differs from plain without a tie")
    _, seg_len = PS.segments(n, chunk, seg_rows)
    col = torch.arange(ki.shape[1], device=ki.device)
    ids = ki.long()
    bad = (ids % l_bins != col % l_bins) | (ids // seg_len != col // (per_bin * l_bins)) | (ids >= n)
    if bool(bad[fin].any()):
        raise AssertionError(f"{label}: an id lies outside its bin or segment")
    if not bool(torch.isfinite(norms[ids[fin]]).all()):
        raise AssertionError(f"{label}: an id names an invalid row")
    hi = lut.to(torch.bfloat16).float()
    planes = [hi] if precision == "default" else [hi, (lut - hi).to(torch.bfloat16).float()]
    table = sum(p.double() for p in planes).reshape(b, n_sub * 16)
    codes = unpack_nibbles(codes_t.T, n_sub).long()                    # [N, S]
    sub16 = torch.arange(n_sub, device=lut.device) * 16
    step = max(1, (1 << 21) // (ki.shape[1] * n_sub))   # queries per f64 recheck
    for lo in range(0, b, step):
        idb = ids[lo:lo + step].clamp(min=0)
        pos = (codes[idb] + sub16).reshape(idb.shape[0], -1)           # [b, W*S]
        dots = torch.gather(table[lo:lo + step], 1, pos).reshape(*idb.shape, n_sub).sum(-1)
        s64 = norms[idb].double() - f * dots
        m = fin[lo:lo + step]
        gap = (s64[m] - ks[lo:lo + step][m].double()).abs()
        if bool((gap > tol).any()):
            raise AssertionError(f"{label}: a chosen row's f64 score is {float(gap.max())} "
                                 "from its bin score")
    return float(diff.max()) if diff.numel() else 0.0


def compare_pq_case(ctx, label, lut, codes_t, norms, l_bins, chunk, metric, precision,
                    per_bin, seg_rows):
    from zvdb_tpu_torch.ops import pq_scan as PS

    args = (l_bins, chunk, metric, precision, per_bin, seg_rows)
    before = PS.pq_scan_bins.launches_mma
    ks, ki = PS.pq_scan_bins(lut, codes_t, norms, l_bins=l_bins, chunk=chunk, metric=metric,
                             precision=precision, per_bin=per_bin, seg_rows=seg_rows)
    ps, pi = PS._pq_scan_bins_plain(lut, codes_t, norms, *args)
    ctx.sync()
    # the route is chosen by precision: int8 alone on the tensor cores
    want = int(not ctx.rehearse and precision == "int8")
    if PS.pq_scan_bins.launches_mma - before != want:
        raise AssertionError(f"{label}: launches_mma moved by "
                             f"{PS.pq_scan_bins.launches_mma - before}, not {want}")
    err = check_pq_bins(lut, codes_t, norms, *args, ks, ki, ps, pi, label)
    print(f"  compare {label}: ok, max |kernel - plain| = {err:.3g}", flush=True)
    return err


def phase_compare_pq(ctx: Ctx):
    from zvdb_tpu_torch.ops import pq_scan as PS

    rng = np.random.default_rng(321)
    dev = ctx.device
    cases = []
    for precision in ("int8", "default", "high"):
        for metric in ("l2", "dot"):
            for per_bin in (1, 2):
                for seg_rows in (0, 2048):   # 2048: three segments of the 5000 rows
                    cases.append((37, 5000, 16, 128, 512, metric, precision, per_bin, seg_rows, 7))
    cases += [
        (1, 3001, 16, 1024, 1024, "l2", "int8", 2, 0, 5),
        (70, 4099, 32, 100, 400, "l2", "high", 2, 800, 9),   # 64 KB of table: > 48 KB smem
        (9, 40, 16, 64, 64, "dot", "default", 2, 0, 0),      # N < L: empty bins
        # int8 on the tensor cores: n_sub 8, 32 and 64 (two table chunks), L no
        # multiple of the block's bins, L < 64, B past one query tile
        (300, 3001, 8, 100, 400, "l2", "int8", 2, 800, 7),
        (70, 4099, 32, 100, 400, "dot", "int8", 1, 0, 9),
        (37, 2500, 64, 48, 96, "l2", "int8", 2, 960, 11),
        (5, 700, 16, 20, 40, "l2", "int8", 2, 0, 3),
    ]
    if not ctx.rehearse:
        for precision in ("int8", "default"):
            cases.append((BATCH, 200_000, 16, 1024, 1024, "l2", precision, 2, 65536, 11))

    # the tie rule: rows L..2L-1, 2L..3L-1, ... repeat rows 0..L-1, so every
    # bin holds equal scores: the lowest row wins slot 1, the next slot 2
    for precision in ("int8", "default", "high"):
        lut, codes, norms = pq_inputs(rng, 65, 512, 16, "l2", dev, dup_rows=128)
        _, ki = PS.pq_scan_bins(lut, codes, norms, l_bins=128, chunk=128, precision=precision,
                                per_bin=2)
        want = torch.arange(128, device=dev, dtype=torch.int32).expand(65, -1)
        if not (torch.equal(ki[:, :128], want) and torch.equal(ki[:, 128:], want + 128)):
            raise AssertionError(f"PQ tie rule broken ({precision})")
    print("  compare PQ tie rule (duplicated codes, every precision, per_bin=2): ok", flush=True)
    for b, n, n_sub, l_bins, chunk, metric, precision, per_bin, seg_rows, inv in cases:
        lut, codes, norms = pq_inputs(rng, b, n, n_sub, metric, dev, invalid_every=inv)
        label = (f"PQ B={b} N={n} S={n_sub} L={l_bins} {metric} {precision} "
                 f"per_bin={per_bin} seg_rows={seg_rows}")
        compare_pq_case(ctx, label, lut, codes, norms, l_bins, chunk, metric, precision,
                        per_bin, seg_rows)


def pq_config(ctx: Ctx):
    from zvdb_tpu_torch import PQConfig

    if ctx.rehearse:   # the CPU resolves scan="auto" to the decode scan
        return PQConfig(dim=ctx.dim, scan="pallas", l_bins=ctx.l_bins)
    return PQConfig(dim=ctx.dim)


def phase_pq_main(ctx: Ctx, x1, q1, gt):
    from zvdb_tpu_torch import PQFlatIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import pq as PQ
    from zvdb_tpu_torch.ops import pq_scan as PS

    dev = ctx.device
    cfg = pq_config(ctx)
    ctx.report("pq_1m config", cfg)
    if cfg.scan != "pallas":
        raise AssertionError(f"PQConfig resolved scan={cfg.scan!r}, not the fused kernel")
    n_batches = -(-q1.shape[0] // ctx.batch)
    xd = torch.from_numpy(x1).to(dev)
    warm = PQFlatIndex(cfg, device=dev)   # first use of every op on the card
    warm.build(xd)
    del warm
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    FS.flat_scan_bins.launches = 0
    PS.pq_scan_bins.launches = PS.pq_scan_bins.launches_mma = 0
    build_pps = []
    for _ in range(2):
        t0 = time.perf_counter()
        idx = PQFlatIndex(cfg, device=dev)
        idx.build(xd)
        ctx.sync()
        build_pps.append(ctx.n / (time.perf_counter() - t0))
    ids = batched_ids(ctx, idx, q1, **APPROX)
    ctx.sync()
    launches, flat_launches = PS.pq_scan_bins.launches, FS.flat_scan_bins.launches
    launches_mma = PS.pq_scan_bins.launches_mma
    rec = recall_at_k(ids, gt, K)
    ctx.report("pq_1m build points/s (2 runs, rows already on the device)", build_pps)
    ctx.report("pq_1m recall@10", rec)
    ctx.report("pq_1m kernel launches", f"pq_scan_bins {launches} (on the tensor cores "
                                        f"{launches_mma}), flat_scan_bins {flat_launches} "
                                        f"for {n_batches} batches")
    if dev.type == "cuda":
        ctx.report("pq_1m peak device memory GB (build + search, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    if not ctx.rehearse and (launches != n_batches or launches_mma != n_batches
                             or flat_launches):
        raise AssertionError(f"pq kernel launched {launches} times ({launches_mma} on the "
                             f"tensor cores) for {n_batches} batches")
    if rec < 0.95:
        raise AssertionError(f"pq_1m recall@10 {rec} < 0.95")
    del xd

    # the kernel on the main path's own inputs (the first batch), held
    # against its plain version
    st = idx.state
    qs = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), cfg.metric)
    lut = PQ.adc_lut(PQ.apply_rotation(qs, st.rot), st.codebooks)
    args = (cfg.l_bins, cfg.pallas_chunk, cfg.metric)
    errs = {}
    for precision in ("int8", "default", "high"):
        errs[precision] = compare_pq_case(
            ctx, f"PQ main-path inputs B={lut.shape[0]} N={st.norms.shape[0]} {precision}",
            lut, st.codes, st.norms, *args, precision, cfg.per_bin, cfg.seg_rows)
    if not ctx.rehearse:   # int8: the tensor cores against the CUDA cores, called directly
        kw = (*args, "int8", cfg.per_bin, cfg.seg_rows)
        ns, ni = PS.pq_scan_bins(lut, st.codes, st.norms, l_bins=cfg.l_bins,
                                 chunk=cfg.pallas_chunk, metric=cfg.metric, precision="int8",
                                 per_bin=cfg.per_bin, seg_rows=cfg.seg_rows)
        os_, oi = PS.launch(PS.build(), lut, st.codes, st.norms, *kw)
        ctx.sync()
        if not (torch.equal(ni, oi) and torch.equal(ns, os_)):
            raise AssertionError(f"PQ main path int8: tensor cores and CUDA cores differ in "
                                 f"{int((ni != oi).sum())} ids, {int((ns != os_).sum())} scores")
        print("  compare PQ main-path inputs int8: tensor cores == CUDA cores, ids and scores",
              flush=True)
    return idx, ids, launches, lut, errs


def profile_search(ctx: Ctx, index, q1, batches: int = 3, label: str = "pq_1m",
                   search_kwargs=APPROX):
    """Where a search batch's device time goes: profile_calls over a few
    batches after a warm one."""
    if ctx.device.type != "cuda":
        return
    qb = [q1[i * ctx.batch:(i + 1) * ctx.batch] for i in range(batches)]
    index.search(qb[0], K, **search_kwargs)
    ctx.sync()
    profile_calls(ctx, f"{label} search profile ({batches} batches of {ctx.batch})",
                  [lambda qq=qq: index.search(qq, K, **search_kwargs) for qq in qb], "batch")


def profile_calls(ctx: Ctx, label: str, calls, unit: str):
    """torch.profiler over `calls`, run in turn in a window that ends in a
    sync: kernel time by name, and the device's busy share of the window
    (the union of kernel intervals over the host wall time). Returns
    {kernel name: (device us, launches)} over the calls, or None when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        ctx.sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        ctx.report(label, "no device time in the trace: not measured")
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    n = len(calls)
    ctx.report(label, f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
               f"({100 * busy / wall_us:.1f}%), {len(kernels) // n} kernels/{unit}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3 / n:9.3f} ms/{unit}  {c / n:5.1f}x/{unit}  {name[:90]}")
    return by_name


def phase_pq_times(ctx: Ctx, idx, q1, lut):
    from zvdb_tpu_torch.ops import pq_scan as PS

    cfg, st = idx.cfg, idx.state
    b, n_sub, _ = lut.shape
    n = st.norms.shape[0]
    kw = dict(l_bins=cfg.l_bins, chunk=cfg.pallas_chunk, metric=cfg.metric,
              per_bin=cfg.per_bin, seg_rows=cfg.seg_rows)
    # 100 calls each: fewer read a host stall after a server phase as kernel time
    ms = {p: ctx.time_ms(lambda p=p: PS.pq_scan_bins(lut, st.codes, st.norms, precision=p, **kw),
                         reps=100)
          for p in ("int8", "default", "high")}
    old_int8_ms = None   # the CUDA-core kernel at int8 (pq_scan.cu), called directly
    if not ctx.rehearse:
        old = PS.build()
        old_int8_ms = ctx.time_ms(lambda: PS.launch(
            old, lut, st.codes, st.norms, cfg.l_bins, cfg.pallas_chunk, cfg.metric, "int8",
            cfg.per_bin, cfg.seg_rows), reps=100)
    plain_ms = ctx.time_ms(lambda: PS._pq_scan_bins_plain(
        lut, st.codes, st.norms, cfg.l_bins, cfg.pallas_chunk, cfg.metric, "int8",
        cfg.per_bin, cfg.seg_rows), reps=2)
    # yardsticks: the product part alone, the LUT by a prebuilt one-hot of
    # the padded corpus (int8 for the int8 path, bf16 for "default")
    n_pad = -(-n // cfg.pallas_chunk) * cfg.pallas_chunk
    lut8, _ = PS._prep_lut(lut, "int8")
    lut8 = lut8.reshape(b, n_sub * 16)
    codes = torch.zeros((n_sub // 2, n_pad), dtype=torch.uint8, device=st.codes.device)
    codes[:, :n] = st.codes
    from zvdb_tpu_torch.ops.pq import unpack_nibbles

    oh8 = torch.nn.functional.one_hot(unpack_nibbles(codes.T, n_sub).long(), 16) \
        .reshape(n_pad, n_sub * 16).to(torch.int8)
    library_ms = None
    if ctx.device.type == "cuda":
        library_ms = ctx.time_ms(lambda: torch._int_mm(lut8, oh8.T), reps=5)
    lutb, ohb = lut.reshape(b, -1).to(torch.bfloat16), oh8.T.to(torch.bfloat16)
    bf16_ms = ctx.time_ms(lambda: torch.matmul(lutb, ohb), reps=5)
    del oh8, ohb
    n_seg, _ = PS.segments(n, cfg.pallas_chunk, cfg.seg_rows)
    ops = 2.0 * b * n_pad * n_sub * 16
    nbytes = n_sub // 2 * n + 4 * n + b * n_sub * 16 + 4 * b + 8 * b * n_seg * cfg.per_bin * cfg.l_bins
    bound_ops, bound_bytes = ops / PEAK_INT8 * 1e3, nbytes / HBM_BYTES_S * 1e3
    # the fold: FOLD_INSTR CUDA-core instructions per score (the float
    # conversion, scale and fma; two compares; four selects), one per lane
    # per clock
    bound_fold = b * n * FOLD_INSTR / CUDA_CORE_INSTR_S * 1e3
    bound_ms = max(bound_ops, bound_bytes, bound_fold)
    shape = f"B={b} N={n} S={n_sub} L={cfg.l_bins} per_bin={cfg.per_bin}"
    for p, t in ms.items():
        route = "tensor cores, pq_scan_mma.cu" if p == "int8" else "CUDA cores, pq_scan.cu"
        ctx.report(f"pq kernel ms ({p}, {route}, {shape}, 100 calls)", t)
    ctx.report("pq kernel ms (int8, CUDA cores, pq_scan.cu called directly, 100 calls)",
               old_int8_ms)
    ctx.report("pq plain version ms (int8)", plain_ms)
    ctx.report("pq torch._int_mm yardstick ms (int8 [2048,256] x one-hot [256,N_pad])", library_ms)
    ctx.report("pq bf16 torch.matmul yardstick ms (same shapes)", bf16_ms)
    ctx.report("pq bound ms (max of 2*B*N_pad*S*16 ops / 1979 TOP/s int8, bytes / 3.35 TB/s, "
               f"B*N*{FOLD_INSTR} fold instructions / (132 SMs x 128 lanes x 1.98 GHz))",
               f"{bound_ms} (ops {bound_ops}, bytes {bound_bytes}, fold {bound_fold})")
    ctx.report("pq_1m search QPS (batches of 2048, 3 runs)", search_qps(ctx, idx, q1))
    ctx.report("pq_1m server QPS (8 threads, requests of 16 queries)", server_qps(ctx, idx, q1))
    profile_search(ctx, idx, q1)
    return dict(ms=ms["int8"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="operations" if max(bound_ops, bound_fold) >= bound_bytes else "bytes")


# ---------------------------------------------------------------------------
# IVF-PQ: kernel C (pq_grouped_scan_bins) and the ivfpq_1m main path

IVFPQ_SEARCH = {"nprobe": 8, "rerank": 12}   # the ivfpq_1m bench row's search


def grouped_inputs(rng, b, c, cap, n_sub, qcap, metric, dev, invalid_every=0, live=6, dup=0):
    """A table of ADC scale, random nibble codes per cluster [C, S/2, cap],
    'decoded norms' [C, cap] (+inf every invalid_every-th row), and up to
    `live` slots of each cluster filled with random queries (the rest empty,
    so whole 16-slot tiles stay empty); dup > 0 repeats each cluster's first
    dup rows through its block."""
    lut = rng.standard_normal((b, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (c, n_sub // 2, cap), dtype=np.uint8)
    norms = ((rng.random((c, cap)) * n_sub).astype(np.float32) if metric == "l2"
             else np.zeros((c, cap), np.float32))
    if dup:
        codes = np.tile(codes[:, :, :dup], (1, 1, -(-cap // dup)))[:, :, :cap].copy()
        norms = np.tile(norms[:, :dup], (1, -(-cap // dup)))[:, :cap].copy()
    if invalid_every:
        norms.reshape(-1)[::invalid_every] = np.inf
    qslot = np.full((c, qcap), -1, np.int32)
    for ci in range(c):
        k = int(rng.integers(0, live + 1))
        qslot[ci, :k] = rng.integers(0, b, k)
    return tuple(torch.from_numpy(a).to(dev) for a in (lut, qslot, codes, norms))


def check_grouped_bins(lut, qslot, codes_blocks, norms_blocks, l_bins, metric, precision,
                       ks, ki, ps, pi, label):
    """Agreement of kernel C's bins (ks, ki) with its plain version's (ps, pi),
    as check_pq_bins holds kernel B. "int8": positions and scores equal.
    "default"/"high": tie-aware: the same empty bins; scores within 1e-5 of
    the score scale; a position differing from plain only on a tie; each
    position a valid row below cap in its own bin, its score recomputed in
    f64 from the rounded table within that tolerance. Returns the largest
    |kernel - plain|."""
    from zvdb_tpu_torch.ops.pq import unpack_nibbles

    if precision == "int8":
        if not torch.equal(ki, pi):
            raise AssertionError(f"{label}: {int((ki != pi).sum())} positions differ from plain")
        if not torch.equal(ks, ps):
            raise AssertionError(f"{label}: {int((ks != ps).sum())} scores differ from plain")
        return 0.0
    b, n_sub, _ = lut.shape
    c, _, cap = codes_blocks.shape
    qcap, lw = ki.shape[1], ki.shape[2]
    f = 2.0 if metric == "l2" else 1.0
    if not torch.equal(ki < 0, pi < 0):
        raise AssertionError(f"{label}: empty bins differ ({int(((ki < 0) != (pi < 0)).sum())})")
    fin = pi >= 0
    if not bool(torch.isinf(ks[~fin]).all()):
        raise AssertionError(f"{label}: an empty bin has a finite score")
    scale = max(float(ps[fin].abs().max()) if bool(fin.any()) else 1.0,
                2.0 * float(lut.abs().amax(-1).sum(-1).max()))
    tol = 1e-5 * scale
    diff = (ks - ps).abs()[fin]
    if bool((diff > tol).any()):
        raise AssertionError(f"{label}: bin scores differ by up to {float(diff.max())}")
    if bool(((ks - ps).abs()[fin & (ki != pi)] > tol).any()):
        raise AssertionError(f"{label}: a position differs from plain without a tie")
    pos = ki.long()
    col = torch.arange(lw, device=ki.device)
    if bool((((pos % l_bins) != (col % l_bins)) | (pos >= cap))[fin].any()):
        raise AssertionError(f"{label}: a position lies outside its bin or past cap")
    hi = lut.to(torch.bfloat16).float()
    planes = [hi] if precision == "default" else [hi, (lut - hi).to(torch.bfloat16).float()]
    table = sum(p.double() for p in planes).reshape(b, n_sub * 16)
    sub16 = torch.arange(n_sub, device=lut.device) * 16
    step = max(1, (1 << 24) // (qcap * lw * n_sub))     # clusters per f64 recheck
    for c0 in range(0, c, step):
        c1 = min(c0 + step, c)
        codes = unpack_nibbles(codes_blocks[c0:c1].transpose(1, 2), n_sub).long()  # [cc, cap, S]
        pp = pos[c0:c1].clamp(min=0)
        ci = torch.arange(c1 - c0, device=lut.device)[:, None, None]
        idx = codes[ci, pp] + sub16                                              # [cc, qcap, lw, S]
        rows = table[qslot[c0:c1].clamp(min=0).long()]                           # [cc, qcap, S*16]
        dots = torch.gather(rows, 2, idx.reshape(c1 - c0, qcap, -1)).reshape(idx.shape).sum(-1)
        nrm = norms_blocks[c0:c1][ci, pp].double()
        m = fin[c0:c1]
        if not bool(torch.isfinite(nrm[m]).all()):
            raise AssertionError(f"{label}: a position names an invalid row")
        gap = (nrm - f * dots - ks[c0:c1].double()).abs()[m]
        if bool((gap > tol).any()):
            raise AssertionError(f"{label}: a chosen row's f64 score is {float(gap.max())} "
                                 "from its bin score")
    return float(diff.max()) if diff.numel() else 0.0


def compare_grouped_case(ctx, label, lut, qslot, codes, norms, l_bins, chunk, metric, precision,
                         per_bin):
    from zvdb_tpu_torch.ops import pq_scan as PS

    ks, ki = PS.pq_grouped_scan_bins(lut, qslot, codes, norms, l_bins=l_bins, chunk=chunk,
                                     metric=metric, precision=precision, per_bin=per_bin)
    ps, pi = PS._pq_grouped_scan_bins_plain(lut, qslot, codes, norms, l_bins, chunk, metric,
                                            precision, per_bin)
    ctx.sync()
    err = check_grouped_bins(lut, qslot, codes, norms, l_bins, metric, precision, ks, ki, ps, pi,
                             label)
    print(f"  compare {label}: ok, max |kernel - plain| = {err:.3g}", flush=True)
    return err


def phase_compare_ivfpq(ctx: Ctx):
    from zvdb_tpu_torch.ops import pq_scan as PS

    rng = np.random.default_rng(432)
    dev = ctx.device
    # (B, C, cap, S, qcap, L, chunk, metric, precision, per_bin, invalid_every, live slots)
    cases = []
    for precision in ("int8", "default", "high"):
        for metric in ("l2", "dot"):
            for per_bin in (1, 2):   # cap 700: no multiple of L; qcap 64: four slot tiles
                cases.append((37, 50, 700, 16, 64, 256, 512, metric, precision, per_bin, 7, 20))
    cases += [
        (1, 20, 300, 16, 32, 256, 512, "l2", "int8", 2, 5, 3),       # B=1, qcap 32
        (70, 30, 1000, 32, 32, 128, 512, "l2", "high", 2, 9, 32),    # 64 KB of table: > 48 KB smem
        (9, 12, 40, 16, 32, 128, 128, "dot", "default", 1, 0, 4),    # cap < L: empty bins
    ]
    if not ctx.rehearse:   # the main path's geometry: about 4 live slots of 32 per cluster
        cases.append((BATCH, 4096, 624, 16, 32, 256, 512, "l2", "int8", 2, 11, 8))

    # the tie rule: each cluster repeats its first 256 rows, so every bin of
    # a live slot holds a row and its equal copy: the lower wins slot 1
    for precision in ("int8", "default", "high"):
        lut, qslot, codes, norms = grouped_inputs(rng, 65, 6, 512, 16, 32, "l2", dev, live=20,
                                                  dup=256)
        _, ki = PS.pq_grouped_scan_bins(lut, qslot, codes, norms, l_bins=256, chunk=256,
                                        precision=precision, per_bin=2)
        ki = ki[qslot >= 0]
        want = torch.arange(256, device=dev, dtype=torch.int32).expand(ki.shape[0], -1)
        if not (torch.equal(ki[:, :256], want) and torch.equal(ki[:, 256:], want + 256)):
            raise AssertionError(f"IVF-PQ tie rule broken ({precision})")
    print("  compare IVF-PQ tie rule (duplicated codes, every precision, per_bin=2): ok",
          flush=True)
    for b, c, cap, n_sub, qcap, l_bins, chunk, metric, precision, per_bin, inv, live in cases:
        lut, qslot, codes, norms = grouped_inputs(rng, b, c, cap, n_sub, qcap, metric, dev,
                                                  invalid_every=inv, live=live)
        label = (f"IVF-PQ B={b} C={c} cap={cap} S={n_sub} qcap={qcap} L={l_bins} {metric} "
                 f"{precision} per_bin={per_bin}")
        compare_grouped_case(ctx, label, lut, qslot, codes, norms, l_bins, chunk, metric,
                             precision, per_bin)
    phase_compare_pairs(ctx)


def pair_inputs(rng, b, c, cap, n_sub, p, q_cap, metric, dev, invalid_every=0, hot=0):
    """grouped_inputs' table, codes and norms, and the engine's slot tables
    (index/ivf.py:_slot_pairs) for p distinct random probes a query; hot > 0
    sends that many queries' rank-0 probe to cluster 0, past q_cap."""
    from zvdb_tpu_torch.index.ivf import _slot_pairs

    lut, _, codes, norms = grouped_inputs(rng, b, c, cap, n_sub, 8, metric, dev,
                                          invalid_every=invalid_every)
    probes = np.argsort(rng.random((b, c)), axis=1)[:, :p]
    for r in range(min(hot, b)):   # cluster 0 first, then p - 1 others
        probes[r] = np.concatenate([[0], 1 + np.argsort(rng.random(c - 1))[:p - 1]])
    qslot, pslot = _slot_pairs(torch.from_numpy(probes.astype(np.int64)).to(dev), b, p, c, q_cap)
    return lut, qslot, pslot, codes, norms


def pairs_to_slots(pool_s, pool_i, qslot, pslot, n_probe, lw, capp):
    """The pair scan's pools read back into the grouped scan's slot layout
    ([C, qcap, lw]: scores, positions within the cluster; empty slots +inf /
    -1) and the [B, n_probe] mask of the pools some slot names."""
    b = pool_s.shape[0]
    c = qslot.shape[0]
    live = (qslot >= 0)[..., None]
    q, p = qslot.clamp(min=0).long(), pslot.clamp(min=0).long()
    ss = pool_s.reshape(b, n_probe, lw)[q, p]
    ii = pool_i.reshape(b, n_probe, lw)[q, p]
    cidx = torch.arange(c, device=ii.device)[:, None, None] * capp
    ss = torch.where(live, ss, float("inf"))
    ii = torch.where(live & (ii >= 0), ii - cidx, -1).to(torch.int32)
    covered = torch.zeros((b, n_probe), dtype=torch.bool, device=ii.device)
    covered[q[qslot >= 0], p[qslot >= 0]] = True
    return ss, ii, covered


def compare_pairs_case(ctx, label, lut, qslot, pslot, codes, norms, n_probe, l_bins, chunk,
                       metric, precision, per_bin):
    """The pair scan against its plain version: "int8" pools equal with
    torch.equal; every precision read back into the slot layout and held to
    the grouped scan's plain bins by check_grouped_bins (tie-aware for
    "default"/"high"), and every pool no slot names all +inf / -1."""
    from zvdb_tpu_torch.ops import pq_scan as PS

    before = PS.pq_grouped_scan_pairs.launches
    ks, ki = PS.pq_grouped_scan_pairs(lut, qslot, pslot, codes, norms, n_probe, l_bins=l_bins,
                                      chunk=chunk, metric=metric, precision=precision,
                                      per_bin=per_bin)
    PS.pq_grouped_scan_pairs.launches = before   # comparison launches count for nothing
    ps, pi = PS._pq_grouped_scan_pairs_plain(lut, qslot, pslot, codes, norms, n_probe, l_bins,
                                             chunk, metric, precision, per_bin)
    ctx.sync()
    if precision == "int8" and not (torch.equal(ki, pi) and torch.equal(ks, ps)):
        raise AssertionError(f"{label}: {int((ki != pi).sum())} positions and "
                             f"{int((ks != ps).sum())} scores differ from plain")
    lw = per_bin * l_bins
    _, capp = PS.grouped_geometry(codes.shape[2], l_bins, chunk)
    ss, si, covered = pairs_to_slots(ks, ki, qslot, pslot, n_probe, lw, capp)
    bs, bi = PS._pq_grouped_scan_bins_plain(lut, qslot, codes, norms, l_bins, chunk, metric,
                                            precision, per_bin)
    err = check_grouped_bins(lut, qslot, codes, norms, l_bins, metric, precision, ss, si, bs, bi,
                             label)
    gone = ~covered.reshape(-1)
    b = ks.shape[0]
    if not (bool((ki.reshape(b * n_probe, lw)[gone] == -1).all())
            and bool(torch.isinf(ks.reshape(b * n_probe, lw)[gone]).all())):
        raise AssertionError(f"{label}: a pool no slot names is not all +inf / -1")
    print(f"  compare {label}: ok ({int(gone.sum())} uncovered pools), max |kernel - plain| = "
          f"{err:.3g}", flush=True)
    return err


def phase_compare_pairs(ctx: Ctx):
    """The pair scan (pq_grouped_scan_pairs) against its plain version:
    every precision x {l2, dot} x per_bin {1, 2} on the engine's slot tables
    with a hot cluster past q_cap, cap no multiple of L, tombstones, qcap
    past one window, B=1, a cap below L, and a cap too large to stage."""
    rng = np.random.default_rng(4320)
    dev = ctx.device
    # (B, C, cap, S, P, q_cap, L, chunk, metric, precision, per_bin, invalid_every, hot)
    cases = [(37, 50, 700, 16, 5, 32, 256, 512, metric, precision, per_bin, 7, 33)
             for precision in ("int8", "default", "high") for metric in ("l2", "dot")
             for per_bin in (1, 2)]
    cases += [
        (300, 40, 300, 16, 4, 96, 128, 256, "l2", "int8", 2, 5, 120),      # int8 window < qcap
        (200, 30, 500, 32, 3, 64, 128, 512, "l2", "high", 2, 9, 90),       # "high": 4 windows
        (1, 20, 300, 16, 8, 32, 256, 512, "l2", "int8", 2, 5, 0),          # B=1
        (9, 12, 40, 16, 4, 32, 128, 128, "dot", "default", 1, 0, 0),       # cap < L
        (20, 6, 4200, 16, 2, 32, 256, 512, "l2", "int8", 2, 3, 0),         # not staged: 50 KB
    ]
    if not ctx.rehearse:   # the ivfpq_1m geometry on random codes
        cases.append((BATCH, 5467, 624, 16, 8, 32, 256, 512, "l2", "int8", 2, 11, 0))
    for b, c, cap, n_sub, p, q_cap, l_bins, chunk, metric, precision, per_bin, inv, hot in cases:
        lut, qslot, pslot, codes, norms = pair_inputs(rng, b, c, cap, n_sub, p, q_cap, metric,
                                                      dev, invalid_every=inv, hot=hot)
        label = (f"IVF-PQ pairs B={b} C={c} cap={cap} S={n_sub} P={p} qcap={q_cap} L={l_bins} "
                 f"{metric} {precision} per_bin={per_bin}")
        compare_pairs_case(ctx, label, lut, qslot, pslot, codes, norms, p, l_bins, chunk, metric,
                           precision, per_bin)


def phase_ivfpq_main(ctx: Ctx, x1, q1, gt):
    from zvdb_tpu_torch import IVFPQConfig, IVFPQIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.index import ivfpq as IV
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import pq as PQ
    from zvdb_tpu_torch.ops import pq_scan as PS

    dev = ctx.device
    cfg = IVFPQConfig(dim=ctx.dim)
    ctx.report("ivfpq_1m config", f"{cfg}, search {IVFPQ_SEARCH}")
    n_batches = -(-q1.shape[0] // ctx.batch)
    xd = torch.from_numpy(x1).to(dev)
    warm = IVFPQIndex(cfg, device=dev)    # first use of every op on the card
    warm.build(xd)
    del warm
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    reset_kernel_counts()
    build_pps = []
    for _ in range(2):
        t0 = time.perf_counter()
        idx = IVFPQIndex(cfg, device=dev)
        idx.build(xd)
        ctx.sync()
        build_pps.append(ctx.n / (time.perf_counter() - t0))
    reset_kernel_counts()
    ids = batched_ids(ctx, idx, q1, **IVFPQ_SEARCH)
    ctx.sync()
    counts = kernel_counts()
    launches = counts["C_pairs"]
    rec = recall_at_k(ids, gt, K)
    ctx.report("ivfpq_1m build points/s (2 runs, rows already on the device)", build_pps)
    ctx.report("ivfpq_1m recall@10", rec)
    ctx.report("ivfpq_1m kernel launches", f"{counts} for {n_batches} batches")
    if dev.type == "cuda":
        ctx.report("ivfpq_1m peak device memory GB (build + search, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    if not ctx.rehearse and (launches != n_batches or sum(counts.values()) != n_batches):
        raise AssertionError(f"ivfpq_1m kernel launches {counts}: the pair scan once a batch "
                             f"({n_batches}) and nothing else")
    if rec < 0.95:
        raise AssertionError(f"ivfpq_1m recall@10 {rec} < 0.95")
    os.environ["ZVDB_BUILD_TRACE"] = "1"   # one more build, its stages timed (syncs between)
    try:
        IVFPQIndex(cfg, device=dev).build(xd)
    finally:
        del os.environ["ZVDB_BUILD_TRACE"]
    del xd

    # the pair scan on the main path's own inputs (the first batch's table
    # and slots) against its plain version, and kernel C beside it
    st = idx.state
    c, _, cap = st.codes_blocks.shape
    _, capp = PS.grouped_geometry(cap, cfg.l_bins, cfg.chunk)
    qp = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), cfg.metric)
    p, qslot, pslot = IV._probe_slots(st, qp, IVFPQ_SEARCH["nprobe"], cfg.group_slack,
                                      cfg.scan_precision, cfg.metric)
    lut = PQ.adc_lut(PQ.apply_rotation(qp, st.rot), st.codebooks)
    live = int((qslot >= 0).sum())
    ctx.report("ivfpq_1m geometry (first batch)",
               f"C={c} cap={cap} capp={capp} q_cap={qslot.shape[1]}; live slots {live} of "
               f"{qslot.numel()}, {qp.shape[0] * p - live} probe pairs dropped")
    errs = {}
    for precision in ("int8", "default", "high"):
        errs[precision] = compare_pairs_case(
            ctx, f"IVF-PQ pairs main-path inputs B={lut.shape[0]} C={c} cap={cap} {precision}",
            lut, qslot, pslot, st.codes_blocks, st.norms_blocks, p, cfg.l_bins, cfg.chunk,
            cfg.metric, precision, cfg.per_bin)
    compare_grouped_case(ctx, f"IVF-PQ kernel C main-path inputs B={lut.shape[0]} int8", lut,
                         qslot, st.codes_blocks, st.norms_blocks, cfg.l_bins, cfg.chunk,
                         cfg.metric, "int8", cfg.per_bin)
    # a hot cluster past q_cap: the first 4 * q_cap queries all probe the
    # first query's nearest cluster (in place of their last probe)
    cs = D.pairwise_scores(qp, st.centroids, st.c_norms, cfg.metric)
    probes = torch.topk(cs, p, dim=1, largest=False).indices
    hot = probes[0, 0]
    n_hot = min(4 * qslot.shape[1], qp.shape[0])
    has = (probes[:n_hot] == hot).any(1)
    probes[:n_hot, -1] = torch.where(has, probes[:n_hot, -1], hot)
    hslot, hpslot = IV._slot_pairs(probes, qp.shape[0], p, c, qslot.shape[1])
    for precision in ("int8", "default", "high"):
        compare_pairs_case(
            ctx, f"IVF-PQ pairs main-path inputs, cluster {int(hot)} probed by {n_hot} queries "
            f"(q_cap {qslot.shape[1]}) {precision}", lut, hslot, hpslot, st.codes_blocks,
            st.norms_blocks, p, cfg.l_bins, cfg.chunk, cfg.metric, precision, cfg.per_bin)
    return idx, ids, launches, lut, (p, qslot, pslot, hslot, hpslot), errs


PAIR_STAGE = "constexpr int PAIR_STAGE_BYTES = 49152;"


def build_pairs_unstaged():
    """The pair scan's entry point built from csrc/pq_scan.cu with its
    staging threshold at 0, so that no cluster's codes and norms are staged
    in shared memory and every walk reads them through the read-only cache:
    phase 12's A/B against the shipped kernel. The engines never run it."""
    import ctypes

    from zvdb_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "pq_scan.cu").read_text()
    if src.count(PAIR_STAGE) != 1:
        raise RuntimeError("pq_scan.cu's PAIR_STAGE_BYTES moved: update PAIR_STAGE")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / "pq_scan_unstaged.cu"
    path.write_text(src.replace(PAIR_STAGE, "constexpr int PAIR_STAGE_BYTES = 0;"))
    lib = path.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).zvdb_pq_grouped_scan_pairs
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pairs_entry(kernel, lut, qslot, pslot, st, cfg, p, precision):
    """A call of one pair-scan entry point on inputs prepared once (the
    table quantized, the outputs allocated), returning its pools; counts
    nothing. Times the kernels alone, without the wrapper's table ops."""
    from zvdb_tpu_torch.ops import pq_scan as PS

    b, n_sub, _ = lut.shape
    c, _, cap = st.codes_blocks.shape
    _, capp = PS.grouped_geometry(cap, cfg.l_bins, cfg.chunk)
    lut_k, scales = PS._prep_lut(lut, precision)
    lut_k = lut_k.contiguous()
    width = p * cfg.per_bin * cfg.l_bins
    pool_s = torch.empty((b, width), dtype=torch.float32, device=lut.device)
    pool_i = torch.empty((b, width), dtype=torch.int32, device=lut.device)
    covered = torch.empty(b * p, dtype=torch.uint8, device=lut.device)
    args = (lut_k.data_ptr(), scales.data_ptr(), qslot.data_ptr(), pslot.data_ptr(),
            st.codes_blocks.data_ptr(), st.norms_blocks.data_ptr(), pool_s.data_ptr(),
            pool_i.data_ptr(), covered.data_ptr(), b, p, c, qslot.shape[1], cap, capp, n_sub,
            cfg.l_bins, 2.0 if cfg.metric == "l2" else 1.0, PS._PRECISION_CODE[precision],
            cfg.per_bin)

    def call():
        rc = kernel(*args, torch.cuda.current_stream(lut.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pair scan entry point failed with CUDA error {rc}")
        return pool_s, pool_i
    return call


def phase_pairs_stage_ab(ctx: Ctx, idx, lut, slots):
    """The pair scan's two code paths on the main path's first batch and on
    its hot-cluster slots: the shipped kernel, which stages each cluster's
    codes and norms in shared memory when they fit 48 KB (every cluster of
    ivfpq_1m), against the same source built never to stage. Pools equal
    bit for bit; each entry point timed twice, in the order shipped,
    unstaged, unstaged, shipped, 100 calls each."""
    from zvdb_tpu_torch.ops import pq_scan as PS

    if ctx.device.type != "cuda":
        return
    cfg, st = idx.cfg, idx.state
    p, qslot, pslot, hslot, hpslot = slots
    cases = [("first batch", qslot, pslot, pr) for pr in ("int8", "default", "high")]
    cases += [("hot cluster", hslot, hpslot, "int8")]
    for label, qs, ps, pr in cases:
        shipped = pairs_entry(PS.build_pairs(), lut, qs, ps, st, cfg, p, pr)
        unstaged = pairs_entry(ctx.pairs_unstaged, lut, qs, ps, st, cfg, p, pr)
        a = [t.clone() for t in shipped()]
        u = unstaged()
        if not (torch.equal(a[0], u[0]) and torch.equal(a[1], u[1])):
            raise AssertionError(f"pair scan {label} {pr}: staged and unstaged pools differ")
        ms = [ctx.time_ms(fn, reps=100) for fn in (shipped, unstaged, unstaged, shipped)]
        ctx.report(f"ivfpq pair scan entry ms ({label}, {pr}): staged (shipped) "
                   f"[{ms[0]}, {ms[3]}], unstaged [{ms[1]}, {ms[2]}]; pools equal", "")


def old_route(lut, qslot, pslot, st, cfg, p, precision):
    """The IVF-PQ search's scan before the pair scan: kernel C's [C, qcap,
    lw] slot output, then the scatter to per-query pools (what the JAX
    package's search does). Returns the pools."""
    from zvdb_tpu_torch.ops import pq_scan as PS

    bin_s, bin_pos = PS.pq_grouped_scan_bins(
        lut, qslot, st.codes_blocks, st.norms_blocks, l_bins=cfg.l_bins, chunk=cfg.chunk,
        metric=cfg.metric, precision=precision, per_bin=cfg.per_bin)
    _, capp = PS.grouped_geometry(st.codes_blocks.shape[2], cfg.l_bins, cfg.chunk)
    return PS.slots_to_pools(bin_s, bin_pos, qslot, pslot, p, capp, lut.shape[0])


def peak_bytes(ctx: Ctx, fn) -> float:
    """Device bytes allocated at the peak of fn() above what was live before."""
    if ctx.device.type != "cuda":
        fn()
        return float("nan")
    ctx.sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    ctx.sync()
    return float(torch.cuda.max_memory_allocated() - base)


def phase_ivfpq_times(ctx: Ctx, idx, q1, lut, slots):
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops.pq import unpack_nibbles

    cfg, st = idx.cfg, idx.state
    dev = ctx.device
    p, qslot, pslot = slots[:3]
    b, n_sub, _ = lut.shape
    c, nb, cap = st.codes_blocks.shape
    qcap = qslot.shape[1]
    _, capp = PS.grouped_geometry(cap, cfg.l_bins, cfg.chunk)
    lw = cfg.per_bin * cfg.l_bins
    kw = dict(l_bins=cfg.l_bins, chunk=cfg.chunk, metric=cfg.metric, per_bin=cfg.per_bin)

    saved = (PS.pq_grouped_scan_pairs.launches, PS.pq_grouped_scan_bins.launches)
    ms = {pr: ctx.time_ms(lambda pr=pr: PS.pq_grouped_scan_pairs(
        lut, qslot, pslot, st.codes_blocks, st.norms_blocks, p, precision=pr, **kw), reps=50)
        for pr in ("int8", "default", "high")}
    ms_c = {pr: ctx.time_ms(lambda pr=pr: PS.pq_grouped_scan_bins(
        lut, qslot, st.codes_blocks, st.norms_blocks, precision=pr, **kw), reps=20)
        for pr in ("int8", "default", "high")}
    ms_route = ctx.time_ms(lambda: old_route(lut, qslot, pslot, st, cfg, p, "int8"), reps=10)
    plain_ms = ctx.time_ms(lambda: PS._pq_grouped_scan_pairs_plain(
        lut, qslot, pslot, st.codes_blocks, st.norms_blocks, p, cfg.l_bins, cfg.chunk,
        cfg.metric, "int8", cfg.per_bin), reps=2)
    plain_c_ms = ctx.time_ms(lambda: PS._pq_grouped_scan_bins_plain(
        lut, qslot, st.codes_blocks, st.norms_blocks, cfg.l_bins, cfg.chunk, cfg.metric, "int8",
        cfg.per_bin), reps=2)
    mem_pairs = peak_bytes(ctx, lambda: PS.pq_grouped_scan_pairs(
        lut, qslot, pslot, st.codes_blocks, st.norms_blocks, p, precision="int8", **kw))
    mem_route = peak_bytes(ctx, lambda: old_route(lut, qslot, pslot, st, cfg, p, "int8"))
    qb = q1[:ctx.batch]
    mem_search = peak_bytes(ctx, lambda: idx.search(qb, K, **IVFPQ_SEARCH))
    if dev.type == "cuda":   # the wrapper's parts: the int8 table, the memset, the two kernels
        profile_calls(ctx, "ivfpq pair scan profile (int8, 10 calls)", [lambda: (
            PS.pq_grouped_scan_pairs(lut, qslot, pslot, st.codes_blocks, st.norms_blocks, p,
                                     precision="int8", **kw))] * 10, "call")
        profile_calls(ctx, "ivfpq previous route profile (int8, 3 calls)",
                      [lambda: old_route(lut, qslot, pslot, st, cfg, p, "int8")] * 3, "call")
    PS.pq_grouped_scan_pairs.launches, PS.pq_grouped_scan_bins.launches = saved
    # yardstick: the product part alone, torch.bmm of the slots' gathered
    # bf16 tables [C, qcap, S*16] by a prebuilt one-hot of each padded block
    # [C, S*16, capp]
    codes = torch.zeros((c, nb, capp), dtype=torch.uint8, device=dev)
    codes[:, :, :cap] = st.codes_blocks
    oh = torch.empty((c, n_sub * 16, capp), dtype=torch.bfloat16, device=dev)
    sixteen = torch.arange(16, device=dev, dtype=torch.uint8)
    for c0 in range(0, c, 256):
        cc = unpack_nibbles(codes[c0:c0 + 256].transpose(1, 2), n_sub)          # [cc, capp, S]
        oh[c0:c0 + 256] = (cc[..., None] == sixteen).reshape(cc.shape[0], capp, -1) \
            .transpose(1, 2).to(torch.bfloat16)
    lutg = lut.reshape(b, -1)[qslot.clamp(min=0).long()].to(torch.bfloat16)
    library_ms = ctx.time_ms(lambda: torch.bmm(lutg, oh), reps=10)
    del oh, codes, lutg
    # the bound, counted by what this batch needs: each pool written once
    # (B * P * lw scores and positions), the stored rows of the probed
    # clusters read once (codes and norms), the int8 table and scales, the
    # slot tables; against the int8 operations of each live slot over its
    # cluster's stored rows. The TPU's count is every slot of [C, qcap, lw]
    # written and every slot against every padded position.
    n_slots = (qslot >= 0).sum(1).double()
    probed_rows = float(st.counts.double()[n_slots > 0].sum())
    live_rows = float((n_slots * st.counts.double()).sum())
    ops = 2.0 * live_rows * n_sub * 16
    ops_tpu = 2.0 * c * qcap * capp * n_sub * 16
    in_bytes = b * n_sub * 16 + 4 * b + 8 * c * qcap + probed_rows * (nb + 4)
    pool_bytes = 8.0 * b * p * lw
    slot_bytes = 8.0 * c * qcap * lw
    bound_ops = ops / PEAK_INT8 * 1e3
    bound_bytes = (in_bytes + pool_bytes) / HBM_BYTES_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    tpu_bytes_ms = (b * n_sub * 16 + 4 * b + 4 * c * qcap + c * nb * cap + 4 * c * cap
                    + slot_bytes) / HBM_BYTES_S * 1e3
    shape = (f"B={b} P={p} C={c} cap={cap} capp={capp} qcap={qcap} S={n_sub} L={cfg.l_bins} "
             f"per_bin={cfg.per_bin}")
    for pr in ms:
        ctx.report(f"ivfpq pair scan ms ({pr}, {shape})", ms[pr])
        ctx.report(f"ivfpq kernel C ms ({pr}, the same inputs)", ms_c[pr])
    ctx.report("ivfpq previous route ms (kernel C int8 + flat positions + the slot scatter)",
               ms_route)
    ctx.report("ivfpq plain versions ms (int8): pair scan, kernel C", f"{plain_ms}, {plain_c_ms}")
    ctx.report("ivfpq torch.bmm yardstick ms (bf16 [C,qcap,S*16] x one-hot [C,S*16,capp])",
               library_ms)
    ctx.report("ivfpq bound ms, recounted (what the batch needs: bytes / 3.35 TB/s vs live "
               "int8 ops / 1979 TOP/s)",
               f"{bound_ms} (bytes {bound_bytes}: pools {pool_bytes:.4g} B + inputs "
               f"{in_bytes:.4g} B ({probed_rows:.0f} stored rows of probed clusters); ops "
               f"{bound_ops}: {ops:.4g}); the TPU's count: bytes {tpu_bytes_ms} ms with the "
               f"[C, qcap, lw] slot output {slot_bytes:.4g} B, ops {ops_tpu / PEAK_INT8 * 1e3} "
               f"ms ({ops_tpu:.4g})")
    ctx.report("ivfpq peak device bytes above the batch's inputs (int8): pair scan, previous "
               "route, one search batch", f"{mem_pairs:.4g}, {mem_route:.4g}, {mem_search:.4g}")
    ctx.report("ivfpq_1m search QPS (batches of 2048, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs=IVFPQ_SEARCH))
    ctx.report("ivfpq_1m server QPS (8 threads, requests of 16 queries)",
               server_qps(ctx, idx, q1, search_kwargs=IVFPQ_SEARCH))
    profile_search(ctx, idx, q1, label="ivfpq_1m", search_kwargs=IVFPQ_SEARCH)
    phase_pairs_stage_ab(ctx, idx, lut, slots)
    bound_by = "operations" if bound_ops >= bound_bytes else "bytes"
    return dict(ms=ms["int8"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)

# ---------------------------------------------------------------------------
# CAGRA: kernel D (block_bins) and the cagra_1m main path

def check_block_bins(v, vn, l_bins, metric, precision, ks, ki, ps, pi, label):
    """Tie-aware agreement of kernel D's bins with its plain version's: per
    block, check_bins with the block as both queries and corpus, and no row
    ever takes its own column. Returns the largest |kernel - plain|."""
    if bool((ki.long() == torch.arange(v.shape[1], device=ki.device)[None, :, None]).any()):
        raise AssertionError(f"{label}: a row took its own column")
    err = 0.0
    for c in range(v.shape[0]):
        err = max(err, check_bins(v[c], v[c], vn[c], l_bins, metric, precision, ks[c], ki[c],
                                  ps[c], pi[c], f"{label} block {c}"))
    return err


def compare_block_case(ctx, label, v, vn, l_bins, metric, precision):
    from zvdb_tpu_torch.ops import block_scan as BS

    ks, ki = BS.block_bins(v, vn, l_bins=l_bins, bq=2 * l_bins, metric=metric,
                           precision=precision)
    ps, pi = BS.block_bins_plain(v, vn, l_bins, metric, precision)
    ctx.sync()
    err = check_block_bins(v, vn, l_bins, metric, precision, ks, ki, ps, pi, label)
    print(f"  compare {label}: ok, max |kernel - plain| = {err:.3g}", flush=True)
    return err


def block_inputs(rng, cc, b, d, metric, dev, invalid_every=0):
    v = rng.standard_normal((cc, b, d)).astype(np.float32)
    vn = (v * v).sum(-1) if metric == "l2" else np.zeros((cc, b), np.float32)
    vn = vn.astype(np.float32)
    if invalid_every:
        vn.reshape(-1)[::invalid_every] = np.inf
    return torch.from_numpy(v).to(dev), torch.from_numpy(vn).to(dev)


def phase_compare_block(ctx: Ctx):
    from zvdb_tpu_torch.ops import block_scan as BS

    rng = np.random.default_rng(543)
    dev = ctx.device
    # (cc, B, D, L, metric, precision, invalid_every)
    cases = [(3, 700, 40, 128, metric, precision, 7)            # B no multiple of 256
             for precision in ("highest", "high", "default") for metric in ("l2", "dot")]
    cases += [(1, 40, 16, 128, "l2", "high", 9),                  # B < L: empty bins
              (2, 1000, 130, 64, "dot", "default", 0)]            # D > 128
    if not ctx.rehearse:   # the main path's shape
        cases.append((12, 1640, 128, 128, "l2", "high", 11))

    # the tie rule: rows L..2L-1 repeat rows 0..L-1, so for row r every bin
    # l != r holds two equal columns (the lower wins) and bin r the row's
    # own column (never taken) and its copy r+L
    for precision in ("highest", "high", "default"):
        v, vn = block_inputs(rng, 2, 128, 40, "l2", dev)
        v, vn = torch.cat([v, v], dim=1), torch.cat([vn, vn], dim=1)
        _, ki = BS.block_bins(v, vn, l_bins=128, bq=256, precision=precision)
        want = torch.arange(128, device=dev, dtype=torch.int32).expand(2, 256, 128).clone()
        r = torch.arange(128, device=dev)
        want[:, r, r] = r.to(torch.int32) + 128
        if not torch.equal(ki, want):
            raise AssertionError(f"block tie rule broken ({precision})")
    print("  compare block tie rule (duplicated rows, every precision): ok", flush=True)
    for cc, b, d, l_bins, metric, precision, inv in cases:
        v, vn = block_inputs(rng, cc, b, d, metric, dev, invalid_every=inv)
        compare_block_case(ctx, f"block cc={cc} B={b} D={d} L={l_bins} {metric} {precision}",
                           v, vn, l_bins, metric, precision)


CAGRA_SEARCH: dict = {}   # cagra_1m searches with the config's ef_search=12


def cagra_config(ctx: Ctx):
    from zvdb_tpu_torch import CagraConfig

    # the bench row's n_anchors = min(262144, n // 4)
    return CagraConfig(dim=ctx.dim, degree=32, metric="l2", n_anchors=min(262144, ctx.n // 4),
                       search_degree=24, max_iters=4, ef_search=12, block_topk="pallas")


def kernel_counts():
    from zvdb_tpu_torch.ops import block_scan as BS
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops import scan_topk as ST

    from zvdb_tpu_torch.ops import approx_topk as AK

    return dict(A=FS.flat_scan_bins.launches, A_mma=FS.flat_scan_bins.launches_mma,
                B=PS.pq_scan_bins.launches,
                B_mma=PS.pq_scan_bins.launches_mma, C=PS.pq_grouped_scan_bins.launches,
                C_pairs=PS.pq_grouped_scan_pairs.launches, D=BS.block_bins.launches,
                D_mma=BS.block_bins.launches_mma,
                E=ST.flat_topk_pallas.launches, E_mma=ST.flat_topk_pallas.launches_mma,
                F=ST.flat_topk_pallas2.launches, F_mma=ST.flat_topk_pallas2.launches_mma,
                approx=AK.approx_min_k.launches)


def reset_kernel_counts():
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import block_scan as BS
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops import scan_topk as ST

    FS.flat_scan_bins.launches = FS.flat_scan_bins.launches_mma = 0
    PS.pq_scan_bins.launches = PS.pq_scan_bins.launches_mma = 0
    PS.pq_grouped_scan_bins.launches = PS.pq_grouped_scan_pairs.launches = 0
    BS.block_bins.launches = BS.block_bins.launches_mma = 0
    ST.flat_topk_pallas.launches = ST.flat_topk_pallas.launches_mma = 0
    ST.flat_topk_pallas2.launches = ST.flat_topk_pallas2.launches_mma = 0
    AK.approx_min_k.launches = 0


def besides_approx(counts: dict) -> dict:
    """The counters of `counts` other than approx_min_k's that are not 0."""
    return {k: v for k, v in counts.items() if k != "approx" and v}


def check_approx(ctx: Ctx, label: str, got: int, want: int):
    """On the card, approx_min_k must have launched exactly `want` times:
    once for each call of a site whose JAX guard holds, at no other."""
    ctx.report(f"{label} approx_min_k launches", f"{got} (expected {want})")
    if not ctx.rehearse and got != want:
        raise AssertionError(f"{label}: approx_min_k launched {got} times, expected {want}")


def check_seed_launches(ctx: Ctx, label: str, before: dict, after: dict, want: dict):
    """CAGRA searches between the counts `before` and `after` must have
    launched what bench_cuda.cagra_seed_launches expects of their seed
    anchors (approx_min_k, and kernel A on the tensor cores where the
    batch takes the "bins" route) and no other kernel."""
    got = {k: after[k] - before[k] for k in after}
    check_approx(ctx, label, got["approx"], want["approx"])
    others = besides_approx(got)
    ctx.report(f"{label} other kernel launches", f"{others} (expected A and A_mma "
               f"{want['A']})")
    if others != besides_approx(want):
        raise AssertionError(f"{label}: kernels launched {got}, expected {want}")


def compare_seed_bins(ctx: Ctx, label: str, q, anchors, a_norms, n_seeds: int, metric: str):
    """Kernel A on a CAGRA index's own seed operand (index/cagra.py:
    _binned_seeds: the anchor table folded into approx_min_k's L bins)
    against its plain version, at both tensor-core precisions."""
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import distance as D

    a = anchors.shape[0]
    L = AK.reduction_output_size(a, 2, min(n_seeds, a), 0.95)
    qp = D.preprocess_queries(torch.as_tensor(q, device=anchors.device), metric)
    errs = {p: compare_case(ctx, f"{label} seed bins [{qp.shape[0]}, {a}] L={L} {p}", qp,
                            anchors, a_norms, L, metric, p) for p in ("high", "default")}
    ctx.report(f"{label} seed bins [{qp.shape[0]}, {a}] L={L} max |kernel A - plain| by "
               "precision", errs)


def binned_plain(s, k, recall_target=0.95):
    """The kernel's function in plain PyTorch at the operand's own L:
    what approx_min_k computes on the card, on any device; counts nothing."""
    from zvdb_tpu_torch.ops import approx_topk as AK

    return AK._approx_min_k_plain(
        s, k, AK.reduction_output_size(s.shape[-1], s.dim(), k, recall_target))


def exact_selection(s, k, recall_target=0.95):
    """The exact top-k the sites took before approx_min_k had a kernel."""
    from zvdb_tpu_torch.ops import topk as T

    return T.smallest_k_dense(s, k)


class _Swapped:
    """What every approx_min_k site calls while site_selection holds: `select`,
    with the kernel wrapper's launch counter read and written through."""

    def __init__(self, select, kernel):
        self.select, self.kernel = select, kernel

    def __call__(self, s, k, recall_target=0.95):
        return self.select(s, k, recall_target)

    launches = property(lambda self: self.kernel.launches,
                        lambda self, v: setattr(self.kernel, "launches", v))


@contextlib.contextmanager
def site_selection(select):
    """Every approx_min_k site (each calls ops/approx_topk.py:approx_min_k
    through the module) selects with `select` inside the block: the CPU side
    of a card-vs-CPU comparison takes `binned_plain`, as the card selects; a
    comparison with an exact path takes `exact_selection`."""
    from zvdb_tpu_torch.ops import approx_topk as AK

    saved = AK.approx_min_k
    AK.approx_min_k = _Swapped(select, getattr(saved, "kernel", saved))
    try:
        yield
    finally:
        AK.approx_min_k = saved


def phase_cagra_main(ctx: Ctx, x1, q1, gt):
    import bench_cuda as BC
    from zvdb_tpu_torch import CagraIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k

    dev = ctx.device
    cfg = cagra_config(ctx)
    ctx.report("cagra_1m config", cfg)
    n_batches = -(-q1.shape[0] // ctx.batch)
    xd = torch.from_numpy(x1).to(dev)
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the main path: build, then search every batch; counts read after each
    reset_kernel_counts()
    t0 = time.perf_counter()
    idx = CagraIndex(cfg, device=dev)
    idx.build(xd)
    ctx.sync()
    build_s = time.perf_counter() - t0
    after_build = kernel_counts()
    ids = batched_ids(ctx, idx, q1, **CAGRA_SEARCH)
    ctx.sync()
    after_search = kernel_counts()
    lb = idx.build_stats
    expected = sum(-(-cb // lb["cc"]) for cb in lb["c_blocks"])
    rec = recall_at_k(ids, gt, K)
    ctx.cagra_pps = ctx.n / build_s
    ctx.report("cagra_1m build points/s (first build, rows already on the device)",
               ctx.cagra_pps)
    ctx.report("cagra_1m build geometry", f"c={lb['c']} bcap={lb['bcap']} cc={lb['cc']} "
               f"kc={lb['kc']} blocks per pass {lb['c_blocks']}")
    ctx.report("cagra_1m kernel launches", f"build: block_bins {after_build['D']}, of them on "
               f"the tensor cores {after_build['D_mma']} (expected sum of ceil(c_blocks/cc) = "
               f"{expected}); A {after_build['A']}, B "
               f"{after_build['B']}, C {after_build['C']}; search of {n_batches} batches: "
               f"{ {k: after_search[k] - after_build[k] for k in after_search} }")
    ctx.report("cagra_1m recall@10 (ef=12)", rec)
    if dev.type == "cuda":
        ctx.report("cagra_1m peak device memory GB (build + search, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    if not ctx.rehearse and (after_build["D"] != expected or after_build["D_mma"] != expected
                             or after_build["A"] or after_build["B"] or after_build["C"]
                             or after_build["approx"]):
        raise AssertionError(f"build launched {after_build}, expected D == D_mma == {expected} "
                             "only")
    # search: approx_min_k selects the seed anchors, once a batch (A > 4 * n_seeds),
    # over kernel A's bins in a batch of SEED_BINS_MIN_QUERIES or more
    check_seed_launches(ctx, f"cagra_1m search ({n_batches} batches)", after_build,
                        after_search, BC.cagra_seed_launches(idx, BC.pass_sizes(
                            q1.shape[0], ctx.batch)))
    if rec < 0.95:
        raise AssertionError(f"cagra_1m recall@10 {rec} < 0.95")
    compare_seed_bins(ctx, "cagra_1m", q1[:ctx.batch], idx.state.anchors, idx.state.a_norms,
                      cfg.n_seeds, cfg.metric)
    for ef in (16, 24):
        ctx.report(f"cagra_1m recall@10 (ef={ef})",
                   recall_at_k(batched_ids(ctx, idx, q1, ef_search=ef), gt, K))

    # one more build with its stages timed (a sync between stages)
    os.environ["ZVDB_BUILD_TRACE"] = "1"
    try:
        t0 = time.perf_counter()
        CagraIndex(cfg, device=dev).build(xd)
        ctx.sync()
        ctx.report("cagra_1m traced build points/s", ctx.n / (time.perf_counter() - t0))
    finally:
        del os.environ["ZVDB_BUILD_TRACE"]

    # kernel D on the main-path build's own first chunk (the last pass),
    # held against its plain version
    bp = lb["first_chunk"]
    valid = bp >= 0
    safe = bp.clamp(min=0).long()
    v = xd[safe]
    vn = torch.where(valid, (xd * xd).sum(-1)[safe], float("inf"))
    errs = {}
    for precision in ("high", "default", "highest"):
        errs[precision] = compare_block_case(
            ctx, f"block main-path chunk {tuple(v.shape)} {precision}", v, vn, 128, "l2",
            precision)
    del xd
    return idx, ids, after_build["D"], (v, vn), errs


def phase_cagra_times(ctx: Ctx, idx, q1, chunk):
    from zvdb_tpu_torch.ops import block_scan as BS

    v, vn = chunk
    cc, b, d = v.shape
    L = 128
    # 100 calls per time on the card: the first timing after the server phase
    # is the one a host stall of a few ms would move
    reps = 3 if ctx.rehearse else 100
    ms = {p: ctx.time_ms(lambda p=p: BS.block_bins(v, vn, l_bins=L, bq=256, precision=p),
                         reps=reps, warmup=5)
          for p in ("high", "default", "highest")}
    if not ctx.rehearse:   # the previous kernel D: the CUDA-core entry, called directly
        fma = BS.build()
        out = (torch.empty((cc, b, L), device=v.device),
               torch.empty((cc, b, L), dtype=torch.int32, device=v.device))
        fma_ms = {p: ctx.time_ms(lambda p=p: BS.launch(fma, v, vn, *out, "l2", p), reps=reps,
                                 warmup=5)
                  for p in ("high", "default")}
        del out
    plain_ms = ctx.time_ms(lambda: BS.block_bins_plain(v, vn, L, "l2", "high"), reps=5)
    vb = v.to(torch.bfloat16)
    vlo = (v - vb.float()).to(torch.bfloat16)
    library_ms = ctx.time_ms(lambda: torch.bmm(vb, vb.transpose(1, 2)), reps=20)
    split_ms = ctx.time_ms(lambda: (torch.bmm(vb, vb.transpose(1, 2)),
                                    torch.bmm(vb, vlo.transpose(1, 2)),
                                    torch.bmm(vlo, vb.transpose(1, 2))), reps=20)
    f32_ms = ctx.time_ms(lambda: torch.bmm(v, v.transpose(1, 2)), reps=10)
    del vb, vlo
    ops = 2.0 * cc * b * b * d            # one full [B, B] product per block, as computed
    needed = 1.0 * cc * b * (b - 1) * d   # the B(B-1)/2 distinct pairs: scores are symmetric
    nbytes = cc * b * d * 4 + cc * b * 4 + cc * b * L * 8
    bound_ops, bound_bytes = 3 * needed / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    shape = f"cc={cc} B={b} D={d} L={L}"
    for p, t in ms.items():
        route = "CUDA cores, flat_scan.cu" if p == "highest" else "tensor cores, block_bins.cu"
        ctx.report(f"block kernel ms ({p}, {route}, {shape})", t)
    if not ctx.rehearse:
        for p, t in fma_ms.items():
            ctx.report(f"previous kernel D (CUDA cores) ms ({p}, zvdb_block_bins called "
                       "directly)", t)
    ctx.report("block kernel achieved TFLOP/s (the full products it computes: high 3, "
               "default 1)",
               f"{3 * ops / (ms['high'] * 1e-3) / 1e12} high, "
               f"{ops / (ms['default'] * 1e-3) / 1e12} default")
    ctx.report("block plain version ms (high)", plain_ms)
    ctx.report("block torch.bmm yardstick ms (bf16 [cc,B,D] x [cc,D,B], one product)", library_ms)
    ctx.report("block torch.bmm yardstick ms (the split's three bf16 products hi.hi, hi.lo, "
               "lo.hi)", split_ms)
    ctx.report("block torch.bmm f32 ms (same shapes, TF32 off)", f32_ms)
    ctx.report("block bound ms (high: 3 bf16 products over the distinct pairs / 989 TFLOP/s "
               "vs bytes / 3.35 TB/s)",
               f"{bound_ms} (ops {bound_ops}, bytes {bound_bytes}; default "
               f"{max(needed / PEAK_BF16 * 1e3, bound_bytes)}, highest "
               f"{max(needed / PEAK_F32 * 1e3, bound_bytes)}); share of the bound: high "
               f"{bound_ms / ms['high']}")
    ctx.report("cagra_1m search QPS (batches of 2048, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs=CAGRA_SEARCH))
    ctx.report("cagra_1m server QPS (8 threads, requests of 16 queries)",
               server_qps(ctx, idx, q1, search_kwargs=CAGRA_SEARCH))
    # one beam hop's candidate scoring as the search runs it: CAGRA's own
    # scorer over [B, expand * search_degree] rows of its packed table
    from zvdb_tpu_torch.index import cagra as CG
    cfg = idx.cfg
    arrs = idx._search_arrays()
    qp = torch.from_numpy(q1[:ctx.batch]).to(ctx.device)
    scorer = CG._make_scorer(arrs, qp, cfg.metric, cfg.packed, cfg.precision)
    cand = cfg.expand * cfg.search_degree
    rows = torch.from_numpy(np.random.default_rng(766).integers(
        0, len(idx), (qp.shape[0], cand)).astype(np.int32)).to(ctx.device)
    ctx.report(f"cagra_1m hop scorer ms (rows [{qp.shape[0]}, {cand}] of the "
               f"{list(arrs.table.shape)} table, precision {cfg.precision!r})",
               ctx.time_ms(lambda: scorer(rows), reps=20))
    profile_search(ctx, idx, q1, label="cagra_1m", search_kwargs=CAGRA_SEARCH)
    return dict(ms=ms["high"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="operations" if bound_ops >= bound_bytes else "bytes")

# ---------------------------------------------------------------------------
# Exact flat top-k: kernels E (flat_topk_pallas) and F (flat_topk_pallas2)


def _scores64(q, x, ids, metric):
    """f64 surrogate scores of rows `ids` [b, k] (clamped to valid rows)."""
    xs = x[ids.clamp(min=0).long()].double()                         # [b, k, D]
    dots = (q.double()[:, None, :] * xs).sum(-1)
    return (xs * xs).sum(-1) - 2.0 * dots if metric == "l2" else -dots


def check_topk(q, x, metric, ks, ki, ps, pi, label):
    """Tie-aware agreement of an exact top-k (ks, ki) with its plain version
    (ps, pi), both in slot order. The scores of each row, sorted, agree within
    1e-5 of the score scale (the largest finite |plain score|): the f32 dots
    sum in other orders. Each row holds as many ids. Where a row's ids differ
    from the plain row's, every id the plain row lacks is a near-tie: its
    score recomputed in f64 lies within that tolerance of the plain row's
    worst. Returns (largest |kernel - plain| over sorted scores, rows whose
    ids differ)."""
    if not torch.equal((ki < 0).sum(1), (pi < 0).sum(1)):
        raise AssertionError(f"{label}: rows hold different numbers of ids")
    fin = torch.isfinite(ps)
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0
    tol = 1e-5 * scale
    sk, sp = torch.sort(ks, 1).values, torch.sort(ps, 1).values
    if not torch.equal(torch.isfinite(sk), torch.isfinite(sp)):
        raise AssertionError(f"{label}: finite scores differ in number")
    diff = (sk - sp).abs()[torch.isfinite(sp)]
    err = float(diff.max()) if diff.numel() else 0.0
    if err > tol:
        raise AssertionError(f"{label}: scores differ by up to {err} (tolerance {tol})")
    rows = torch.nonzero((ki != pi).any(1)).flatten()
    if rows.numel():
        kid, pid = ki[rows], pi[rows]
        extra = (kid >= 0) & ~(kid[:, :, None] == pid[:, None, :]).any(-1)
        s64 = _scores64(q[rows], x, kid, metric)
        worst = torch.where(torch.isfinite(ps[rows]), ps[rows], -float("inf")).amax(1)
        if bool((s64 - worst[:, None].double() > tol)[extra].any()):
            raise AssertionError(f"{label}: an id differs from plain without a tie")
    return err, int(rows.numel())


def _topk_inputs(rng, n, d, b, dev, dup=0):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dup:   # rows 300 .. 300+dup-2 repeat row 0, and query 0 is row 0
        x[300:300 + dup - 1] = x[0]
        q[0] = x[0]
    return torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)


def _overflow_inputs(rng, dev):
    """Query 0's nearest row repeated 600 times past the first chunks (rows
    5000-5599), then 100 rows 1 ulp away from it in one coordinate: at
    k=100 query 0's candidate list overflows."""
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    q = rng.standard_normal((24, 64)).astype(np.float32)
    near = int(np.argmin(((x - q[0]) ** 2).sum(1)))
    x[5000:5600] = x[near]
    x[5600:5700] = x[near]
    x[5600:5700, 0] = np.nextafter(x[near, 0], np.float32(np.inf))
    return torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)


def _far_inputs(rng, dev):
    """Rows of norm ~1e3 around a query near the origin: ||x||^2 ~ 1e6
    against dots ~1e-1, where an l2 score cancels most."""
    x = rng.standard_normal((8_000, 64)).astype(np.float32)
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * (1e3 + rng.standard_normal((8_000, 1)))
    q = (1e-3 * rng.standard_normal((16, 64))).astype(np.float32)
    return torch.from_numpy(q).to(dev), torch.from_numpy(x.astype(np.float32)).to(dev)


def _misaligned(x):
    """x as a contiguous view whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _scan_stats(ST, q, x, k, metric, chunk):
    """The tensor-core E's filter counters for one uncounted launch."""
    st = torch.zeros(5, dtype=torch.int64, device=q.device)
    ST.launch(ST.build_v1_mma(), q, x, k, metric, chunk, stats=st)
    return dict(zip(ST._STATS, st.tolist()))


def _scan_stats_f(ST, q, x, k, metric, chunk):
    """The tensor-core F's filter counters for one uncounted launch."""
    st = torch.zeros(5, dtype=torch.int64, device=q.device)
    ST.launch_f_passes(ST.build_v2_mma(), q, x, k, metric, chunk, stats=st)
    return dict(zip(ST._STATS_F, st.tolist()))


def phase_compare_scan(ctx: Ctx):
    from zvdb_tpu_torch.ops import scan_topk as ST

    rng = np.random.default_rng(654)
    dev = ctx.device
    old_e = None if ctx.rehearse else ST.build_v1()
    old_f = None if ctx.rehearse else ST.build_v2_passes()
    # (N, D, B, k, metric, chunk, inputs); inputs None: seeded normal rows
    cases = [(5000, 128, 37, k, metric, chunk, None)
             for metric in ("l2", "dot") for chunk in (256, 2048) for k in (1, 10, 100)]
    cases += [(5003, 40, 70, 100, "l2", 256, None),    # ragged N: the last chunk's tail past N
              (3000, 33, 1, 10, "dot", 2048, None),     # B=1, D % 4 != 0 (the scalar path)
              (5, 16, 9, 10, "l2", 256, None),          # N < k: slots past N stay +inf / -1
              (700, 64, 513, 10, "l2", 2048, None),     # N < chunk, B no multiple of the tile
              (20_000, 64, 37, 256, "l2", 4096, None),  # the largest k and chunk
              (5000, 1024, 20, 10, "dot", 2048, None),  # the deepest D
              (5000, 33, 19, 10, "l2", 256, "misaligned"),   # D = 33 on a misaligned x
              (6000, 128, 17, 10, "l2", 2048, None),    # B = 17, no multiple of 16
              (20_000, 64, 24, 100, "l2", 2048, "overflow"),
              (8_000, 64, 16, 10, "l2", 2048, "far")]
    if not ctx.rehearse:
        cases.append((200_000, 128, BATCH, 10, "l2", 2048, None))   # the main path's width
    for n, d, b, k, metric, chunk, kind in cases:
        if kind == "overflow":
            q, x = _overflow_inputs(rng, dev)
        elif kind == "far":
            q, x = _far_inputs(rng, dev)
        else:
            q, x = _topk_inputs(rng, n, d, b, dev)
            if kind == "misaligned" and dev.type == "cuda":
                x = _misaligned(x)
                assert x.data_ptr() % 16 == 4
        ps, pi = ST._flat_topk_plain(q, x, k, metric, chunk=chunk)
        es, ei = ST.flat_topk_pallas(q, x, k, metric, chunk=chunk)
        fs, fi = ST.flat_topk_pallas2(q, x, k, metric, chunk=chunk)
        ctx.sync()
        label = f"topk N={n} D={d} B={b} k={k} {metric} chunk={chunk}" + \
            (f" ({kind})" if kind else "")
        if not (torch.equal(ei, fi) and torch.equal(es, fs)):
            raise AssertionError(f"{label}: E and F differ")
        extra = ""
        if old_e is not None:   # the CUDA-core E and F, uncounted: equal bit for bit
            os_, oi = ST.launch(old_e, q, x, k, metric, chunk)
            gs, gi, _, _ = ST.launch_f_passes(old_f, q, x, k, metric, chunk)
            ctx.sync()
            if not (torch.equal(oi, ei) and torch.equal(os_, es)):
                raise AssertionError(f"{label}: E differs from the CUDA-core E")
            if not (torch.equal(gi, fi) and torch.equal(gs, fs)):
                raise AssertionError(f"{label}: F differs from the CUDA-core F")
            extra = " == CUDA-core E == CUDA-core F"
            if kind in ("overflow", "far") or k == 256:
                st = _scan_stats(ST, q, x, k, metric, chunk)
                stf = _scan_stats_f(ST, q, x, k, metric, chunk)
                if kind == "overflow" and st["overflowed"] < 1:
                    raise AssertionError(f"{label}: no candidate list of E overflowed ({st})")
                if kind == "overflow" and stf["overflowed"] < 1:
                    raise AssertionError(f"{label}: no list of F overflowed ({stf})")
                extra += f", E's filter counts {st}, F's {stf}"
        err, rows = check_topk(q, x, metric, es, ei, ps, pi, label)
        print(f"  compare {label}: ok, E == F{extra}, max |kernel - plain| = {err:.3g}, "
              f"{rows} rows with other ids (near-ties)", flush=True)

    # the tie rule: 40 equal rows; the lower row wins an extraction, the first
    # worst slot is replaced and an equal score is never taken
    want = [0, 308, 307, 306, 305, 304, 303, 302, 301, 300]
    fns = [ST.flat_topk_pallas, ST.flat_topk_pallas2]
    if old_e is not None:
        fns.append(lambda q, x, k, metric, chunk: ST.launch(old_e, q, x, k, metric, chunk))
        fns.append(lambda q, x, k, metric, chunk:
                   ST.launch_f_passes(old_f, q, x, k, metric, chunk)[:2])
    for metric in ("l2", "dot"):
        q, x = _topk_inputs(rng, 1000, 16, 32, dev, dup=40)
        _, pi = ST._flat_topk_plain(q, x, 10, metric, chunk=256)
        for i, fn in enumerate(fns):
            _, ki = fn(q, x, 10, metric, chunk=256)
            if not torch.equal(ki[0], pi[0]) or (metric == "l2" and ki[0].tolist() != want):
                raise AssertionError(f"topk tie rule broken (entry {i}, {metric}): "
                                     f"{ki[0].tolist()} vs plain {pi[0].tolist()}")
    print(f"  compare topk tie rule (40 equal rows, l2 and dot, E, F and the CUDA-core E and "
          f"F): ok, {want}", flush=True)


def phase_scan_main(ctx: Ctx, x1, q1, gt):
    """The exact top-10 of every query over the whole corpus through E, then
    F, at their defaults (q_tile=256, chunk=2048), in batches."""
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops import scan_topk as ST

    dev = ctx.device
    xd = torch.from_numpy(x1).to(dev)
    qb = [torch.from_numpy(q1[lo:lo + ctx.batch]).to(dev) for lo in range(0, q1.shape[0], ctx.batch)]
    ctx.sync()

    reset_kernel_counts()
    ids, scores = {}, {}
    for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2):
        t0 = time.perf_counter()
        out = [fn(qq, xd, K) for qq in qb]
        scores[fn.__name__] = torch.cat([o[0] for o in out])
        ids[fn.__name__] = torch.cat([o[1] for o in out])
        ctx.sync()
        ctx.report(f"scan main {fn.__name__} seconds for {len(qb)} batches (host clock)",
                   round(time.perf_counter() - t0, 3))
    counts = kernel_counts()
    launches = {name: counts[name] for name in ("E", "E_mma", "F", "F_mma")}
    ctx.report("scan main launches", f"{launches} for {len(qb)} batches")
    if not ctx.rehearse and launches != dict.fromkeys(launches, len(qb)):
        raise AssertionError(f"scan kernels launched {launches} for {len(qb)} batches")
    ei, fi = ids["flat_topk_pallas"], ids["flat_topk_pallas2"]
    if not (torch.equal(ei, fi) and torch.equal(scores["flat_topk_pallas"],
                                                scores["flat_topk_pallas2"])):
        raise AssertionError("scan main: E and F differ")
    ids_np = ei.cpu().numpy()
    rec = recall_at_k(ids_np, gt, K)
    ctx.report("scan main recall@10 (E == F bit for bit) against the exact f32 flat search", rec)
    if rec < 0.999:
        raise AssertionError(f"scan main recall@10 {rec} < 0.999")
    # every id outside the oracle's row is a near-tie of the oracle's 10th
    qd = torch.from_numpy(q1).to(dev).double()
    gtd = torch.from_numpy(gt.astype(np.int64)).to(dev)

    def dist(ids_):
        return ((qd[:, None, :] - xd[ids_.long()].double()) ** 2).sum(-1)

    d10 = dist(gtd).amax(1)
    extra = ~(ei[:, :, None].long() == gtd[:, None, :]).any(-1)
    worst = float(((dist(ei) - d10[:, None]) / d10[:, None])[extra].max()) if bool(extra.any()) \
        else 0.0
    ctx.report("scan main ids outside the oracle's rows",
               f"{int(extra.sum())}, worst relative distance past the oracle's 10th {worst:.3g}")
    if worst > 1e-3:
        raise AssertionError(f"scan main: an id lies {worst} past the oracle's 10th distance")
    del qd, gtd

    # the kernels on the main path's first batch, held against the plain version
    # and, on the card, the CUDA-core E against the tensor-core E bit for bit
    q0 = qb[0]
    ps, pi = ST._flat_topk_plain(q0, xd, K)
    errs = {}
    for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2):
        ks, ki = fn(q0, xd, K)
        ctx.sync()
        errs[fn.__name__], rows = check_topk(q0, xd, "l2", ks, ki, ps, pi,
                                             f"scan main first batch {fn.__name__}")
        print(f"  compare scan main first batch {fn.__name__}: ok, max |kernel - plain| = "
              f"{errs[fn.__name__]:.3g}, {rows} rows with other ids", flush=True)
    b, d = q0.shape
    n = xd.shape[0]
    shape = f"B={b} N={n} D={d} k={K} chunk=2048"
    if ctx.rehearse:
        ms = {fn.__name__: ctx.time_ms(lambda fn=fn: fn(q0, xd, K), reps=1)
              for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2)}
        st = {"candidates": 0, "most_in_a_list": 0, "overflowed": 0, "cold": 0, "lists": 1}
        stf = dict.fromkeys(ST._STATS_F, 0)
    else:
        old_e, old_f, new_f = ST.build_v1(), ST.build_v2_passes(), ST.build_v2_mma()
        os_, oi = ST.launch(old_e, q0, xd, K)
        gs, gi, _, _ = ST.launch_f_passes(old_f, q0, xd, K)
        ks, ki = ST.flat_topk_pallas(q0, xd, K)
        fs, fi = ST.flat_topk_pallas2(q0, xd, K)
        ctx.sync()
        if not (torch.equal(oi, ki) and torch.equal(os_, ks)):
            raise AssertionError("scan main first batch: E differs from the CUDA-core E")
        if not (torch.equal(gi, fi) and torch.equal(gs, fs)):
            raise AssertionError("scan main first batch: F differs from the CUDA-core F")
        print("  compare scan main first batch: E == the CUDA-core E and F == the CUDA-core F "
              "bit for bit", flush=True)
        st = _scan_stats(ST, q0, xd, K, "l2", 2048)
        stf = _scan_stats_f(ST, q0, xd, K, "l2", 2048)
        # 100 calls each of E on both routes (fewer read host stalls), F 20
        ms = {"flat_topk_pallas": ctx.time_ms(lambda: ST.flat_topk_pallas(q0, xd, K), reps=100,
                                              warmup=2)}
        ms["cuda_core_e"] = ctx.time_ms(lambda: ST.launch(old_e, q0, xd, K), reps=100)
        ms["flat_topk_pallas2"] = ctx.time_ms(lambda: ST.flat_topk_pallas2(q0, xd, K), reps=20,
                                              warmup=2)
        # F's parts apart, each on what the others wrote: the pre-pass, the
        # pairs pass (its filter and select passes), the fold
        _, _, pairs, scratch = ST.launch_f_passes(new_f, q0, xd, K)
        for name, part, reps in (("f_prepass", ST.PREP, 100), ("f_pairs", ST.PAIRS, 20),
                                 ("f_filter", ST.FILTER, 20), ("f_select", ST.SELECT, 20),
                                 ("f_fold", ST.FOLD, 100)):
            ms[name] = ctx.time_ms(lambda part=part: ST.launch_f_passes(
                new_f, q0, xd, K, passes=part, pairs=pairs, scratch=scratch), reps=reps)
        ms["cuda_core_f"] = ctx.time_ms(lambda: ST.launch_f_passes(old_f, q0, xd, K), reps=10)
        _, _, pairs_c, _ = ST.launch_f_passes(old_f, q0, xd, K, passes=ST.PAIRS)
        ms["cuda_core_f_pairs"] = ctx.time_ms(lambda: ST.launch_f_passes(
            old_f, q0, xd, K, passes=ST.PAIRS, pairs=pairs_c), reps=10)
        ms["cuda_core_f_fold"] = ctx.time_ms(lambda: ST.launch_f_passes(
            old_f, q0, xd, K, passes=ST.FOLD, pairs=pairs_c), reps=100)
        ms["e_prepass"] = ctx.time_ms(lambda: ST.launch_prep(q0, xd, K), reps=100)
        ctx.report("scan E pre-pass share (its time alone over E's)",
                   f"{ms['e_prepass']:.4f} of {ms['flat_topk_pallas']:.4f} ms "
                   f"({100 * ms['e_prepass'] / ms['flat_topk_pallas']:.2f}%)")
        # a small batch: E has B/16 blocks, F a block per SM
        qs = q0[:128]
        for name, fn, reps in (("flat_topk_pallas", lambda: ST.flat_topk_pallas(qs, xd, K), 20),
                               ("flat_topk_pallas2", lambda: ST.flat_topk_pallas2(qs, xd, K), 20),
                               ("cuda_core_f", lambda: ST.launch_f_passes(old_f, qs, xd, K), 10)):
            ctx.report(f"scan kernel ms ({name}, B=128 N={n} D={d} k={K} chunk=2048)",
                       ctx.time_ms(fn, reps=reps, warmup=2))
    plain_ms = ctx.time_ms(lambda: ST._flat_topk_plain(q0, xd, K), reps=1, warmup=0)
    norms = (xd * xd).sum(1)

    def product_selection():
        best_s = best_i = None
        for lo in range(0, n, 131072):
            s = norms[lo:lo + 131072] - 2.0 * (q0 @ xd[lo:lo + 131072].T)
            v, i = torch.topk(s, K, dim=1, largest=False)
            i = i + lo
            if best_s is not None:
                v, i = torch.cat([best_s, v], 1), torch.cat([best_i, i], 1)
                v, p = torch.topk(v, K, dim=1, largest=False)
                i = torch.gather(i, 1, p)
            best_s, best_i = v, i
        return best_s, best_i

    library_ms = ctx.time_ms(product_selection, reps=10)

    # bounds: the f32 function (the CUDA-core E and F), and each tensor-core
    # kernel's own work: three bf16 products over DP, plus the exact f32
    # re-scoring of this run's candidates (E) or survivors (F) and of its cold
    # and overflowed (query, chunk) pairs
    dp = -(-d // 16) * 16
    nbytes = n * d * 4 + b * d * 4 + b * K * 8
    bound_bytes = nbytes / HBM_BYTES_S * 1e3
    bound_f32 = 2.0 * b * n * d / PEAK_F32 * 1e3
    products = 6.0 * b * n * dp / PEAK_BF16 * 1e3
    rescored = st["candidates"] + (st["cold"] + st["overflowed"]) * 2048
    bound_mma = products + 2.0 * d * rescored / PEAK_F32 * 1e3
    rescored_f = stf["rescored"] + stf["overflowed"] * 2048
    bound_f = products + 2.0 * d * rescored_f / PEAK_F32 * 1e3
    steps = sum(-(-min(2048, n - lo) // 128) for lo in range(0, n, 2048))
    tile_bytes = -(-b // 16) * steps * (2 * 128 * (dp + 8) * 2 + 2 * 132 * 4)
    lists = max(1, st["lists"])
    ctx.report("scan E filter (one call)",
               f"{st}: candidates per (query, chunk) mean {st['candidates'] / lists:.4f}, "
               f"max {st['most_in_a_list']}; {st['overflowed']} lists overflowed, "
               f"{st['cold']} cold (query, chunk) pairs re-scored in full")
    ctx.report("scan E corpus bytes the query tiles read (bf16 planes + norms, from the shapes)",
               f"{tile_bytes / 1e9:.2f} GB ({-(-b // 16)} tiles of 16 queries)")
    nc = -(-n // 2048)
    lists = b * nc
    ctx.report("scan F filter (one call)",
               f"{stf}: entries pushed per (query, chunk) {stf['pushed'] / lists:.4f}, survivors "
               f"re-scored {stf['rescored'] / lists:.4f}, longest list {stf['most_in_a_list']}, "
               f"{stf['overflowed']} lists overflowed, {stf['refreshes']} compacted")
    qf = 64 if b > 16 else 16
    ctx.report("scan F corpus bytes the query tiles read (bf16 planes + norms, from the shapes)",
               f"{tile_bytes // -(-b // 16) * -(-b // qf) / 1e9:.2f} GB ({-(-b // qf)} tiles of "
               f"{qf} queries)")
    for name, t in ms.items():
        ctx.report(f"scan kernel ms ({name}, {shape})", t)
    ctx.report("scan plain version ms (one batch)", plain_ms)
    ctx.report("scan yardstick ms (product + selection: f32 torch.matmul per 131,072 rows "
               "+ torch.topk)", library_ms)
    ctx.report("scan bound ms, the f32 function (2*B*N*D f32 ops / 67 TFLOP/s vs bytes / "
               "3.35 TB/s; the CUDA-core E and F)",
               f"{max(bound_f32, bound_bytes)} (ops {bound_f32}, bytes {bound_bytes})")
    ctx.report("scan bound ms, the tensor-core E (6*B*N*DP bf16 ops / 989 TFLOP/s + the "
               "exact re-scoring's f32 ops / 67 TFLOP/s vs bytes)",
               f"{max(bound_mma, bound_bytes)} (ops {bound_mma}, bytes {bound_bytes})")
    ctx.report("scan bound ms, the tensor-core F (the same products + its survivors' exact "
               "re-scoring's f32 ops vs bytes)",
               f"{max(bound_f, bound_bytes)} (ops {bound_f}, bytes {bound_bytes})")
    del xd
    common = dict(plain_ms=plain_ms, library_ms=library_ms)
    return {
        "flat_topk_pallas": dict(common, ms=ms["flat_topk_pallas"], launches=launches["E_mma"],
                                 max_abs_err=errs["flat_topk_pallas"],
                                 bound_ms=max(bound_mma, bound_bytes),
                                 bound_by="operations" if bound_mma >= bound_bytes else "bytes"),
        "flat_topk_pallas2": dict(common, ms=ms["flat_topk_pallas2"],
                                  launches=launches["F_mma"],
                                  max_abs_err=errs["flat_topk_pallas2"],
                                  bound_ms=max(bound_f, bound_bytes),
                                  bound_by="operations" if bound_f >= bound_bytes else "bytes"),
    }

# ---------------------------------------------------------------------------
# The fused hop scorer: kernel G (fused_hop_scores)


def _hop_check(idx, q, x, got, want, label):
    """|kernel - plain| within rtol 1e-5 of |q|.|x| per score (the f32 dot
    sums in other orders). Returns the largest |kernel - plain|."""
    scale = q.norm(dim=1)[:, None] * x.norm(dim=1)[idx.long()]
    diff = (got - want).abs()
    if not bool((diff <= 1e-5 * scale).all()):
        raise AssertionError(f"{label}: |kernel - plain| up to {float(diff.max())}")
    return float(diff.max())


def _hop_ids(rng, b, k, n, live=None):
    """[b, k] random ids; with `live`, the first `live` per row random and
    the rest repeats of them (a hop's padded candidate list)."""
    ids = rng.integers(0, n, (b, k)).astype(np.int32)
    if live is not None:
        ids[:, live:] = ids[:, :k - live]
    return ids


# kernel G's times before its redesign: its first, one-route kernel at these
# shapes (PERF.md section 6, with the card's name and power limit)
OLD_G_MS = {"experiment": "0.2264-0.2352", "cagra_1m hop": "0.0464-0.0522"}
HOP_ROUTES = ("direct", "grouped")


@contextlib.contextmanager
def _hop_route(HS, route):
    """Within the block, kernel G's wrapper takes `route` whatever the shape
    (its `choose_route` swapped out), so each route is held and timed."""
    chosen, HS.choose_route = HS.choose_route, lambda b, k, n: route
    try:
        yield
    finally:
        HS.choose_route = chosen


def _hop_scratch_ints(ctx: Ctx, HS):
    """The kernel's zvdb_hop_scratch_ints; when rehearsing on the CPU, a
    stand-in that takes every window count."""
    return (lambda p, n, shift: 0) if ctx.rehearse else HS.build_grouped().scratch_ints


def _hop_entry_ms(ctx: Ctx, HS, route, idx, q, x):
    """ms of a route's C entry point alone, its scratch made beforehand (20
    calls, CUDA events): the device's pace where the wrapper's host work
    would set it. None when rehearsing."""
    if ctx.rehearse:
        return None
    (b, k), (n, d) = idx.shape, x.shape
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k, n, d)
    if route == "direct":
        fn, more = HS.build(), ()
    else:   # "grouped", or its counting pass alone
        fn = HS.build_grouped()
        shift = HS.window_shift(n, d, fn.scratch_ints)
        need = fn.scratch_ints(b * k, n, shift)
        scratch = torch.empty(need, dtype=torch.int32, device=q.device)
        more = (shift, scratch.data_ptr(), need)
        if route == "counting pass":
            fn, args = HS.build_window_order(), (idx.data_ptr(), b * k, n)

    def call():
        if fn(*args, *more, stream) != 0:
            raise RuntimeError(f"hop {route} entry point failed")

    return ctx.time_ms(call, reps=20)


def phase_hop(ctx: Ctx, x1, q1):
    from zvdb_tpu_torch.ops import hop_scores as HS

    rng = np.random.default_rng(765)
    dev = ctx.device
    for b, k, d in ((8, 128, 32), (64, 256, 128), (8, 128, 100), (8, 128, 13)):
        for n in (5000, 7):   # 7 rows: every id repeats many times
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
            idx = torch.from_numpy(_hop_ids(rng, b, k, n, live=k // 2)).to(dev)   # duplicated ids
            if not ctx.rehearse:   # outside [0, N): NaN, nothing read (the plain version cannot)
                idx[0, 0], idx[-1, -1] = -1, n
            ok = idx.clamp(0, n - 1)
            want = HS._hop_scores_plain(ok, q, x)
            errs = []
            for route in HOP_ROUTES:
                with _hop_route(HS, route):
                    got = HS.fused_hop_scores(idx, q, x)
                ctx.sync()
                if not ctx.rehearse and not (bool(torch.isnan(got[0, 0]))
                                             and bool(torch.isnan(got[-1, -1]))):
                    raise AssertionError(f"hop {route} B={b} K={k} N={n} D={d}: an id outside "
                                         "[0, N) did not score NaN")
                got[0, 0], got[-1, -1] = want[0, 0], want[-1, -1]
                errs.append(_hop_check(ok, q, x, got, want,
                                       f"hop {route} B={b} K={k} N={n} D={d}"))
            shift = HS.window_shift(n, d, _hop_scratch_ints(ctx, HS))
            plain = HS._window_order_plain(idx, n, shift)
            for got, exp in zip(HS.window_order(idx, n, shift), plain):
                if not torch.equal(got, exp):
                    raise AssertionError(f"hop window order B={b} K={k} N={n} shift={shift} "
                                         "differs from its plain version")
            print(f"  compare hop B={b} K={k} N={n} D={d} (duplicated ids, two outside [0, N)): "
                  f"direct and grouped ok, max |kernel - plain| = {max(errs):.3g}; window order "
                  f"(shift {shift}) equal", flush=True)

    # two shapes over the corpus: the experiment's own (random ids) and the
    # cagra_1m hop (2048 queries x 96 candidates, padded to 128)
    xd = torch.from_numpy(x1).to(dev)
    n, d = xd.shape
    big = 4992 if not ctx.rehearse else 64
    shapes = {"experiment": (big, 256, None), "cagra_1m hop": (ctx.batch, 128, 96)}
    inputs = {}
    for name, (b, k, live) in shapes.items():
        rows = rng.integers(0, q1.shape[0], b)
        inputs[name] = (torch.from_numpy(_hop_ids(rng, b, k, n, live)).to(dev),
                        torch.from_numpy(q1[rows]).to(dev))
    routes = {name: HS.choose_route(b, k, n) for name, (b, k, _) in shapes.items()}
    ctx.sync()
    HS.fused_hop_scores.launches = HS.fused_hop_scores.launches_grouped = 0
    outs = {name: HS.fused_hop_scores(idx, q, xd) for name, (idx, q) in inputs.items()}
    ctx.sync()
    launches, grouped = HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped
    ctx.report("hop launches (all / grouped route)",
               f"{launches} / {grouped} for {len(shapes)} hops; routes chosen {routes}")
    want_grouped = sum(r == "grouped" for r in routes.values())
    if not ctx.rehearse and (launches, grouped) != (len(shapes), want_grouped):
        raise AssertionError(f"hop kernel launched {launches} times ({grouped} grouped) for "
                             f"{len(shapes)} hops ({want_grouped} grouped)")
    res = {}
    for name, (idx, q) in inputs.items():
        b, k = idx.shape
        want = HS._hop_scores_plain(idx, q, xd)
        err = _hop_check(idx, q, xd, outs[name], want, f"hop {name}")
        # the least bytes: each distinct row once, then ids, q and the output
        rows_read = int(torch.unique(idx).numel())
        nbytes = rows_read * d * 4 + b * k * 4 + b * d * 4 + b * k * 4
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        shape = f"B={b} K={k} N={n} D={d}"
        ctx.report(f"hop {name} ({shape}) distinct rows", f"{rows_read} of {b * k} ids "
                   f"(expected repeat share {HS.repeat_share(b, k, n):.3f})")
        ctx.report(f"hop {name} bound ms (distinct rows, ids, q, output / 3.35 TB/s)", bound_ms)
        ms = {}
        for route in HOP_ROUTES:
            with _hop_route(HS, route):
                err = max(err, _hop_check(idx, q, xd, HS.fused_hop_scores(idx, q, xd), want,
                                          f"hop {name} {route}"))
                ms[route] = ctx.time_ms(lambda: HS.fused_hop_scores(idx, q, xd), reps=20)
            entry = _hop_entry_ms(ctx, HS, route, idx, q, xd)
            ctx.report(f"hop {name} {route} route ms, share of the bound; its entry point alone "
                       "(no Python wrapper)",
                       f"{ms[route]:.4f}, {bound_ms / ms[route]:.1%}; " + (
                           "not measured (rehearsal)" if entry is None else
                           f"{entry:.4f}, {bound_ms / entry:.1%}"))
        entry = _hop_entry_ms(ctx, HS, "counting pass", idx, q, xd)
        ctx.report(f"hop {name} counting pass alone ms (its entry point, shift "
                   f"{HS.window_shift(n, d, _hop_scratch_ints(ctx, HS))})",
                   "not measured (rehearsal)" if entry is None else entry)
        ms_now = ms[routes[name]]
        ctx.report(f"hop {name} shipped route ({routes[name]}) ms, share of the bound; before "
                   "the redesign (PERF.md)",
                   f"{ms_now:.4f}, {bound_ms / ms_now:.1%}; {OLD_G_MS[name]}")
        ctx.report(f"hop {name} achieved GB/s (the bound's bytes / shipped route's time)",
                   nbytes / (ms_now * 1e-3) / 1e9)
        plain_ms = ctx.time_ms(lambda: HS._hop_scores_plain(idx, q, xd), reps=10)
        gather_ms = ctx.time_ms(lambda: xd[idx.long()].sum(dim=(1, 2)), reps=10)
        ctx.report(f"hop {name} plain ms (gather + einsum, the yardstick)", plain_ms)
        ctx.report(f"hop {name} gather alone ms (x[idx].sum)", gather_ms)
        ctx.report(f"hop {name} max |kernel - plain|", err)
        res[name] = dict(ms=ms_now, plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes", max_abs_err=err, launches=launches)
    del xd
    return res


# ---------------------------------------------------------------------------
# HNSW: the one-shot build (kernel D in its base layer) and hierarchical search

EFS = (16, 24, 32, 48, 64, 96)


def hnsw_config(ctx: Ctx):
    from zvdb_tpu_torch import HNSWConfig

    # the bench row's configuration (bench.py:686) with the kernel's selection
    return HNSWConfig(dim=ctx.dim, m=16, ef_construction=100, build_batch=8192,
                      block_topk="pallas")


def phase_hnsw_main(ctx: Ctx, x1, q1, gt):
    from zvdb_tpu_torch import HNSW
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.stats import index_stats

    dev = ctx.device
    cfg = hnsw_config(ctx)
    ctx.report("hnsw_1m config", cfg)
    xd = torch.from_numpy(x1).to(dev)
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the main path: build, then search; counts read after each
    reset_kernel_counts()
    t0 = time.perf_counter()
    idx = HNSW(cfg, seed=0, device=dev)
    idx.build(xd)
    ctx.sync()
    build_s = [time.perf_counter() - t0]
    after_build = kernel_counts()
    lb = idx.build_stats
    expected = sum(-(-cb // lb["cc"]) for cb in lb["c_blocks"])
    nq = min(2048, q1.shape[0])
    sweep, ef, rec = {}, None, 0.0
    for e in EFS:
        ids = batched_ids(ctx, idx, q1[:nq], ef_search=e)
        sweep[e] = rec = recall_at_k(ids, gt[:nq], K)
        if rec >= 0.95:
            ef = e
            break
    if ef is None:
        ef = 128
        sweep[ef] = rec = recall_at_k(batched_ids(ctx, idx, q1[:nq], ef_search=ef), gt[:nq], K)
    ids = batched_ids(ctx, idx, q1, ef_search=ef)
    ctx.sync()
    after_search = kernel_counts()
    rec_all = recall_at_k(ids, gt, K)
    ctx.report("hnsw_1m kernel launches", f"build: block_bins {after_build['D']}, of them on "
               f"the tensor cores {after_build['D_mma']} (expected sum of ceil(c_blocks/cc) = "
               f"{expected} for the base layer); others {after_build}; search: "
               f"{ {k: after_search[k] - after_build[k] for k in after_search} }")
    if dev.type == "cuda":
        ctx.report("hnsw_1m peak device memory GB (build + search, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    st = index_stats(idx)
    ctx.report("hnsw_1m levels", f"max_level {st['max_level']} (levels_cap {idx.levels_cap}), "
               f"histogram {st['levels_hist']}, entry row {idx.state.entry}, capacity "
               f"{idx.capacity}, base degree {st['degree']}, anchors "
               f"{idx.state.anchors.shape[0]}, state GB {st['total_bytes'] / 1e9:.3f}")
    ctx.report("hnsw_1m ef sweep recall@10 (first 2048 queries)", sweep)
    ctx.report(f"hnsw_1m recall@10 (ef={ef}, all queries)", rec_all)
    others = {k: v for k, v in after_build.items() if k not in ("D", "D_mma")}
    if not ctx.rehearse and (after_build["D"] != expected or after_build["D_mma"] != expected
                             or expected == 0 or any(others.values())):
        raise AssertionError(f"build launched {after_build}, expected D == D_mma == {expected} "
                             "only")
    if after_search != after_build:
        raise AssertionError(f"search launched kernels: {after_build} -> {after_search}")
    if st["degree"]["isolated"] or st["max_level"] != idx.state.max_level:
        raise AssertionError(f"hnsw_1m graph: {st['degree']}, max_level {st['max_level']}")
    if rec < 0.95 and not ctx.rehearse:
        ctx.report("hnsw_1m recall@10 stays below 0.95 up to ef=128", rec)

    # a second timed build, then a traced one (a sync between stages)
    for trace in (False, True):
        if trace:
            os.environ["ZVDB_BUILD_TRACE"] = "1"
        try:
            t0 = time.perf_counter()
            other = HNSW(cfg, seed=1, device=dev)
            other.build(xd)
            ctx.sync()
            build_s.append(time.perf_counter() - t0)
        finally:
            os.environ.pop("ZVDB_BUILD_TRACE", None)
        if trace:
            ctx.report("hnsw_1m traced build stage seconds", {
                k: round(v, 4) for k, v in other.build_stats["stages"].items()})
        del other
    ctx.report("hnsw_1m build points/s (rows already on the device; two builds, then a traced "
               "one)", [ctx.n / s for s in build_s])
    ctx.report("hnsw_1m build seconds, best of the two untraced", min(build_s[:2]))
    ctx.hnsw_oneshot_s = min(build_s[:2])

    # kernel D on the HNSW base layer's own first chunk (the last pass),
    # held against its plain version at the build's precision
    bp = lb["first_chunk"]
    valid = bp >= 0
    safe = bp.clamp(min=0).long()
    v = xd[safe]
    vn = torch.where(valid, (xd * xd).sum(-1)[safe], float("inf"))
    compare_block_case(ctx, f"block hnsw_1m base-layer chunk {tuple(v.shape)} high", v, vn, 128,
                       "l2", "high")
    del xd, v, vn
    return idx, ids, ef


def phase_hnsw_times(ctx: Ctx, idx, x1, q1, gt, ef):
    from zvdb_tpu_torch import HNSW
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.index import hnsw as TH
    from zvdb_tpu_torch.index.flat import masked_exact_search
    from zvdb_tpu_torch.ops import distance as D

    dev = ctx.device
    kw = {"ef_search": ef}
    ctx.report(f"hnsw_1m search QPS (ef={ef}, batches of {ctx.batch}, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs=kw))
    ctx.report("hnsw_1m server QPS (8 threads, requests of 16 queries)",
               server_qps(ctx, idx, q1, search_kwargs=kw))

    # one batch taken apart: descent, anchor seeding, beam (the search's own calls)
    cfg, sc, st = idx.cfg, idx.search_cfg, idx.state
    prec = TH.torch_precision(cfg.precision)
    qp = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), cfg.metric)
    scorer = TH.make_packed_scorer(idx._packed(), qp, prec)
    reps = 2 if ctx.rehearse else 10

    def descent():
        return TH.descend(st, qp, cfg.metric, idx.levels_cap, max_upper_iters=sc.max_upper_iters,
                          scorer=scorer)

    def descent_all_hops():
        """The descent without the per-hop host check: every layer runs all
        max_upper_iters hops (a query that did not move re-scores its row),
        timed here against the engine's form."""
        ep = torch.full((qp.shape[0],), st.entry, dtype=torch.int32, device=dev)
        ep_s = scorer(ep[:, None])[:, 0]
        for ell in range(min(idx.levels_cap, st.max_level), 0, -1):
            nbrs = st.nbrU[ell - 1]
            for _ in range(sc.max_upper_iters):
                cand = nbrs[ep.clamp(min=0).long()]
                best_s, best_i = scorer(cand).min(dim=-1)
                better = best_s < ep_s
                ep = torch.where(better, torch.gather(cand, -1, best_i[:, None])[:, 0], ep)
                ep_s = torch.where(better, best_s, ep_s)
        return ep, ep_s

    ms = {"descent (greedy, host check after every hop: the engine's)":
          ctx.time_ms(descent, reps=reps),
          f"descent (greedy, all {sc.max_upper_iters} hops, no sync)":
          ctx.time_ms(descent_all_hops, reps=reps)}
    ep, ep_s = descent()
    if not torch.equal(ep, descent_all_hops()[0]):
        raise AssertionError("the two greedy forms reached other rows")
    ms["anchor seeds ([B, A] product + top-16)"] = ctx.time_ms(
        lambda: TH.anchor_seeds(st, qp, sc.seed_anchors, cfg.metric, prec), reps=reps)
    # the anchor product alone, and one bf16 matmul of the same shape beside it
    ms["anchor product alone ([B, A] pairwise_scores)"] = ctx.time_ms(
        lambda: D.pairwise_scores(qp, st.anchors, st.a_norms, cfg.metric, precision=prec),
        reps=reps)
    qb16, ab16 = qp.bfloat16(), st.anchors.bfloat16()
    ms["one bf16 torch.matmul, same [B, D] x [D, A] shape"] = ctx.time_ms(
        lambda: torch.matmul(qb16, ab16.T), reps=reps)
    a_rows, a_s = TH.anchor_seeds(st, qp, sc.seed_anchors, cfg.metric, prec)
    seeds, seed_s = torch.cat([ep[:, None], a_rows], 1), torch.cat([ep_s[:, None], a_s], 1)
    ms[f"beam (ef={ef})"] = ctx.time_ms(lambda: TH.beam_layer_fn(
        scorer, seeds, seed_s, st.nbr0, max(ef, K), expand=sc.expand, max_iters=sc.max_iters,
        use_degree=sc.search_degree, dedupe_candidates=sc.dedupe_candidates), reps=reps)
    ms["whole search() call"] = ctx.time_ms(lambda: idx.search(q1[:ctx.batch], K, **kw),
                                            reps=reps)
    for name, t in ms.items():
        ctx.report(f"hnsw_1m ms a batch of {ctx.batch}: {name}", t)
    t_exit, t_fixed = list(ms.values())[:2]
    ctx.report("hnsw_1m greedy forms, all hops / host check", t_fixed / t_exit)
    ctx.report(f"hnsw_1m anchor product ([{qp.shape[0]}, {st.anchors.shape[0]}]) / one bf16 "
               "matmul of its shape",
               ms["anchor product alone ([B, A] pairwise_scores)"]
               / ms["one bf16 torch.matmul, same [B, D] x [D, A] shape"])
    profile_search(ctx, idx, q1, label="hnsw_1m", search_kwargs=kw)

    # tombstones: remove 1% of ids; none may come back
    rng = np.random.default_rng(9)
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    t0 = time.perf_counter()
    idx.remove(dead)
    ctx.sync()
    rm_s = time.perf_counter() - t0
    ids = batched_ids(ctx, idx, q1, **kw)
    hit = int(np.isin(ids, dead).sum())
    ctx.report("hnsw_1m remove 1% of ids", f"{dead.size} ids in {rm_s:.3f} s; removed ids "
               f"returned: {hit}; recall@10 vs the unfiltered truth {recall_at_k(ids, gt, K)}")
    if hit:
        raise AssertionError(f"{hit} removed ids returned")

    # filtered search on even ids, both modes
    even = np.zeros(ctx.n, bool)
    even[::2] = True
    qb = q1[:ctx.batch]
    cap = st.vectors.shape[0]
    ok_rows = torch.zeros(cap, dtype=torch.bool, device=dev)   # the engine's mask, by row
    ok_rows[:ctx.n] = torch.from_numpy(even).to(dev) & ~idx._dead_rows[:ctx.n]
    for mode in ("scan", "beam"):
        t0 = time.perf_counter()
        s, i = idx.search(qb, K, allowed=even, filter_mode=mode, **kw)
        ctx.sync()
        t = time.perf_counter() - t0
        got = i.cpu().numpy()
        if (got[got >= 0] % 2).any() or np.isin(got, dead).any():
            raise AssertionError(f"filter_mode={mode} returned an odd or removed id")
        line = (f"{t * 1e3:.1f} ms for {qb.shape[0]} queries, {(got >= 0).mean():.4f} of "
                "slots filled")
        if mode == "scan":
            bias = torch.where(ok_rows, 0.0, float("inf"))
            _, wr = masked_exact_search(st.vectors, st.norms + bias,
                                        torch.ones(cap, device=dev),
                                        torch.from_numpy(qb).to(dev), K, cfg.metric,
                                        precision=cfg.precision)
            if not torch.equal(i, wr):
                raise AssertionError("filter_mode=scan differs from the masked exact search")
            line += "; equal to the masked exact search"
        ctx.report(f"hnsw_1m filter even ids, filter_mode={mode}", line)

    # save / load round trip at the bench row's size
    n_small = min(100_000, ctx.n)
    small = HNSW(hnsw_config(ctx), seed=2, device=dev)
    small.build(torch.from_numpy(x1[:n_small]).to(dev))
    before = small.search(qb, K, **kw)[1]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "hnsw_100k.npz")
    try:
        t0 = time.perf_counter()
        small.save(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = HNSW.load(path, device=dev)
        ctx.sync()
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    after = back.search(qb, K, **kw)[1]
    if not torch.equal(before, after):
        raise AssertionError("ids differ after the save/load round trip")
    ctx.report("hnsw 100k save/load", f"save {t_save:.2f} s, load {t_load:.2f} s, file "
               f"{size / 1e6:.1f} MB; ids equal after load")


# ---------------------------------------------------------------------------
# HNSW's write path: insert and flush, the batched build, build checkpoints


def hnsw_batched_config(ctx: Ctx):
    """hnsw_1m with the frozen-prefix batched build (batches of 1024 rows
    when rehearsing on the CPU: a full batch's [8192, 200, 200] products
    would fill its memory)."""
    return dataclasses.replace(hnsw_config(ctx), build_mode="batched",
                               build_batch=1024 if ctx.rehearse else 8192)


def _inserted_query_rows(ctx: Ctx, lo: int):
    """Which queries make_workload drew from corpus rows >= lo."""
    return np.random.default_rng(777).integers(0, ctx.n, ctx.nq) >= lo


def phase_hnsw_insert(ctx: Ctx, x1, q1, gt, ef, ref_ids):
    """The one-shot build over all rows but the last 1%, then those rows
    through insert() in requests of 100 (the build_batch threshold flushes
    once, growing the capacity) and an explicit flush() for the rest,
    traced. Their external ids are their corpus rows, so phase 4's truth
    holds as it is."""
    from zvdb_tpu_torch import HNSW
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.stats import index_stats

    dev = ctx.device
    cfg = hnsw_config(ctx)
    n_ins, req = ctx.n // 100, 100
    n0 = ctx.n - n_ins
    idx = HNSW(cfg, seed=3, device=dev)
    idx.build(torch.from_numpy(x1[:n0]).to(dev))
    ctx.sync()
    cap0 = idx.capacity
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the main path: inserts, then the last flush; counts read after
    reset_kernel_counts()
    before = kernel_counts()
    flushes = []
    t0 = time.perf_counter()
    for lo in range(n0, ctx.n, req):
        stats, t1 = idx.build_stats, time.perf_counter()
        idx.insert(x1[lo:lo + req])
        if idx.build_stats is not stats:   # this request flushed
            ctx.sync()
            flushes.append(("threshold", time.perf_counter() - t1, idx.build_stats))
    os.environ["ZVDB_BUILD_TRACE"] = "1"
    try:
        t1 = time.perf_counter()
        idx.flush()
        ctx.sync()
    finally:
        os.environ.pop("ZVDB_BUILD_TRACE", None)
    flushes.append(("explicit, traced", time.perf_counter() - t1, idx.build_stats))
    ins_s = time.perf_counter() - t0
    after = kernel_counts()

    ctx.report("hnsw_1m insert", f"{n_ins} rows in requests of {req} after a one-shot build "
               f"over {n0}: {ins_s:.3f} s, {n_ins / ins_s:.1f} rows/s (host clock, first insert "
               "to a sync after the last flush)")
    for kind, s, st in flushes:
        ctx.report(f"hnsw_1m flush ({kind})", f"{s:.4f} s for {st['batches']} batch(es); "
                   f"capacity growth {st.get('grow_s', 0.0):.4f} s of it")
    ctx.report("hnsw_1m traced flush stage seconds (one batch)",
               {k: round(v, 4) for k, v in flushes[-1][2]["stages"].items()})
    ctx.report("hnsw_1m capacity before / after the inserts", f"{cap0} / {idx.capacity}")
    if dev.type == "cuda":
        ctx.report("hnsw_1m insert peak device memory GB (max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    ids = batched_ids(ctx, idx, q1, ef_search=ef)
    rec = recall_at_k(ids, gt, K)
    sel = _inserted_query_rows(ctx, n0)
    ctx.report(f"hnsw_1m recall@10 after the inserts (ef={ef}, all queries)",
               f"{rec} (phase 20's index: {recall_at_k(ref_ids, gt, K)})")
    ctx.report(f"hnsw_1m recall@10 of the {int(sel.sum())} queries drawn from inserted rows",
               recall_at_k(ids[sel], gt[sel], K))
    self_ids = batched_ids(ctx, idx, x1[n0:], ef_search=ef)[:, 0]
    hit = float((self_ids == np.arange(n0, ctx.n)).mean())
    ctx.report(f"hnsw_1m self-hit@1 of the inserted rows (ef={ef})", hit)
    ctx.report(f"hnsw_1m search QPS after the inserts (ef={ef}, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs={"ef_search": ef}))
    st = index_stats(idx)
    ctx.report("hnsw_1m after the inserts", f"n {idx.state.n}, len {len(idx)}, degree "
               f"{st['degree']}, levels {st['levels_hist']}")
    if after != before:
        raise AssertionError(f"insert/flush launched kernels: {before} -> {after}")
    if hit < 0.95:
        raise AssertionError(f"self-hit@1 of the inserted rows {hit} < 0.95")
    if rec < 0.95 and not ctx.rehearse:
        raise AssertionError(f"recall@10 after the inserts {rec} < 0.95")
    if st["degree"]["isolated"] or len(idx) != ctx.n:
        raise AssertionError(f"after the inserts: {st['degree']}, len {len(idx)}")


def phase_hnsw_batched(ctx: Ctx, x1, q1, gt):
    """hnsw_1m built by the batched build over every row on the device,
    once, traced (a sync at each stage mark beside the descent's one a
    hop)."""
    from zvdb_tpu_torch import HNSW
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.stats import index_stats

    dev = ctx.device
    cfg = hnsw_batched_config(ctx)
    ctx.report("hnsw_1m batched config", cfg)
    xd = torch.from_numpy(x1).to(dev)
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    before = kernel_counts()
    os.environ["ZVDB_BUILD_TRACE"] = "1"
    try:
        t0 = time.perf_counter()
        idx = HNSW(cfg, seed=0, device=dev)
        idx.build(xd)
        ctx.sync()
        build_s = time.perf_counter() - t0
    finally:
        os.environ.pop("ZVDB_BUILD_TRACE", None)
    after = kernel_counts()
    del xd
    bs = idx.build_stats
    ctx.hnsw_batched_s = build_s
    ctx.report("hnsw_1m batched build", f"{build_s:.3f} s, {ctx.n / build_s:.1f} points/s over "
               f"{bs['batches']} batches (phase 20's one-shot: {ctx.n / ctx.hnsw_oneshot_s:.1f} "
               "points/s)")
    ctx.report("hnsw_1m batched build stage seconds (summed over the batches)",
               {k: round(v, 4) for k, v in bs["stages"].items()})
    if dev.type == "cuda":
        ctx.report("hnsw_1m batched build peak device memory GB (max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    st = index_stats(idx)
    ctx.report("hnsw_1m batched levels", f"max_level {st['max_level']}, histogram "
               f"{st['levels_hist']}, entry row {idx.state.entry}, capacity {idx.capacity}, "
               f"degree {st['degree']}")
    nq = min(2048, q1.shape[0])
    sweep, ef = {}, None
    for e in EFS:
        sweep[e] = rec = recall_at_k(batched_ids(ctx, idx, q1[:nq], ef_search=e), gt[:nq], K)
        if rec >= 0.95:
            ef = e
            break
    if ef is None:
        ef = 128
        sweep[ef] = recall_at_k(batched_ids(ctx, idx, q1[:nq], ef_search=ef), gt[:nq], K)
    rec_all = recall_at_k(batched_ids(ctx, idx, q1, ef_search=ef), gt, K)
    ctx.report("hnsw_1m batched ef sweep recall@10 (first 2048 queries)", sweep)
    ctx.report(f"hnsw_1m batched recall@10 (ef={ef}, all queries)", rec_all)
    # one batch step under the profiler: a flush of the capacity's free rows
    # (corpus rows + 0.01), so no growth enters the window
    free = idx.capacity - idx.state.n
    if dev.type == "cuda" and free:
        idx.insert(x1[:free] + np.float32(0.01))
        profile_calls(ctx, f"hnsw_1m batched step profile (one flush of {free} rows, "
                      "one batch)", [idx.flush], "step")
    if after != before:
        raise AssertionError(f"the batched build launched kernels: {before} -> {after}")
    if st["degree"]["isolated"]:
        raise AssertionError(f"batched build: {st['degree']}")
    if sweep[ef] < 0.95 and not ctx.rehearse:
        raise AssertionError(f"batched build recall@10 {sweep[ef]} < 0.95 up to ef=128")


def phase_hnsw_checkpoint(ctx: Ctx, x1):
    """At 100k rows: the batched build direct, with a checkpoint every 4
    batches, and resumed from that file (nbr0 equal in all three); the
    one-shot build direct and resumed from its base-layer checkpoint."""
    from zvdb_tpu_torch import HNSW

    dev = ctx.device
    n_small = 5000 if ctx.rehearse else min(100_000, ctx.n)
    xs = torch.from_numpy(x1[:n_small]).to(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    line = []
    for mode in ("batched", "oneshot"):
        cfg = (hnsw_batched_config(ctx) if mode == "batched"
               else dataclasses.replace(hnsw_config(ctx), build_mode="oneshot"))
        path = os.path.join(ROOT, "build", f"hnsw_{mode}_ckpt.npz")
        kw = {"checkpoint_every": 4} if mode == "batched" else {}
        try:
            t0 = time.perf_counter()
            direct = HNSW(cfg, seed=4, device=dev)
            direct.build(xs)
            ctx.sync()
            t_direct = time.perf_counter() - t0
            t0 = time.perf_counter()
            ck = HNSW(cfg, seed=4, device=dev)
            ck.build(xs, checkpoint_path=path, **kw)
            ctx.sync()
            t_ck = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            res = HNSW.resume_build(path, device=dev)
            ctx.sync()
            t_res = time.perf_counter() - t0
        finally:
            if os.path.exists(path):
                os.remove(path)
        fields = (("nbr0",) if mode == "batched"
                  else ("nbr0", "nbrU", "a_rows", "levels", "entry", "max_level"))
        for f in fields:
            a, b, c = (getattr(i.state, f) for i in (direct, ck, res))
            same = (torch.equal(a, b) and torch.equal(b, c)) if torch.is_tensor(a) else a == b == c
            if not same:
                raise AssertionError(f"{mode} build: {f} differs between direct, checkpointed "
                                     "and resumed")
        line.append(f"{mode}: direct {t_direct:.3f} s, with checkpoints {t_ck:.3f} s, resumed "
                    f"{t_res:.3f} s, file {size / 1e6:.1f} MB; {', '.join(fields)} equal")
        del direct, ck, res
    ctx.report(f"hnsw {n_small // 1000}k build checkpoints", "; ".join(line))


IVF_NPROBES = (2, 4, 8)       # the bench.py ivf row's nprobe sweep
IVF8_NPROBES = (4, 8, 16)


def ivf_config(ctx: Ctx):
    """ivf_1m: the bench.py ivf row's configuration (bench.py:553-620)."""
    from zvdb_tpu_torch import IVFConfig

    return IVFConfig(dim=ctx.dim, n_clusters=1024, nprobe=8, kmeans_iters=4,
                     kmeans_sample=65536)


def ivf8_config(ctx: Ctx):
    """ivf_1m_int8: the 10M engine's shape (examples/bench_deep10m.py:80,
    examples/exp_r3_100m_config.py:63), clusters by the default rule."""
    from zvdb_tpu_torch import IVFConfig

    return IVFConfig(dim=ctx.dim, dtype="int8", rerank=4, kmeans_iters=6)


def _ivf_arrays(st):
    """An IVFState's fields as numpy, as a save file holds them (bf16 as f32)."""
    from zvdb_tpu_torch.index.ivf import _STATE_FIELDS

    out = {}
    for f in _STATE_FIELDS:
        v = getattr(st, f)
        out[f] = (np.asarray(v, np.int32) if f == "n"
                  else (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy())
    return out


def phase_ivf_carry(ctx: Ctx, x1):
    """26. One small index built on the CPU and carried by from_numpy onto
    the card and onto the CPU: the same ids from both, f32 blocks and int8 +
    rerank, at a batch that takes the pair scan and one that takes the
    grouped scan (the pair scan's cut runs approx_min_k on the card where
    cap >= 4 * kk; the CPU side then selects with its plain version)."""
    from zvdb_tpu_torch import IVFConfig, IVFIndex
    from zvdb_tpu_torch.index.ivf import use_pair_scan

    n = 4000
    x = x1[:n]
    rng = np.random.default_rng(26)
    lines = []
    for cfg in (IVFConfig(dim=ctx.dim, n_clusters=64, nprobe=8),
                IVFConfig(dim=ctx.dim, n_clusters=64, nprobe=8, dtype="int8", rerank=4)):
        src = IVFIndex(cfg, device="cpu")
        src.build(x)
        arrays = _ivf_arrays(src.state)
        card = IVFIndex.from_numpy(cfg, arrays, device=ctx.device)
        cpu = IVFIndex.from_numpy(cfg, arrays, device="cpu")
        c = cpu.state.centroids.shape[0]
        for b in (8, 512):
            qq = (x[rng.integers(0, n, b)]
                  + 0.05 * rng.standard_normal((b, ctx.dim))).astype(np.float32)
            sc, ic = card.search(qq, K)
            with site_selection(binned_plain):
                sp, ip = cpu.search(qq, K)
            differ = int((ic.cpu() != ip).sum())
            err = float((sc.cpu() - sp).abs().max())
            scan = "pair" if use_pair_scan(c, b, cfg.nprobe) else "grouped"
            lines.append(f"{cfg.dtype}{' + rerank' if cfg.rerank else ''} B={b} ({scan} scan): "
                         f"{differ} ids differ, max |score diff| {err:.3g}")
            if differ:
                raise AssertionError(f"ivf carried index: {lines[-1]}")
    ctx.report(f"ivf carried {n}-row index, card vs CPU (C={c})", "; ".join(lines))


def _compare_scans(ps, pi, gs, gi, live):
    """The pair and grouped scans' [B, P * kk] outputs on the same probes:
    on every (query, probe) pair the grouped scan kept, the same kk ids
    (up to near-ties at the kk-th score) and scores; on a dropped pair no
    id. Returns (max |score diff|, pairs whose id sets differ, pairs past a
    near-tie)."""
    b, p = live.shape
    ps, pi, gs, gi = (t.reshape(b, p, -1) for t in (ps, pi, gs, gi))
    ok = live[..., None]
    fin = torch.isfinite(ps) & torch.isfinite(gs) & ok
    err = float((ps - gs).abs()[fin].max()) if bool(fin.any()) else 0.0
    tol = 1e-5 * max(1.0, float(ps[fin].abs().max()) if bool(fin.any()) else 1.0)
    missing = ok & (pi >= 0) & ~(pi[..., :, None] == gi[..., None, :]).any(-1)
    bad = missing & ((ps - gs[..., -1:]).abs() > tol)
    if bool((gi[~live] >= 0).any()):
        raise AssertionError("the grouped scan returned ids on a dropped probe pair")
    return err, int(missing.any(-1).sum()), int(bad.any(-1).sum())


def ivf_calls(ctx: Ctx, idx, nq: int, nprobe: int, passes: int, rerank: int = 0) -> int:
    """approx_min_k launches of `passes` passes of unfiltered IVF search
    calls over nq queries in batches of ctx.batch (bench_cuda's guards)."""
    import bench_cuda as BC

    return passes * sum(BC.ivf_search_launches(idx, min(ctx.batch, nq - lo), nprobe, K, rerank)
                        for lo in range(0, nq, ctx.batch))


def sharded_ivf_calls(ctx: Ctx, idx, nq: int, nprobe: int, passes: int) -> int:
    """ivf_calls for a ShardedIVF: each shard's ivf_search_impl at the
    local probe count the sharded search gives it."""
    import bench_cuda as BC

    p_loc = min(max(1, -(-nprobe // idx.n_shards) + 1), idx.state[0].centroids.shape[0])
    return passes * sum(
        BC.ivf_search_launches(types.SimpleNamespace(state=st), min(ctx.batch, nq - lo), p_loc,
                               K, idx.cfg.rerank)
        for st in idx.state for lo in range(0, nq, ctx.batch))


def ivf_scan_check(ctx: Ctx, idx, q1, p: int, label: str):
    """Both scans on the first batch's probes at nprobe p, held together
    (the pair scan's cut taken exactly, as the grouped scan's is); the
    share of probe pairs the grouped scan's q_cap drops."""
    from zvdb_tpu_torch.index import ivf as TI
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import topk as T

    cfg, st = idx.cfg, idx.state
    kk = K * cfg.rerank if cfg.rerank else K
    qp = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(ctx.device), cfg.metric)
    b, c = qp.shape[0], st.centroids.shape[0]
    cs = D.pairwise_scores(qp, st.centroids, st.c_norms, cfg.metric, precision="highest")
    _, probes = T.smallest_k_dense(cs, p)
    resid = cfg.dtype == "int8"
    with site_selection(exact_selection):
        ps, pi = TI._pair_scan(st, qp, cs, probes, kk, cfg.metric, resid, "highest")
    gs, gi = TI._grouped_scan(st, qp, cs, probes, kk, cfg.metric, resid, 4.0, "highest")
    qslot, pslot = TI._slot_pairs(probes, b, p, c, TI.group_q_cap(b, p, c, 4.0))
    live = torch.zeros((b, p), dtype=torch.bool, device=ctx.device)
    keep = qslot >= 0
    live[qslot[keep].long(), pslot[keep].long()] = True
    err, differ, bad = _compare_scans(ps, pi, gs, gi, live)
    dropped = 1.0 - float(live.float().mean())
    ctx.report(f"{label} pair scan vs grouped scan (nprobe={p}, B={b}, kk={kk}, q_cap="
               f"{qslot.shape[1]})", f"max |score diff| {err:.3g}; {differ} of "
               f"{int(live.sum())} kept pairs differ in ids, {bad} past a near-tie; "
               f"{100 * dropped:.3f}% of the {b * p} probe pairs dropped by q_cap")
    if bad or err > 1e-3:
        raise AssertionError(f"{label}: the pair and grouped scans disagree")


def ivf_sweep(ctx: Ctx, idx, q1, gt, nprobes, label: str):
    """recall@10, the scan taken, QPS (3 runs) and peak device memory at
    each nprobe; returns (the first nprobe with recall >= 0.95, else the
    last, its ids, {nprobe: recall}). Four passes over q1 at each nprobe:
    approx_min_k launches ivf_calls(..., 4) times."""
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.index.ivf import use_pair_scan

    c = idx.state.centroids.shape[0]
    chosen, recs = None, {}
    for p in nprobes:
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ids = batched_ids(ctx, idx, q1, nprobe=p)
        recs[p] = rec = recall_at_k(ids, gt, K)
        qps = search_qps(ctx, idx, q1, search_kwargs={"nprobe": p})
        peak = (f", peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
                if ctx.device.type == "cuda" else "")
        scan = "pair" if use_pair_scan(c, ctx.batch, p) else "grouped"
        ctx.report(f"{label} nprobe={p}", f"recall@10 {rec}, the {scan} scan at B={ctx.batch} "
                   f"(C={c}), QPS (3 runs) {[round(v, 1) for v in qps]}{peak}")
        if chosen is None and rec >= 0.95:
            chosen = (p, ids)
    if chosen is None:
        ctx.report(f"{label} recall@10 stays below 0.95 over nprobe {nprobes}", recs)
        chosen = (p, ids)
    return chosen[0], chosen[1], recs


def phase_ivf_main(ctx: Ctx, x1, q1, gt):
    """27. ivf_1m: builds from host and device rows, the nprobe sweep, both
    scans held together, a profile, a server, filtered and range search
    against the flat oracle, and 10,000 rows added through the append."""
    from zvdb_tpu_torch import FlatConfig, FlatIndex, IVFIndex
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.stats import index_stats

    dev = ctx.device
    cfg = ivf_config(ctx)
    ctx.report("ivf_1m config", cfg)
    xd = torch.from_numpy(x1).to(dev)
    IVFIndex(cfg, device=dev).build(xd)          # warm-up: first use of every op
    ctx.sync()
    pps = {"host": [], "device": []}
    for src in ("host", "device", "host", "device"):
        t0 = time.perf_counter()
        idx = IVFIndex(cfg, device=dev)
        idx.build(x1 if src == "host" else xd)
        ctx.sync()
        pps[src].append(ctx.n / (time.perf_counter() - t0))
    ctx.report("ivf_1m build points/s (2 runs each after a warm-up; host rows are uploaded "
               "inside the build)", pps)
    for src in ("host", "device"):
        os.environ["ZVDB_BUILD_TRACE"] = "1"
        try:
            print(f"  traced build from {src} rows:", flush=True)
            IVFIndex(cfg, device=dev).build(x1 if src == "host" else xd)
        finally:
            os.environ.pop("ZVDB_BUILD_TRACE", None)
    st = index_stats(idx)
    ctx.report("ivf_1m index", f"C={st['clusters']['count']} (of {cfg.n_clusters} before the "
               f"split), cap {st['clusters']['capacity']}, fill max {st['clusters']['fill_max']},"
               f" pad waste {st['clusters']['pad_waste']:.3f}, state GB "
               f"{st['total_bytes'] / 1e9:.3f}")

    reset_kernel_counts()
    np_, ids, recs = ivf_sweep(ctx, idx, q1, gt, IVF_NPROBES, "ivf_1m")
    launched = kernel_counts()
    if besides_approx(launched):
        raise AssertionError(f"the IVF search launched kernels: {launched}")
    ctx.report("ivf_1m kernel launches (search, all nprobes)", "none of A-G")
    check_approx(ctx, "ivf_1m search (all nprobes)", launched["approx"],
                 sum(ivf_calls(ctx, idx, q1.shape[0], p, 4) for p in IVF_NPROBES))
    for p in IVF_NPROBES:
        ivf_scan_check(ctx, idx, q1, p, "ivf_1m")
    profile_search(ctx, idx, q1, label=f"ivf_1m nprobe={np_}", search_kwargs={"nprobe": np_})
    phase_server(ctx, idx, q1, ids, label="ivf_1m ", search_kwargs={"nprobe": np_},
                 max_differ=0.01)
    ctx.report(f"ivf_1m server QPS (nprobe={np_})",
               server_qps(ctx, idx, q1, search_kwargs={"nprobe": np_}))

    # filtered and range search against the exact flat oracle
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(xd)
    qf = q1[:ctx.batch]
    rng = np.random.default_rng(27)
    for name, allow in (("1%", np.sort(rng.choice(ctx.n, ctx.n // 100, replace=False))),
                        ("50%", np.arange(0, ctx.n, 2))):
        truth = oracle.search(qf, K, allowed=allow)[1].cpu().numpy()
        for mode in ("scan", "probe"):
            ctx.sync()
            t0 = time.perf_counter()
            got = idx.search(qf, K, nprobe=np_, allowed=allow, filter_mode=mode)[1].cpu().numpy()
            dt = time.perf_counter() - t0
            rec = recall_at_k(got, truth, K)
            ctx.report(f"ivf_1m filtered {name} {mode} (nprobe={np_}, B={len(qf)})",
                       f"recall@10 vs the masked truth {rec}, {dt * 1e3:.1f} ms")
            if not np.isin(got[got >= 0], allow).all():
                raise AssertionError(f"filtered {name} {mode}: an id outside the allowlist")
            # the masked flat scan: exact scores, approx_min_k at 0.97 over tiles
            # of 131,072 rows (L = 512), where two of a query's 10 best rows
            # share a tile and a bin ~1e-3 of the time at 1M; a rehearsal's
            # few rows crowd one tile, so its recall is not held
            if mode == "scan" and rec < 0.99 and not ctx.rehearse:
                raise AssertionError(f"filtered {name} scan recall {rec} < 0.99")
    qr = q1[:256]
    radius = float(np.median(oracle.search(qr, K)[0].cpu().numpy()[:, -1]))
    t0 = time.perf_counter()
    got = idx.search_range(qr, radius, max_results=K)[2].cpu().numpy()
    dt = time.perf_counter() - t0
    want = oracle.search_range(qr, radius, max_results=K)[2].cpu().numpy()
    lo = oracle.search_range(qr, radius * (1 - 1e-5), max_results=K)[2].cpu().numpy()
    hi = oracle.search_range(qr, radius * (1 + 1e-5), max_results=K)[2].cpu().numpy()
    ctx.report(f"ivf_1m search_range (256 queries, radius {radius:.4f}, {dt * 1e3:.1f} ms)",
               f"counts equal to the flat oracle's on {int((got == want).sum())} of 256 "
               f"(mean count {got.mean():.2f}); all within the oracle's at radius x (1 -+ 1e-5)")
    if not ((lo <= got) & (got <= hi)).all():
        raise AssertionError("search_range counts differ from the flat oracle's")
    del oracle

    # add 1% of the rows to an index over the rest, through the O(new) append
    n_add = ctx.n // 100
    n0 = ctx.n - n_add
    add_idx = IVFIndex(cfg, device=dev)
    add_idx.build(xd[:n0])
    ctx.sync()
    ptr = add_idx.state.blocks.data_ptr()
    reset_kernel_counts()
    t0 = time.perf_counter()
    add_idx.add(x1[n0:])
    add_idx.flush()
    ctx.sync()
    dt = time.perf_counter() - t0
    appended = add_idx.state.blocks.data_ptr() == ptr
    rec = recall_at_k(batched_ids(ctx, add_idx, q1, nprobe=np_), gt, K)
    hit = float((batched_ids(ctx, add_idx, x1[n0:], nprobe=np_)[:, 0]
                 == np.arange(n0, ctx.n)).mean())
    ctx.report(f"ivf_1m add of {n_add} rows after a build over {n0}",
               f"{dt:.4f} s, {n_add / dt:.1f} rows/s, "
               f"{'the O(new) append' if appended else 'a repack'}; recall@10 after "
               f"(nprobe={np_}) {rec}; self-hit@1 of the added rows {hit}")
    if not appended or besides_approx(kernel_counts()):
        raise AssertionError("the add did not take the append, or launched a kernel")
    check_approx(ctx, "ivf_1m add + its two searches", kernel_counts()["approx"],
                 ivf_calls(ctx, add_idx, q1.shape[0], np_, 1)
                 + ivf_calls(ctx, add_idx, n_add, np_, 1))
    if hit < 0.95:
        raise AssertionError(f"self-hit@1 of the added rows {hit} < 0.95")
    del add_idx, xd
    return np_, recs


def phase_ivf_int8(ctx: Ctx, x1, q1, gt):
    """28. ivf_1m_int8: residual codes, the shadow store and the exact
    rerank; build, the nprobe sweep, both scans held together, remove and
    compact."""
    from zvdb_tpu_torch import IVFIndex
    from zvdb_tpu_torch.utils.stats import index_stats

    dev = ctx.device
    cfg = ivf8_config(ctx)
    ctx.report("ivf_1m_int8 config", cfg)
    xd = torch.from_numpy(x1).to(dev)
    IVFIndex(cfg, device=dev).build(xd)          # warm-up
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pps = []
    for _ in range(2):
        t0 = time.perf_counter()
        idx = IVFIndex(cfg, device=dev)
        idx.build(xd)
        ctx.sync()
        pps.append(ctx.n / (time.perf_counter() - t0))
    ctx.report("ivf_1m_int8 build points/s (rows on the device, 2 runs after a warm-up)", pps)
    if dev.type == "cuda":
        ctx.report("ivf_1m_int8 build peak device memory GB",
                   torch.cuda.max_memory_allocated() / 1e9)
    os.environ["ZVDB_BUILD_TRACE"] = "1"
    try:
        IVFIndex(cfg, device=dev).build(xd)
    finally:
        os.environ.pop("ZVDB_BUILD_TRACE", None)
    st = index_stats(idx)
    ctx.report("ivf_1m_int8 index", f"C={st['clusters']['count']}, cap "
               f"{st['clusters']['capacity']}, fill max {st['clusters']['fill_max']}, shadow "
               f"rows {idx.state.rerank_vecs.shape[0]}, state GB {st['total_bytes'] / 1e9:.3f} "
               f"({ {k: round(v / 1e9, 3) for k, v in st['component_bytes'].items()} })")
    reset_kernel_counts()
    np_, ids, recs = ivf_sweep(ctx, idx, q1, gt, IVF8_NPROBES, "ivf_1m_int8")
    if besides_approx(kernel_counts()):
        raise AssertionError("the int8 IVF search launched kernels")
    check_approx(ctx, "ivf_1m_int8 search (all nprobes)", kernel_counts()["approx"],
                 sum(ivf_calls(ctx, idx, q1.shape[0], p, 4, cfg.rerank) for p in IVF8_NPROBES))
    ivf_scan_check(ctx, idx, q1, np_, "ivf_1m_int8")
    profile_search(ctx, idx, q1, label=f"ivf_1m_int8 nprobe={np_}",
                   search_kwargs={"nprobe": np_})

    dead = np.sort(np.random.default_rng(28).choice(ctx.n, ctx.n // 100, replace=False))
    t0 = time.perf_counter()
    idx.remove(dead)
    ctx.sync()
    t_rm = time.perf_counter() - t0
    got = batched_ids(ctx, idx, q1, nprobe=np_)
    if np.isin(got, dead).any():
        raise AssertionError("a removed id came back")
    t0 = time.perf_counter()
    old = idx.compact()
    ctx.sync()
    t_cp = time.perf_counter() - t0
    ctx.report(f"ivf_1m_int8 remove {len(dead)} ids / compact",
               f"{t_rm:.4f} s / {t_cp:.3f} s; {len(idx)} rows after, none removed returned")
    if len(idx) != ctx.n - len(dead) or np.isin(old, dead).any():
        raise AssertionError("compact kept a removed row or lost a live one")
    del idx, xd
    return recs


def phase_ivf_checkpoint_sweep(ctx: Ctx, x1):
    """29. At 100k rows: the plan checkpoint resumed equal to the direct
    build, a save/load round trip with equal ids; then the sweep CLI (the
    reference protocol at d=128) for the ivf, flat and hnsw engines."""
    from zvdb_tpu_torch import IVFIndex
    from zvdb_tpu_torch.index.ivf import _STATE_FIELDS

    dev = ctx.device
    n_small = 5000 if ctx.rehearse else min(100_000, ctx.n)
    cfg = ivf8_config(ctx)
    xs = torch.from_numpy(x1[:n_small]).to(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = os.path.join(ROOT, "build", "ivf_plan.npz")
    saved = os.path.join(ROOT, "build", "ivf_save.npz")
    try:
        t = {}
        t0 = time.perf_counter()
        direct = IVFIndex(cfg, device=dev)
        direct.build(xs)
        ctx.sync()
        t["direct"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        IVFIndex(cfg, device=dev).build(xs, checkpoint_path=ckpt)
        ctx.sync()
        t["with the plan checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = IVFIndex.resume_build(ckpt, device=dev)
        ctx.sync()
        t["resumed"] = time.perf_counter() - t0
        for f in _STATE_FIELDS:
            a, b = getattr(direct.state, f), getattr(res.state, f)
            if not (torch.equal(a, b) if torch.is_tensor(a) else a == b):
                raise AssertionError(f"resumed IVF build: {f} differs from the direct build")
        t0 = time.perf_counter()
        direct.save(saved)
        t["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = IVFIndex.load(saved, device=dev)
        ctx.sync()
        t["load"] = time.perf_counter() - t0
        qq = x1[:ctx.batch:2] + 0.01
        if not torch.equal(direct.search(qq, K)[1], back.search(qq, K)[1]):
            raise AssertionError("ids differ after save/load")
        sizes = {os.path.basename(p): round(os.path.getsize(p) / 1e6, 1) for p in (ckpt, saved)}
    finally:
        for p in (ckpt, saved):
            if os.path.exists(p):
                os.remove(p)
    ctx.report(f"ivf {n_small // 1000}k int8 + rerank plan checkpoint and save/load",
               f"seconds {({k: round(v, 3) for k, v in t.items()})}, files MB {sizes}; resumed "
               "== direct field by field, ids equal after load")
    del direct, res, back, xs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    base = [sys.executable, "-m", "zvdb_tpu_torch.bench.sweep", "--recall",
            "--device", dev.type, "--dims", str(ctx.dim)]
    base += (["--points", "2000", "--queries", "200"] if ctx.rehearse else
             ["--points", "100000", "--queries", "10000"])
    for engine, ks in (("ivf", "10,25,50,100"), ("flat", "10"), ("hnsw", "10")):
        t0 = time.perf_counter()
        run = subprocess.run(base + ["--engine", engine, "--ks", ks], capture_output=True,
                             text=True, timeout=900, cwd=ROOT)
        if run.returncode:
            print(run.stderr[-4000:], flush=True)
            raise AssertionError(f"the sweep CLI failed for --engine {engine}")
        rows = [line for line in run.stderr.splitlines()
                if line.startswith(("insertion:", "search:"))]
        last = json.loads(run.stdout.strip().splitlines()[-1])
        ctx.report(f"sweep CLI --engine {engine} --ks {ks} ({time.perf_counter() - t0:.1f} s)",
                   json.dumps(last))
        for line in rows:
            print("  " + line, flush=True)


# ---------------------------------------------------------------------------
# the sharded engines: 4 shards on the one card (no kernel runs on their paths)

N_SHARDS = 4


def sharded_mesh(ctx: Ctx):
    """4 shards placed cyclically on the one device: every shard on it."""
    from zvdb_tpu_torch import make_mesh

    return make_mesh(n_shards=N_SHARDS, devices=[ctx.device])


def batched_search(ctx, index, q1, **search_kwargs):
    """(scores, ids) of every query, in batches, as numpy."""
    out = [index.search(q1[lo:lo + ctx.batch], K, **search_kwargs)
           for lo in range(0, q1.shape[0], ctx.batch)]
    return (torch.cat([o[0] for o in out]).cpu().numpy(),
            torch.cat([o[1] for o in out]).cpu().numpy())


def differing_ties(label, got, want, atol):
    """tests/test_sharded_equivalence.py's rule: scores equal slot by slot
    (rtol 1e-4, `atol`), so an id may differ only where both sides score
    the slot alike (a tie). Returns the number of differing ids."""
    (sa, ia), (sb, ib) = got, want
    fin = np.isfinite(sa) | np.isfinite(sb)
    close = np.isclose(np.where(fin, sa, 0.0), np.where(fin, sb, 0.0), rtol=1e-4, atol=atol)
    if not close.all():
        raise AssertionError(f"{label}: {int((~close).sum())} scores differ from the flat "
                             f"oracle's (first at {np.argwhere(~close)[0]})")
    return int(((ia != ib) & fin).sum())


def hold_approx(label, got, ref, exact, q, x, bar):
    """An l2 approx=True search's (scores, ids) held three ways: against the
    same search with approx_min_k swapped for its plain version (`ref`:
    scores slot by slot, ids only at ties), by each id's squared distance
    recomputed in f64 from the host rows (the id names the row that scored),
    and by recall@10 against the exact search `exact`, at least `bar`.
    Returns (ids differing from `ref`, recall@10)."""
    from zvdb_tpu_torch.bench.harness import recall_at_k

    s, i = got
    if not ((i >= -1) & (i < x.shape[0])).all():
        raise AssertionError(f"{label}: an id outside [-1, n)")
    bad = differing_ties(f"{label} against its plain selection", got, ref, atol=1e-3)
    live = i >= 0
    rows = x[i[live]].astype(np.float64)
    qs = np.repeat(q.astype(np.float64), live.sum(1), axis=0)
    d = ((rows - qs) ** 2).sum(-1)
    if not np.isclose(s[live], d, rtol=1e-4, atol=1e-3).all():
        raise AssertionError(f"{label}: an id's f64 distance differs from its score")
    rec = recall_at_k(i, exact[1], K)
    if rec < bar:
        raise AssertionError(f"{label}: recall@10 {rec} against the exact search is below "
                             f"the bins' bar {bar:.4f}")
    return bad, rec


def shard_times(ctx: Ctx, idx, q1, label: str, **search_kwargs):
    """One pass over every query with a utils.profiling.PhaseRecorder on the
    index: ms a batch of each shard's local search and of the merge (each
    span ends in a sync)."""
    from zvdb_tpu_torch.utils.profiling import PhaseRecorder

    idx.recorder = PhaseRecorder()
    try:
        batched_ids(ctx, idx, q1, **search_kwargs)
    finally:
        rec, idx.recorder = idx.recorder.report(), None
    ctx.report(f"{label} ms a batch of {ctx.batch} by span (synced phases)",
               {name: round(r["mean_s"] * 1e3, 3) for name, r in rec.items()})
    return rec


def range_counts_check(ctx, idx, oracle, q1, label: str):
    """search_range counts on 256 queries at the median 10th-neighbour
    distance, bracketed by the flat oracle's at radius x (1 -+ 1e-5)."""
    qr = q1[:256]
    radius = float(np.median(oracle.search(qr, K)[0].cpu().numpy()[:, -1]))
    t0 = time.perf_counter()
    s, i, got = (a.cpu().numpy() for a in idx.search_range(qr, radius, max_results=K))
    dt = time.perf_counter() - t0
    want = oracle.search_range(qr, radius, max_results=K)[2].cpu().numpy()
    lo = oracle.search_range(qr, radius * (1 - 1e-5), max_results=K)[2].cpu().numpy()
    hi = oracle.search_range(qr, radius * (1 + 1e-5), max_results=K)[2].cpu().numpy()
    ctx.report(f"{label} search_range (256 queries, radius {radius:.4f}, {dt * 1e3:.1f} ms)",
               f"counts equal to the flat oracle's on {int((got == want).sum())} of 256 (mean "
               f"count {got.mean():.2f}); all within the oracle's at radius x (1 -+ 1e-5)")
    if not ((lo <= got) & (got <= hi)).all() or (s[i >= 0] > radius).any():
        raise AssertionError(f"{label} search_range differs from the flat oracle's")


def phase_sharded_flat(ctx: Ctx, x1, q1, gt):
    """30. sharded_flat_1m: ShardedFlat(FlatConfig(precision="highest")) over
    4 shards on the card. approx=False (each shard's exact top-k, the
    selection every search took before approx_min_k had a kernel) against
    the port's single-chip exact FlatIndex; approx=True (the default: each
    shard's k by approx_min_k, 4 launches a batch) against its own run with
    the kernel's plain version, by each id's f64 distance, and by recall@10
    against approx=False at the bins' bar, with QPS and span times beside
    it; the filtered batch both ways, held alike."""
    from zvdb_tpu_torch import FlatConfig, FlatIndex, ShardedFlat
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.profiling import Phase, live_buffer_bytes

    dev = ctx.device
    cfg = FlatConfig(dim=ctx.dim, precision="highest")
    oracle = FlatIndex(dataclasses.replace(cfg, tile_n=262144), capacity=ctx.n, device=dev)
    oracle.add(x1)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        before = live_buffer_bytes()
    reset_kernel_counts()
    with Phase("sharded_flat_1m build") as p:
        idx = ShardedFlat(cfg, mesh=sharded_mesh(ctx))
        idx.build(x1)
    ctx.report("sharded_flat_1m build", f"{p.elapsed_s:.3f} s ({ctx.n / p.elapsed_s:.1f} "
               f"points/s from host rows), shards {idx._per_shard_n.tolist()} on {idx.mesh}")
    if dev.type == "cuda":
        ctx.report("sharded_flat_1m live_buffer_bytes after the build (GB; the oracle's "
                   "excluded)", (live_buffer_bytes() - before) / 1e9)
    else:
        ctx.report("sharded_flat_1m live_buffer_bytes", "not measured (CUDA tensors only)")

    exact = {"approx": False}
    got, want = batched_search(ctx, idx, q1, **exact), batched_search(ctx, oracle, q1)
    bad = differing_ties("sharded_flat_1m", got, want, atol=1e-3)
    ctx.report("sharded_flat_1m approx=False ids against the single-chip exact FlatIndex (all "
               "queries)", f"{bad} of {got[1].size} differ, each at a tie; recall@10 vs phase "
               f"4's truth {recall_at_k(got[1], gt, K)}")
    if besides_approx(kernel_counts()) or kernel_counts()["approx"]:
        raise AssertionError(f"sharded flat approx=False launched kernels: {kernel_counts()}")
    n_batches = -(-q1.shape[0] // ctx.batch)
    apx = batched_search(ctx, idx, q1)
    check_approx(ctx, f"sharded_flat_1m approx=True ({n_batches} batches x {N_SHARDS} shards)",
                 kernel_counts()["approx"], n_batches * N_SHARDS)
    with site_selection(binned_plain):
        ref = batched_search(ctx, idx, q1)
    shard_n = ctx.n // N_SHARDS
    bar = selection_bar(shard_n, cfg.recall_target, q1.shape[0])
    bad, rec = hold_approx("sharded_flat_1m approx=True", apx, ref, got, q1, x1, bar)
    ctx.report("sharded_flat_1m approx=True recall@10 vs phase 4's truth / vs the exact "
               "sharded search", f"{recall_at_k(apx[1], gt, K)} / {rec} (bar {bar:.4f}); "
               f"{bad} ids differ from its run with the plain selection (ties); each id's "
               "f64 distance equals its score")
    for label, kw in (("approx=False", exact), ("approx=True", {}), ("approx=True", {}),
                      ("approx=False", exact)):
        ctx.report(f"sharded_flat_1m {label} search QPS (batches of {ctx.batch}, 3 runs)",
                   search_qps(ctx, idx, q1, search_kwargs=kw))
        shard_times(ctx, idx, q1, f"sharded_flat_1m {label}", **kw)
    profile_search(ctx, idx, q1, label="sharded_flat_1m", search_kwargs={})
    profile_search(ctx, idx, q1, label="sharded_flat_1m approx=False", search_kwargs=exact)
    reset_kernel_counts()

    rng = np.random.default_rng(30)
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    with Phase("remove") as p:
        removed = idx.remove(dead)
    oracle.remove(dead)
    qf = q1[:ctx.batch]
    got = tuple(a.cpu().numpy() for a in idx.search(qf, K, approx=False))
    bad = differing_ties("sharded_flat_1m after remove", got,
                         tuple(a.cpu().numpy() for a in oracle.search(qf, K)), atol=1e-3)
    if removed != dead.size or np.isin(got[1], dead).any():
        raise AssertionError("sharded_flat_1m: remove did not take every id out")
    allow = np.sort(rng.choice(ctx.n, ctx.n // 10, replace=False))
    ctx.sync()
    t0 = time.perf_counter()
    fgot = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow, approx=False))
    t_f = time.perf_counter() - t0
    fbad = differing_ties("sharded_flat_1m filtered", fgot,
                          tuple(a.cpu().numpy() for a in oracle.search(qf, K, allowed=allow)),
                          atol=1e-3)
    ids = fgot[1]
    if not np.isin(ids[ids >= 0], allow).all() or np.isin(ids, dead).any():
        raise AssertionError("sharded_flat_1m filtered: an id outside the allowlist or removed")
    ctx.report("sharded_flat_1m remove 1% + a 10% allowlist (approx=False)", f"{removed} ids "
               f"removed in {p.elapsed_s * 1e3:.1f} ms, {bad} ids differ from the oracle's "
               f"after it (ties); filtered batch {t_f * 1e3:.1f} ms, {fbad} differ (ties)")
    fapx = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow))
    if not np.isin(fapx[1][fapx[1] >= 0], allow).all() or np.isin(fapx[1], dead).any():
        raise AssertionError("sharded_flat_1m filtered approx=True: an id outside the allowlist "
                             "or removed")
    with site_selection(binned_plain):
        fref = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow))
    fbar = selection_bar(shard_n, cfg.recall_target, qf.shape[0])
    fbad, frec = hold_approx("sharded_flat_1m filtered approx=True", fapx, fref, fgot,
                             qf, x1, fbar)
    ctx.report("sharded_flat_1m filtered approx=True recall@10 vs the exact filtered search",
               f"{frec} (bar {fbar:.4f}); {fbad} ids differ from its run with the plain "
               "selection (ties); each id's f64 distance equals its score")
    range_counts_check(ctx, idx, oracle, q1, "sharded_flat_1m")
    if besides_approx(kernel_counts()):
        raise AssertionError(f"the sharded flat path launched kernels: {kernel_counts()}")
    check_approx(ctx, "sharded_flat_1m filtered approx=True batch", kernel_counts()["approx"],
                 N_SHARDS)
    del idx
    return oracle, dead


def trace_split(ctx: Ctx, label: str, call):
    """`call` once under utils/profiling.trace: each "zvdb shard <s>" and
    "zvdb merge" span's wall ms and the device's busy ms inside it, from
    the Chrome trace the profiler writes; the file is deleted after."""
    import glob
    import shutil

    from zvdb_tpu_torch.utils.profiling import trace

    log_dir = os.path.join(ROOT, "build", "sharded_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    try:
        with trace(log_dir):
            t0 = time.perf_counter()
            call()
            ctx.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3   # the trace's export not included
        with open(glob.glob(os.path.join(log_dir, "*.json"))[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    # the sharded search's own host ranges (a C++ range's category is
    # "cpu_op"); the engines' inner spans (seeds, hops, waits) are left out
    spans = [(e["name"][5:], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and not e.get("cat", "").startswith("gpu_")
             and (e.get("name", "").startswith("zvdb shard ") or e.get("name") == "zvdb merge")]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not kernels:
        ctx.report(label, f"{len(spans)} spans, {wall_ms:.1f} ms wall; no device time in the "
                   "trace: the split is not measured")
        return

    def busy(a, b):
        """Device-busy microseconds inside [a, b]: the union of kernel intervals."""
        total, end = 0.0, a
        for k0, k1 in kernels:
            k0, k1 = max(k0, end), min(k1, b)
            if k1 > k0:
                total += k1 - k0
                end = k1
        return total

    split = {name: f"{(b - a) / 1e3:.3f} ms wall, {busy(a, b) / 1e3:.3f} ms busy"
             for name, a, b in spans}
    a0, b0 = min(a for _, a, _ in spans), max(b for _, _, b in spans)
    ctx.report(label, f"{wall_ms:.1f} ms wall; spans {split}; device idle "
               f"{100 * (1 - busy(a0, b0) / (b0 - a0)):.1f}% of the spans' window; "
               f"{len(kernels)} kernels")


def clone_sharded_hnsw(idx, search_cfg):
    """A copy of a ShardedHNSW (tensors cloned on their devices) searching
    and flushing with `search_cfg`."""
    from zvdb_tpu_torch import ShardedHNSW
    from zvdb_tpu_torch.index import hnsw as TH

    c = ShardedHNSW(idx.cfg, search_cfg, mesh=idx.mesh, seed=7)
    c.state = [dataclasses.replace(st, **{f: getattr(st, f).clone() for f in TH.FIELDS
                                          if torch.is_tensor(getattr(st, f))})
               for st in idx.state]
    c.levels_cap, c.shard_cap, c._n, c._anchor_n = (idx.levels_cap, idx.shard_cap, idx._n,
                                                    idx._anchor_n)
    return c


def phase_sharded_hnsw(ctx: Ctx, x1, q1, gt, oracle, dead):
    """31. sharded_hnsw_1m: hnsw_1m's configuration over 4 shards on the
    card, built by the batched step; the ef sweep; 10,000 inserted rows with
    and without anchor seeding; remove + the sharded masked scan."""
    from zvdb_tpu_torch import HNSWConfig, SearchConfig, ShardedHNSW
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    cfg = HNSWConfig(dim=ctx.dim, m=16, ef_construction=100,
                     build_batch=1024 if ctx.rehearse else 8192)
    ctx.report("sharded_hnsw_1m config", cfg)
    mesh = sharded_mesh(ctx)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with Phase("sharded_hnsw_1m build") as p:
        idx = ShardedHNSW(cfg, mesh=mesh, seed=0)
        idx.build(x1)
    ctx.report("sharded_hnsw_1m build", f"{p.elapsed_s:.3f} s, {ctx.n / p.elapsed_s:.1f} "
               f"points/s from host rows, shards {[st.n for st in idx.state]}, shard_cap "
               f"{idx.shard_cap}, levels_cap {idx.levels_cap}, anchors "
               f"{idx.state[0].anchors.shape[0]} a shard (single chip: phase 24's batched "
               f"{ctx.n / getattr(ctx, 'hnsw_batched_s', float('nan')):.1f}, phase 20's one-shot "
               f"{ctx.n / getattr(ctx, 'hnsw_oneshot_s', float('nan')):.1f} points/s)")
    if dev.type == "cuda":
        ctx.report("sharded_hnsw_1m peak device memory GB (build, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    sweep, ef = {}, None
    for e in EFS:
        ctx.sync()
        t0 = time.perf_counter()
        ids = batched_ids(ctx, idx, q1, ef_search=e)
        qps = q1.shape[0] / (time.perf_counter() - t0)
        rec = recall_at_k(ids, gt, K)
        sweep[e] = (rec, round(qps, 1))
        if ef is None and rec >= 0.95:
            ef = e
    ctx.report("sharded_hnsw_1m ef sweep (recall@10 over all queries, QPS)", sweep)
    ctx.report("sharded_hnsw_1m first ef with recall@10 >= 0.95", ef)
    if ef is None:
        raise AssertionError(f"sharded_hnsw_1m recall@10 stays below 0.95 up to ef=96: {sweep}")
    ctx.report(f"sharded_hnsw_1m search QPS (ef={ef}, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs={"ef_search": ef}))
    shard_times(ctx, idx, q1, f"sharded_hnsw_1m (ef={ef})", ef_search=ef)
    trace_split(ctx, f"sharded_hnsw_1m one traced batch of {ctx.batch} (ef={ef})",
                lambda: idx.search(q1[:ctx.batch], K, ef_search=ef))
    if any(kernel_counts().values()):
        raise AssertionError(f"the sharded HNSW path launched kernels: {kernel_counts()}")

    # remove 1% (phase 30's ids: the oracle holds the same tombstones), then
    # a 10% filter through the sharded masked scan
    with Phase("remove") as p:
        idx.remove(dead)
    ids = batched_ids(ctx, idx, q1, ef_search=ef)
    if np.isin(ids, dead).any():
        raise AssertionError("sharded_hnsw_1m: a removed id came back")
    qf = q1[:ctx.batch]
    allow = np.sort(np.random.default_rng(31).choice(ctx.n, ctx.n // 10, replace=False))
    ctx.sync()
    t0 = time.perf_counter()
    fgot = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow, filter_mode="scan"))
    t_f = time.perf_counter() - t0
    # the scan's products are the config's bf16x3 ("high"): atol 1e-2 of scores ~1-10
    fbad = differing_ties("sharded_hnsw_1m filtered scan", fgot,
                          tuple(a.cpu().numpy() for a in oracle.search(qf, K, allowed=allow)),
                          atol=1e-2)
    if not np.isin(fgot[1][fgot[1] >= 0], allow).all() or np.isin(fgot[1], dead).any():
        raise AssertionError("sharded_hnsw_1m filtered: an id outside the allowlist or removed")
    ctx.report("sharded_hnsw_1m remove 1% + a 10% allowlist in filter_mode=scan",
               f"{dead.size} removed in {p.elapsed_s * 1e3:.1f} ms, none returned; recall@10 "
               f"vs the unfiltered truth {recall_at_k(ids, gt, K)}; filtered batch "
               f"{t_f * 1e3:.1f} ms, {fbad} ids differ from the exact FlatIndex's (ties)")
    del idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 10,000 rows inserted in requests of 100 into a build over the rest,
    # flushed with anchor seeding (SearchConfig's 16) and with JAX's
    # descent-only seeding (seed_anchors=0); their global ids are their rows
    n_ins, req = ctx.n // 100, 100
    n0 = ctx.n - n_ins
    base = ShardedHNSW(cfg, mesh=mesh, seed=3)
    base.build(x1[:n0])
    sel = _inserted_query_rows(ctx, n0)
    line = []
    for seed_anchors in (16, 0):
        ins = clone_sharded_hnsw(base, SearchConfig(seed_anchors=seed_anchors))
        reset_kernel_counts()
        ctx.sync()
        t0 = time.perf_counter()
        for lo in range(n0, ctx.n, req):
            ins.insert(x1[lo:lo + req])
        ins.flush()
        ctx.sync()
        dt = time.perf_counter() - t0
        hit = float((batched_ids(ctx, ins, x1[n0:], ef_search=ef)[:, 0]
                     == np.arange(n0, ctx.n)).mean())
        ids = batched_ids(ctx, ins, q1, ef_search=ef)
        line.append(f"seed_anchors={seed_anchors}: {dt:.3f} s ({n_ins / dt:.1f} rows/s), "
                    f"self-hit@1 {hit}, recall@10 {recall_at_k(ids, gt, K)} (of the "
                    f"{int(sel.sum())} queries from inserted rows "
                    f"{recall_at_k(ids[sel], gt[sel], K)}), shard_cap {ins.shard_cap}")
        if any(kernel_counts().values()) or len(ins) != ctx.n:
            raise AssertionError(f"sharded insert: kernels {kernel_counts()}, len {len(ins)}")
        if seed_anchors and hit < 0.95:
            raise AssertionError(f"sharded_hnsw_1m self-hit@1 of the inserted rows {hit} < 0.95")
        del ins
    ctx.report(f"sharded_hnsw_1m insert of {n_ins} rows in requests of {req} after a build "
               f"over {n0} (ef={ef})", "; ".join(line))
    del base
    return ef


def phase_sharded_persist_sweep(ctx: Ctx, x1, ef: int):
    """32. ShardedHNSW and ShardedFlat save/load at 100k (ids equal), the
    sweep CLI with --devices 4, and utils/router.suggest_engine."""
    from zvdb_tpu_torch import FlatConfig, HNSWConfig, ShardedFlat, ShardedHNSW
    from zvdb_tpu_torch.utils.profiling import Phase
    from zvdb_tpu_torch.utils.router import RC_GRAPH_THRESHOLD, suggest_engine

    dev = ctx.device
    n_small = 5000 if ctx.rehearse else min(100_000, ctx.n)
    xs = x1[:n_small]
    qb = xs[:ctx.batch] + np.float32(0.01)
    mesh = sharded_mesh(ctx)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, make, kw in (
            ("ShardedHNSW", lambda: ShardedHNSW(HNSWConfig(
                dim=ctx.dim, m=16, ef_construction=100,
                build_batch=1024 if ctx.rehearse else 8192), mesh=mesh), {"ef_search": ef}),
            ("ShardedFlat", lambda: ShardedFlat(FlatConfig(dim=ctx.dim), mesh=mesh), {})):
        path = os.path.join(ROOT, "build", f"{name}_{n_small}.npz")
        try:
            with Phase("build") as pb:
                idx = make()
                idx.build(xs)
            before = idx.search(qb, K, **kw)[1]
            with Phase("save") as ps:
                idx.save(path)
            with Phase("load") as pl:
                back = type(idx).load(path, mesh=mesh)
            size = os.path.getsize(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        if not torch.equal(before, back.search(qb, K, **kw)[1]):
            raise AssertionError(f"{name}: ids differ after the save/load round trip")
        ctx.report(f"{name} {n_small // 1000}k save/load", f"build {pb.elapsed_s:.2f} s, save "
                   f"{ps.elapsed_s:.2f} s, load {pl.elapsed_s:.2f} s, file {size / 1e6:.1f} "
                   "MB; ids equal after load")
        del idx, back

    argv = [sys.executable, "-m", "zvdb_tpu_torch.bench.sweep", "--recall", "--engine", "hnsw",
            "--devices", str(N_SHARDS), "--device", dev.type, "--dims", str(ctx.dim), "--ks",
            "10"] + (["--points", "2000", "--queries", "200"] if ctx.rehearse else
                     ["--points", "100000", "--queries", "10000"])
    t0 = time.perf_counter()
    run = subprocess.run(argv, capture_output=True, text=True, timeout=900, cwd=ROOT)
    if run.returncode:
        print(run.stderr[-4000:], flush=True)
        raise AssertionError("the sweep CLI failed for --engine hnsw --devices 4")
    last = json.loads(run.stdout.strip().splitlines()[-1])
    ctx.report(f"sweep CLI --engine hnsw --devices {N_SHARDS} ({time.perf_counter() - t0:.1f} "
               "s)", json.dumps(last))
    for line in run.stderr.splitlines():
        if line.startswith(("sharded:", "insertion:", "search:")):
            print("  " + line, flush=True)
    if last["num_devices"] != 1:
        raise AssertionError(f"a one-card sweep row claims {last['num_devices']} devices")

    sample = x1[np.random.default_rng(32).choice(ctx.n, min(20_000, ctx.n), replace=False)]
    t0 = time.perf_counter()
    engine, rc = suggest_engine(sample)
    ctx.report("utils/router.suggest_engine on 20,000 corpus rows (host numpy)",
               f"{engine} (relative contrast {rc:.3f}, threshold {RC_GRAPH_THRESHOLD}) in "
               f"{time.perf_counter() - t0:.3f} s")
    if not np.isfinite(rc) or engine != ("cagra" if rc >= RC_GRAPH_THRESHOLD else "flat"):
        raise AssertionError(f"the router's answer {engine} does not follow its contrast {rc}")


# ---------------------------------------------------------------------------
# the sharded PQ engines: kernels B and C once a shard a batch

def phase_sharded_pq(ctx: Ctx, x1, q1, gt, pq_recall: float):
    """33. sharded_pq_1m: pq_1m's configuration over 4 shards on the card,
    kernel B once a shard a batch."""
    from zvdb_tpu_torch import ShardedPQFlat
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import pq as PQ
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.utils.profiling import Phase, live_buffer_bytes

    dev = ctx.device
    cfg = pq_config(ctx)
    ctx.report("sharded_pq_1m config", f"{cfg}, {N_SHARDS} shards")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        before = live_buffer_bytes()
    with Phase("sharded_pq_1m build") as p:
        idx = ShardedPQFlat(cfg, mesh=sharded_mesh(ctx))
        idx.build(x1)
    ctx.report("sharded_pq_1m build", f"{p.elapsed_s:.3f} s ({ctx.n / p.elapsed_s:.1f} points/s "
               f"from host rows), shards {idx._per_shard_n.tolist()}, codes a shard "
               f"{tuple(idx.state[0]['codes'].shape)}")
    if dev.type == "cuda":
        ctx.report("sharded_pq_1m live_buffer_bytes after the build (GB)",
                   (live_buffer_bytes() - before) / 1e9)
    n_batches = -(-q1.shape[0] // ctx.batch)
    reset_kernel_counts()
    ids = batched_ids(ctx, idx, q1, **APPROX)
    ctx.sync()
    counts = kernel_counts()
    rec = recall_at_k(ids, gt, K)
    ctx.report("sharded_pq_1m kernel launches", f"{counts} for {n_batches} batches "
               f"({N_SHARDS} shards)")
    ctx.report("sharded_pq_1m recall@10 (all queries)",
               f"{rec} (single-chip pq_1m {pq_recall})")
    want = N_SHARDS * n_batches
    if not ctx.rehearse and (counts["B"] != want or counts["B_mma"] != want
                             or sum(counts.values()) != 2 * want):
        raise AssertionError(f"sharded_pq_1m: kernel B launched {counts['B']} times "
                             f"({counts['B_mma']} on the tensor cores), not {want}: {counts}")
    if rec < 0.95 or rec < pq_recall - 0.005:
        raise AssertionError(f"sharded_pq_1m recall@10 {rec} < max(0.95, {pq_recall} - 0.005)")
    ctx.report(f"sharded_pq_1m search QPS (batches of {ctx.batch}, 3 runs)",
               search_qps(ctx, idx, q1))
    shard_times(ctx, idx, q1, "sharded_pq_1m", **APPROX)
    trace_split(ctx, f"sharded_pq_1m one traced batch of {ctx.batch}",
                lambda: idx.search(q1[:ctx.batch], K))

    # kernel B on shard 0's own inputs: the first batch's table, its codes
    # and norms
    st = idx.state[0]
    qs = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), cfg.metric)
    lut = PQ.adc_lut(PQ.apply_rotation(qs, idx.rot), idx.codebooks)
    args = (cfg.l_bins, cfg.pallas_chunk, cfg.metric)
    for precision in ("int8", "default", "high"):
        compare_pq_case(
            ctx, f"PQ shard 0 inputs B={lut.shape[0]} N={st['norms'].shape[0]} {precision}",
            lut, st["codes"], st["norms"], *args, precision, cfg.per_bin, cfg.seg_rows)
    if not ctx.rehearse:
        ns, ni = PS.pq_scan_bins(lut, st["codes"], st["norms"], l_bins=cfg.l_bins,
                                 chunk=cfg.pallas_chunk, metric=cfg.metric, precision="int8",
                                 per_bin=cfg.per_bin, seg_rows=cfg.seg_rows)
        os_, oi = PS.launch(PS.build(), lut, st["codes"], st["norms"], *args, "int8",
                            cfg.per_bin, cfg.seg_rows)
        ctx.sync()
        if not (torch.equal(ni, oi) and torch.equal(ns, os_)):
            raise AssertionError("PQ shard 0 int8: the tensor cores and the CUDA cores differ")
        print("  compare PQ shard 0 inputs int8: tensor cores == CUDA cores, ids and scores",
              flush=True)

    # remove 1% and a 10% allowlist
    rng = np.random.default_rng(33)
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    with Phase("remove") as p:
        removed = idx.remove(dead)
    ids = batched_ids(ctx, idx, q1, **APPROX)
    allow = np.sort(rng.choice(ctx.n, ctx.n // 10, replace=False))
    qf = q1[:ctx.batch]
    ctx.sync()
    t0 = time.perf_counter()
    fids = idx.search(qf, K, allowed=allow)[1].cpu().numpy()
    t_f = time.perf_counter() - t0
    if removed != dead.size or np.isin(ids, dead).any() or np.isin(fids, dead).any() \
            or not np.isin(fids[fids >= 0], allow).all():
        raise AssertionError("sharded_pq_1m: a removed id came back or an id outside the "
                             "allowlist surfaced")
    ctx.report("sharded_pq_1m remove 1% + a 10% allowlist",
               f"{removed} ids removed in {p.elapsed_s * 1e3:.1f} ms, none returned; recall@10 "
               f"vs the unfiltered truth {recall_at_k(ids, gt, K)}; filtered batch "
               f"{t_f * 1e3:.1f} ms, only allowed ids")
    del idx


def phase_sharded_ivfpq(ctx: Ctx, x1, q1, gt, ivf_recall: float):
    """34. sharded_ivfpq_1m: ivfpq_1m's configuration over 4 shards on the
    card, kernel C once a shard a batch."""
    from zvdb_tpu_torch import (FlatConfig, FlatIndex, IVFPQConfig, IVFPQIndex,
                                ShardedIVFPQ)
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.index import ivfpq as IV
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import pq as PQ
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    cfg = IVFPQConfig(dim=ctx.dim)
    mesh = sharded_mesh(ctx)
    ctx.report("sharded_ivfpq_1m config", f"{cfg}, search {IVFPQ_SEARCH}, {N_SHARDS} shards")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with Phase("sharded_ivfpq_1m build") as p:
        idx = ShardedIVFPQ(cfg, mesh=mesh)
        idx.build(x1)
    with Phase("single-chip build") as ps:      # the same build in its two parts
        single = IVFPQIndex(cfg, device=dev)
        single.build(x1)
    with Phase("placement") as pp:
        ShardedIVFPQ(cfg, mesh=mesh)._place(single.state)
    del single
    st0 = idx.state[0]
    ctx.report("sharded_ivfpq_1m build", f"{p.elapsed_s:.3f} s ({ctx.n / p.elapsed_s:.1f} "
               f"points/s from host rows); again in parts: single-chip build "
               f"{ps.elapsed_s:.3f} s, placement {pp.elapsed_s:.3f} s; clusters "
               f"{idx._cluster_of.shape[0]}, C_loc {st0.codes_blocks.shape[0]}, cap "
               f"{st0.codes_blocks.shape[2]}, rows a shard {idx._n_loc.tolist()}, rcap "
               f"{st0.refine.shape[0]}")
    if dev.type == "cuda":
        ctx.report("sharded_ivfpq_1m peak device memory GB (the builds, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    n_batches = -(-q1.shape[0] // ctx.batch)
    reset_kernel_counts()
    ids = batched_ids(ctx, idx, q1, **IVFPQ_SEARCH)
    ctx.sync()
    counts = kernel_counts()
    rec = recall_at_k(ids, gt, K)
    ctx.report("sharded_ivfpq_1m kernel launches", f"{counts} for {n_batches} batches "
               f"({N_SHARDS} shards)")
    ctx.report("sharded_ivfpq_1m recall@10 (all queries)",
               f"{rec} (single-chip ivfpq_1m {ivf_recall})")
    want = N_SHARDS * n_batches
    if not ctx.rehearse and (counts["C_pairs"] != want or sum(counts.values()) != want):
        raise AssertionError(f"sharded_ivfpq_1m: the pair scan launched {counts['C_pairs']} "
                             f"times, not {want}: {counts}")
    if rec < 0.95 or rec < ivf_recall - 0.005:
        raise AssertionError(f"sharded_ivfpq_1m recall@10 {rec} < max(0.95, {ivf_recall} "
                             "- 0.005)")
    ctx.report(f"sharded_ivfpq_1m search QPS (batches of {ctx.batch}, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs=IVFPQ_SEARCH))
    shard_times(ctx, idx, q1, "sharded_ivfpq_1m", **IVFPQ_SEARCH)
    trace_split(ctx, f"sharded_ivfpq_1m one traced batch of {ctx.batch}",
                lambda: idx.search(q1[:ctx.batch], K, **IVFPQ_SEARCH))

    # the pair scan on shard 0's own inputs: its slots for the first batch,
    # its blocks, the table
    qp = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(dev), cfg.metric)
    p_loc = min(-(-IVFPQ_SEARCH["nprobe"] // N_SHARDS) + 1, st0.c_norms.shape[0])
    p_loc, qslot, pslot = IV._probe_slots(st0, qp, p_loc, cfg.group_slack, cfg.scan_precision,
                                          cfg.metric, c_mask=idx.c_mask[0])
    lut = PQ.adc_lut(PQ.apply_rotation(qp, st0.rot), st0.codebooks)
    for precision in ("int8", "default", "high"):
        compare_pairs_case(
            ctx, f"IVF-PQ pairs shard 0 inputs B={lut.shape[0]} C_loc={st0.codes_blocks.shape[0]} "
            f"P={p_loc} q_cap={qslot.shape[1]} {precision}", lut, qslot, pslot, st0.codes_blocks,
            st0.norms_blocks, p_loc, cfg.l_bins, cfg.chunk, cfg.metric, precision, cfg.per_bin)

    # a 1% allowlist: the exact masked scan against the exact FlatIndex's
    # filtered search (up to ties: the scan reads the int16 refine store at
    # "high"), and the probe pool
    rng = np.random.default_rng(34)
    allow = np.sort(rng.choice(ctx.n, ctx.n // 100, replace=False))
    qf = q1[:ctx.batch]
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(x1)
    want = tuple(a.cpu().numpy() for a in oracle.search(qf, K, allowed=allow))
    del oracle
    line = []
    for mode in ("scan", "probe"):
        ctx.sync()
        t0 = time.perf_counter()
        got = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow, filter_mode=mode,
                                                        **IVFPQ_SEARCH))
        dt = time.perf_counter() - t0
        fids = got[1]
        if not np.isin(fids[fids >= 0], allow).all():
            raise AssertionError(f"sharded_ivfpq_1m {mode}: an id outside the allowlist")
        frec = recall_at_k(fids, want[1], K)
        if mode == "scan":
            differ = differing_ties("sharded_ivfpq_1m filtered scan", got, want, atol=1e-2)
            line.append(f"scan {dt * 1e3:.1f} ms, recall {frec} against the exact filtered "
                        f"search, {differ} ids differ (ties)")
        else:
            line.append(f"probe {dt * 1e3:.1f} ms, recall {frec}")
    ctx.report("sharded_ivfpq_1m filtered 1% (first batch)", "; ".join(line))

    # remove 1% and compact, timed
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    with Phase("remove") as pr:
        removed = idx.remove(dead)
    ids = batched_ids(ctx, idx, q1, **IVFPQ_SEARCH)
    if removed != dead.size or np.isin(ids, dead).any():
        raise AssertionError("sharded_ivfpq_1m: a removed id came back")
    with Phase("compact") as pc:
        old = idx.compact()
    if old.size != ctx.n - dead.size or len(idx) != old.size:
        raise AssertionError("sharded_ivfpq_1m: compact kept the wrong rows")
    ctx.report("sharded_ivfpq_1m remove 1% + compact", f"remove {pr.elapsed_s * 1e3:.1f} ms "
               f"(none returned), compact {pc.elapsed_s:.3f} s (a rebuild of {old.size} rows)")
    del idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 10,000 rows added to a build over the rest in one add (a shard's share
    # passes its refine store's spare rows, so the flush rebuilds: JAX's
    # rule), and 1,000 rows the same way, which take the append path
    n_ins = ctx.n // 100
    n0 = ctx.n - n_ins
    line = []
    for m in (n_ins, n_ins // 10):
        base = ShardedIVFPQ(cfg, mesh=mesh)
        base.build(x1[:n0])
        before = base.state[0]
        ctx.sync()
        t0 = time.perf_counter()
        base.add(x1[n0:n0 + m])
        base.flush()
        ctx.sync()
        dt = time.perf_counter() - t0
        path = "append" if base.state[0] is before else "overflow rebuild"
        hit = float((batched_ids(ctx, base, x1[n0:n0 + m], **IVFPQ_SEARCH)[:, 0]
                     == np.arange(n0, n0 + m)).mean())
        line.append(f"{m} rows: {dt:.3f} s ({m / dt:.1f} rows/s, {path}), self-hit@1 {hit}")
        if hit < 0.95 or len(base) != n0 + m:
            raise AssertionError(f"sharded_ivfpq_1m add of {m}: self-hit@1 {hit}, len "
                                 f"{len(base)}")
        del base
    ctx.report(f"sharded_ivfpq_1m add after a build over {n0}", "; ".join(line))


def phase_sharded_pq_persist(ctx: Ctx, x1):
    """35. ShardedPQFlat and ShardedIVFPQ at 100k: save/load round trips,
    card == CPU on the saved files, and the exhaustive-pool case (sharded ==
    single chip) on the card."""
    from zvdb_tpu_torch import IVFPQConfig, IVFPQIndex, ShardedIVFPQ, ShardedPQFlat, make_mesh
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    n_small = 5000 if ctx.rehearse else min(100_000, ctx.n)
    xs = x1[:n_small]
    qb = xs[:ctx.batch] + np.float32(0.01)
    qc = qb[:256]
    mesh = sharded_mesh(ctx)
    cpu_mesh = make_mesh(n_shards=N_SHARDS, devices=["cpu"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, make, kw in (
            ("ShardedPQFlat", lambda m: ShardedPQFlat(pq_config(ctx), mesh=m), APPROX),
            ("ShardedIVFPQ", lambda m: ShardedIVFPQ(IVFPQConfig(dim=ctx.dim), mesh=m),
             IVFPQ_SEARCH)):
        path = os.path.join(ROOT, "build", f"{name}_{n_small}.npz")
        try:
            with Phase("build") as pb:
                idx = make(mesh)
                idx.build(xs)
            before = idx.search(qb, K, **kw)[1]
            with Phase("save") as ps:
                idx.save(path)
            with Phase("load") as pl:
                back = type(idx).load(path, mesh=mesh)
            cpu = type(idx).load(path, mesh=cpu_mesh)
            size = os.path.getsize(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        if not torch.equal(before, back.search(qb, K, **kw)[1]):
            raise AssertionError(f"{name}: ids differ after the save/load round trip")
        card = tuple(a.cpu().numpy() for a in back.search(qc, K, **kw))
        with site_selection(binned_plain):   # the CPU selects as approx_min_k's kernel does
            host = tuple(a.numpy() for a in cpu.search(qc, K, **kw))
        bad = differing_ties(f"{name} card == CPU", card, host, atol=1e-3)
        if bad > card[1].size // 100:
            raise AssertionError(f"{name}: {bad} ids differ between the card and the CPU")
        ctx.report(f"{name} {n_small // 1000}k save/load", f"build {pb.elapsed_s:.2f} s, save "
                   f"{ps.elapsed_s:.2f} s, load {pl.elapsed_s:.2f} s, file {size / 1e6:.1f} "
                   f"MB; ids equal after load; card == CPU (the file on CPU devices, the plain "
                   f"kernels) on 256 queries: {bad} ids differ, each at a tie")
        del idx, back, cpu

    # tests/test_sharded_equivalence.py's exhaustive-pool case on the card:
    # exhaustive probes, one bin a row and an f32 refine pool covering the
    # corpus make the sharded index and the single chip exact over the rows
    rng = np.random.default_rng(42)
    cents = rng.standard_normal((24, 24)).astype(np.float32) * 4
    xe = (cents[rng.integers(0, 24, 2000)] + rng.standard_normal((2000, 24))).astype(np.float32)
    qe = (xe[rng.integers(0, 2000, 48)] + 0.05 * rng.standard_normal((48, 24))).astype(np.float32)
    cfg = IVFPQConfig(dim=24, n_sub=8, n_clusters=8, nprobe=8, refine="float32", rerank=256,
                      l_bins=1024, chunk=1024, train_sample=1024, kmeans_sample=1024)
    single = IVFPQIndex(cfg, device=dev)
    single.build(xe)
    sh = ShardedIVFPQ(cfg, mesh=mesh)
    sh.build(xe)

    def same(label, a, b):
        return differing_ties(label, tuple(t.cpu().numpy() for t in a),
                              tuple(t.cpu().numpy() for t in b), atol=1e-3)

    line = [same("exhaustive pool", sh.search(qe, K, nprobe=10 ** 6),
                 single.search(qe, K, nprobe=8))]
    dead = np.unique(np.argmin(((qe[:4, None, :] - xe[None]) ** 2).sum(-1), axis=1))
    if single.remove(dead) != sh.remove(dead):
        raise AssertionError("exhaustive pool: remove counts differ")
    line.append(same("exhaustive pool after remove", sh.search(qe, K, nprobe=10 ** 6),
                     single.search(qe, K, nprobe=8)))
    allowed = np.arange(0, 2000, 3)
    # the single chip's filtered scan is masked_exact_search, whose selection
    # is approx_min_k (as JAX's); the sharded masked scan selects exactly
    with site_selection(exact_selection):
        want = single.search(qe, K, nprobe=8, allowed=allowed)
    line.append(same("exhaustive pool filtered", sh.search(qe, K, nprobe=10 ** 6,
                                                           allowed=allowed), want))
    ctx.report("ShardedIVFPQ == IVFPQIndex on an exhaustive pool (2000 x 24d, 4 shards, on "
               "the device)", f"ids differing (ties only): plain {line[0]}, after remove "
               f"{line[1]}, filtered {line[2]}")


def ivf_shard_scans(ctx: Ctx, idx, q1, p: int):
    """What each shard's scan is at global nprobe p on the first batch: the
    pair or grouped scan (index/ivf.py:use_pair_scan on the shard's C_loc)
    and, for the grouped one, the probe pairs its q_cap drops."""
    from zvdb_tpu_torch.index import ivf as TI
    from zvdb_tpu_torch.ops import distance as D
    from zvdb_tpu_torch.ops import topk as T

    cfg = idx.cfg
    qp = D.preprocess_queries(torch.from_numpy(q1[:ctx.batch]).to(ctx.device), cfg.metric)
    b = qp.shape[0]
    c = idx.state[0].centroids.shape[0]
    p_loc = min(max(1, -(-p // N_SHARDS) + 1), c)
    out = []
    for st, cm in zip(idx.state, idx.c_mask):
        if TI.use_pair_scan(c, b, p_loc):
            out.append("pair")
            continue
        cs = D.pairwise_scores(qp, st.centroids, st.c_norms, cfg.metric, precision="highest")
        _, probes = T.smallest_k_dense(torch.where(cm[None, :], cs, float("inf")), p_loc)
        qslot, _ = TI._slot_pairs(probes, b, p_loc, c, TI.group_q_cap(b, p_loc, c, 4.0))
        dropped = b * p_loc - int((qslot >= 0).sum())
        out.append(f"grouped (q_cap {qslot.shape[1]}, {dropped} of {b * p_loc} pairs dropped, "
                   f"{100 * dropped / (b * p_loc):.2f}%)")
    return p_loc, out


def phase_sharded_ivf(ctx: Ctx, x1, q1, gt, ivf_recs: dict, ivf8_recs: dict):
    """36. sharded_ivf_1m and sharded_ivf_1m_int8: phases 27's and 28's
    IVFConfigs over 4 shards on the card (one single-chip build, then the
    clusters placed largest first on the least-loaded shard). No kernel."""
    from zvdb_tpu_torch import FlatConfig, FlatIndex, IVFIndex, ShardedIVF
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    cfg = ivf_config(ctx)
    mesh = sharded_mesh(ctx)
    ctx.report("sharded_ivf_1m config", f"{cfg}, {N_SHARDS} shards")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with Phase("sharded_ivf_1m build") as p:
        idx = ShardedIVF(cfg, mesh=mesh)
        idx.build(x1)
    with Phase("single-chip build") as ps:      # the same build in its two parts
        single = IVFIndex(cfg, device=dev)
        single.build(x1)
    with Phase("placement") as pp:
        ShardedIVF(cfg, mesh=mesh)._place(single.state, x1)
    del single
    st0 = idx.state[0]
    ctx.report("sharded_ivf_1m build", f"{p.elapsed_s:.3f} s ({ctx.n / p.elapsed_s:.1f} points/s "
               f"from host rows); again in parts: single-chip build {ps.elapsed_s:.3f} s, "
               f"placement {pp.elapsed_s:.3f} s; clusters {idx._cluster_of.shape[0]}, C_loc "
               f"{st0.centroids.shape[0]} (real a shard {[int(m.sum()) for m in idx.c_mask]}),"
               f" cap {st0.blocks.shape[1]}, rows a shard {[st.n for st in idx.state]}")
    if dev.type == "cuda":
        ctx.report("sharded_ivf_1m peak device memory GB (the builds, max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    recs = {}
    for p_ in IVF_NPROBES:
        ids = batched_ids(ctx, idx, q1, nprobe=p_)
        recs[p_] = recall_at_k(ids, gt, K)
        qps = search_qps(ctx, idx, q1, search_kwargs={"nprobe": p_})
        p_loc, scans = ivf_shard_scans(ctx, idx, q1, p_)
        ctx.report(f"sharded_ivf_1m nprobe={p_} ({p_loc} local probes a shard)",
                   f"recall@10 {recs[p_]} (ivf_1m {ivf_recs.get(p_)}), QPS (3 runs) "
                   f"{[round(v, 1) for v in qps]}; scans at B={ctx.batch}: {scans}")
        shard_times(ctx, idx, q1, f"sharded_ivf_1m nprobe={p_}", nprobe=p_)
    trace_split(ctx, f"sharded_ivf_1m one traced batch of {ctx.batch} (nprobe=8)",
                lambda: idx.search(q1[:ctx.batch], K, nprobe=8))
    launched = kernel_counts()
    if besides_approx(launched):
        raise AssertionError(f"the sharded IVF path launched kernels: {launched}")
    ctx.report("sharded_ivf_1m kernel launches (build and search, all nprobes)", "none of A-G")
    check_approx(ctx, "sharded_ivf_1m search (all nprobes)", launched["approx"],
                 sum(sharded_ivf_calls(ctx, idx, q1.shape[0], p_, 5) for p_ in IVF_NPROBES)
                 + sharded_ivf_calls(ctx, idx, ctx.batch, 8, 1))
    if recs[8] < 0.95 or recs[8] < ivf_recs[8] - 0.005:
        raise AssertionError(f"sharded_ivf_1m recall@10 {recs[8]} at nprobe 8 < max(0.95, "
                             f"{ivf_recs[8]} - 0.005)")

    # a 1% allowlist: the exact masked scan against the exact FlatIndex's
    # filtered search (up to ties), and the probe pool
    rng = np.random.default_rng(36)
    allow = np.sort(rng.choice(ctx.n, ctx.n // 100, replace=False))
    qf = q1[:ctx.batch]
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(x1)
    want = tuple(a.cpu().numpy() for a in oracle.search(qf, K, allowed=allow))
    del oracle
    line = []
    for mode in ("scan", "probe"):
        ctx.sync()
        t0 = time.perf_counter()
        got = tuple(a.cpu().numpy() for a in idx.search(qf, K, nprobe=8, allowed=allow,
                                                        filter_mode=mode))
        dt = time.perf_counter() - t0
        if not np.isin(got[1][got[1] >= 0], allow).all():
            raise AssertionError(f"sharded_ivf_1m {mode}: an id outside the allowlist")
        frec = recall_at_k(got[1], want[1], K)
        if mode == "scan":
            differ = differing_ties("sharded_ivf_1m filtered scan", got, want, atol=1e-3)
            line.append(f"scan {dt * 1e3:.1f} ms, recall {frec} against the exact filtered "
                        f"search, {differ} ids differ (ties)")
        else:
            line.append(f"probe {dt * 1e3:.1f} ms (the first converts the index to local ids "
                        f"and id maps), recall {frec}")
    ctx.report("sharded_ivf_1m filtered 1% (first batch, nprobe=8)", "; ".join(line))

    # remove 1% and compact, timed
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    with Phase("remove") as pr:
        removed = idx.remove(dead)
    ids = batched_ids(ctx, idx, q1, nprobe=8)
    if removed != dead.size or np.isin(ids, dead).any():
        raise AssertionError("sharded_ivf_1m: a removed id came back")
    with Phase("compact") as pc:
        old = idx.compact()
    if old.size != ctx.n - dead.size or len(idx) != old.size:
        raise AssertionError("sharded_ivf_1m: compact kept the wrong rows")
    ctx.report("sharded_ivf_1m remove 1% + compact", f"remove {pr.elapsed_s * 1e3:.1f} ms "
               f"(none returned), compact {pc.elapsed_s:.3f} s (a rebuild of {old.size} rows)")
    del idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 1,000 and 10,000 rows added to builds over 99% of the rows; the host
    # routing (numpy, JAX's expression) timed inside the add
    n0 = ctx.n - ctx.n // 100
    line = []
    for m in (ctx.n // 1000, ctx.n // 100):
        base = ShardedIVF(cfg, mesh=mesh)
        base.build(x1[:n0])
        before = base.state[0].blocks
        route_s = []

        def timed_route(rows, route=base._route):
            t0 = time.perf_counter()
            out = route(rows)
            route_s.append(time.perf_counter() - t0)
            return out

        base._route = timed_route
        ctx.sync()
        t0 = time.perf_counter()
        base.add(x1[n0:n0 + m])
        base.flush()
        ctx.sync()
        dt = time.perf_counter() - t0
        path = "append" if base.state[0].blocks is before else "overflow rebuild"
        hit = float((batched_ids(ctx, base, x1[n0:n0 + m], nprobe=8)[:, 0]
                     == np.arange(n0, n0 + m)).mean())
        line.append(f"{m} rows: {dt:.3f} s ({m / dt:.1f} rows/s, {path}; of it the host "
                    f"routing {sum(route_s):.3f} s), self-hit@1 {hit}")
        if hit < 0.95 or len(base) != n0 + m:
            raise AssertionError(f"sharded_ivf_1m add of {m}: self-hit@1 {hit}, len {len(base)}")
        del base
    ctx.report(f"sharded_ivf_1m add after a build over {n0}", "; ".join(line))

    # sharded_ivf_1m_int8: residual codes, the shadow stores, the rerank
    cfg8 = ivf8_config(ctx)
    ctx.report("sharded_ivf_1m_int8 config", f"{cfg8}, {N_SHARDS} shards")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with Phase("sharded_ivf_1m_int8 build") as p:
        idx = ShardedIVF(cfg8, mesh=mesh)
        idx.build(x1)
    built = kernel_counts()
    ids = batched_ids(ctx, idx, q1, nprobe=4)
    rec = recall_at_k(ids, gt, K)
    qps = search_qps(ctx, idx, q1, search_kwargs={"nprobe": 4})
    p_loc, scans = ivf_shard_scans(ctx, idx, q1, 4)
    st0 = idx.state[0]
    ctx.report("sharded_ivf_1m_int8 build + nprobe=4", f"build {p.elapsed_s:.3f} s "
               f"({ctx.n / p.elapsed_s:.1f} points/s), clusters {idx._cluster_of.shape[0]}, "
               f"C_loc {st0.centroids.shape[0]}, cap {st0.blocks.shape[1]}, shadow rows a shard "
               f"{st0.rerank_vecs.shape[0]}; recall@10 {rec} (ivf_1m_int8 {ivf8_recs.get(4)}), "
               f"{p_loc} local probes, QPS (3 runs) {[round(v, 1) for v in qps]}; scans {scans}")
    if dev.type == "cuda":
        ctx.report("sharded_ivf_1m_int8 peak device memory GB (build + search)",
                   torch.cuda.max_memory_allocated() / 1e9)
    shard_times(ctx, idx, q1, "sharded_ivf_1m_int8 nprobe=4", nprobe=4)
    check_approx(ctx, "sharded_ivf_1m_int8 build + search (5 passes, nprobe=4)",
                 kernel_counts()["approx"],
                 built["approx"] + sharded_ivf_calls(ctx, idx, q1.shape[0], 4, 5))
    ctx.sync()
    t0 = time.perf_counter()
    got = idx.search(qf, K, nprobe=4, allowed=allow, filter_mode="probe")[1].cpu().numpy()
    dt = time.perf_counter() - t0
    if not np.isin(got[got >= 0], allow).all():
        raise AssertionError("sharded_ivf_1m_int8 probe filter: an id outside the allowlist")
    ctx.report("sharded_ivf_1m_int8 filtered 1% in probe mode (int8 has no exact row form)",
               f"{dt * 1e3:.1f} ms, recall {recall_at_k(got, want[1], K)} against the exact "
               "filtered search")
    if besides_approx(kernel_counts()) or built["approx"]:
        raise AssertionError(f"the sharded int8 IVF path launched kernels: {kernel_counts()}")
    if rec < 0.95:
        raise AssertionError(f"sharded_ivf_1m_int8 recall@10 {rec} < 0.95 at nprobe 4")
    del idx


def phase_sharded_cagra(ctx: Ctx, x1, q1, gt, cagra_recall: float):
    """37. sharded_cagra_1m: phase 14's CagraConfig over 4 x 250,000 rows,
    the shards' graphs built together by build_knn_graph_multi (kernel D in
    every shard's cluster-kNN build), searched shard by shard (approx_min_k
    selecting each shard's seed anchors)."""
    import bench_cuda as BC
    from zvdb_tpu_torch import FlatConfig, FlatIndex, ShardedCagra
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    cfg = cagra_config(ctx)
    mesh = sharded_mesh(ctx)
    ctx.report("sharded_cagra_1m config", f"{cfg}, {N_SHARDS} shards")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    ctx.sync()
    t0 = time.perf_counter()
    idx = ShardedCagra(cfg, mesh=mesh)
    idx.build(x1)
    ctx.sync()
    build_s = time.perf_counter() - t0
    built = kernel_counts()
    expected = sum(-(-cb // st["cc"]) for st in idx.build_stats for cb in st["c_blocks"])
    ctx.report("sharded_cagra_1m build", f"{build_s:.3f} s, {ctx.n / build_s:.1f} points/s from "
               f"host rows (cagra_1m, phase 14, from device rows: "
               f"{getattr(ctx, 'cagra_pps', float('nan')):.1f}); shard_cap {idx.shard_cap}, "
               f"anchors a shard {idx.state[0].anchors.shape[0]}; per shard c / bcap / cc / "
               f"blocks per pass " + "; ".join(
                   f"{st['c']} / {st['bcap']} / {st['cc']} / {st['c_blocks']}"
                   for st in idx.build_stats))
    ctx.report("sharded_cagra_1m build kernel launches",
               f"block_bins {built['D']}, of them on the tensor cores {built['D_mma']} "
               f"(expected the shards' sum of ceil(c_blocks/cc) = {expected}); all: {built}")
    if dev.type == "cuda":
        ctx.report("sharded_cagra_1m build peak device memory GB (max_memory_allocated)",
                   torch.cuda.max_memory_allocated() / 1e9)
    others = sum(v for k, v in built.items() if k not in ("D", "D_mma"))
    if not ctx.rehearse and (built["D"] != expected or built["D_mma"] != expected or others):
        raise AssertionError(f"sharded_cagra_1m build launched {built}, expected D == D_mma == "
                             f"{expected} only")

    # kernel D on shard 0's own first chunk (its last pass), against its plain version
    bp = idx.build_stats[0]["first_chunk"]
    xs0 = torch.from_numpy(x1[:-(-ctx.n // N_SHARDS)]).to(dev)
    valid = bp >= 0
    safe = bp.clamp(min=0).long()
    v = xs0[safe]
    vn = torch.where(valid, (xs0 * xs0).sum(-1)[safe], float("inf"))
    for precision in ("high", "default", "highest"):
        compare_block_case(ctx, f"block shard-0 chunk {tuple(v.shape)} {precision}", v, vn, 128,
                           "l2", precision)
    del xs0, v, vn

    reset_kernel_counts()
    ids = batched_ids(ctx, idx, q1, **CAGRA_SEARCH)
    rec = recall_at_k(ids, gt, K)
    ctx.report("sharded_cagra_1m recall@10 (ef=12)", f"{rec} (cagra_1m, phase 14: "
               f"{cagra_recall})")
    ctx.report(f"sharded_cagra_1m search QPS (batches of {ctx.batch}, 3 runs)",
               search_qps(ctx, idx, q1, search_kwargs=CAGRA_SEARCH))
    shard_times(ctx, idx, q1, "sharded_cagra_1m", **CAGRA_SEARCH)
    trace_split(ctx, f"sharded_cagra_1m one traced batch of {ctx.batch}",
                lambda: idx.search(q1[:ctx.batch], K, **CAGRA_SEARCH))
    # approx_min_k selects each shard's seed anchors (over kernel A's bins in a
    # large batch): 5 passes over q1 and one batch
    sizes = BC.pass_sizes(q1.shape[0], ctx.batch) * 5 + [ctx.batch]
    seeds = [BC.cagra_seed_launches(types.SimpleNamespace(state=st, cfg=idx.cfg), sizes)
             for st in idx.state]
    check_seed_launches(ctx, "sharded_cagra_1m search", dict.fromkeys(kernel_counts(), 0),
                        kernel_counts(), {k: sum(s[k] for s in seeds) for k in seeds[0]})
    if rec < 0.95:
        raise AssertionError(f"sharded_cagra_1m recall@10 {rec} < 0.95")
    st = idx.state[0]
    compare_seed_bins(ctx, "sharded_cagra_1m shard 0", q1[:ctx.batch], st.anchors, st.a_norms,
                      idx.cfg.n_seeds, idx.cfg.metric)

    # remove 1%, then a 10% allowlist: "scan" against the exact FlatIndex
    # with the same tombstones (up to ties), "beam" by its recall
    rng = np.random.default_rng(37)
    dead = rng.choice(ctx.n, ctx.n // 100, replace=False)
    with Phase("remove") as pr:
        removed = idx.remove(dead)
    ids = batched_ids(ctx, idx, q1, **CAGRA_SEARCH)
    if removed != dead.size or np.isin(ids, dead).any():
        raise AssertionError("sharded_cagra_1m: a removed id came back")
    oracle = FlatIndex(FlatConfig(dim=ctx.dim, precision="highest", tile_n=262144),
                       capacity=ctx.n, device=dev)
    oracle.add(x1)
    oracle.remove(dead)
    qf = q1[:ctx.batch]
    allow = np.sort(rng.choice(ctx.n, ctx.n // 10, replace=False))
    want = tuple(a.cpu().numpy() for a in oracle.search(qf, K, allowed=allow))
    del oracle
    line = []
    for mode in ("scan", "beam"):
        ctx.sync()
        t0 = time.perf_counter()
        got = tuple(a.cpu().numpy() for a in idx.search(qf, K, allowed=allow, filter_mode=mode))
        dt = time.perf_counter() - t0
        if not np.isin(got[1][got[1] >= 0], allow).all() or np.isin(got[1], dead).any():
            raise AssertionError(f"sharded_cagra_1m {mode}: an id outside the allowlist or "
                                 "removed")
        frec = recall_at_k(got[1], want[1], K)
        if mode == "scan":
            # the scan's products are the config's bf16x3 ("high"): atol 1e-2
            differ = differing_ties("sharded_cagra_1m filtered scan", got, want, atol=1e-2)
            line.append(f"scan {dt * 1e3:.1f} ms, {differ} ids differ from the exact filtered "
                        f"search (ties), recall {frec}")
        else:
            line.append(f"beam {dt * 1e3:.1f} ms, recall {frec}")
    ctx.report("sharded_cagra_1m remove 1% + a 10% allowlist (first batch)",
               f"{dead.size} removed in {pr.elapsed_s * 1e3:.1f} ms, none returned; "
               + "; ".join(line))
    del idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the last 1% inserted in requests of 100 into a build over the rest
    n_ins, req = ctx.n // 100, 100
    n0 = ctx.n - n_ins
    base = ShardedCagra(cfg, mesh=mesh)
    base.build(x1[:n0])
    cap0, anchor_n0 = base.shard_cap, base._anchor_n
    a_rows0 = base.state[0].a_rows.clone()
    reset_kernel_counts()
    ctx.sync()
    t0 = time.perf_counter()
    for lo in range(n0, ctx.n, req):
        base.insert(x1[lo:lo + req])
    base.flush()
    ctx.sync()
    dt = time.perf_counter() - t0
    grew = base.shard_cap != cap0
    reseeded = base._anchor_n != anchor_n0 or not torch.equal(base.state[0].a_rows, a_rows0)
    hit = float((batched_ids(ctx, base, x1[n0:], **CAGRA_SEARCH)[:, 0]
                 == np.arange(n0, ctx.n)).mean())
    rec = recall_at_k(batched_ids(ctx, base, q1, **CAGRA_SEARCH), gt, K)
    ctx.report(f"sharded_cagra_1m insert of {n_ins} rows in requests of {req} after a build "
               f"over {n0}", f"{dt:.3f} s ({n_ins / dt:.1f} rows/s); shard_cap {cap0} -> "
               f"{base.shard_cap} ({'grown' if grew else 'no growth'}), anchors "
               f"{'reseeded' if reseeded else 'kept (under the reseed threshold)'}; self-hit@1 "
               f"{hit}, recall@10 after {rec}; kernels {kernel_counts()}")
    if hit < 0.95 or len(base) != ctx.n:
        raise AssertionError(f"sharded_cagra_1m insert: self-hit@1 {hit}, len {len(base)}")
    del base


def phase_sharded_ivf_cagra_persist(ctx: Ctx, x1):
    """38. ShardedIVF and ShardedCagra at 100k: save/load round trips, card
    == CPU on the saved files (the CPU's approx_min_k sites taking the
    kernel's plain version), ShardedIVF == IVFIndex on an exhaustive pool,
    and build_knn_graph_multi == build_knn_graph shard by shard, on the card."""
    from zvdb_tpu_torch import IVFConfig, IVFIndex, ShardedCagra, ShardedIVF, make_mesh
    from zvdb_tpu_torch.index import knn_graph as TK
    from zvdb_tpu_torch.parallel.sharded_cagra import shard_generators
    from zvdb_tpu_torch.utils.profiling import Phase

    dev = ctx.device
    n_small = 5000 if ctx.rehearse else min(100_000, ctx.n)
    xs = x1[:n_small]
    qb = xs[:ctx.batch] + np.float32(0.01)
    qc = qb[:256]
    mesh = sharded_mesh(ctx)
    cpu_mesh = make_mesh(n_shards=N_SHARDS, devices=["cpu"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, make, kw in (
            ("ShardedIVF", lambda m: ShardedIVF(ivf_config(ctx), mesh=m), {"nprobe": 8}),
            ("ShardedCagra", lambda m: ShardedCagra(cagra_config(ctx), mesh=m), CAGRA_SEARCH)):
        path = os.path.join(ROOT, "build", f"{name}_{n_small}.npz")
        try:
            with Phase("build") as pb:
                idx = make(mesh)
                idx.build(xs)
            before = idx.search(qb, K, **kw)[1]
            with Phase("save") as ps:
                idx.save(path)
            with Phase("load") as pl:
                back = type(idx).load(path, mesh=mesh)
            cpu = type(idx).load(path, mesh=cpu_mesh)
            size = os.path.getsize(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        if not torch.equal(before, back.search(qb, K, **kw)[1]):
            raise AssertionError(f"{name}: ids differ after the save/load round trip")
        card = tuple(a.cpu().numpy() for a in back.search(qc, K, **kw))
        with site_selection(binned_plain):   # the CPU selects as approx_min_k's kernel does
            host = tuple(a.numpy() for a in cpu.search(qc, K, **kw))
        bad = differing_ties(f"{name} card == CPU", card, host, atol=1e-3)
        if bad > card[1].size // 100:
            raise AssertionError(f"{name}: {bad} ids differ between the card and the CPU")
        ctx.report(f"{name} {n_small // 1000}k save/load", f"build {pb.elapsed_s:.2f} s, save "
                   f"{ps.elapsed_s:.2f} s, load {pl.elapsed_s:.2f} s, file {size / 1e6:.1f} "
                   f"MB; ids equal after load; card == CPU (the file on CPU devices) on 256 "
                   f"queries: {bad} ids differ, each at a tie")
        del idx, back, cpu

    # every cluster probed: the sharded index answers as the single chip
    rng = np.random.default_rng(42)
    cents = rng.standard_normal((24, 24)).astype(np.float32) * 4
    xe = (cents[rng.integers(0, 24, 2000)] + rng.standard_normal((2000, 24))).astype(np.float32)
    qe = (xe[rng.integers(0, 2000, 48)] + 0.05 * rng.standard_normal((48, 24))).astype(np.float32)
    cfg = IVFConfig(dim=24, n_clusters=16, nprobe=16)
    single = IVFIndex(cfg, device=dev)
    single.build(xe)
    sh = ShardedIVF(cfg, mesh=mesh)
    sh.build(xe)

    def same(label, a, b):
        return differing_ties(label, tuple(t.cpu().numpy() for t in a),
                              tuple(t.cpu().numpy() for t in b), atol=1e-3)

    line = [same("exhaustive pool", sh.search(qe, K, nprobe=10 ** 6),
                 single.search(qe, K, nprobe=10 ** 6))]
    dead = np.unique(np.argmin(((qe[:4, None, :] - xe[None]) ** 2).sum(-1), axis=1))
    if single.remove(dead) != sh.remove(dead):
        raise AssertionError("exhaustive pool: remove counts differ")
    line.append(same("exhaustive pool after remove", sh.search(qe, K, nprobe=10 ** 6),
                     single.search(qe, K, nprobe=10 ** 6)))
    allowed = np.arange(0, 2000, 3)
    for mode in ("scan", "probe"):
        # the single chip's "scan" selects by approx_min_k (masked_exact_search,
        # as JAX's); the sharded one exactly (parallel/scan_filter.py)
        with site_selection(exact_selection):
            want = single.search(qe, K, nprobe=10 ** 6, allowed=allowed, filter_mode=mode)
        line.append(same(f"exhaustive pool filtered ({mode})",
                         sh.search(qe, K, nprobe=10 ** 6, allowed=allowed, filter_mode=mode),
                         want))
    ctx.report("ShardedIVF == IVFIndex on an exhaustive pool (2000 x 24d, 4 shards, on the "
               "device)", f"ids differing (ties only): plain {line[0]}, after remove {line[1]}, "
               f"filtered scan {line[2]}, probe {line[3]}")

    # build_knn_graph_multi == build_knn_graph shard by shard, on the card
    cc = cagra_config(ctx)
    per = -(-n_small // N_SHARDS)
    parts = [xs[i * per:(i + 1) * per] for i in range(N_SHARDS)]
    kw = dict(metric=cc.metric, block=cc.block, spill=cc.spill, passes=cc.passes,
              kmeans_iters=cc.kmeans_iters, alpha=cc.alpha, reps=cc.seed_reps, n_long=cc.n_long,
              kc_per_view=cc.kc_per_view, prune_cap=cc.prune_cap, block_topk=cc.block_topk,
              kmeans_sample=cc.kmeans_sample)
    with Phase("multi") as pm:
        multi = TK.build_knn_graph_multi(parts, cc.degree,
                                         [shard_generators(cc.seed, si)[0]
                                          for si in range(N_SHARDS)],
                                         devices=[dev] * N_SHARDS, precision=cc.precision, **kw)
    with Phase("one by one") as po:
        one = [TK.build_knn_graph(part, cc.degree, shard_generators(cc.seed, si)[0], device=dev,
                                  precision=cc.precision, **kw)
               for si, part in enumerate(parts)]
    equal = [torch.equal(a[0], b[0]) for a, b in zip(multi, one)]
    ctx.report(f"build_knn_graph_multi vs build_knn_graph shard by shard ({N_SHARDS} x {per} "
               "rows, on the device)", f"nbrs equal {equal}; {pm.elapsed_s:.3f} s interleaved, "
               f"{po.elapsed_s:.3f} s one by one")
    if not all(equal):
        raise AssertionError("build_knn_graph_multi differs from the per-shard builds")


def selection_bar(n: int, recall_target: float, nq: int) -> float:
    """approx_min_k's expected selection recall@10 over one [B, n] tile,
    L/k * (1 - (1 - 1/L)^k) (zvdb_tpu/ops/pallas_topk.py), less 4 standard
    errors of a mean over nq queries (a query loses about Poisson(k(1 - r))
    of its k)."""
    from zvdb_tpu_torch.ops.approx_topk import reduction_output_size

    L = reduction_output_size(n, 2, K, recall_target)
    r = L / K * (1 - (1 - 1 / L) ** K)
    return r - 4 * ((1 - r) / (K * nq)) ** 0.5


def phase_bench_cuda(ctx: Ctx):
    import contextlib
    import io

    import bench_cuda as BC

    n, nq, n1 = (2_048, 128, 4_096) if ctx.rehearse else (20_000, 2_000, 60_000)
    reset_kernel_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = BC.run(ctx.device, n, nq, n1, K)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    print(f"  bench_cuda: {len(lines)} result lines, the last: {lines[-1] if lines else None}")
    counts = kernel_counts()
    ctx.report(f"bench_cuda rows at n={n}, n1={n1}, nq={nq}: exit code, seconds, "
               "kernel launches", f"{rc}, {seconds:.1f}, {counts}")
    if rc != 0:
        raise AssertionError(f"bench_cuda.run exited {rc}")
    engines = json.loads(lines[-1])["engines"]
    for name, keys in BC.ROW_KEYS.items():
        if name not in engines or tuple(engines[name]) != keys:
            raise AssertionError(f"bench_cuda row {name}: {engines.get(name)} lacks {keys}")
    # the flat row selects each tile's k by approx_min_k at recall_target 0.97:
    # its bar is the bins' expected selection recall less 4 standard errors
    # (flat_1m's rerank absorbs its losses; flat_1m_pallas runs kernel A)
    bars = dict(flat=min(0.99, selection_bar(n, 0.97, nq)), flat_1m=0.99, flat_1m_pallas=0.99)
    for name, bar in bars.items():
        if engines[name]["recall"] < bar:
            raise AssertionError(f"bench_cuda {name} recall@10 {engines[name]['recall']} < "
                                 f"{bar}")
    calls = 0 if ctx.rehearse else BC.search_calls(nq, 2048, 6)
    want = {name: 0 for name in counts}
    # each row checked its own approx_min_k count (bench_cuda.check_launches);
    # kernel A also folds the CAGRA rows' seed bins
    bins = BC.cagra_rows_seed_bins(engines, n, nq, n1, 128, "l2", ctx.device)  # sift1m's
    want.update(A=calls + bins, A_mma=calls + bins, B=calls, B_mma=calls, C_pairs=calls,
                approx=counts["approx"])
    if counts != want or not (ctx.rehearse or counts["approx"]):
        raise AssertionError(f"bench_cuda kernel launches {counts}, expected {want}")


# ---------------------------------------------------------------------------
# approx_min_k: the binned partial top-k of the JAX package's seven
# lax.approx_min_k sites (ops/approx_topk.py, csrc/approx_topk.cu)

# (shape, k, recall_target) on rows of ties, +-0.0 and +inf
# (tests/test_torch_approx_topk.py's grid): ragged last windows, N <= 128,
# k = L = N, rank 3, one and few long rows whose windows split over blocks
APPROX_GRID = [((6, 1000), 10, 0.95), ((5, 1027), 7, 0.9), ((3, 5, 700), 16, 0.95),
               ((7, 300), 300, 0.95), ((2, 4096), 1, 0.95), ((6, 1000), 128, 0.5),
               ((4, 100), 100, 0.95), ((16, 1 << 20), 10, 0.95), ((1, 3_000_000), 100, 0.99),
               ((300, 2456), 40, 0.95), ((4, 250_000), 256, 0.95), ((64, 2_048), 40, 0.95)]
# (rows of _approx_rows, shape, k, recall_target), also the CPU tests' cases
# for the kernel's algorithm: L from reduction_output_size; 2048 rows and
# more take one split; the k-th key's value shared past k, so the column
# decides (in the lanes' bound or the column digits); +-0.0 only; k = 1;
# k = L; k > 256
APPROX_TIE_GRID = [
    ("column ties", (2048, 300), 10, 0.95),      # L = N = 300, the lanes' bound
    ("column ties", (3, 1000), 100, 0.5),        # L = 256, the split route, column digits
    ("column ties", (2048, 1300), 300, 0.5),     # L = 768, 64 threads a row
    ("zeros", (2048, 260), 40, 0.95),            # L = N = 260, column digits
    ("zeros", (2, 2000), 7, 0.95),               # L = 256, the split route
    ("ties", (2048, 1500), 1, 0.95),             # L = 128
    ("ties", (2048, 300), 300, 0.95),            # k = L = N
    ("ties", (3, 512), 512, 0.95),               # k = L = N, one window
    ("normal", (2048, 5000), 300, 0.5),          # L = 640
    ("normal", (2048, 2000), 10, 0.5),           # L = 256, the lanes' bound
]
# the sites' operands at the main paths' sizes: (label, shape, k, recall_target)
APPROX_SITES_AT_SIZE = [
    ("flat row tile", (10_000, 100_000), 10, 0.97),
    ("flat_1m first-pass tile", (2048, 500_000), 40, 0.97),
    ("sharded_flat_1m shard", (2048, 250_000), 10, 0.95),
    ("cagra_1m seed anchors, [B, A] route", (2048, 250_000), 16, 0.95),
    ("cagra_1m seed bins", (2048, 512), 16, 1.0),
    ("IVF probes at C = 4096", (2048, 4096), 8, 0.95),
    ("ivf_1m pair-scan cut (B*P x cap)", (4096, 2456), 10, 0.95),
    ("knn_graph block chunk (cagra_1m build)", (12, 1640, 1640), 16, 0.95),
    ("PQ decode-scan tile (rerank 12)", (2048, 16_384), 120, 0.95),
]


# the kernel's times at the site operands before its redesign, from
# PERF.md's row H (its first run; its final call)
OLD_H_MS = {"flat row tile": "1.6046-1.6065; 1.6043-1.6047",
            "flat_1m first-pass tile": "1.750; 1.7475", "sharded_flat_1m shard": "0.7745; 0.7672",
            "cagra_1m seed anchors, [B, A] route": "0.8041; 0.8012",
            "cagra_1m seed bins": "not measured (no such operand then)",
            "IVF probes at C = 4096": "0.0697; 0.0548",
            "ivf_1m pair-scan cut (B*P x cap)": "0.1116; 0.1104",
            "knn_graph block chunk (cagra_1m build)": "0.4677; 0.4648",
            "PQ decode-scan tile (rerank 12)": "0.5988; 0.595"}


def _approx_tie_rows(shape, seed):
    rng = np.random.default_rng(seed)
    s = (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)
    flat = s.reshape(-1, shape[-1])
    z = rng.random(flat.shape) < 0.2
    flat[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    flat[rng.random(flat.shape) < 0.1] = np.inf
    if flat.shape[0] > 2:
        flat[1] = np.inf
    return s


def _approx_rows(kind, shape, seed):
    """APPROX_TIE_GRID's rows: "column ties" mostly 1.0 (the rest 2.0 or
    +inf), "zeros" only -0.0 and +0.0, "ties" _approx_tie_rows, "normal"
    standard normal."""
    rng = np.random.default_rng(seed)
    if kind == "column ties":
        return rng.choice(np.float32([1.0, 1.0, 1.0, 2.0, np.inf]), size=shape).astype(np.float32)
    if kind == "zeros":
        return np.where(rng.random(shape) < 0.5, np.float32(-0.0), np.float32(0.0))
    if kind == "ties":
        return _approx_tie_rows(shape, seed)
    return rng.standard_normal(shape).astype(np.float32)


def approx_case(ctx: Ctx, label: str, s, k: int, r: float, run=None) -> float:
    """The kernel through its wrapper (on a CPU rehearsal: the CPU branch),
    or `run()` (an `approx_entry_call`), against its plain version on s:
    positions equal and values equal bit for bit on the card. Returns the
    largest |value difference| (0.0 when equal)."""
    from zvdb_tpu_torch.ops import approx_topk as AK

    L = AK.reduction_output_size(s.shape[-1], s.dim(), k, r)
    v, p = run() if run else AK.approx_min_k(s, k, recall_target=r)
    pv, pp = AK._approx_min_k_plain(s, k, L)
    ctx.sync()
    fin = torch.isfinite(pv)
    err = float((v - pv).abs()[fin].max()) if bool(fin.any()) else 0.0
    equal = torch.equal(p, pp) and torch.equal(v.view(torch.int32), pv.view(torch.int32))
    rows = s.numel() // s.shape[-1]
    splits = AK.fold_splits(rows, -(-s.shape[-1] // L))[0]
    print(f"  approx {label} {tuple(s.shape)} k={k} r={r}: L={L}, splits {splits} "
          f"({'one launch' if splits == 1 else 'split route'}), "
          f"{'equal bit for bit' if equal else 'DIFFER'}", flush=True)
    if not ctx.rehearse and not equal:
        raise AssertionError(f"approx_min_k {label}: the kernel differs from its plain version")
    return err


def approx_entry_call(s, k: int, r: float, fn=None):
    """A call of the kernel's C entry point `fn` (the package's build by
    default) on s, its outputs (and a split route's scratch) made
    beforehand; returns (values, positions) shaped as the wrapper's."""
    from zvdb_tpu_torch.ops import approx_topk as AK

    n = s.shape[-1]
    rows = s.numel() // n
    L = AK.reduction_output_size(n, s.dim(), k, r)
    splits, per = AK.fold_splits(rows, -(-n // L))
    vals = s.new_empty((*s.shape[:-1], k))
    pos = s.new_empty((*s.shape[:-1], k), dtype=torch.int64)
    part = s.new_empty((rows, splits, L), dtype=torch.int64) if splits > 1 else None
    fn = fn or AK.build()
    args = (s.data_ptr(), None if part is None else part.data_ptr(), vals.data_ptr(),
            pos.data_ptr(), rows, n, L, k, splits, per, torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args) != 0:
            raise RuntimeError("approx_min_k entry point failed")
        return vals, pos

    return call


def approx_entry_ms(ctx: Ctx, s, k: int, r: float, reps: int = 20, fn=None):
    """ms a call of the kernel's C entry point alone (CUDA events around
    `reps` ctypes calls, `approx_entry_call`): the device's pace where the
    wrapper's host work would set it. None when rehearsing."""
    if ctx.rehearse:
        return None
    return ctx.time_ms(approx_entry_call(s, k, r, fn), reps=reps, warmup=2)


def approx_times(ctx: Ctx, label: str, s, k: int, r: float, reps: int = 20) -> dict:
    """ms a call of the kernel through its wrapper and through its entry
    point alone, its plain version, torch.topk(largest=False) and
    ops/topk.py:smallest_k_dense (the sites' exact selection) on s, the
    bound (s read once and the k (value, position) pairs written, at the
    card's memory rate) and each time's share of it; the route and the
    launches a call; a profile of 5 calls (kernels a call, device ms),
    which must hold no kernel but approx_fused_kernel, at most one a call
    (the profiler may drop some of these ctypes launches, never add one)."""
    from zvdb_tpu_torch.ops import approx_topk as AK
    from zvdb_tpu_torch.ops import topk as T

    L = AK.reduction_output_size(s.shape[-1], s.dim(), k, r)
    rows = s.numel() // s.shape[-1]
    splits = AK.fold_splits(rows, -(-s.shape[-1] // L))[0]
    few = max(1, reps // 10)
    before = AK.approx_min_k.launches
    AK.approx_min_k(s, k, recall_target=r)
    launches = AK.approx_min_k.launches - before
    out = dict(
        ms=ctx.time_ms(lambda: AK.approx_min_k(s, k, recall_target=r), reps=reps, warmup=2),
        entry_ms=approx_entry_ms(ctx, s, k, r, reps=reps),
        plain_ms=ctx.time_ms(lambda: AK._approx_min_k_plain(s, k, L), reps=few),
        library_ms=ctx.time_ms(lambda: torch.topk(s, k, dim=-1, largest=False), reps=few),
        smallest_k_dense_ms=ctx.time_ms(lambda: T.smallest_k_dense(s, k), reps=few),
        bound_ms=(s.numel() * 4 + rows * k * 12) / HBM_BYTES_S * 1e3, bound_by="bytes")
    ctx.report(f"approx {label} {tuple(s.shape)} k={k} L={L} ms (kernel through the wrapper, "
               "its entry point alone, plain, torch.topk, smallest_k_dense; byte bound)",
               {key: (round(v, 4) if isinstance(v, float) else v) for key, v in out.items()})
    shares = {key: f"{out['bound_ms'] / out[key]:.1%}" for key in ("ms", "entry_ms")
              if out[key]}
    ctx.report(f"approx {label} route, launches a call, share of the byte bound (wrapper, "
               "entry point alone)", f"{'one launch' if splits == 1 else 'split route'} "
               f"(splits {splits}), {launches}, {shares or 'not measured (rehearsal)'}")
    if not ctx.rehearse and launches != 1:
        raise AssertionError(f"approx {label}: {launches} launches counted for one call")
    if not ctx.rehearse:
        by_name = profile_calls(ctx, f"approx {label} profile (5 calls through the wrapper)",
                                [lambda: AK.approx_min_k(s, k, recall_target=r)] * 5, "call")
        names = {name: c for name, (_, c) in (by_name or {}).items()}
        if any("approx_fused_kernel" not in name for name in names) \
                or sum(names.values()) > 5:
            raise AssertionError(f"approx {label}: 5 calls ran the kernels {names}, not one "
                                 "approx_fused_kernel a call")
    return out


def phase_approx(ctx: Ctx, x1, q1, gt):
    """40. approx_min_k: the kernel against its plain version over the
    test grid and at every site's operand size, timed beside torch.topk and
    smallest_k_dense; the flat row (bench.py's headline `flat`, 100k x 128d,
    10,000 queries in one batch) as the main path, its launches counted and
    its recall read; the flat_1m row against exact selection; then each of
    the seven sites launches the kernel where JAX's guard holds and not
    where it fails. Returns (the main path's record, the site times)."""
    import bench_cuda as BC
    from zvdb_tpu_torch import (CagraConfig, CagraIndex, FlatConfig, FlatIndex, IVFConfig,
                                IVFIndex, PQConfig, PQFlatIndex, ShardedFlat, ShardedPQFlat)
    from zvdb_tpu_torch.bench.harness import recall_at_k
    from zvdb_tpu_torch.ops import distance as D

    dev = ctx.device
    t_phase = time.perf_counter()
    for i, (shape, k, r) in enumerate(APPROX_GRID):
        if ctx.rehearse and math.prod(shape) > 2_000_000:
            continue
        approx_case(ctx, "grid", torch.from_numpy(_approx_tie_rows(shape, i)).to(dev), k, r)
    for kind, shape, k, r in APPROX_TIE_GRID:
        approx_case(ctx, f"grid {kind}", torch.from_numpy(_approx_rows(kind, shape, k)).to(dev),
                    k, r)
    gen = torch.Generator(device=dev).manual_seed(40)
    site_ms = {}
    for label, shape, k, r in APPROX_SITES_AT_SIZE:
        if ctx.rehearse:
            shape = shape[:-2] + (min(shape[-2], 64), shape[-1])
        s = torch.randn(shape, generator=gen, device=dev)
        s.view(-1, shape[-1])[:, ::97] = float("inf")
        approx_case(ctx, label, s, k, r)
        site_ms[label] = approx_times(ctx, label, s, k, r, reps=3 if ctx.rehearse else 20)
        del s
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for label, t in site_ms.items():
        ctx.report(f"approx {label} ms through the wrapper / entry point alone / byte bound / "
                   "torch.topk; the kernel before its redesign (PERF.md row H)",
                   f"{t['ms']:.4f} / " + ("not measured" if t["entry_ms"] is None else
                                          f"{t['entry_ms']:.4f}")
                   + f" / {t['bound_ms']:.4f} / {t['library_ms']:.4f}; {OLD_H_MS[label]}")

    # the main path: bench.py's flat row at full width
    n = min(100_000, ctx.n)
    xs = torch.from_numpy(x1[:n]).to(dev)
    cfg = FlatConfig(dim=ctx.dim, precision="high", recall_target=0.97, tile_n=131072)
    flat = FlatIndex(cfg, capacity=n, device=dev)
    flat.add(xs)
    oracle = FlatIndex(dataclasses.replace(cfg, precision="highest"), capacity=n, device=dev)
    oracle.add(xs)
    qd = torch.from_numpy(q1).to(dev)
    truth = oracle.search(qd, K)[1].cpu().numpy()
    flat.search(qd, K, approx=True)           # warm
    ctx.sync()
    reset_kernel_counts()
    t0 = time.perf_counter()
    ids = flat.search(qd, K, approx=True)[1]
    ctx.sync()
    wall = time.perf_counter() - t0
    launches = kernel_counts()["approx"]
    rec = recall_at_k(ids.cpu().numpy(), truth, K)
    check_approx(ctx, f"flat row main path (one batch of {q1.shape[0]})", launches,
                 BC.flat_tiles(n, cfg.tile_n))
    if besides_approx(kernel_counts()):
        raise AssertionError(f"the flat row launched other kernels: {kernel_counts()}")
    bar = selection_bar(n, 0.97, q1.shape[0])
    ctx.report("flat row (100k x 128d, recall_target 0.97, precision high) recall@10 against "
               "the exact f32 search / one batch's wall ms",
               f"{rec} (bar {bar:.4f}: the bins' expected selection recall less 4 standard "
               f"errors) / {wall * 1e3:.3f}")
    if rec < bar:
        raise AssertionError(f"flat row recall@10 {rec} < {bar}")
    ctx.report("flat row search QPS, approx=True (the kernel) and approx=False (exact "
               "selection), in turns", {
                   label: round(q1.shape[0] / (ctx.time_ms(
                       lambda a=a: flat.search(qd, K, approx=a), reps=3) / 1e3), 1)
                   for label, a in (("exact", False), ("kernel", True), ("kernel ", True),
                                    ("exact ", False))})
    profile_calls(ctx, f"flat row search profile (3 batches of {q1.shape[0]}, approx=True)",
                  [lambda: flat.search(qd, K, approx=True)] * 3, "batch")
    # the kernel on the main path's own tile
    qs = D.preprocess_queries(qd, cfg.metric)
    s = D.pairwise_scores(qs, flat.state.vectors, flat.state.norms, cfg.metric,
                          precision=cfg.precision, x_scales=flat.state.scales)
    err = approx_case(ctx, "flat row main-path tile", s, min(K, n), 0.97)
    main = approx_times(ctx, "flat row main-path tile", s, min(K, n), 0.97,
                        reps=3 if ctx.rehearse else 20)
    main.update(launches=launches, max_abs_err=err)
    del s, qs, oracle, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # bench.py's flat_1m row (two 500k tiles a batch, rerank 4): the kernel
    # against the exact selection it replaced, in turns
    f1 = FlatIndex(FlatConfig(dim=ctx.dim, rerank=4, recall_target=0.97, tile_n=500_000),
                   capacity=ctx.n, device=dev)
    f1.add(x1)
    reset_kernel_counts()
    rec1 = recall_at_k(batched_ids(ctx, f1, q1, **APPROX), gt, K)
    check_approx(ctx, "flat_1m row (all batches)", kernel_counts()["approx"],
                 -(-q1.shape[0] // ctx.batch) * BC.flat_tiles(ctx.n, 500_000))
    with site_selection(exact_selection):
        rec0 = recall_at_k(batched_ids(ctx, f1, q1, **APPROX), gt, K)
    qps = {}
    for label in ("exact", "kernel", "kernel ", "exact "):
        with site_selection(exact_selection) if label.startswith("exact") else \
                contextlib.nullcontext():
            qps[label] = [round(v, 1) for v in search_qps(ctx, f1, q1)]
    ctx.report(f"flat_1m row recall@10 (kernel / exact selection) and search QPS (batches of "
               f"{ctx.batch}, 3 runs each, in turns)", f"{rec1} / {rec0}; {qps}")
    profile_search(ctx, f1, q1, label="flat_1m row (approx=True)")
    del f1
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # each site: launched where JAX's guard holds, not where it fails
    qb = q1[:ctx.batch]

    def launched(call, others=None):
        """approx_min_k's launches in `call`, which may launch no other kernel
        than the counts `others` names."""
        reset_kernel_counts()
        call()
        ctx.sync()
        if besides_approx(kernel_counts()) != (others or {}):
            raise AssertionError(f"approx site check launched other kernels: {kernel_counts()}"
                                 f", expected {others or {}}")
        return kernel_counts()["approx"]

    # 1. the flat tiled scan: tiles of 32768 (the last padded), the two-pass path
    f4 = FlatIndex(FlatConfig(dim=ctx.dim, tile_n=32768), capacity=n, device=dev)
    f4.add(xs)
    check_approx(ctx, "site 1 flat approx=True, tiles of 32768", launched(
        lambda: f4.search(qb, K, approx=True)), BC.flat_tiles(n, 32768))
    check_approx(ctx, "site 1 flat approx=False", launched(
        lambda: f4.search(qb, K, approx=False)), 0)
    f2 = FlatIndex(FlatConfig(dim=ctx.dim, rerank=4, recall_target=0.97, tile_n=n // 2),
                   capacity=n, device=dev)
    f2.add(xs)
    check_approx(ctx, "site 1 flat two-pass (rerank 4)", launched(
        lambda: f2.search(qb, K, approx=True)), BC.flat_tiles(n, n // 2))
    del f4, f2
    # 2. ShardedFlat
    sf = ShardedFlat(FlatConfig(dim=ctx.dim), mesh=sharded_mesh(ctx))
    sf.build(x1[:n])
    check_approx(ctx, "site 2 ShardedFlat approx=True", launched(
        lambda: sf.search(qb, K)), N_SHARDS)
    check_approx(ctx, "site 2 ShardedFlat approx=False", launched(
        lambda: sf.search(qb, K, approx=False)), 0)
    del sf
    # 3. the PQ decode scan (scan="xla"), single chip and sharded
    pcfg = PQConfig(dim=ctx.dim, scan="xla")
    pq = PQFlatIndex(pcfg, device=dev)
    pq.build(xs)
    check_approx(ctx, "site 3 PQFlatIndex scan=xla approx=True", launched(
        lambda: pq.search(qb, K)), BC.flat_tiles(pq.state.norms.shape[0], pcfg.tile_n))
    check_approx(ctx, "site 3 PQFlatIndex approx=False", launched(
        lambda: pq.search(qb, K, approx=False)), 0)
    del pq
    spq = ShardedPQFlat(pcfg, mesh=sharded_mesh(ctx))
    spq.build(x1[:n])
    check_approx(ctx, "site 3 ShardedPQFlat scan=xla approx=True", launched(
        lambda: spq.search(qb, K)),
        sum(BC.flat_tiles(st["norms"].shape[0], pcfg.tile_n) for st in spq.state))
    del spq
    # 4 and 5. IVF probes (C >= 4096 and 4P <= C) and the pair scan's cut (cap >= 4 kk)
    for icfg, p_, b in ((IVFConfig(dim=ctx.dim, n_clusters=4096), 8, ctx.batch),
                        (IVFConfig(dim=ctx.dim, n_clusters=4096, dtype="int8", rerank=4), 8,
                         ctx.batch),
                        (IVFConfig(dim=ctx.dim, n_clusters=1024), 8, 256),
                        (IVFConfig(dim=ctx.dim, n_clusters=1024), 64, ctx.batch)):
        iv = IVFIndex(icfg, device=dev)
        iv.build(xs)
        c, cap = iv.state.blocks.shape[:2]
        for p, bb in ((p_, b), (c // 4 + 1, 256)):
            want = BC.ivf_search_launches(iv, bb, p, K, icfg.rerank)
            check_approx(ctx, f"sites 4+5 IVF C={c} cap={cap} {icfg.dtype} rerank "
                         f"{icfg.rerank} nprobe={p} B={bb}", launched(
                             lambda: iv.search(q1[:bb], K, nprobe=p)), want)
        del iv
    # 6 and 7. the graph build's block cut (block_topk="approx") and CAGRA's seeds
    ccfg = CagraConfig(dim=ctx.dim, degree=32, block_topk="approx")
    cg = CagraIndex(ccfg, device=dev)
    built = launched(lambda: cg.build(xs))
    check_approx(ctx, f"site 6 CAGRA build block_topk=approx ({cg.build_stats['c_blocks']} "
                 f"blocks, cc {cg.build_stats['cc']})", built, BC.graph_build_launches(cg))
    if not ctx.rehearse and not built:
        raise AssertionError("site 6: the CAGRA build launched approx_min_k no time")
    seeds = BC.cagra_seed_launches(cg, [qb.shape[0]])
    others = besides_approx(seeds)
    check_approx(ctx, f"site 7 CAGRA seeds ({cg.state.anchors.shape[0]} anchors, kernel A "
                 f"{others})", launched(lambda: cg.search(qb, K), others), seeds["approx"])
    if not ctx.rehearse and not others:
        raise AssertionError(f"site 7: a batch of {qb.shape[0]} took no kernel A bins")
    cg.cfg = dataclasses.replace(ccfg, precision="highest")
    check_approx(ctx, "site 7 CAGRA seeds at \"highest\" (no bins)", launched(
        lambda: cg.search(qb, K)), 1)
    cg.cfg = dataclasses.replace(ccfg, seed_approx=False)
    check_approx(ctx, "site 7 CAGRA seeds, seed_approx=False", launched(
        lambda: cg.search(qb, K)), 0)
    del cg
    ex = CagraIndex(dataclasses.replace(ccfg, block_topk="exact", n_anchors=64), device=dev)
    check_approx(ctx, "site 6 CAGRA build block_topk=exact", launched(lambda: ex.build(xs)), 0)
    check_approx(ctx, "site 7 CAGRA seeds, 64 anchors = 4 * n_seeds", launched(
        lambda: ex.search(qb, K)), 0)
    del ex, xs, qd
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.report("approx phase seconds", round(time.perf_counter() - t_phase, 1))
    return main, site_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; prints no result")
    args = ap.parse_args()
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import zvdb_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    ctx = Ctx(args.rehearse)
    # a rehearsal's approx_min_k sites select as the card's kernel does
    with site_selection(binned_plain) if ctx.rehearse else contextlib.nullcontext():
        return run(ctx)


def run(ctx: Ctx) -> int:
    from zvdb_tpu_torch.bench.harness import recall_at_k

    t_start = time.perf_counter()
    phase_device(ctx)
    phase_build(ctx)
    phase_compare(ctx)
    phase_compare_pq(ctx)
    phase_compare_ivfpq(ctx)
    phase_compare_block(ctx)
    x1, q1 = make_workload(ctx)
    flp, ids, launches, gt = phase_main(ctx, x1, q1)
    phase_server(ctx, flp, q1, ids)
    t = phase_times(ctx, flp, q1)
    del flp
    pq_idx, pq_ids, pq_launches, lut, pq_errs = phase_pq_main(ctx, x1, q1, gt)
    phase_server(ctx, pq_idx, q1, pq_ids, label="pq_1m ")
    tp = phase_pq_times(ctx, pq_idx, q1, lut)
    del pq_idx, lut
    iv_idx, iv_ids, iv_launches, lut_c, slots_c, iv_errs = phase_ivfpq_main(ctx, x1, q1, gt)
    phase_server(ctx, iv_idx, q1, iv_ids, label="ivfpq_1m ", search_kwargs=IVFPQ_SEARCH)
    tc = phase_ivfpq_times(ctx, iv_idx, q1, lut_c, slots_c)
    del iv_idx, lut_c, slots_c
    cg_idx, cg_ids, cg_launches, chunk, cg_errs = phase_cagra_main(ctx, x1, q1, gt)
    phase_server(ctx, cg_idx, q1, cg_ids, label="cagra_1m ", search_kwargs=CAGRA_SEARCH,
                 max_differ=0.01)
    td = phase_cagra_times(ctx, cg_idx, q1, chunk)
    del cg_idx, chunk
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_compare_scan(ctx)
    te = phase_scan_main(ctx, x1, q1, gt)
    tg = phase_hop(ctx, x1, q1)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    hn_idx, hn_ids, hn_ef = phase_hnsw_main(ctx, x1, q1, gt)
    phase_server(ctx, hn_idx, q1, hn_ids, label="hnsw_1m ", search_kwargs={"ef_search": hn_ef},
                 max_differ=0.01)
    phase_hnsw_times(ctx, hn_idx, x1, q1, gt, hn_ef)
    del hn_idx
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_hnsw_insert(ctx, x1, q1, gt, hn_ef, hn_ids)
    phase_hnsw_batched(ctx, x1, q1, gt)
    phase_hnsw_checkpoint(ctx, x1)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_ivf_carry(ctx, x1)
    _, ivf_recs = phase_ivf_main(ctx, x1, q1, gt)
    ivf8_recs = phase_ivf_int8(ctx, x1, q1, gt)
    phase_ivf_checkpoint_sweep(ctx, x1)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    oracle, dead = phase_sharded_flat(ctx, x1, q1, gt)
    sh_ef = phase_sharded_hnsw(ctx, x1, q1, gt, oracle, dead)
    del oracle
    phase_sharded_persist_sweep(ctx, x1, sh_ef)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_sharded_pq(ctx, x1, q1, gt, recall_at_k(pq_ids, gt, K))
    phase_sharded_ivfpq(ctx, x1, q1, gt, recall_at_k(iv_ids, gt, K))
    phase_sharded_pq_persist(ctx, x1)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_sharded_ivf(ctx, x1, q1, gt, ivf_recs, ivf8_recs)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_sharded_cagra(ctx, x1, q1, gt, recall_at_k(cg_ids, gt, K))
    phase_sharded_ivf_cagra_persist(ctx, x1)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    phase_bench_cuda(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ta, _ = phase_approx(ctx, x1, q1, gt)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    hop = tg["experiment"]
    record = {"kernels": [{
        "name": "flat_scan_bins",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/flat_scan_mma.cu",
        "replaces": "zvdb_tpu/ops/pallas_topk.py:113",
        "launches": launches,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }, {
        "name": "pq_scan_bins",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/pq_scan_mma.cu",
        "replaces": "zvdb_tpu/ops/pallas_pq.py:203",
        "launches": pq_launches,
        "max_abs_err": pq_errs["int8"],
        "ms": tp["ms"],
        "plain_ms": tp["plain_ms"],
        "bound_ms": tp["bound_ms"],
        "bound_by": tp["bound_by"],
        "library_ms": tp["library_ms"],
    }, {
        "name": "pq_grouped_scan_pairs",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/pq_scan.cu",
        "replaces": "zvdb_tpu/ops/pallas_pq.py:336",
        "launches": iv_launches,
        "max_abs_err": iv_errs["int8"],
        "ms": tc["ms"],
        "plain_ms": tc["plain_ms"],
        "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"],
        "library_ms": tc["library_ms"],
    }, {
        "name": "block_bins",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/block_bins.cu",
        "replaces": "zvdb_tpu/ops/pallas_block.py:90",
        "launches": cg_launches,
        "max_abs_err": cg_errs["high"],
        "ms": td["ms"],
        "plain_ms": td["plain_ms"],
        "bound_ms": td["bound_ms"],
        "bound_by": td["bound_by"],
        "library_ms": td["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": te[name]["launches"],
        "max_abs_err": te[name]["max_abs_err"],
        "ms": te[name]["ms"],
        "plain_ms": te[name]["plain_ms"],
        "bound_ms": te[name]["bound_ms"],
        "bound_by": te[name]["bound_by"],
        "library_ms": te[name]["library_ms"],
    } for name, source, replaces in (
        ("flat_topk_pallas", "zvdb_tpu_torch/csrc/scan_topk_mma.cu",
         "examples/pallas_scan_v1.py:95"),
        ("flat_topk_pallas2", "zvdb_tpu_torch/csrc/scan_topk_mma.cu",
         "examples/pallas_scan_v2.py:85"))] + [{
        "name": "fused_hop_scores",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/hop_scores.cu",
        "replaces": "examples/exp_r3_hopkernel.py:93",
        "launches": hop["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in tg.values()),
        "ms": hop["ms"],
        "plain_ms": hop["plain_ms"],
        "bound_ms": hop["bound_ms"],
        "bound_by": hop["bound_by"],
        "library_ms": hop["library_ms"],
    }, {
        "name": "approx_min_k",
        "route": "cuda",
        "source": "zvdb_tpu_torch/csrc/approx_topk.cu",
        "replaces": "zvdb_tpu/index/flat.py:119",
        "launches": ta["launches"],
        "max_abs_err": ta["max_abs_err"],
        "ms": ta["ms"],
        "plain_ms": ta["plain_ms"],
        "bound_ms": ta["bound_ms"],
        "bound_by": ta["bound_by"],
        "library_ms": ta["library_ms"],
    }]}
    if ctx.rehearse:
        print(json.dumps(record))
        print("rehearsal finished: no result line (run on a GPU for one)")
        return 0
    print(json.dumps(record))
    print(ctx.card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ctx.kind,
                                             "count": ctx.count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
