"""CAGRA-style single-layer graph engine (port of zvdb_tpu/index/cagra.py).

  * The graph is one fixed-degree diversity-pruned kNN graph, built from
    dense products by the cluster-kNN build (index/knn_graph.py; with
    block_topk="pallas" its block scoring runs the block scorer kernel).
  * Anchor seeding: a random sample of corpus rows is kept as a dense [A, D]
    anchor table; one [B, A] product ranks all anchors per query and the
    beam (index/hnsw.py:beam_layer_fn) starts at the best `n_seeds` anchor
    rows, inside the answer's neighborhood.
  * For l2 + f32 storage the beam scores rows from a packed [N, D+1] table
    (vector | squared norm), one row gather per candidate.

Differences from the JAX package: random draws (the graph's, the anchor
rows) come from a torch.Generator seeded from cfg.seed, so one seed builds a
different index in each package; `CagraIndex.from_numpy` and `load` carry a
JAX-built index across. The seed anchors (seed_approx) and the build's
block_topk="approx" select through ops/approx_topk.py:approx_min_k under
JAX's guards, as JAX does through lax.approx_min_k: the binned kernel on the
card, the exact top-k on the CPU, as JAX's approx_min_k there.
Every product names its precision (cfg.precision) instead of relying on an
ambient one. `CagraState.n` is a host int. Entry points take `device=None`,
which means "cuda"; without a CUDA device they raise unless the caller asks
for "cpu".
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Optional

import numpy as np
import torch

from ..ops import approx_topk as AK
from ..ops import distance as D
from ..ops import topk as T
from ..utils.filter_policy import resolve_filter_mode
from ..utils.masks import allowed_mask
from ..utils.profiling import entry, span, wait
from .build import _reverse_pass, select_neighbors
from .flat import masked_exact_search, resolve_device, tensor_from_numpy
from .hnsw import _bdot, _f32, beam_layer_fn
from .knn_graph import VecStore, build_knn_graph

_INF = float("inf")

# minimum host-corpus size for the segmented upload path when
# CagraConfig.upload_segments > 1 (tests shrink it)
_OVERLAP_MIN_N = 1 << 16

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class CagraConfig:
    """The JAX package's CagraConfig: the same fields, defaults and
    validation, so save files load both ways."""

    dim: int
    degree: int = 32              # fixed out-degree of the graph
    metric: str = "l2"
    dtype: str = "float32"        # float32 | bfloat16 | int8 (per-tensor codes)
    # --- construction (see knn_graph.build_knn_graph) ---
    block: int = 1024             # target cluster/block size
    spill: int = 2                # clusters each point joins per pass
    passes: int = 2               # independent clustering passes
    kmeans_iters: int = 3
    kmeans_sample: int = 65536    # Lloyd runs on this many sampled rows
    alpha: float = 1.2            # diversity-pruning relaxation
    precision: str = "high"
    seed_reps: int = 4            # representative rows kept per cluster
    n_long: int = 4               # random long-range edges per row
    # candidates kept per view (0 -> degree), merged-pool cap entering the
    # diversity prune (0 -> no cap), and the per-block top-k: "exact",
    # "approx" (approx_min_k: the binned kernel on the card), "binfold", or
    # "pallas" (the block scorer kernel)
    kc_per_view: int = 16
    prune_cap: int = 64
    block_topk: str = "approx"
    # anchors for seed routing: 0 -> auto (~n/12, pow2-clamped to [1024, 32768])
    n_anchors: int = 0
    # --- search defaults ---
    ef_search: int = 32
    n_seeds: int = 16             # anchors seeding each query's beam
    expand: int = 4               # beam entries expanded per hop
    # expand only the first search_degree neighbors of a row (rows are
    # diversity-ordered by construction); None = the full row
    search_degree: Optional[int] = 24
    # hop budget; None = ef/expand + 8 (hnsw.beam_layer_fn)
    max_iters: Optional[int] = None
    # select the seed anchors with approx_min_k when anchors > 4 * n_seeds
    seed_approx: bool = True
    # --- incremental insert ---
    build_batch: int = 2048
    ef_construction: int = 64
    seed: int = 0
    # >1: split a host corpus into this many uploads; pass-0 clustering and
    # assignment start on the first while the rest transfer. 0 = off.
    upload_segments: int = 0
    # fat-row hop expansion: each node's whole neighborhood (deg x (vector |
    # norm | id)) as ONE row of a [cap+1, deg*(D+2)] f32 table, so a hop
    # gathers `expand` rows instead of `expand*degree`
    fat_rows: str = "off"         # "auto" | "on" | "off"
    fat_budget_bytes: int = 6 << 30

    def __post_init__(self):
        if self.metric not in ("l2", "dot", "cosine"):
            raise ValueError(f"bad metric {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")

    @property
    def storage_dtype(self) -> torch.dtype:
        return _STORAGE[self.dtype]

    @property
    def packed(self) -> bool:
        """One-gather packed (vector | norm) search layout: l2 + f32 only
        (bf16 would round the norm column; int8 codes cannot carry it)."""
        return self.metric == "l2" and self.dtype == "float32"


@dataclasses.dataclass
class CagraState:
    vectors: torch.Tensor    # [cap, D] storage dtype (int8: codes)
    norms: torch.Tensor      # [cap] f32 (true squared norms for l2; zeros else)
    nbrs: torch.Tensor       # [cap+1, degree] int32, -1 padded (row cap = trash)
    dists: torch.Tensor      # [cap+1, degree] f32 edge distances (for extends)
    anchors: torch.Tensor    # [A, D] f32 dense copies of the anchor rows
    a_norms: torch.Tensor    # [A] f32
    a_rows: torch.Tensor     # [A] int32 row id of each anchor
    n: int                   # rows used; a host int (a device scalar in JAX)
    q_scale: float           # int8 dequant scale as an f32 value (1.0 otherwise)


_FIELDS = tuple(f.name for f in dataclasses.fields(CagraState))


@dataclasses.dataclass
class _SearchArrays:
    """What the search reads. `table` is the packed [cap, D+1] layout when
    cfg.packed, the fat pack when fat rows are on, else the raw vectors.
    `dead` is the [cap] bool tombstone (and allowlist) mask, or None:
    blocked nodes stay in the graph as waypoints and leave only the final
    beam."""
    table: torch.Tensor
    norms: torch.Tensor
    nbrs: torch.Tensor
    anchors: torch.Tensor
    a_norms: torch.Tensor
    a_rows: torch.Tensor
    n: int
    q_scale: float
    dead: Optional[torch.Tensor] = None


def _pick_anchor_rows(gen: torch.Generator, n: int, n_anchors: int, device) -> torch.Tensor:
    """Random anchor rows without replacement: auto-size ~n/12,
    pow2-clamped to [1024, 32768]; all rows when that is n or more."""
    if n_anchors <= 0:
        n_anchors = 1 << max(10, min(15, int(math.ceil(math.log2(max(n, 2) / 12.0)))))
    a = min(n_anchors, max(n, 1))
    if a >= n:
        return torch.arange(n, dtype=torch.int32, device=device)
    rows = torch.randperm(n, generator=gen)[:a].to(torch.int32)
    with wait("anchor_rows"):   # a pageable upload
        return rows.to(device)


def _reseed_anchors(state: CagraState, n: int, gen: torch.Generator,
                    n_anchors: int) -> CagraState:
    """Resample the anchor table over the rows [0, n). An index grown well
    past its build size would otherwise seed every beam from the original
    rows only; callers refresh when n doubles past the last snapshot."""
    a_rows = _pick_anchor_rows(gen, n, n_anchors, state.vectors.device)
    rows = a_rows.long()
    state.anchors = state.vectors[rows].float() * state.q_scale
    state.a_norms = state.norms[rows]   # zeros already for dot/cosine
    state.a_rows = a_rows
    return state


def _build_fat_pack(vectors, norms, nbrs, q_scale: float) -> torch.Tensor:
    """[cap+1, deg*(D+2)] f32: per node, its neighbors' (vector | norm | id)
    rows side by side. Ids ride as f32 (exact below 2^24); a missing neighbor
    carries id -1 and norm +inf."""
    safe = nbrs.clamp(min=0).long()
    vx = (vectors[safe.reshape(-1)].float() * q_scale).reshape(nbrs.shape[0], nbrs.shape[1], -1)
    nx = torch.where(nbrs >= 0, norms[safe], _INF)
    pack = torch.cat([vx, nx[..., None], nbrs.float()[..., None]], dim=-1)
    return pack.reshape(nbrs.shape[0], -1)


def _make_fat_expander(arrs: _SearchArrays, qp: torch.Tensor, metric: str, deg: int,
                       precision: Optional[str]):
    """sel_r [B, E] -> (cand_ids [B, E*deg], scores [B, E*deg]) from one
    gather per selected row (arrs.table is the fat pack)."""
    dp2 = arrs.table.shape[-1] // deg
    d = dp2 - 2
    factor = 2.0 if metric == "l2" else 1.0

    def expand_fn(sel_r):
        b, e = sel_r.shape
        fat = arrs.table[sel_r.clamp(min=0).long()].reshape(b, e * deg, dp2)
        vx, nx = fat[..., :d], fat[..., d]
        ids = fat[..., d + 1].to(torch.int32)
        ids = torch.where((sel_r >= 0).repeat_interleave(deg, dim=1), ids, -1)
        s = torch.where(ids >= 0, nx - factor * _bdot(qp, vx, precision), _INF)
        return torch.where(torch.isfinite(s), ids, -1), s

    return expand_fn


def _make_scorer(arrs: _SearchArrays, qp: torch.Tensor, metric: str, packed: bool,
                 precision: Optional[str]):
    """rows [B, C] -> surrogate scores [B, C] (+inf for rows < 0)."""
    if packed:
        # score = ||x||^2 - 2 q.x = -2 * ([q, -0.5] . [x, ||x||^2]): the norm
        # rides in the product, at the same precision
        qe = torch.cat([qp, qp.new_full((qp.shape[0], 1), -0.5)], dim=1)

        def score_rows(rows):
            vx = arrs.table[rows.clamp(min=0).long()]            # ONE gather
            return torch.where(rows >= 0, -2.0 * _bdot(qe, vx, precision), _INF)

        return score_rows

    def score_rows(rows):
        safe = rows.clamp(min=0).long()
        dots = _bdot(qp, arrs.table[safe].float(), precision) * arrs.q_scale
        s = arrs.norms[safe] - 2.0 * dots if metric == "l2" else -dots
        return torch.where(rows >= 0, s, _INF)

    return score_rows


def cagra_search_impl(
    arrs: _SearchArrays,
    q: torch.Tensor,
    k: int,
    metric: str,
    ef: int,
    n_seeds: int,
    expand: int,
    max_iters: Optional[int],
    precision: str,
    packed: bool,
    fat: bool = False,
    dedupe: bool = True,
    seed_approx: bool = True,
    search_degree: Optional[int] = None,
):
    """Returns (user_scores [B, k], ids [B, k]); ids are row ids (insertion
    order: the graph never reorders rows). With seed_approx and more than
    4 * n_seeds anchors, the seeds are selected by approx_min_k, as in JAX;
    else they are the exact n_seeds best anchors. Spans (utils.profiling):
    "cagra.seeds", beam_layer_fn's "beam.init" and "beam.hop", "cagra.final"."""
    qp = D.preprocess_queries(q, metric)
    efk = max(ef, k)
    with span("cagra.seeds"):
        # seeds: one [B, A] product over the dense anchor table; the anchor
        # scores ARE the seed scores (anchors hold the stored vectors exactly)
        cs = D.pairwise_scores(qp, arrs.anchors, arrs.a_norms, metric, precision=precision)
        s_count = min(n_seeds, arrs.anchors.shape[0])
        if seed_approx and arrs.anchors.shape[0] > 4 * s_count:
            seed_s, top = AK.approx_min_k(cs, s_count)
        else:
            seed_s, top = T.smallest_k_dense(cs, s_count)
        del cs
        seeds = arrs.a_rows[top]
    if fat:
        expander = _make_fat_expander(arrs, qp, metric, arrs.nbrs.shape[-1], precision)
        beam_s, beam_r = beam_layer_fn(None, seeds, seed_s, arrs.nbrs, efk, expand=expand,
                                       max_iters=max_iters, expand_fn=expander,
                                       dedupe_candidates=dedupe)
    else:
        scorer = _make_scorer(arrs, qp, metric, packed, precision)
        beam_s, beam_r = beam_layer_fn(scorer, seeds, seed_s, arrs.nbrs, efk, expand=expand,
                                       max_iters=max_iters, dedupe_candidates=dedupe,
                                       use_degree=search_degree)
    with span("cagra.final"):
        beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
        if arrs.dead is not None:
            # tombstoned / filtered rows routed the beam but never enter results
            hit = arrs.dead[beam_r.clamp(min=0).long()] & (beam_r >= 0)
            beam_s = torch.where(hit, _INF, beam_s)
            beam_r = torch.where(hit, -1, beam_r)
        top_s, top_r = T.smallest_k(beam_s, beam_r, k)
        valid = top_r >= 0
        user = D.finalize_scores(top_s, qp, metric)
        user = torch.where(valid, user, _INF if metric == "l2" else -_INF)
        ids = torch.where(valid & (arrs.n > 0), top_r, -1)
    return user, ids


# ---------------------------------------------------------------------------
# incremental extend


def _extend_batch_impl(state: CagraState, xb: torch.Tensor, valid: torch.Tensor,
                       cfg: CagraConfig) -> CagraState:
    """Append a batch at rows [n, n+B), IN PLACE (the caller made room):
    beam-search the frozen prefix for candidates, add the batch's own
    nearest rows, diversity-prune to degree, connect and reverse-merge.
    `valid` [B] bool marks the real rows of a padded batch."""
    prec = cfg.precision
    b = xb.shape[0]
    base = state.n
    dev = state.vectors.device
    rows = base + torch.arange(b, dtype=torch.int32, device=dev)
    if cfg.dtype == "int8":
        stored, norms = D.quantize_corpus_global(xb, cfg.metric, state.q_scale)
    else:
        stored, norms = D.preprocess_corpus(xb, cfg.metric, cfg.storage_dtype)
    state.vectors[base:base + b] = stored
    state.norms[base:base + b] = norms

    q = stored.float() * state.q_scale
    qn = D.sq_norms(q)
    store = VecStore(state.vectors, state.norms, state.q_scale)

    def score_rows(r):
        safe = r.clamp(min=0).long()
        dots = _bdot(q, state.vectors[safe].float(), prec) * state.q_scale
        s = state.norms[safe] - 2.0 * dots if cfg.metric == "l2" else -dots
        return torch.where(r >= 0, s, _INF)

    # seeds from the anchors, clamped to the frozen prefix
    cs = D.pairwise_scores(q, state.anchors, state.a_norms, cfg.metric, precision=prec)
    _, top = T.smallest_k_dense(cs, min(cfg.n_seeds, state.anchors.shape[0]))
    seeds = state.a_rows[top]
    seeds = torch.where(seeds < base, seeds, -1)
    g_s, g_r = beam_layer_fn(score_rows, seeds, score_rows(seeds), state.nbrs,
                             cfg.ef_construction, expand=cfg.expand, limit_n=base)
    # intra-batch candidates (batchmates are invisible to the beam)
    intra = D.pairwise_scores(q, q, torch.where(valid, qn, _INF), cfg.metric, precision=prec)
    eye = torch.eye(b, dtype=torch.bool, device=dev)
    intra = torch.where(eye | ~valid[None, :], _INF, intra)
    i_s, i_c = T.smallest_k_dense(intra, min(b, cfg.ef_construction))
    i_rows = torch.where(torch.isfinite(i_s), base + i_c.to(torch.int32), -1)
    i_s = torch.where(i_rows >= 0, i_s, _INF)
    c_s, c_r = T.mask_duplicate_ids(torch.cat([g_s, i_s], dim=-1),
                                    torch.cat([g_r, i_rows], dim=-1))
    fwd, fwd_d = select_neighbors(store, q, qn, c_r, c_s, cfg.degree, cfg.alpha, cfg.metric,
                                  precision=prec)
    fwd = torch.where(valid[:, None], fwd, -1)
    fwd_d = torch.where(fwd >= 0, fwd_d, _INF)
    state.nbrs[base:base + b] = fwd
    state.dists[base:base + b] = fwd_d
    _reverse_pass(state.nbrs, state.dists, rows, fwd, fwd_d, cfg.degree)
    state.n = base + int(valid.sum())
    return state


def state_from_numpy(cfg: CagraConfig, arrays, device) -> CagraState:
    """The JAX package's CagraState arrays, as numpy (a save file's
    contents), -> the port's state on `device`. bf16 vectors may arrive as
    ml_dtypes.bfloat16 or as the f32 a save file holds."""
    t = {f: tensor_from_numpy(arrays[f], device) for f in _FIELDS if f not in ("n", "q_scale")}
    t["vectors"] = t["vectors"].to(cfg.storage_dtype)
    for f in ("norms", "dists", "anchors", "a_norms"):
        t[f] = t[f].float()
    for f in ("nbrs", "a_rows"):
        t[f] = t[f].to(torch.int32)
    return CagraState(n=int(np.asarray(arrays["n"])), q_scale=_f32(np.asarray(arrays["q_scale"])),
                      **t)


# ---------------------------------------------------------------------------
# public class


class CagraIndex:
    """Single-layer graph index: build/insert/search/remove/compact/get/save/load."""

    def __init__(self, cfg: CagraConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Optional[CagraState] = None
        self.capacity = 0
        # the graph's, the anchors' and the refreshes' draws advance this
        # generator build after build, as the JAX package splits its key
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._anchor_n = 0            # n at the last anchor snapshot
        self._packed_table: Optional[torch.Tensor] = None   # derived, not saved
        self._fat_pack: Optional[torch.Tensor] = None       # derived, not saved
        self._dead: set[int] = set()                        # tombstoned ids
        self._dead_dev: Optional[torch.Tensor] = None       # [cap] bool mirror
        self.build_stats: dict = {}   # the last bulk build's geometry (knn_graph)

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else self.state.n
            return n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _reset_derived(self) -> None:
        self._packed_table = None
        self._fat_pack = None

    # -- build ----------------------------------------------------------------

    def build(self, x) -> None:
        """Bulk-build from corpus [N, D], replacing the contents. x is numpy
        (one upload) or a tensor on the index's device (no copy); with
        ZVDB_BUILD_TRACE=1 the graph build prints its stages' times."""
        cfg = self.cfg
        on_device = isinstance(x, torch.Tensor)
        if on_device:
            x = x.to(device=self.device, dtype=torch.float32)
        else:
            x = np.asarray(x, np.float32)
        n = x.shape[0]
        with self._lock, entry("cagra.build"):
            self._pending = []
            self._n_inserted = n
            self._dead = set()
            self._dead_dev = None
            self._reset_derived()
            self.build_stats.clear()
            if n == 0:
                self.state = None
                self.capacity = 0
                return
            if x.shape[-1] != cfg.dim:
                raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {x.shape[-1]}")
            if cfg.metric == "cosine":
                if on_device:
                    x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
                else:
                    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            kw = dict(metric=cfg.metric, block=cfg.block, spill=cfg.spill, passes=cfg.passes,
                      kmeans_iters=cfg.kmeans_iters, alpha=cfg.alpha, precision=cfg.precision,
                      reps=cfg.seed_reps, n_long=cfg.n_long, kc_per_view=cfg.kc_per_view,
                      prune_cap=cfg.prune_cap, block_topk=cfg.block_topk,
                      kmeans_sample=cfg.kmeans_sample, stats=self.build_stats)
            if not on_device and cfg.upload_segments > 1 and n >= _OVERLAP_MIN_N:
                per = -(-n // cfg.upload_segments)
                segs = [torch.from_numpy(np.ascontiguousarray(x[i * per:(i + 1) * per]))
                        .to(self.device) for i in range(cfg.upload_segments) if i * per < n]
                nbrs, dists, _c, _cn, _r = build_knn_graph(None, cfg.degree, self._gen,
                                                           segments=segs, **kw)
                xj = torch.cat(segs)
            else:
                xj = x if on_device else torch.from_numpy(x).to(self.device)
                nbrs, dists, _c, _cn, _r = build_knn_graph(xj, cfg.degree, self._gen, **kw)
            with span("cagra.anchors"):
                q_scale = 1.0
                if cfg.dtype == "int8":
                    with wait("int8_scale"):
                        amax = float(xj.abs().max())
                    q_scale = _f32(max(amax, 1e-12) / 127.0)
                    stored, norms = D.quantize_corpus_global(xj, cfg.metric, q_scale)
                else:
                    stored, norms = D.preprocess_corpus(xj, cfg.metric, cfg.storage_dtype)
                    if stored is xj:   # f32 l2/dot rows would alias the caller's
                        stored = stored.clone()
                a_rows = _pick_anchor_rows(self._gen, n, cfg.n_anchors, self.device)
                # anchors hold the DEQUANTIZED stored vectors, so seed scores are
                # what the beam scorer computes for those rows
                anchors = stored[a_rows.long()].float() * q_scale
                a_norms = norms[a_rows.long()] if cfg.metric == "l2" else \
                    torch.zeros(a_rows.shape[0], dtype=torch.float32, device=self.device)
            self.capacity = n
            self.state = CagraState(vectors=stored, norms=norms, nbrs=nbrs, dists=dists,
                                    anchors=anchors, a_norms=a_norms, a_rows=a_rows, n=n,
                                    q_scale=q_scale)
            self._anchor_n = n

    # -- delete ---------------------------------------------------------------

    def remove(self, ids) -> int:
        """Delete by external id (mark-and-filter): ids never renumber and
        freed slots are not reused. Tombstoned nodes stay in the graph as
        waypoints and leave only the final beam; compact() reclaims them.
        Returns the number newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else self.state.n
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            new = [int(i) for i in ids if int(i) not in self._dead]
            if not new:
                return 0
            cap = self.state.vectors.shape[0]
            if self._dead_dev is None or self._dead_dev.shape[0] < cap:
                base = torch.zeros(cap, dtype=torch.bool, device=self.device)
                if self._dead_dev is not None:
                    base[: self._dead_dev.shape[0]] = self._dead_dev
                self._dead_dev = base
            self._dead_dev[torch.as_tensor(new, dtype=torch.long, device=self.device)] = True
            self._dead.update(new)
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without the tombstoned rows; survivors renumber to [0, L)
        in their former order. Returns the survivors' old ids."""
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else self.state.n
            alive = np.ones(n, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or live.size == n:
                return live
            vecs = self.state.vectors[torch.as_tensor(live, device=self.device)].float()
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
        self.build(vecs)   # resets tombstones; takes the lock itself
        return live

    # -- incremental insert ---------------------------------------------------

    def insert(self, x) -> None:
        """Insert one vector [D] or a batch [B, D] (buffered; flushed on the
        next search or when build_batch rows are pending)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.array(x, dtype=np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")
        with self._lock:
            self._pending.append(x)
            self._n_inserted += x.shape[0]
            if sum(p.shape[0] for p in self._pending) >= self.cfg.build_batch:
                self._flush_locked()

    add = insert

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        cfg = self.cfg
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None or self.state.n == 0:
            n_before = self._n_inserted
            self.build(new)
            self._n_inserted = n_before
            return
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        bsz = min(cfg.build_batch, max(new.shape[0], 1))
        nb = -(-new.shape[0] // bsz)
        need = self.state.n + nb * bsz
        if need > self.capacity:
            self._grow(max(need, 2 * self.capacity))
        st = self.state
        for t in range(nb):
            lo, hi = t * bsz, min((t + 1) * bsz, new.shape[0])
            xb = torch.zeros((bsz, cfg.dim), dtype=torch.float32, device=self.device)
            xb[: hi - lo] = torch.from_numpy(new[lo:hi]).to(self.device)
            vb = torch.zeros(bsz, dtype=torch.bool, device=self.device)
            vb[: hi - lo] = True
            st = _extend_batch_impl(st, xb, vb, cfg)
        if st.n >= 2 * max(self._anchor_n, 1):
            st = _reseed_anchors(st, st.n, self._gen, cfg.n_anchors)
            self._anchor_n = st.n
        self.state = st
        self._reset_derived()

    def _grow(self, new_cap: int) -> None:
        st = self.state
        cap = self.capacity
        dev = self.device
        vectors = torch.zeros((new_cap, self.cfg.dim), dtype=self.cfg.storage_dtype, device=dev)
        vectors[:cap] = st.vectors
        norms = torch.zeros(new_cap, dtype=torch.float32, device=dev)
        norms[:cap] = st.norms
        nbrs = torch.full((new_cap + 1, self.cfg.degree), -1, dtype=torch.int32, device=dev)
        nbrs[:cap] = st.nbrs[:-1]
        dists = torch.full((new_cap + 1, self.cfg.degree), _INF, dtype=torch.float32, device=dev)
        dists[:cap] = st.dists[:-1]
        self.state = dataclasses.replace(st, vectors=vectors, norms=norms, nbrs=nbrs, dists=dists)
        self.capacity = new_cap

    # -- search ---------------------------------------------------------------

    def _fat_enabled(self) -> bool:
        cfg = self.cfg
        if cfg.fat_rows == "off" or self.state is None:
            return False
        cap = self.state.nbrs.shape[0]
        if cap - 1 >= (1 << 24):     # f32-exact id range
            return False
        if cfg.fat_rows == "on":
            return True
        bytes_needed = cap * cfg.degree * (cfg.dim + 2) * 4
        return cfg.dtype == "float32" and bytes_needed <= cfg.fat_budget_bytes

    def _search_arrays(self) -> _SearchArrays:
        st = self.state
        if self._fat_enabled():
            if self._fat_pack is None:
                self._fat_pack = _build_fat_pack(st.vectors, st.norms, st.nbrs, st.q_scale)
            table = self._fat_pack
        elif self.cfg.packed:
            if self._packed_table is None:
                self._packed_table = torch.cat([st.vectors, st.norms[:, None]], dim=1)
            table = self._packed_table
        else:
            table = st.vectors
        dead = None
        if self._dead:
            dead = self._dead_dev
            cap = st.vectors.shape[0]
            if dead.shape[0] < cap:   # capacity grew since the last remove
                grown = torch.zeros(cap, dtype=torch.bool, device=self.device)
                grown[: dead.shape[0]] = dead
                dead = self._dead_dev = grown
        return _SearchArrays(table=table, norms=st.norms, nbrs=st.nbrs, anchors=st.anchors,
                             a_norms=st.a_norms, a_rows=st.a_rows, n=st.n,
                             q_scale=st.q_scale, dead=dead)

    def search(self, q, k: int, ef_search: Optional[int] = None,
               search_degree: Optional[int] = None, max_iters: Optional[int] = None,
               allowed=None, filter_mode: str = "auto"):
        """kNN search. q [D] or [B, D] -> (scores, ids) [B, k] ([k] squeezed),
        tensors on the index's device; invalid slots id -1. ef_search /
        search_degree / max_iters override the config for this call.
        allowed: optional allowlist (bool mask over ids, or an int id array);
        filter_mode "scan" runs the exact masked scan over the stored rows,
        "beam" the graph beam with blocked nodes routing but filtered from
        the final beam, "auto" picks (utils/filter_policy.py)."""
        if filter_mode not in ("auto", "scan", "beam"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock, entry("cagra.search"):
            self._flush_locked()
            filter_mode = resolve_filter_mode(filter_mode, allowed, self._n_inserted, alt="beam")
            q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
            squeeze = q.dim() == 1
            if squeeze:
                q = q[None, :]
            cfg = self.cfg
            if q.shape[-1] != cfg.dim:
                raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {q.shape[-1]}")
            st = self.state
            if st is None or st.n == 0:
                s = torch.full((q.shape[0], k), _INF if cfg.metric == "l2" else -_INF,
                               device=self.device)
                i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=self.device)
            elif allowed is not None and filter_mode == "scan":
                cap = st.vectors.shape[0]
                block = ~allowed_mask(allowed, st.n, cap, self.device)
                arrs = self._search_arrays()
                if arrs.dead is not None:
                    block = block | arrs.dead
                bias = torch.where(block, _INF, 0.0)
                s, i = masked_exact_search(
                    st.vectors, st.norms + bias,
                    torch.full((cap,), st.q_scale, dtype=torch.float32, device=self.device),
                    q, k, cfg.metric,
                    precision="high" if cfg.precision == "default" else cfg.precision)
            else:
                arrs = self._search_arrays()
                if allowed is not None:
                    block = ~allowed_mask(allowed, st.n, st.vectors.shape[0], self.device)
                    arrs.dead = block if arrs.dead is None else (arrs.dead | block)
                s, i = cagra_search_impl(
                    arrs, q, k, cfg.metric,
                    ef_search if ef_search is not None else cfg.ef_search,
                    cfg.n_seeds, cfg.expand,
                    max_iters if max_iters is not None else cfg.max_iters,
                    cfg.precision, cfg.packed, self._fat_enabled(), True, cfg.seed_approx,
                    search_degree if search_degree is not None else cfg.search_degree)
            if squeeze:
                return s[0], i[0]
            return s, i

    # -- reads ----------------------------------------------------------------

    def get(self, ids) -> np.ndarray:
        """Stored vectors for ids -> [K, D] f32 numpy (dequantized for int8,
        normalized for cosine)."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            n = 0 if self.state is None else self.state.n
            if ids.size == 0:
                return np.zeros((0, self.cfg.dim), np.float32)
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            vecs = self.state.vectors[torch.as_tensor(ids, device=self.device)].float()
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
            return vecs.cpu().numpy()

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format (bf16 vectors as f32)."""
        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg), capacity=self.capacity,
                        n_inserted=self._n_inserted)
            arrays = {}
            if self.state is not None:
                for f in _FIELDS:
                    v = getattr(self.state, f)
                    if f == "n":
                        arrays[f] = np.asarray(v, np.int32)
                    elif f == "q_scale":
                        arrays[f] = np.asarray(v, np.float32)
                    else:
                        arrays[f] = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            if self._dead:
                arrays["dead_rows"] = np.asarray(sorted(self._dead), np.int64)
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, cfg, arrays=None, capacity: Optional[int] = None,
                   n_inserted: Optional[int] = None, device=None) -> "CagraIndex":
        """An index over the JAX package's state. `cfg` is a CagraConfig or
        dataclasses.asdict of the JAX package's one; `arrays` maps its
        CagraState's fields to numpy (a save file's contents; "dead_rows"
        optional), None for an empty index. capacity and n_inserted default
        to the state's size."""
        if isinstance(cfg, dict):
            cfg = CagraConfig(**cfg)
        idx = cls(cfg, device=device)
        if arrays is None or "vectors" not in arrays:
            idx.capacity = int(capacity or 0)
            idx._n_inserted = int(n_inserted or 0)
            return idx
        idx.state = state_from_numpy(cfg, arrays, idx.device)
        idx.capacity = int(idx.state.vectors.shape[0] if capacity is None else capacity)
        idx._n_inserted = idx.state.n if n_inserted is None else int(n_inserted)
        idx._anchor_n = idx.state.n
        if "dead_rows" in arrays:
            dead = np.asarray(arrays["dead_rows"], np.int64)
            idx._dead = set(int(i) for i in dead)
            idx._dead_dev = torch.zeros(idx.state.vectors.shape[0], dtype=torch.bool,
                                        device=idx.device)
            idx._dead_dev[torch.as_tensor(dead, device=idx.device)] = True
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "CagraIndex":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(meta["cfg"], arrays, capacity=meta["capacity"],
                              n_inserted=meta["n_inserted"], device=device)
