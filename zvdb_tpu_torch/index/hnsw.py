"""HNSW engine: flat int32 neighbor tables and a batched hierarchical search
(port of zvdb_tpu/index/hnsw.py).

The index is a dataclass of dense tensors:

    vectors  f32/bf16/int8 [cap, D]
    norms    f32      [cap]            (squared norms, l2 metric only)
    nbr0     int32    [cap+1, M0]      base-layer adjacency, -1 padded
    nbrU     int32    [L, cap+1, M]    upper-layer adjacency (layer l at nbrU[l-1])
    levels   int32    [cap]            per-node level (-1 = unused slot)
    ext_ids  int32    [cap]            user-visible id of each internal row

Search descends greedily from the entry point through the upper layers,
unions the descent's row with the best anchor rows (one [B, A] product over
a dense anchor table), and runs a batched beam over the base layer
(`beam_layer_fn`). Row cap of each adjacency table is a write-trash row.

Differences from the JAX package, by design:
  * the state's `entry`, `max_level` and `n` are host ints and `q_scale` a
    host float holding an f32 value (device scalars in JAX); tensors are
    updated in place where JAX returns copies;
  * every product names its precision (the config's, by the JAX names:
    "float32" is the port's "highest") instead of an ambient
    jax.default_matmul_precision;
  * the greedy descent reads "did any query move" on the host after each
    hop, as JAX's while_loop stops (a device sync per hop; see
    _greedy_layer_fn for the unsynced form);
  * `beam_layer_fn` runs all max_iters hops (see its docstring);
  * the batched build's bookkeeping (levels, valid rows, entry promotion,
    max_level, n) is host numpy, so a skipped upper layer is a Python `if`;
    its greedy descent skips the layers above the prefix's max_level,
    where no edge exists and JAX's walk does not move;
  * the builds and flushes draw from a torch.Generator seeded from
    HNSW(seed=...), so one seed builds a different graph in each package;
    `HNSW.from_numpy`, `load` and `resume_build` carry a JAX-built state
    across;
  * a flush seeds each base beam with the top SearchConfig.seed_anchors
    anchors beside the descent's row, as search does (JAX: the descent
    alone; 0 gives JAX's); a bulk build has no anchors until its end;
  * a flush that builds from no state sets the index's levels_cap to the
    state's height (JAX keeps the one __init__ derived, which a later
    growth then cannot copy into when the two differ).
Entry points take `device=None`, which means "cuda"; without a CUDA device
they raise unless the caller asks for "cpu".
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

import numpy as np
import torch

from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import HNSWConfig, SearchConfig
from .flat import resolve_device, tensor_from_numpy

_INF = float("inf")

# the JAX package's precision names -> the port's (ops/distance.py)
_PRECISION = {"float32": "highest", "tensorfloat32": "high", "bfloat16": "default"}


def torch_precision(precision: Optional[str]) -> Optional[str]:
    """A JAX precision name as ops/distance.py names it."""
    return _PRECISION.get(precision, precision)


def _f32(v) -> float:
    return float(np.float32(v))


def _bdot(q: torch.Tensor, rows: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """q [B, D] . rows [B, C, D] -> [B, C] f32 at `precision`."""
    return D._sum_products(D._operand_pairs(q, rows, precision),
                           lambda a, b: torch.einsum("bd,bcd->bc", a, b))


@dataclasses.dataclass
class HNSWState:
    vectors: torch.Tensor    # [cap, D] storage dtype (int8: codes)
    norms: torch.Tensor      # [cap] f32
    nbr0: torch.Tensor       # [cap+1, M0] int32
    nbrU: torch.Tensor       # [L, cap+1, M] int32
    dist0: torch.Tensor      # [cap+1, M0] f32 true edge distances, +inf padded
    distU: torch.Tensor      # [L, cap+1, M] f32
    levels: torch.Tensor     # [cap] int32, -1 unused
    ext_ids: torch.Tensor    # [cap] int32
    entry: int               # internal row of the entry point (-1 = empty)
    max_level: int
    n: int                   # rows used
    q_scale: float           # int8 dequant scale as an f32 value (1.0 otherwise)
    anchors: torch.Tensor    # [A, D] f32 dequantized copies of anchor rows ([0, D]: none)
    a_norms: torch.Tensor    # [A] f32
    a_rows: torch.Tensor     # [A] int32


FIELDS = tuple(f.name for f in dataclasses.fields(HNSWState))
_HOST_FIELDS = ("entry", "max_level", "n", "q_scale")


def max_level_for(capacity: int, m: int) -> int:
    """Hierarchy height: enough layers that the top layer is ~O(1) nodes."""
    if capacity <= 1:
        return 1
    return max(1, int(math.ceil(math.log(max(capacity, 2)) / math.log(max(m, 2)))))


def init_state(capacity: int, cfg: HNSWConfig, levels_cap: Optional[int] = None,
               device=None) -> HNSWState:
    dev = resolve_device(device)
    L = levels_cap if levels_cap is not None else (
        cfg.max_level if cfg.max_level is not None else max_level_for(capacity, cfg.m))

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return HNSWState(
        vectors=torch.zeros((capacity, cfg.dim), dtype=cfg.storage_dtype, device=dev),
        norms=torch.zeros(capacity, dtype=torch.float32, device=dev),
        nbr0=full((capacity + 1, cfg.base_degree), -1, torch.int32),
        nbrU=full((L, capacity + 1, cfg.m), -1, torch.int32),
        dist0=full((capacity + 1, cfg.base_degree), _INF, torch.float32),
        distU=full((L, capacity + 1, cfg.m), _INF, torch.float32),
        levels=full((capacity,), -1, torch.int32),
        ext_ids=full((capacity,), -1, torch.int32),
        entry=-1, max_level=0, n=0, q_scale=1.0,
        anchors=torch.zeros((0, cfg.dim), dtype=torch.float32, device=dev),
        a_norms=torch.zeros(0, dtype=torch.float32, device=dev),
        a_rows=torch.zeros(0, dtype=torch.int32, device=dev),
    )


def state_from_numpy(cfg: HNSWConfig, arrays, device) -> HNSWState:
    """The JAX package's HNSWState fields, as numpy (a save file's contents),
    -> the port's state on `device`. bf16 vectors may arrive as
    ml_dtypes.bfloat16 or as the f32 a save file holds. A file without an
    anchor table or q_scale (older saves) gets none / 1.0."""
    t = {}
    for f in FIELDS:
        if f in _HOST_FIELDS:
            continue
        if f in arrays:
            t[f] = tensor_from_numpy(arrays[f], device)
        elif f == "anchors":
            t[f] = torch.zeros((0, cfg.dim), dtype=torch.float32, device=device)
        else:
            t[f] = torch.zeros(0, dtype=torch.float32 if f == "a_norms" else torch.int32,
                               device=device)
    t["vectors"] = t["vectors"].to(cfg.storage_dtype)
    for f in ("norms", "dist0", "distU", "anchors", "a_norms"):
        t[f] = t[f].float()
    for f in ("nbr0", "nbrU", "levels", "ext_ids", "a_rows"):
        t[f] = t[f].to(torch.int32)
    q_scale = _f32(np.asarray(arrays["q_scale"])) if "q_scale" in arrays else 1.0
    return HNSWState(entry=int(np.asarray(arrays["entry"])),
                     max_level=int(np.asarray(arrays["max_level"])),
                     n=int(np.asarray(arrays["n"])), q_scale=q_scale, **t)


def state_to_numpy(state: HNSWState) -> dict:
    """The state's fields as numpy in the JAX package's dtypes (host scalars
    as 0-d int32 / f32; bf16 vectors as f32, which a save file needs)."""
    out = {}
    for f in FIELDS:
        v = getattr(state, f)
        if f == "q_scale":
            out[f] = np.asarray(v, np.float32)
        elif f in _HOST_FIELDS:
            out[f] = np.asarray(v, np.int32)
        else:
            out[f] = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# score helpers


def _gather_vecs(state: HNSWState, rows: torch.Tensor):
    """Vectors and norms of row ids (any shape); -1 rows are clamped (callers mask)."""
    safe = rows.clamp(min=0).long()
    return state.vectors[safe], state.norms[safe]


def _scores_to(state: HNSWState, q: torch.Tensor, rows: torch.Tensor, metric: str,
               precision: Optional[str] = None) -> torch.Tensor:
    """Surrogate scores from queries [B, D] to per-query rows [B, C] -> [B, C];
    +inf for rows < 0."""
    vecs, norms = _gather_vecs(state, rows)
    s = D.gathered_scores(q, vecs, norms, metric, precision=precision, scale=state.q_scale)
    return torch.where(rows >= 0, s, _INF)


def make_scorer(state: HNSWState, q: torch.Tensor, metric: str,
                precision: Optional[str] = None):
    """rows [B, C] -> surrogate scores [B, C] for fixed (state, preprocessed
    queries, metric): the interface the greedy and beam loops score through."""
    return lambda rows: _scores_to(state, q, rows, metric, precision)


def make_packed_scorer(table: torch.Tensor, qp: torch.Tensor, precision: Optional[str] = None):
    """One-gather scorer over the packed [cap, D+1] (vector | squared norm)
    table (l2 + f32 only): score = ||x||^2 - 2 q.x = -2 * ([q, -0.5] . [x,
    ||x||^2]), so the norm rides in the product at the same precision and a
    hop gathers one row per candidate instead of two."""
    qe = torch.cat([qp, qp.new_full((qp.shape[0], 1), -0.5)], dim=1)

    def score_rows(rows):
        vx = table[rows.clamp(min=0).long()]                  # ONE gather
        return torch.where(rows >= 0, -2.0 * _bdot(qe, vx, precision), _INF)

    return score_rows


# ---------------------------------------------------------------------------
# greedy descent over one upper layer


def _greedy_layer_fn(score_rows, ep: torch.Tensor, ep_score: torch.Tensor, nbrs: torch.Tensor,
                     max_iters: int):
    """Batched greedy walk: move each query to its best neighbor until no
    query improves, at most max_iters hops. Whether any query moved is read
    on the host after every hop (a device sync), as JAX's while_loop stops.
    Running all max_iters hops without that read gives the same result but
    measured 4.7-7.1x slower at hnsw_1m on an H100 (PERF.md §6)."""
    for _ in range(max_iters):
        cand = nbrs[ep.clamp(min=0).long()]                   # [B, M]
        s = score_rows(cand)
        best_s, best_i = s.min(dim=-1)                        # ties: the first, as argmin
        best_row = torch.gather(cand, -1, best_i[:, None])[:, 0]
        better = best_s < ep_score
        ep = torch.where(better, best_row, ep)
        ep_score = torch.where(better, best_s, ep_score)
        if not bool(better.any()):
            break
    return ep, ep_score


def _greedy_layer(state: HNSWState, q: torch.Tensor, ep: torch.Tensor, ep_score: torch.Tensor,
                  nbrs: torch.Tensor, metric: str, max_iters: int,
                  precision: Optional[str] = None):
    """_greedy_layer_fn with the state scorer (the batched build's descent)."""
    return _greedy_layer_fn(make_scorer(state, q, metric, precision), ep, ep_score, nbrs,
                            max_iters)


# ---------------------------------------------------------------------------
# beam search over one layer


def beam_layer_fn(
    score_rows,                   # rows [B, C] -> surrogate scores [B, C]
    seed_rows: torch.Tensor,      # [B, S] initial candidate rows (-1 ok)
    seed_scores: torch.Tensor,    # [B, S]
    nbrs: torch.Tensor,           # [cap+1, deg] adjacency of this layer
    ef: int,
    expand: int = 1,
    max_iters: Optional[int] = None,
    limit_n: Optional[int] = None,
    use_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
    expand_fn=None,
):
    """Batched best-first beam search on one layer's graph.

    Returns (beam_scores [B, ef], beam_rows [B, ef]) sorted ascending by
    score. `limit_n`: rows >= limit_n are treated as nonexistent (the frozen
    prefix of an incremental build). `use_degree`: expand only the first
    use_degree neighbors of each row. `expand_fn`: optional override of the
    adjacency gather + score step, sel_r [B, E] -> (cand_ids, cand_scores)
    with invalid slots (-1, +inf). The visited set is implicit: candidates
    are deduped against the beam, and beam entries carry an expanded flag.

    JAX's while_loop stops once every query is done; this loop always runs
    max_iters iterations and never reads `done` on the host, so a batch on
    the GPU costs no device-to-host sync per hop. The two return the same
    beam: once every query is done, every entry is expanded, so an iteration
    selects no row (sel_r all -1), scores only invalid candidates (-1/+inf)
    and its merge keeps the beam as it was.
    """
    b, s_width = seed_rows.shape
    e = expand
    deg = nbrs.shape[-1]
    if max_iters is None:
        max_iters = max(ef // max(e, 1), 1) + 8

    pad = ef - s_width
    if pad < 0:
        seed_scores, seed_rows = T.smallest_k(seed_scores, seed_rows, ef)
        pad = 0
    beam_s = torch.cat([seed_scores, seed_scores.new_full((b, pad), _INF)], dim=1)
    beam_r = torch.cat([seed_rows, seed_rows.new_full((b, pad), -1)], dim=1)
    beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
    beam_s, beam_r = T.smallest_k(beam_s, beam_r, ef)
    expanded = beam_r < 0   # invalid slots count as expanded
    done = torch.zeros(b, dtype=torch.bool, device=beam_s.device)

    for _ in range(max_iters):
        unexp_s = torch.where(expanded, _INF, beam_s)
        _, pos = T.smallest_k_dense(unexp_s, e)                        # [B, E]
        sel_s = torch.gather(unexp_s, -1, pos)
        sel_r = torch.where(torch.isfinite(sel_s), torch.gather(beam_r, -1, pos), -1)

        # termination: best unexpanded no better than the worst beam slot
        done = done | (sel_s[:, 0] >= beam_s.amax(-1))

        onehot = torch.zeros_like(expanded).scatter_(1, pos, True) & torch.isfinite(unexp_s)
        expanded = expanded | onehot

        if expand_fn is not None:
            cand, c_s = expand_fn(sel_r)
        else:
            cand = nbrs[sel_r.clamp(min=0).long()]                     # [B, E, deg]
            if use_degree is not None and use_degree < deg:
                cand = cand[:, :, :use_degree]
            cand = torch.where((sel_r >= 0)[:, :, None], cand, -1).reshape(b, -1)
            if limit_n is not None:
                cand = torch.where(cand < limit_n, cand, -1)
            c_s = score_rows(cand)
        if dedupe_candidates:
            c_s, cand = T.mask_duplicate_ids(c_s, cand)
        c_s, cand = T.mask_ids_in(c_s, cand, beam_r)

        # merge into the beam, carrying expanded flags (new entries unexpanded)
        all_s = torch.cat([beam_s, c_s], dim=-1)
        all_r = torch.cat([beam_r, cand], dim=-1)
        all_e = torch.cat([expanded, torch.zeros_like(cand, dtype=torch.bool)], dim=-1)
        _, top = T.smallest_k_dense(all_s, ef)
        beam_s = torch.gather(all_s, -1, top)
        beam_r = torch.gather(all_r, -1, top)
        # done queries keep everything expanded, so they do no further work
        expanded = torch.gather(all_e, -1, top) | (beam_r < 0) | done[:, None]
    return beam_s, beam_r


def beam_layer(state: HNSWState, q: torch.Tensor, seed_rows: torch.Tensor,
               seed_scores: torch.Tensor, nbrs: torch.Tensor, ef: int, metric: str,
               expand: int = 1, limit_n: Optional[int] = None,
               precision: Optional[str] = None):
    """beam_layer_fn with the state scorer (the batched build's frozen-prefix beams)."""
    return beam_layer_fn(make_scorer(state, q, metric, precision), seed_rows, seed_scores, nbrs,
                         ef, expand=expand, limit_n=limit_n)


# ---------------------------------------------------------------------------
# full hierarchical search


def descend(state: HNSWState, q: torch.Tensor, metric: str, levels_cap: int,
            stop_layer: int = 0, max_upper_iters: int = 32,
            scorer=None, precision: Optional[str] = None):
    """Greedy-descend from the entry point through the upper layers down to
    `stop_layer + 1`, returning per-query entry rows and scores for
    `stop_layer`. Layers above state.max_level are skipped (a host int, so
    a Python `if` where JAX has a lax.cond). `scorer`: optional row-scoring
    closure (the packed layout)."""
    b = q.shape[0]
    if scorer is None:
        scorer = make_scorer(state, q, metric, precision)
    ep = torch.full((b,), state.entry, dtype=torch.int32, device=q.device)
    ep_score = scorer(ep[:, None])[:, 0]
    for ell in range(levels_cap, stop_layer, -1):
        if ell <= state.max_level:
            ep, ep_score = _greedy_layer_fn(scorer, ep, ep_score, state.nbrU[ell - 1],
                                            max_upper_iters)
    return ep, ep_score


def anchor_seeds(state: HNSWState, qp: torch.Tensor, seed_anchors: int, metric: str,
                 precision: Optional[str] = None):
    """The best min(seed_anchors, A) anchor rows per query and their scores
    (one [B, A] product; ties to the lower anchor, as lax.top_k). The
    anchors hold the dequantized stored rows, so their scores are what the
    beam's scorer computes for those rows. None when there are no anchors."""
    if seed_anchors <= 0 or state.anchors.shape[0] == 0:
        return None
    a_s = D.pairwise_scores(qp, state.anchors, state.a_norms, metric, precision=precision)
    s, top = T.smallest_k_dense(a_s, min(seed_anchors, state.anchors.shape[0]))
    return state.a_rows[top], s


def search_state_impl(
    state: HNSWState,
    q: torch.Tensor,          # [B, D] raw queries
    k: int,
    metric: str,
    ef: int,
    expand: int = 1,
    max_iters: Optional[int] = None,
    max_upper_iters: int = 32,
    levels_cap: int = 1,
    precision: str = "float32",
    search_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
    seed_anchors: int = 16,
    dead: Optional[torch.Tensor] = None,
    packed_table: Optional[torch.Tensor] = None,
):
    """Full hierarchical kNN search. Returns (scores [B, k], ext_ids [B, k],
    rows [B, k]). Scores are user-facing (squared L2, or similarity for
    dot/cosine); empty slots score +inf / -inf with id -1. `dead`: optional
    [cap+1] bool mask by internal row: those nodes route beams but never
    enter results. `packed_table`: optional [cap, D+1] (vector | norm)
    layout (l2 + f32 only): every hop on every layer gathers one row per
    candidate. `precision` takes the JAX names ("float32", "high", "default")."""
    prec = torch_precision(precision)
    qp = D.preprocess_queries(q, metric)
    ef = max(ef, k)
    scorer = (make_packed_scorer(packed_table, qp, prec) if packed_table is not None
              else make_scorer(state, qp, metric, prec))
    ep, ep_score = descend(state, qp, metric, levels_cap, stop_layer=0,
                           max_upper_iters=max_upper_iters, scorer=scorer)
    seeds, seed_s = ep[:, None], ep_score[:, None]
    anchors = anchor_seeds(state, qp, seed_anchors, metric, prec)
    if anchors is not None:
        seeds = torch.cat([seeds, anchors[0]], dim=1)
        seed_s = torch.cat([seed_s, anchors[1]], dim=1)
    beam_s, beam_r = beam_layer_fn(scorer, seeds, seed_s, state.nbr0, ef, expand=expand,
                                   max_iters=max_iters, use_degree=search_degree,
                                   dedupe_candidates=dedupe_candidates)
    # final dedupe on the (small) beam: results must be unique even when
    # in-hop dedupe is off
    beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
    if dead is not None:
        hit = dead[beam_r.clamp(min=0).long()] & (beam_r >= 0)
        beam_s = torch.where(hit, _INF, beam_s)
        beam_r = torch.where(hit, -1, beam_r)
    top_s, top_r = T.smallest_k(beam_s, beam_r, k)
    valid = top_r >= 0
    ext = torch.where(valid, state.ext_ids[top_r.clamp(min=0).long()], -1)
    user = D.finalize_scores(top_s, qp, metric)
    user = torch.where(valid, user, _INF if metric == "l2" else -_INF)
    if state.n == 0:   # empty index: entry == -1, everything invalid
        ext = torch.full_like(ext, -1)
        top_r = torch.full_like(top_r, -1)
    return user, ext, top_r


# ---------------------------------------------------------------------------
# the engine


class HNSW:
    """HNSW index: insert/add (buffered on the host, flushed through the
    batched build step), build (one-shot or batched, with crash
    checkpoints), resume_build, search with allowed=, remove/compact, get,
    save/load. Host-side mutation and search share one lock."""

    def __init__(self, cfg: HNSWConfig, search_cfg: SearchConfig = SearchConfig(),
                 capacity: int = 0, seed: int = 0, device=None):
        self.cfg = cfg
        self.search_cfg = search_cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.levels_cap = cfg.max_level or max_level_for(max(capacity, 1024), cfg.m)
        self.state: Optional[HNSWState] = None
        self._pending: list[np.ndarray] = []   # the host-side insert buffer
        self._n_inserted = 0                 # external ids handed out
        self._anchor_n = 0                   # n at the last anchor sample
        # the builds' and flushes' draws (levels, graphs, anchors) advance
        # this generator one after another, as the JAX package splits its key
        self._gen = torch.Generator().manual_seed(seed)
        self._lock = threading.RLock()
        self._dead: set[int] = set()         # tombstoned EXTERNAL ids
        self._dead_rows: Optional[torch.Tensor] = None   # [cap+1] bool by row
        self._packed_table: Optional[torch.Tensor] = None   # derived, not saved
        self.build_stats: dict = {}          # the last build's or flush's geometry and stages
        if capacity:
            self.state = init_state(self.capacity, cfg, self.levels_cap, self.device)

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else self.state.n
            return n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _set_state(self, state: Optional[HNSWState]) -> None:
        """Replace the state; the derived packed table and the tombstones go."""
        self.state = state
        self._packed_table = None
        self._dead = set()
        self._dead_rows = None

    # -- mutation ---------------------------------------------------------
    def insert(self, x) -> None:
        """Insert one vector [D] or a batch [B, D] (numpy, a list or a
        tensor). The rows are copied and buffered on the host; the graph
        grows in bulk at the next flush, which comes once build_batch rows
        wait, or at the next search, get, remove, compact or save."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy().copy()
        else:
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
        """Insert every buffered row into the graph now."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        """The buffered rows through build.extend_graph, in arrival order,
        each base beam seeded as search seeds it: the descent's row and the
        top search_cfg.seed_anchors anchors (JAX: the descent alone). The
        packed table is derived from the rows, so it goes; tombstones stay,
        their mask padded to a grown capacity. Once n doubles past the last
        anchor sample, the anchors are drawn again over every row."""
        if not self._pending:
            return
        from .build import _attach_anchors, extend_graph

        x = np.concatenate(self._pending, axis=0)
        self._pending = []
        self.build_stats = {}
        self.state, self.capacity = extend_graph(
            self.state, self.capacity, self.levels_cap, x, self.cfg, self._gen,
            ext_id_start=self._n_inserted - x.shape[0], device=self.device,
            stats=self.build_stats, seed_anchors=self.search_cfg.seed_anchors)
        # a flush from nothing builds at its own height
        self.levels_cap = self.state.nbrU.shape[0]
        self._packed_table = None
        cap1 = self.state.nbr0.shape[0]
        if self._dead_rows is not None and self._dead_rows.shape[0] < cap1:
            grown = torch.zeros(cap1, dtype=torch.bool, device=self.device)
            grown[:self._dead_rows.shape[0]] = self._dead_rows
            self._dead_rows = grown
        n_now = self.state.n
        if self._anchor_n == 0:
            self._anchor_n = n_now   # the first flush built from nothing
        elif n_now >= 2 * self._anchor_n:
            _attach_anchors(self.state, n_now, self._gen)
            self._anchor_n = n_now

    # -- build ------------------------------------------------------------
    def build(self, x, sort_by_level: bool = True, checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 0) -> None:
        """Bulk-build from a corpus [N, D], replacing the contents (buffered
        inserts included). x is numpy (uploaded) or a tensor (kept on its
        device; not copied).

        build_mode "oneshot", or "auto" without a checkpoint_path: the
        one-shot build (index/build.py:bulk_build_oneshot); a checkpoint_path
        snapshots it once its base layer is built. "batched", or "auto" with
        a checkpoint_path: the frozen-prefix batches (bulk_build), rows in
        level-descending order unless sort_by_level=False, a snapshot every
        checkpoint_every batches. HNSW.resume_build(path) finishes either.
        With ZVDB_BUILD_TRACE=1 the build prints its stages' times."""
        from .build import bulk_build, bulk_build_oneshot   # local: build imports this module

        mode = self.cfg.build_mode
        oneshot = mode == "oneshot" or (mode == "auto" and not checkpoint_path)
        if isinstance(x, torch.Tensor):
            x = x.to(device=self.device, dtype=torch.float32)
        else:
            x = np.asarray(x, dtype=np.float32)
        if x.shape[0] and x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")
        with self._lock:
            self.build_stats = {}
            self._set_state(None)
            self._pending = []
            self._n_inserted = self._anchor_n = x.shape[0]
            if x.shape[0] == 0:   # empty corpus -> empty index
                self.capacity = 0
                return
            if oneshot:
                self.state, self.capacity, self.levels_cap = bulk_build_oneshot(
                    x, self.cfg, self._gen, device=self.device, stats=self.build_stats,
                    checkpoint_path=checkpoint_path)
            else:
                self.state, self.capacity, self.levels_cap = bulk_build(
                    x, self.cfg, self._gen, sort_by_level=sort_by_level,
                    checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                    device=self.device, stats=self.build_stats)

    @classmethod
    def resume_build(cls, checkpoint_path: str, device=None) -> "HNSW":
        """Finish a build from its checkpoint, written by either package:
        a one-shot snapshot (kind "hnsw_oneshot") reruns the upper layers,
        anchors and reorder; a batched one runs the remaining batches."""
        import json

        from .build import resume_build, resume_build_oneshot

        with np.load(checkpoint_path, allow_pickle=False) as z:
            kind = json.loads(str(z["meta"])).get("kind")
        resume = resume_build_oneshot if kind == "hnsw_oneshot" else resume_build
        state, capacity, levels_cap, cfg = resume(checkpoint_path, device=device)
        idx = cls(cfg, device=device)
        idx.state, idx.capacity, idx.levels_cap = state, capacity, levels_cap
        idx._n_inserted = idx._anchor_n = state.n
        return idx

    # -- delete -----------------------------------------------------------
    def _ext_to_rows(self, ext_ids_np: np.ndarray) -> np.ndarray:
        """External ids -> internal rows through the stored ext_ids table."""
        ext = self.state.ext_ids.cpu().numpy()
        live = ext >= 0
        inv = np.full(max(self._n_inserted, 1), -1, np.int64)
        inv[ext[live]] = np.nonzero(live)[0]
        return inv[ext_ids_np]

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
            if (ids < 0).any() or (ids >= self._n_inserted).any():
                raise IndexError(f"ids must be in [0, {self._n_inserted})")
            new = np.asarray([int(i) for i in ids if int(i) not in self._dead], np.int64)
            if new.size == 0:
                return 0
            rows = self._ext_to_rows(new)
            assert (rows >= 0).all()
            cap1 = self.state.nbr0.shape[0]        # cap + trash row
            if self._dead_rows is None:
                self._dead_rows = torch.zeros(cap1, dtype=torch.bool, device=self.device)
            self._dead_rows[torch.as_tensor(rows, device=self.device)] = True
            self._dead.update(int(i) for i in new)
            return int(new.size)

    def compact(self) -> np.ndarray:
        """Rebuild without the tombstoned rows; survivors renumber to [0, L)
        in former external-id order. Returns the survivors' old external ids
        (new id == position). One one-shot build."""
        with self._lock:
            self._flush_locked()
            alive = np.ones(self._n_inserted, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or not self._dead:
                return live
            rows = torch.as_tensor(self._ext_to_rows(live), device=self.device)
            vecs = self.state.vectors[rows].float()
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
        self.build(vecs)   # takes the lock itself
        return live

    # -- search -----------------------------------------------------------
    def _allowed_rows(self, allowed) -> torch.Tensor:
        """[cap] bool: rows whose external id the allowlist passes."""
        from ..utils.masks import allowed_mask

        av = allowed_mask(allowed, self._n_inserted, self._n_inserted, self.device)
        ext = self.state.ext_ids
        return av[ext.clamp(min=0).long()] & (ext >= 0)

    def _packed(self) -> torch.Tensor:
        if self._packed_table is None:
            st = self.state
            self._packed_table = torch.cat([st.vectors, st.norms[:, None]], dim=1)
        return self._packed_table

    def search(self, q, k: int, ef_search: Optional[int] = None,
               search_degree: Optional[int] = None, max_iters: Optional[int] = None,
               allowed=None, filter_mode: str = "auto"):
        """kNN search. q [D] or [B, D] -> (scores, ids) [B, k] ([k] squeezed),
        tensors on the index's device; invalid slots id -1. ef_search /
        search_degree / max_iters override search_cfg for this call.
        allowed: optional allowlist over external ids (bool mask or int id
        array). filter_mode "scan" answers with the exact masked scan over
        the stored rows, "beam" runs the graph beam with blocked nodes
        routing but filtered from the final ef-wide beam, "auto" picks
        (utils/filter_policy.py)."""
        from ..utils.filter_policy import resolve_filter_mode

        if filter_mode not in ("auto", "scan", "beam"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock:
            self._flush_locked()
            filter_mode = resolve_filter_mode(filter_mode, allowed, self._n_inserted, alt="beam")
            q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
            squeeze = q.dim() == 1
            if squeeze:
                q = q[None, :]
            cfg, sc, st = self.cfg, self.search_cfg, self.state
            if q.shape[-1] != cfg.dim:
                raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {q.shape[-1]}")
            if st is None or st.n == 0:
                s = torch.full((q.shape[0], k), _INF if cfg.metric == "l2" else -_INF,
                               device=self.device)
                i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=self.device)
            elif allowed is not None and filter_mode == "scan":
                from .flat import masked_exact_search

                cap = st.vectors.shape[0]
                ok = self._allowed_rows(allowed)
                if self._dead_rows is not None:
                    ok = ok & ~self._dead_rows[:cap]
                bias = torch.where(ok, 0.0, _INF)
                s, rows = masked_exact_search(
                    st.vectors, st.norms + bias,
                    torch.full((cap,), st.q_scale, dtype=torch.float32, device=self.device),
                    q, k, cfg.metric,
                    precision="high" if cfg.precision == "default" else cfg.precision)
                i = torch.where(rows >= 0, st.ext_ids[rows.clamp(min=0).long()], -1)
            else:
                dead = self._dead_rows if self._dead else None
                if allowed is not None:
                    block = ~self._allowed_rows(allowed)
                    block = torch.cat([block, block.new_ones(1)])   # the trash row
                    dead = block if dead is None else (dead | block)
                s, i, _ = search_state_impl(
                    st, q, k, cfg.metric,
                    ef_search if ef_search is not None else sc.ef_search,
                    expand=sc.expand,
                    max_iters=max_iters if max_iters is not None else sc.max_iters,
                    max_upper_iters=sc.max_upper_iters, levels_cap=self.levels_cap,
                    precision=cfg.precision,
                    search_degree=search_degree if search_degree is not None
                    else sc.search_degree,
                    dedupe_candidates=sc.dedupe_candidates, seed_anchors=sc.seed_anchors,
                    dead=dead, packed_table=self._packed() if cfg.packed else None)
            if squeeze:
                return s[0], i[0]
            return s, i

    # -- reads ------------------------------------------------------------
    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids [K] -> [K, D] f32 numpy: exact for
        f32, rounded for bf16, dequantized for int8, normalized for cosine."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if ids.size == 0 or self.state is None:
                if ids.size and self.state is None:
                    raise IndexError("index is empty")
                return np.zeros((0, self.cfg.dim), np.float32)
            if (ids < 0).any() or (ids >= self._n_inserted).any():
                raise IndexError(f"ids must be in [0, {self._n_inserted})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            rows = torch.as_tensor(self._ext_to_rows(ids), device=self.device)
            vecs = self.state.vectors[rows].float()
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
            return vecs.cpu().numpy()

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format (io/persist.py)."""
        from ..io.persist import save_hnsw

        with self._lock:
            self._flush_locked()
            save_hnsw(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "HNSW":
        """Read a save file written by either package."""
        from ..io.persist import load_hnsw

        return load_hnsw(path, device=device)

    @classmethod
    def from_numpy(cls, cfg, arrays=None, search_cfg=None, capacity: Optional[int] = None,
                   levels_cap: Optional[int] = None, n_inserted: Optional[int] = None,
                   dead_ext=None, seed: int = 0, device=None) -> "HNSW":
        """An index over the JAX package's state. `cfg` / `search_cfg` are
        configs or dataclasses.asdict of the JAX package's; `arrays` maps
        HNSWState's fields to numpy (a save file's contents), None for an
        empty index. capacity, levels_cap and n_inserted default to the
        state's; dead_ext (external ids) restores tombstones."""
        if isinstance(cfg, dict):
            cfg = HNSWConfig(**cfg)
        if isinstance(search_cfg, dict):
            search_cfg = SearchConfig(**search_cfg)
        idx = cls(cfg, search_cfg or SearchConfig(), seed=seed, device=device)
        if arrays is None or "vectors" not in arrays:
            idx.capacity = int(capacity or 0)
            if levels_cap is not None:
                idx.levels_cap = int(levels_cap)
            idx._n_inserted = int(n_inserted or 0)
            return idx
        idx.state = state_from_numpy(cfg, arrays, idx.device)
        idx.capacity = int(idx.state.vectors.shape[0] if capacity is None else capacity)
        idx.levels_cap = int(idx.state.nbrU.shape[0] if levels_cap is None else levels_cap)
        idx._n_inserted = idx.state.n if n_inserted is None else int(n_inserted)
        idx._anchor_n = idx.state.n
        if dead_ext is not None and len(dead_ext):
            dead_ext = np.asarray(dead_ext, np.int64)
            idx._dead = set(int(i) for i in dead_ext)
            idx._dead_rows = torch.zeros(idx.state.nbr0.shape[0], dtype=torch.bool,
                                         device=idx.device)
            idx._dead_rows[torch.as_tensor(idx._ext_to_rows(dead_ext), device=idx.device)] = True
        return idx
