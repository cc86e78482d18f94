"""Mesh-sharded CAGRA: the graph engine over a device mesh (port of
zvdb_tpu/parallel/sharded_cagra.py).

  * The corpus is split into S contiguous shards of per = ceil(n / S) rows;
    each shard holds its own single-layer graph (index/cagra.py's
    CagraState) on its mesh cell's device, so graph gathers never cross
    shards. `ext_ids` maps each shard's rows to global insertion-order ids.
  * Bulk build: every shard's graph comes from the cluster-kNN build,
    driven phase by phase over all shards at once
    (index/knn_graph.py:build_knn_graph_multi); with block_topk="pallas"
    each shard's block scoring runs kernel D (ops/block_scan.py).
  * Search: index/cagra.py:cagra_search_impl on every shard over its raw
    vectors (JAX's sharded call: no packed or fat table), rows mapped to
    global ids, then a [B, S*k] merge on the mesh's merge device
    (parallel/sharded.py:run_shards).
  * Insert: each flush splits its rows contiguously over the shards and
    runs the single-chip extend step (index/cagra.py:_extend_batch_impl) in
    place on every shard that has rows in a step.

Differences from the JAX package, by design: the graph's and the anchors'
draws come from torch.Generators, one pair a shard seeded
2 * (cfg.seed + s) and 2 * (cfg.seed + s) + 1 (JAX splits
PRNGKey(cfg.seed + s) in two), and the anchor reseeds from a generator
seeded by ShardedCagra(seed=...) through parallel/sharded.py:
make_anchor_reseed; `from_numpy` and `load` carry a JAX-built index
across. A shard with no row in an insert step skips it (JAX runs it over
padding, which changes nothing). The state is a list of per-shard states
with host-int `n` and host-float `q_scale`, stacked only in save files.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..index.cagra import (
    _FIELDS, CagraConfig, CagraState, _extend_batch_impl, _pick_anchor_rows, _SearchArrays,
    cagra_search_impl, state_from_numpy,
)
from ..index.hnsw import _f32
from ..index.knn_graph import build_knn_graph_multi
from ..ops import distance as D
from ..ops import topk as T
from ..utils.filter_policy import resolve_filter_mode
from ..utils.masks import allowed_mask
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh
from .scan_filter import make_sharded_masked_scan
from .sharded import make_anchor_reseed, merge_span, run_shards

_INF = float("inf")


def shard_generators(seed: int, si: int):
    """Shard si's (graph build, anchor) generators."""
    return (torch.Generator().manual_seed(2 * (seed + si)),
            torch.Generator().manual_seed(2 * (seed + si) + 1))


class ShardedCagra:
    """Mesh-sharded CagraIndex; the API mirrors the single-chip class."""

    def __init__(self, cfg: CagraConfig, mesh=None, seed: int = 0):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.n_data = self.mesh.shape.get(DATA_AXIS, 1)
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one CagraState per shard
        self.ext_ids: Optional[list] = None      # per shard [cap] int32 global ids, -1 pad
        self.shard_cap = 0
        self._gen = torch.Generator().manual_seed(seed)   # the anchor reseeds
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._anchor_n = 0   # max per-shard n at the last anchor sample
        self._dead: set[int] = set()                  # tombstoned global ids
        self._dead_mask: Optional[list] = None        # per shard [cap] bool by row
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times
        self.build_stats: list = []   # the last bulk build's geometry, one dict a built shard

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    # -- delete -----------------------------------------------------------
    def remove(self, ids) -> int:
        """Delete by global id (mark-and-filter): tombstoned nodes keep
        routing each shard's beam and leave its results before the merge.
        Ids never renumber. Returns the number newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        self._flush()
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        new = np.asarray([int(i) for i in ids if int(i) not in self._dead], np.int64)
        if new.size == 0:
            return 0
        self._mark(new)
        self._dead.update(int(i) for i in new)
        return int(new.size)

    def _mark(self, dead: np.ndarray) -> None:
        self._sync_dead_mask()
        for ext, mask in zip(self.ext_ids, self._dead_mask):
            rows = np.flatnonzero(np.isin(ext.cpu().numpy(), dead))
            mask[torch.as_tensor(rows, device=mask.device)] = True

    def compact(self) -> np.ndarray:
        """Drop tombstones by a rebuild; survivors renumber to [0, L) in
        former global-id order. Returns the survivors' old ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        for st, ext in zip(self.state, self.ext_ids):
            e = ext.cpu().numpy()
            vecs = st.vectors.float()
            if self.cfg.dtype == "int8":
                vecs = vecs * st.q_scale
            sel = e >= 0
            x_all[e[sel]] = vecs.cpu().numpy()[sel]
        self.build(x_all[live])
        return live

    def _sync_dead_mask(self) -> None:
        """Per-shard [cap] dead masks, created or grown to the capacity."""
        cap = self.shard_cap
        if self._dead_mask is None:
            self._dead_mask = [torch.zeros(cap, dtype=torch.bool, device=e.device)
                               for e in self.ext_ids]
        elif self._dead_mask[0].shape[0] < cap:
            grown = []
            for old in self._dead_mask:
                g = torch.zeros(cap, dtype=torch.bool, device=old.device)
                g[:old.shape[0]] = old
                grown.append(g)
            self._dead_mask = grown

    # -- build ------------------------------------------------------------
    def build(self, x) -> None:
        """Bulk build: shard s takes rows [s*per, (s+1)*per) (per =
        ceil(n / S)) at a capacity of per rounded up to the batch; the
        shards' graphs are built together by build_knn_graph_multi, then
        each shard's storage (int8: its own scale) and anchors. Global ids
        are the rows' positions in x."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        x = np.asarray(x, np.float32)
        n, cfg, s = x.shape[0], self.cfg, self.n_shards
        if n and x.shape[-1] != cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {x.shape[-1]}")
        per = -(-n // s) if n else 1
        bsz = min(cfg.build_batch, max(per, 1))
        cap = -(-per // bsz) * bsz
        self.shard_cap = cap
        self._n = n
        self._pending = []
        self._dead = set()
        self._dead_mask = None
        if cfg.metric == "cosine" and n:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

        lohi = [(si * per, min((si + 1) * per, n)) for si in range(s)]
        live = [si for si in range(s) if lohi[si][1] - lohi[si][0] > 0]
        gens = {si: shard_generators(cfg.seed, si) for si in live}
        self.build_stats = [{} for _ in live]
        g_out = build_knn_graph_multi(
            [x[lohi[si][0]:lohi[si][1]] for si in live], cfg.degree,
            [gens[si][0] for si in live], devices=[self.mesh.shard_device(si) for si in live],
            precision=cfg.precision, stats=self.build_stats, metric=cfg.metric,
            block=cfg.block, spill=cfg.spill, passes=cfg.passes, kmeans_iters=cfg.kmeans_iters,
            alpha=cfg.alpha, reps=cfg.seed_reps, n_long=cfg.n_long,
            kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap, block_topk=cfg.block_topk,
            kmeans_sample=cfg.kmeans_sample)

        self.state, self.ext_ids = [], []
        a_count = None
        outs = dict(zip(live, g_out))
        for si in range(s):
            lo, hi = lohi[si]
            dev = self.mesh.shard_device(si)
            ext = torch.full((cap,), -1, dtype=torch.int32, device=dev)
            if si not in outs:
                # tail shards of a small corpus hold no rows; anchors pad below
                st = _empty_cagra_state(cfg, cap, dev)
            else:
                nbrs, dists = outs[si][:2]
                st = _shard_state(cfg, x[lo:hi], nbrs, dists, cap, gens[si][1], dev)
                ext[:hi - lo] = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            if a_count is None:
                a_count = st.anchors.shape[0]
            elif st.anchors.shape[0] != a_count:
                _pad_anchors(st, a_count)   # one anchor count across the shards
            self.state.append(st)
            self.ext_ids.append(ext)
        self._anchor_n = per

    # -- insert -----------------------------------------------------------
    def insert(self, x) -> None:
        """Buffered insert; rows are appended at the next flush (or
        search). Global ids stay dense, in arrival order."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy().copy()
        else:
            x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")
        self._pending.append(x)

    add = insert

    def flush(self) -> None:
        self._flush()

    def _flush(self) -> None:
        """The buffered rows: shard s takes rows [s*per, (s+1)*per) (per =
        ceil(rows / S)) in ceil(per / bsz) steps of bsz = min(build_batch,
        per) rows; every shard grows to max(need, 2 * cap) first when its n
        plus the steps' windows passes the capacity. Once the largest
        shard's n doubles past the last anchor sample, the anchors are
        drawn again. An empty index builds instead."""
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None or self._n == 0:
            # an all-empty state has no anchor tables to seed the extend step with
            base = self._n
            self.build(new)
            self._n = base + new.shape[0]
            return
        s, cfg = self.n_shards, self.cfg
        base = self._n
        per = -(-new.shape[0] // s)
        bsz = min(cfg.build_batch, max(per, 1))
        nb = -(-per // bsz)
        need = max(st.n for st in self.state) + nb * bsz
        if need > self.shard_cap:
            self._grow(max(need, 2 * self.shard_cap))
        for t in range(nb):
            for si, (st, ext) in enumerate(zip(self.state, self.ext_ids)):
                lo = si * per + t * bsz
                hi = min(lo + bsz, min((si + 1) * per, new.shape[0]))
                cnt = max(hi - lo, 0)
                if cnt == 0:
                    continue
                dev = st.vectors.device
                xb = torch.zeros((bsz, cfg.dim), dtype=torch.float32, device=dev)
                xb[:cnt] = torch.from_numpy(new[lo:hi]).to(dev)
                vb = torch.zeros(bsz, dtype=torch.bool, device=dev)
                vb[:cnt] = True
                row0 = st.n
                _extend_batch_impl(st, xb, vb, cfg)
                ext[row0:row0 + cnt] = torch.arange(base + lo, base + hi, dtype=torch.int32,
                                                    device=dev)
        self._n = base + new.shape[0]
        n_after = max(st.n for st in self.state)
        a = self.state[0].anchors.shape[0]
        if a > 0 and n_after >= 2 * max(self._anchor_n, 1):
            seed = int(torch.randint(0, 2**31 - 1 - s, (1,), generator=self._gen))
            make_anchor_reseed(self.mesh, a)(self.state, seed)
            self._anchor_n = n_after

    def _grow(self, new_cap: int) -> None:
        """Every shard's capacity to new_cap rounded up to the batch (the
        trash rows re-created at the new cap)."""
        bsz = min(self.cfg.build_batch, max(new_cap, 1))
        new_cap = -(-new_cap // bsz) * bsz
        cap, deg, d = self.shard_cap, self.cfg.degree, self.cfg.dim
        for si, st in enumerate(self.state):
            dev = st.vectors.device
            vectors = torch.zeros((new_cap, d), dtype=self.cfg.storage_dtype, device=dev)
            vectors[:cap] = st.vectors
            norms = torch.zeros(new_cap, dtype=torch.float32, device=dev)
            norms[:cap] = st.norms
            nbrs = torch.full((new_cap + 1, deg), -1, dtype=torch.int32, device=dev)
            nbrs[:cap] = st.nbrs[:-1]
            dists = torch.full((new_cap + 1, deg), _INF, dtype=torch.float32, device=dev)
            dists[:cap] = st.dists[:-1]
            st.vectors, st.norms, st.nbrs, st.dists = vectors, norms, nbrs, dists
            ext = torch.full((new_cap,), -1, dtype=torch.int32, device=dev)
            ext[:cap] = self.ext_ids[si]
            self.ext_ids[si] = ext
        self.shard_cap = new_cap

    # -- search -----------------------------------------------------------
    def search(self, q, k: int, ef_search: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """kNN over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device; empty slots id -1. allowed: optional allowlist
        over global ids (bool mask or id array). filter_mode "scan" answers
        filtered queries with the exact per-shard masked scan and a global
        merge (parallel/scan_filter.py), "beam" keeps the beam with blocked
        nodes routing but filtered from its final beam, "auto" picks
        (utils/filter_policy.py)."""
        if filter_mode not in ("auto", "scan", "beam"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        self._flush()
        filter_mode = resolve_filter_mode(filter_mode, allowed, self._n, alt="beam")
        cfg = self.cfg
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None, :]
        if q.shape[-1] != cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {q.shape[-1]}")
        if self.state is None or self._n == 0:
            return (torch.full((q.shape[0], k), _INF if cfg.metric == "l2" else -_INF,
                               device=self.device),
                    torch.full((q.shape[0], k), -1, dtype=torch.int32, device=self.device))
        av = None if allowed is None else allowed_mask(allowed, self._n, self._n, self.device)
        if self._dead:
            self._sync_dead_mask()
        blocked = []
        for si, ext in enumerate(self.ext_ids):
            block = None if not self._dead else self._dead_mask[si]
            if av is not None:
                out = ~(av.to(ext.device)[ext.clamp(min=0).long()] & (ext >= 0))
                block = out if block is None else block | out
            blocked.append(block)
        if av is not None and filter_mode == "scan":
            bias, scales = [], []
            for st, block in zip(self.state, blocked):
                bias.append(st.norms + torch.where(block, _INF, 0.0))
                scales.append(torch.full((self.shard_cap,), st.q_scale, dtype=torch.float32,
                                         device=st.vectors.device))
            scan = make_sharded_masked_scan(self.mesh, self.n_data, cfg.metric, cfg.precision,
                                            k, recorder=self.recorder)
            return scan([st.vectors for st in self.state], bias, scales, self.ext_ids, q)
        ef = ef_search if ef_search is not None else cfg.ef_search

        def local(si, st, ext, dead, qs):
            arrs = _SearchArrays(table=st.vectors, norms=st.norms, nbrs=st.nbrs,
                                 anchors=st.anchors, a_norms=st.a_norms, a_rows=st.a_rows,
                                 n=st.n, q_scale=st.q_scale, dead=dead)
            s_, rows = cagra_search_impl(
                arrs, qs, k, cfg.metric, ef, cfg.n_seeds, cfg.expand, cfg.max_iters,
                cfg.precision, packed=False, fat=False, dedupe=True,
                seed_approx=cfg.seed_approx, search_degree=cfg.search_degree)
            return s_, torch.where(rows >= 0, ext[rows.clamp(min=0).long()], -1)

        s_, g = run_shards(self.mesh, local, list(zip(self.state, self.ext_ids, blocked)), q,
                           self.recorder, split_data=self.n_data > 1)
        with merge_span(self.recorder):
            b = s_.shape[0]
            s_, g = s_.reshape(b, -1), g.reshape(b, -1)
            # smaller first: l2 scores ascend, dot/cosine similarities descend
            key = torch.where(g >= 0, s_ if cfg.metric == "l2" else -s_, _INF)
            mk, mi = T.smallest_k(key, g, k)
            merged = mk if cfg.metric == "l2" else -mk
            merged = torch.where(mi >= 0, merged, _INF if cfg.metric == "l2" else -_INF)
        return merged, mi

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: each CagraState field
        stacked on a leading shard axis (n int32 and q_scale f32 as [S]
        arrays, bf16 vectors as f32), ext_ids, tombstones as dead_ext."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), shard_cap=self.shard_cap, n=self._n,
                    n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in _FIELDS:
                parts = []
                for st in self.state:
                    v = getattr(st, f)
                    if f == "n":
                        parts.append(np.asarray(v, np.int32))
                    elif f == "q_scale":
                        parts.append(np.asarray(v, np.float32))
                    else:
                        parts.append((v.float() if v.dtype == torch.bfloat16 else v)
                                     .cpu().numpy())
                arrays[f] = np.stack(parts)
            arrays["ext_ids"] = np.stack([e.cpu().numpy() for e in self.ext_ids])
            if self._dead:
                arrays["dead_ext"] = np.asarray(sorted(self._dead), np.int64)
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None, seed: int = 0) -> "ShardedCagra":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg as a dict, shard_cap, n, n_shards), `arrays` its
        arrays ([S, ...] CagraState fields, ext_ids, an optional dead_ext;
        no vectors: an empty index). Shard s goes to the mesh's cell for s."""
        idx = cls(CagraConfig(**meta["cfg"]), mesh=mesh, seed=seed)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx.shard_cap = int(meta["shard_cap"])
        idx._n = int(meta["n"])
        if "vectors" not in arrays:
            return idx
        idx.state, idx.ext_ids = [], []
        for si in range(idx.n_shards):
            dev = idx.mesh.shard_device(si)
            idx.state.append(state_from_numpy(
                idx.cfg, {f: np.asarray(arrays[f])[si] for f in _FIELDS}, dev))
            idx.ext_ids.append(torch.from_numpy(
                np.asarray(arrays["ext_ids"][si], np.int32)).to(dev))
        idx._anchor_n = int(np.asarray(arrays["n"]).max())
        if "dead_ext" in arrays:
            dead = np.asarray(arrays["dead_ext"], np.int64)
            idx._dead = set(int(i) for i in dead)
            idx._mark(dead)
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedCagra":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)


def _shard_state(cfg: CagraConfig, xs: np.ndarray, nbrs, dists, cap: int,
                 gen: torch.Generator, device) -> CagraState:
    """One shard's CagraState at capacity `cap` from its built graph: the
    stored rows (int8: a scale from the shard's own rows) and an anchor
    table drawn by `gen`, as CagraIndex.build makes them."""
    cnt = xs.shape[0]
    xj = torch.from_numpy(np.ascontiguousarray(xs)).to(device)
    q_scale = 1.0
    if cfg.dtype == "int8":
        q_scale = _f32(max(float(np.abs(xs).max()) if cnt else 1.0, 1e-12) / 127.0)
        stored, norms = D.quantize_corpus_global(xj, cfg.metric, q_scale)
    else:
        stored, norms = D.preprocess_corpus(xj, cfg.metric, cfg.storage_dtype)
    a_rows = _pick_anchor_rows(gen, cnt, cfg.n_anchors, device)
    anchors = stored[a_rows.long()].float() * q_scale
    a_norms = norms[a_rows.long()] if cfg.metric == "l2" else \
        torch.zeros(a_rows.shape[0], dtype=torch.float32, device=device)
    st = _empty_cagra_state(cfg, cap, device)
    st.vectors[:cnt] = stored
    st.norms[:cnt] = norms
    st.nbrs[:cnt] = nbrs[:cnt].to(device)
    st.dists[:cnt] = dists[:cnt].to(device)
    st.anchors, st.a_norms, st.a_rows = anchors, a_norms, a_rows
    st.n, st.q_scale = cnt, q_scale
    return st


def _empty_cagra_state(cfg: CagraConfig, cap: int, device) -> CagraState:
    """A zero-row shard at capacity `cap`: all-invalid adjacency, no anchors."""
    d, deg = cfg.dim, cfg.degree
    return CagraState(
        vectors=torch.zeros((cap, d), dtype=cfg.storage_dtype, device=device),
        norms=torch.zeros(cap, dtype=torch.float32, device=device),
        nbrs=torch.full((cap + 1, deg), -1, dtype=torch.int32, device=device),
        dists=torch.full((cap + 1, deg), _INF, dtype=torch.float32, device=device),
        anchors=torch.zeros((0, d), dtype=torch.float32, device=device),
        a_norms=torch.zeros(0, dtype=torch.float32, device=device),
        a_rows=torch.zeros(0, dtype=torch.int32, device=device),
        n=0, q_scale=1.0)


def _pad_anchors(st: CagraState, a_count: int) -> None:
    """The anchor table cut or padded to a_count rows, in place (padding:
    zero rows, a_norms +inf so they never seed, row 0)."""
    pad = a_count - st.anchors.shape[0]
    if pad <= 0:
        st.anchors, st.a_norms, st.a_rows = (st.anchors[:a_count], st.a_norms[:a_count],
                                             st.a_rows[:a_count])
        return
    st.anchors = torch.cat([st.anchors, st.anchors.new_zeros((pad, st.anchors.shape[1]))])
    st.a_norms = torch.cat([st.a_norms, st.a_norms.new_full((pad,), _INF)])
    st.a_rows = torch.cat([st.a_rows, st.a_rows.new_zeros(pad)])
