"""Mesh-sharded brute-force search (port of zvdb_tpu/parallel/sharded_flat.py).

The corpus is split over the mesh's shard axis; each shard scores its rows
with one dense product and keeps its top-k, and the [B, S*k] candidates are
merged on the mesh's merge device (parallel/sharded.py:run_shards). There
is no cross-shard traffic until that merge. As in JAX, the queries are not
split over a data axis: every shard scores the whole batch.

As in the single-chip FlatIndex of the port, `approx=True` selects exactly
(PyTorch has no approx_min_k), so its recall is at least the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..index.flat import tensor_from_numpy
from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import FlatConfig
from .mesh import SHARD_AXIS, make_mesh
from .sharded import merge_span, run_shards

_INF = float("inf")
_FIELDS = ("vectors", "norms", "ids")


class ShardedFlat:
    """Brute-force index sharded over a device mesh. Each shard's state is
    a dict of vectors [cap, D] (storage dtype), norms [cap] f32 (+inf on
    padding and tombstones: the validity bias) and ids [cap] int32 global
    ids (-1 on padding), on the shard's device."""

    def __init__(self, cfg: FlatConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one dict of tensors per shard
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._per_shard_n: Optional[np.ndarray] = None   # slots used, tombstones included
        self._dead: set[int] = set()   # tombstoned global ids
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    def _ids_np(self):
        return [st["ids"].cpu().numpy() for st in self.state]

    def remove(self, ids) -> int:
        """Delete by global id (tombstone: the rows' norm validity bias
        becomes +inf; ids never renumber). Returns the number of rows newly
        deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        self._flush()
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        new = np.asarray([int(i) for i in ids if int(i) not in self._dead], np.int64)
        if new.size == 0:
            return 0
        for st, grid in zip(self.state, self._ids_np()):
            rows = np.flatnonzero(np.isin(grid, new))
            st["norms"][torch.as_tensor(rows, device=st["norms"].device)] = _INF
        self._dead.update(int(i) for i in new)
        return int(new.size)

    def compact(self) -> np.ndarray:
        """Drop tombstones; survivors renumber to [0, L) in former global-id
        order (one re-shard + rebuild from the stored rows). Returns the
        survivors' old ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        for st, grid in zip(self.state, self._ids_np()):
            sel = grid >= 0
            x_all[grid[sel]] = st["vectors"].float().cpu().numpy()[sel]
        self.build(x_all[live])
        return live

    def _ingest(self, xb: np.ndarray, idb: np.ndarray, dev):
        """Stored rows, norms (+inf where idb < 0) and ids of one shard's block."""
        ids = torch.from_numpy(idb).to(dev)
        stored, norms = D.preprocess_corpus(torch.from_numpy(xb).to(dev), self.cfg.metric,
                                            self.cfg.storage_dtype)
        return stored, torch.where(ids >= 0, norms, _INF), ids

    def build(self, x) -> None:
        """Replace the contents: shard s holds rows [s*per, (s+1)*per), per =
        ceil(n / S), with their positions in x as global ids."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        x = np.asarray(x, np.float32)
        n, s = x.shape[0], self.n_shards
        if n and x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")
        per = -(-max(n, 1) // s)
        self._n = n
        self.state = []
        counts = np.zeros(s, np.int64)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            xs = np.zeros((per, self.cfg.dim), np.float32)
            ids = np.full(per, -1, np.int32)
            if hi > lo:
                xs[:hi - lo] = x[lo:hi]
                ids[:hi - lo] = np.arange(lo, hi, dtype=np.int32)
                counts[si] = hi - lo
            self.state.append(dict(zip(_FIELDS, self._ingest(xs, ids,
                                                             self.mesh.shard_device(si)))))
        self._per_shard_n = counts
        self._pending = []
        self._dead = set()

    # -- incremental insert -----------------------------------------------
    def add(self, x) -> None:
        """Buffered append, flushed on the next search. New rows go to the
        least-loaded shards; global ids stay dense, in insertion order."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy().copy()
        else:
            x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        self._pending.append(x)

    insert = add

    def flush(self) -> None:
        self._flush()

    def _flush(self) -> None:
        """The buffered rows in chunks of per = ceil(rows / S), chunk j to
        the shard j-th in a stable argsort of the per-shard counts (the
        least loaded first); every shard grows to max(need, 2 * cap) first
        when one would overflow."""
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        s = self.n_shards
        order = np.argsort(self._per_shard_n, kind="stable")
        per = -(-new.shape[0] // s)
        shard_of = np.empty(new.shape[0], np.int64)
        for j, si in enumerate(order):
            shard_of[j * per:(j + 1) * per] = si
        added = np.bincount(shard_of, minlength=s)
        need = int((added + self._per_shard_n).max())
        cap = self.state[0]["vectors"].shape[0]
        if need > cap:
            self._grow(max(need, 2 * cap))
        for si in range(s):
            rows = np.flatnonzero(shard_of == si)
            if rows.size == 0:
                continue
            st = self.state[si]
            stored, norms, ids = self._ingest(
                new[rows], (self._n + rows).astype(np.int32), st["vectors"].device)
            lo, hi = int(self._per_shard_n[si]), int(self._per_shard_n[si]) + rows.size
            st["vectors"][lo:hi] = stored
            st["ids"][lo:hi] = ids
            st["norms"][lo:hi] = norms
        self._per_shard_n = self._per_shard_n + added
        self._n += new.shape[0]

    def _grow(self, new_cap: int) -> None:
        grown = []
        for st in self.state:
            cap, dev = st["vectors"].shape[0], st["vectors"].device
            g = dict(vectors=torch.zeros((new_cap, self.cfg.dim), dtype=st["vectors"].dtype,
                                         device=dev),
                     norms=torch.full((new_cap,), _INF, dtype=torch.float32, device=dev),
                     ids=torch.full((new_cap,), -1, dtype=torch.int32, device=dev))
            for f in _FIELDS:
                g[f][:cap] = st[f]
            grown.append(g)
        self.state = grown

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: the shards' arrays
        stacked on a leading shard axis (bf16 vectors as f32); tombstones
        ride in norms (+inf on a row with an id)."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n, n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in _FIELDS:
                arrays[f] = np.stack([(st[f].float() if st[f].dtype == torch.bfloat16
                                       else st[f]).cpu().numpy() for st in self.state])
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None) -> "ShardedFlat":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg as a dict, n, n_shards), `arrays` maps vectors,
        norms and ids to [S, cap, ...] numpy arrays (absent: an empty index)."""
        cfg = FlatConfig(**meta["cfg"])
        idx = cls(cfg, mesh=mesh)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx._n = meta["n"]
        if "vectors" in arrays:
            ids = np.asarray(arrays["ids"])
            norms = np.asarray(arrays["norms"], np.float32)
            vecs = np.asarray(arrays["vectors"], np.float32)
            idx.state = []
            for si in range(idx.n_shards):
                dev = idx.mesh.shard_device(si)
                idx.state.append(dict(
                    vectors=tensor_from_numpy(vecs[si], dev).to(cfg.storage_dtype),
                    norms=tensor_from_numpy(norms[si], dev),
                    ids=tensor_from_numpy(ids[si].astype(np.int32), dev)))
            idx._per_shard_n = (ids >= 0).sum(1)
            # tombstones ride in norms: a live slot (id >= 0) with an inf norm
            idx._dead = set(int(i) for i in ids[(ids >= 0) & np.isinf(norms)])
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedFlat":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)

    # -- search -----------------------------------------------------------
    def _queries(self, q) -> torch.Tensor:
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None, :]
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}")
        return q

    def _empty(self, b: int, width: int):
        return (torch.full((b, width), _INF if self.cfg.metric == "l2" else -_INF,
                           device=self.device),
                torch.full((b, width), -1, dtype=torch.int32, device=self.device))

    def _shard_scores(self, v, nn, ii, q):
        """A shard's surrogate scores [B, cap], +inf on rows without an id."""
        qp = D.preprocess_queries(q, self.cfg.metric)
        s = D.pairwise_scores(qp, v, nn, self.cfg.metric, precision=self.cfg.precision)
        return qp, torch.where(ii[None, :] >= 0, s, _INF)

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius` over every shard (squared L2 <=
        radius for l2, similarity >= radius otherwise). Returns (scores [B,
        R], ids [B, R], counts [B]); counts is the exact global in-range
        total (per-shard counts summed), and a row holds the R globally best
        when truncated: each shard contributes its top R."""
        self._flush()
        q = self._queries(q)
        b, metric = q.shape[0], self.cfg.metric
        is_l2 = metric == "l2"
        if self.state is None or self._n == 0:
            return (*self._empty(b, max_results),
                    torch.zeros((b,), dtype=torch.int32, device=self.device))

        def local(si, v, nn, ii, qs):
            qp, s = self._shard_scores(v, nn, ii, qs)
            user = D.finalize_scores(s, qp, metric)
            in_r = torch.isfinite(s) & ((user <= radius) if is_l2 else (user >= radius))
            cnt = in_r.sum(dim=-1, dtype=torch.int32)
            kk = min(max_results, s.shape[-1])
            ts, ti = T.smallest_k(s, ii[None, :].expand(s.shape), kk)
            ti = torch.where(torch.isfinite(ts), ti, -1)
            if kk < max_results:
                pad = (ts.shape[0], max_results - kk)
                ts = torch.cat([ts, ts.new_full(pad, _INF)], dim=1)
                ti = torch.cat([ti, ti.new_full(pad, -1)], dim=1)
            return ts, ti, cnt

        ts, ti, cnt = run_shards(self.mesh, local,
                                 [(st["vectors"], st["norms"], st["ids"]) for st in self.state],
                                 q, self.recorder, split_data=False)
        with merge_span(self.recorder):
            counts = cnt.sum(dim=-1, dtype=torch.int32)
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), max_results)
            user = D.finalize_scores(ms, D.preprocess_queries(q, metric), metric)
            in_r = (mi >= 0) & ((user <= radius) if is_l2 else (user >= radius))
            mi = torch.where(in_r, mi, -1)
            user = torch.where(in_r, user, _INF if is_l2 else -_INF)
        return user, mi, counts

    def search(self, q, k: int, approx: bool = True, allowed=None):
        """Top-k over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device. allowed: optional allowlist over global ids
        (bool mask or id array): filtered search, exact at any selectivity
        (one validity-bias mask over the full scan). approx selects exactly
        either way."""
        from ..utils.masks import allowed_mask

        self._flush()
        q = self._queries(q)
        b, metric = q.shape[0], self.cfg.metric
        if self.state is None or self._n == 0:
            return self._empty(b, k)
        args = [(st["vectors"], st["norms"], st["ids"]) for st in self.state]
        if allowed is not None:
            av = allowed_mask(allowed, self._n, self._n, self.device)
            for si, (v, nn, ii) in enumerate(args):
                ok = av.to(ii.device)[ii.clamp(min=0).long()] & (ii >= 0)
                args[si] = (v, torch.where(ok, nn, _INF), ii)

        def local(si, v, nn, ii, qs):
            _, s = self._shard_scores(v, nn, ii, qs)
            ts, ti = T.smallest_k(s, ii[None, :].expand(s.shape), min(k, s.shape[-1]))
            # a tombstoned row carries a live-looking id but an inf score:
            # it never surfaces when fewer than k finite candidates exist
            return ts, torch.where(torch.isfinite(ts), ti, -1)

        ts, ti = run_shards(self.mesh, local, args, q, self.recorder, split_data=False)
        with merge_span(self.recorder):
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), k)
            user = D.finalize_scores(ms, D.preprocess_queries(q, metric), metric)
            user = torch.where(mi >= 0, user, _INF if metric == "l2" else -_INF)
        return user, mi
