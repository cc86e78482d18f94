"""Mesh-sharded IVF-Flat: clusters are the sharding unit (port of
zvdb_tpu/parallel/sharded_ivf.py).

A build is one global single-chip build (index/ivf.py: k-means, the split,
the block pack), then a placement: clusters go greedily, largest first, to
the least-loaded shard, so the shards' scan work balances. Each shard holds
a complete IVFState over its clusters on its device. Queries are replicated:
every shard probes its own best ceil(nprobe / S) + 1 local clusters with the
pair or grouped scan (index/ivf.py:use_pair_scan decides a shard at a time,
on its own cluster count), and the [B, S*k] candidates are merged on the
mesh's merge device (parallel/sharded.py:run_shards).

Rerank: each shard keeps the shadow rows of the points in its clusters in
dense local-id order and a local -> global id map; block ids are local
during the scan and map to global ids after the rerank (ivf_search_impl's
`id_map`). An index without rerank keeps global block ids until its first
append or probe-filtered search converts it to the same layout.

Insert: new rows are routed on the host to their nearest global centroid
(numpy, the JAX package's expression, so the argmins agree), bucketed per
owning shard and appended into spare block capacity (index/ivf.py:
_ivf_append); a block overflow rebuilds everything from the reconstructed
rows instead (ids stay stable).

The state is a list of per-shard IVFStates with `c_mask` and `id_map`
lists beside it; `n` is a host int a shard (JAX stacks an [S] array). Save
files stack the shards on a leading axis in the JAX package's format. The
IVF path runs no hand-written kernel, in either package.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np
import torch

from ..index.ivf import (
    _STATE_FIELDS, IVFConfig, IVFIndex, IVFState, _ivf_append, ivf_search_impl,
    state_from_numpy,
)
from ..ops import topk as T
from ..utils.filter_policy import resolve_filter_mode
from ..utils.masks import allowed_mask
from .mesh import SHARD_AXIS, make_mesh
from .scan_filter import make_sharded_masked_scan
from .sharded import merge_span, place_clusters, run_shards

_INF = float("inf")


class ShardedIVF:
    """IVF index with clusters sharded over a device mesh."""

    def __init__(self, cfg: IVFConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one IVFState per shard
        self.c_mask: Optional[list] = None       # per shard [C_loc] bool: real clusters
        self.id_map: Optional[list] = None       # per shard [rcap] int32 local -> global
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._cent_host: Optional[np.ndarray] = None   # [C_glob, D]
        self._cluster_of: Optional[np.ndarray] = None  # [C_glob, 2] (shard, local cluster)
        self._dead: set[int] = set()                   # tombstoned global ids
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    def _check_dim(self, x) -> None:
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    # -- delete -----------------------------------------------------------
    def remove(self, ids) -> int:
        """Tombstone by global id (-2-id in the block ids, which every scan
        masks). Ids never renumber. Returns the number newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        self._flush()
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        new = np.asarray([int(i) for i in ids if int(i) not in self._dead], np.int64)
        if new.size == 0:
            return 0
        self._dead.update(int(i) for i in new)
        self._mark_dead(new)
        return int(new.size)

    def _decoded_slot_globals(self, si: int, enc: np.ndarray):
        """(decoded slot values, global id a slot) of shard si's block ids:
        local ids when an id map exists, else global; tombstones -2-v."""
        dec = np.where(enc <= -2, -2 - enc, enc)
        if self.id_map is None:
            return dec, dec.astype(np.int64)
        im = self.id_map[si].cpu().numpy()
        glob = np.full(dec.shape, -1, np.int64)
        m = dec >= 0
        glob[m] = im[dec[m]]
        return dec, glob

    def _mark_dead(self, dead_ids: np.ndarray) -> None:
        if dead_ids.size == 0 or self.state is None:
            return
        for si, st in enumerate(self.state):
            enc = st.b_ids.cpu().numpy()
            dec, glob = self._decoded_slot_globals(si, enc)
            cc, ss = np.nonzero(np.isin(glob, dead_ids) & (glob >= 0) & (enc >= 0))
            if cc.size:
                dev = st.b_ids.device
                st.b_ids[torch.from_numpy(cc).to(dev), torch.from_numpy(ss).to(dev)] = \
                    torch.from_numpy((-2 - dec[cc, ss]).astype(np.int32)).to(dev)

    # -- build ------------------------------------------------------------
    def build(self, x) -> None:
        """One global single-chip build on the merge device, then the
        cluster placement (_place). Global ids are the rows' positions."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        x = np.asarray(x, np.float32)
        single = IVFIndex(self.cfg, device=self.device)
        single.build(x)
        self._pending = []
        if single.state is None:
            self.state = self.c_mask = self.id_map = None
            self._n = 0
            self._dead = set()
            return
        if self.cfg.metric == "cosine":
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        self._place(single.state, x)

    def _place(self, st: IVFState, x: np.ndarray) -> None:
        """Distribute a built single-chip state over the shards: clusters
        largest first (stable), each to the least-loaded shard; per shard
        its blocks padded to C_loc clusters (c_norms and b_norms +inf,
        b_scales 1, b_ids -1, counts 0). With rerank, each shard's block
        ids become local ids in block order, its shadow store holds those
        rows of x (the preprocessed corpus, in global-id order) in a store
        of max(1024, ceil(max rows / 1024) * 1024 + 1024) rows, and the id
        map holds their global ids; `n` is a shard's row count."""
        cfg, s = self.cfg, self.n_shards
        self._n = int(st.n)
        self._pending = []
        self._dead = set()
        members, self._cluster_of = place_clusters(st.counts.cpu().numpy(), s)
        c_loc = max(len(m) for m in members)
        self._cent_host = st.centroids.cpu().numpy()

        b_ids = st.b_ids.cpu().numpy()            # global ids at this point
        bids = []
        for m in members:
            bid = np.full((c_loc,) + b_ids.shape[1:], -1, np.int32)
            bid[:len(m)] = b_ids[m]
            bids.append(bid)
        n_loc = [int((bid >= 0).sum()) for bid in bids]
        rcap = max(1024, -(-max(n_loc) // 1024) * 1024 + 1024)
        src = st.blocks.device
        self.state, self.c_mask = [], []
        self.id_map = [] if cfg.rerank else None
        for si, m in enumerate(members):
            dev = self.mesh.shard_device(si)
            mi = torch.as_tensor(m, dtype=torch.long, device=src)

            def stack(t, pad):
                out = t.new_full((c_loc,) + tuple(t.shape[1:]), pad)
                out[:len(m)] = t[mi]
                return out.to(dev)

            bid = bids[si]
            if cfg.rerank:
                sel = bid >= 0
                glob = bid[sel]                       # block order
                loc = np.full(self._n, -1, np.int64)
                loc[glob] = np.arange(glob.size)
                bid[sel] = loc[glob]
                idmap = np.full(rcap, -1, np.int32)
                idmap[:glob.size] = glob
                rows = x[glob]
                shadows = np.zeros((rcap, cfg.dim), np.float32)
                shadows[:glob.size] = rows
                shadow_norms = np.zeros(rcap, np.float32)
                if cfg.metric == "l2":
                    shadow_norms[:glob.size] = (rows.astype(np.float64) ** 2).sum(-1) \
                        .astype(np.float32)
                rr = torch.from_numpy(shadows).to(dev).to(
                    torch.float32 if cfg.rerank_dtype == "float32" else torch.bfloat16)
                rrn = torch.from_numpy(shadow_norms).to(dev)
                self.id_map.append(torch.from_numpy(idmap).to(dev))
            else:
                rr = torch.zeros((0, cfg.dim), dtype=torch.bfloat16, device=dev)
                rrn = torch.zeros(0, dtype=torch.float32, device=dev)
            mask = np.zeros(c_loc, bool)
            mask[:len(m)] = True
            self.state.append(IVFState(
                centroids=stack(st.centroids, 0.0), c_norms=stack(st.c_norms, _INF),
                blocks=stack(st.blocks, 0), b_norms=stack(st.b_norms, _INF),
                b_scales=stack(st.b_scales, 1.0), b_ids=torch.from_numpy(bid).to(dev),
                counts=stack(st.counts, 0), n=n_loc[si], rerank_vecs=rr, rerank_norms=rrn))
            self.c_mask.append(torch.from_numpy(mask).to(dev))

    # -- search -----------------------------------------------------------
    def _masked_scan(self, q: torch.Tensor, k: int, allowed):
        """Exact filtered search: each shard's blocks as [C_loc * cap, D]
        rows with their scales and global ids, the allowlist and the
        tombstones (negative block ids) folded into the norms' bias."""
        av = allowed_mask(allowed, self._n, self._n, self.device)
        rows, bias, scales, gids = [], [], [], []
        for si, st in enumerate(self.state):
            bi = st.b_ids.reshape(-1)
            if self.id_map is not None:   # the local-id layout -> global ids
                gi = torch.where(bi >= 0, self.id_map[si][bi.clamp(min=0).long()], -1)
            else:
                gi = torch.where(bi >= 0, bi, -1)
            ok = (gi >= 0) & av.to(gi.device)[gi.clamp(min=0).long()]
            rows.append(st.blocks.reshape(-1, self.cfg.dim))
            bias.append(st.b_norms.reshape(-1) + torch.where(ok, 0.0, _INF))
            scales.append(st.b_scales.reshape(-1))
            gids.append(torch.where(ok, gi, -1))
        scan = make_sharded_masked_scan(self.mesh, 1, self.cfg.metric, self.cfg.precision, k,
                                        recorder=self.recorder)
        return scan(rows, bias, scales, gids, q)

    def search(self, q, k: int, nprobe: Optional[int] = None, allowed=None,
               filter_mode: str = "scan"):
        """Top-k over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device. `nprobe` is a global budget: each shard probes
        its best min(max(1, ceil(nprobe / S) + 1), C_loc) local clusters.
        allowed (a bool mask over ids or an id list): "scan" (float dtypes)
        is the exact per-shard masked scan over the blocks; "probe" (and
        int8, which has no exact row form) filters each shard's probe pool,
        widened 8x, converting the index to the id-map layout on first use;
        "auto" picks (utils/filter_policy.py)."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        self._flush()
        if filter_mode == "auto":
            filter_mode = resolve_filter_mode("auto", allowed, self._n, alt="probe")
        cfg = self.cfg
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None, :]
        self._check_dim(q)
        b = q.shape[0]
        if self.state is None or self._n == 0:
            return (torch.full((b, k), _INF if cfg.metric == "l2" else -_INF, device=self.device),
                    torch.full((b, k), -1, dtype=torch.int32, device=self.device))
        if allowed is not None and filter_mode == "scan" and cfg.dtype != "int8":
            return self._masked_scan(q, k, allowed)
        p_loc = min(max(1, -(-(nprobe or cfg.nprobe) // self.n_shards) + 1),
                    self.state[0].centroids.shape[0])
        allows = [None] * self.n_shards
        if allowed is not None:
            if self.id_map is None:
                self._ensure_id_map(headroom=1024)
            av = allowed_mask(allowed, self._n, self._n, self.device)
            allows = [av.to(im.device)[im.clamp(min=0).long()] & (im >= 0) for im in self.id_map]
        maps = self.id_map if self.id_map is not None else [None] * self.n_shards

        def local(si, st, cm, im, al, qs):
            return ivf_search_impl(
                st, qs, k, p_loc, cfg.metric, cfg.precision, residual=cfg.dtype == "int8",
                rerank=cfg.rerank, allowed=al, filter_widen=8 if al is not None else 1,
                c_mask=cm, id_map=im)

        s_, i_ = run_shards(self.mesh, local, list(zip(self.state, self.c_mask, maps, allows)),
                            q, self.recorder, split_data=False)
        with merge_span(self.recorder):
            # smaller first: l2 distances ascend, dot/cosine similarities descend
            key = s_.reshape(b, -1) if cfg.metric == "l2" else -s_.reshape(b, -1)
            ms, mi = T.smallest_k(key, i_.reshape(b, -1), k)
        return (ms if cfg.metric == "l2" else -ms), mi

    # -- insert -----------------------------------------------------------
    def add(self, x) -> None:
        """Buffered append (centroids frozen); global ids stay dense
        insertion order."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy().copy()
        else:
            x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        self._check_dim(x)
        self._pending.append(x)

    insert = add

    def flush(self) -> None:
        self._flush()

    def _route(self, new: np.ndarray) -> np.ndarray:
        """Nearest global centroid of each row by squared L2, in numpy with
        the JAX package's expression and chunks (4,096 rows once rows x
        clusters reaches 4,000,000), so the argmins agree bit for bit."""
        cent = self._cent_host
        if new.shape[0] * len(cent) < 4_000_000:
            return ((new[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
        a = np.empty(new.shape[0], np.int64)
        for lo in range(0, new.shape[0], 4096):
            a[lo:lo + 4096] = ((new[lo:lo + 4096, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
        return a

    def _flush(self) -> None:
        """Route the buffered rows and append them a shard at a time, in a
        batch padded to chunk = 2^max(9, ceil(log2 of the largest shard's
        share)) rows; a block overflow rebuilds instead (_rebuild_with)."""
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        cfg, s = self.cfg, self.n_shards
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        a = self._route(new)
        shard_of = self._cluster_of[a, 0]
        local_cl = self._cluster_of[a, 1]
        bcap = self.state[0].blocks.shape[1]
        counts = np.stack([st.counts.cpu().numpy() for st in self.state])   # [S, C_loc]
        addc = np.zeros_like(counts)
        np.add.at(addc, (shard_of, local_cl), 1)
        per_shard = np.bincount(shard_of, minlength=s)
        chunk = 1 << max(9, int(math.ceil(math.log2(max(int(per_shard.max()), 1)))))
        if int((counts + addc).max()) > bcap:   # a cluster block would overflow
            self._rebuild_with(new)
            return
        # appends always use local block ids and an id map; a global-id
        # index converts on its first append
        self._ensure_id_map(headroom=8 * chunk)
        for si, st in enumerate(self.state):
            rows = np.flatnonzero(shard_of == si)
            dev = st.blocks.device
            xb = torch.zeros((chunk, cfg.dim), dtype=torch.float32, device=dev)
            xb[:rows.size] = torch.from_numpy(new[rows]).to(dev)
            ab = torch.zeros(chunk, dtype=torch.int64, device=dev)
            ab[:rows.size] = torch.from_numpy(local_cl[rows].astype(np.int64)).to(dev)
            vb = torch.zeros(chunk, dtype=torch.bool, device=dev)
            vb[:rows.size] = True
            base = st.n                               # the local offset (= local rows)
            _ivf_append(st, xb, ab, vb, base, cfg.metric, cfg.dtype, rerank=bool(cfg.rerank))
            gids = np.full(chunk, -1, np.int32)
            gids[:rows.size] = self._n + rows
            self.id_map[si][base:base + chunk] = torch.from_numpy(gids).to(dev)
        self._n += new.shape[0]

    def _ensure_id_map(self, headroom: int) -> None:
        """Convert a global-id (non-rerank) index to local ids and an id
        map, or widen the map (and the shadow stores) so that `headroom`
        rows past the largest shard's n fit."""
        n_max = max(st.n for st in self.state)
        if self.id_map is not None and n_max + headroom <= self.id_map[0].shape[0]:
            return
        rcap = max(1024, -(-(n_max + headroom) // 1024) * 1024)
        maps = []
        for si, st in enumerate(self.state):
            dev = st.b_ids.device
            idmap = np.full(rcap, -1, np.int32)
            if self.id_map is not None:
                old = self.id_map[si].cpu().numpy()
                w = min(old.size, rcap)
                idmap[:w] = old[:w]
            else:
                enc = st.b_ids.cpu().numpy()
                dec = np.where(enc <= -2, -2 - enc, enc)   # decode tombstones
                sel = dec >= 0                             # live and tombstoned
                glob = dec[sel]
                idmap[:glob.size] = glob
                loc = np.full(self._n, -1, np.int64)
                loc[glob] = np.arange(glob.size)
                vals = loc[glob]
                # tombstoned slots stay tombstoned in the local encoding
                enc[sel] = np.where(enc[sel] <= -2, -2 - vals, vals)
                st.b_ids = torch.from_numpy(enc).to(dev)
            maps.append(torch.from_numpy(idmap).to(dev))
            if self.cfg.rerank and st.rerank_vecs.shape[0] < rcap:
                rr = st.rerank_vecs.new_zeros((rcap, self.cfg.dim))
                rr[:st.rerank_vecs.shape[0]] = st.rerank_vecs
                rrn = st.rerank_norms.new_zeros(rcap)
                rrn[:st.rerank_norms.shape[0]] = st.rerank_norms
                st.rerank_vecs, st.rerank_norms = rr, rrn
        self.id_map = maps

    def _reconstruct_global(self, extra_rows: int = 0) -> np.ndarray:
        """Every stored row in global-id order [n (+ extra_rows), D] f32:
        the shadow stores, or the (dequantized) blocks. Tombstoned rows
        are decoded and included (their ids stay occupied)."""
        x_all = np.empty((self._n + extra_rows, self.cfg.dim), np.float32)
        for si, st in enumerate(self.state):
            if self.id_map is not None and self.cfg.rerank:
                im = self.id_map[si].cpu().numpy()
                sel = im >= 0
                x_all[im[sel]] = st.rerank_vecs.float().cpu().numpy()[sel]
                continue
            blocks = st.blocks.float().cpu().numpy()
            if self.cfg.dtype == "int8":
                blocks = blocks * st.b_scales.cpu().numpy()[..., None] \
                    + st.centroids.cpu().numpy()[:, None, :]
            dec, glob = self._decoded_slot_globals(si, st.b_ids.cpu().numpy())
            sel = dec >= 0
            x_all[glob[sel]] = blocks[sel]
        return x_all

    def _rebuild_with(self, new: np.ndarray) -> None:
        """Overflow fallback: every stored row in global-id order plus the
        new rows, rebuilt and placed again (ids stay stable; the
        tombstones are marked again after)."""
        x_all = self._reconstruct_global(extra_rows=new.shape[0])
        x_all[self._n:] = new
        n_total = self._n + new.shape[0]
        dead = self._dead
        self.build(x_all)
        self._n = n_total
        if dead:
            self._dead = dead
            self._mark_dead(np.asarray(sorted(dead), np.int64))

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
        self.build(self._reconstruct_global()[live])
        return live

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: each IVFState field
        stacked on a leading shard axis (bf16 as f32, n as int32 [S]),
        c_mask, id_map (when the index has one), the host maps; tombstones
        ride in b_ids."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n, n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in _STATE_FIELDS:
                parts = []
                for st in self.state:
                    v = getattr(st, f)
                    parts.append(np.asarray(v, np.int32) if f == "n" else
                                 (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy())
                arrays[f] = np.stack(parts)
            arrays["c_mask"] = np.stack([m.cpu().numpy() for m in self.c_mask])
            if self.id_map is not None:
                arrays["id_map"] = np.stack([m.cpu().numpy() for m in self.id_map])
            arrays["cent_host"] = self._cent_host
            arrays["cluster_of"] = self._cluster_of
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None) -> "ShardedIVF":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg as a dict, n, n_shards), `arrays` its arrays
        ([S, ...] IVFState fields, c_mask, an optional id_map, cent_host,
        cluster_of; no centroids: an empty index). Tombstones are read
        from b_ids."""
        cfg = IVFConfig(**meta["cfg"])
        idx = cls(cfg, mesh=mesh)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx._n = int(meta["n"])
        if "centroids" not in arrays:
            return idx
        idx.state, idx.c_mask = [], []
        idx.id_map = [] if "id_map" in arrays else None
        for si in range(idx.n_shards):
            dev = idx.mesh.shard_device(si)
            idx.state.append(state_from_numpy(
                cfg, {f: np.asarray(arrays[f])[si] for f in _STATE_FIELDS}, dev))
            idx.c_mask.append(torch.from_numpy(np.asarray(arrays["c_mask"][si], bool)).to(dev))
            if idx.id_map is not None:
                idx.id_map.append(torch.from_numpy(
                    np.asarray(arrays["id_map"][si], np.int32)).to(dev))
        idx._cent_host = np.asarray(arrays["cent_host"], np.float32)
        idx._cluster_of = np.asarray(arrays["cluster_of"], np.int32)
        for si in range(idx.n_shards):   # tombstones ride in the encoding
            enc = np.asarray(arrays["b_ids"][si])
            _, glob = idx._decoded_slot_globals(si, enc)
            idx._dead.update(int(g) for g in glob[(enc <= -2) & (glob >= 0)])
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedIVF":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)
