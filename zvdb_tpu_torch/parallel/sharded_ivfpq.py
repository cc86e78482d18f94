"""Mesh-sharded IVF-PQ: the scale tier over a device mesh (port of
zvdb_tpu/parallel/sharded_ivfpq.py).

Clusters are the sharding unit. A build is one global single-chip build
(index/ivfpq.py: k-means, PQ codebooks, packed code blocks), then a
placement: clusters go greedily, largest first, to the least-loaded shard,
so the shards' scan work balances. Each shard holds a complete IVFPQState
over its clusters on its device: packed 4-bit codes, decoded norms, local
block ids, its clusters' refine rows in dense local-id order and a
local -> global id map. Queries are replicated: every shard probes its own
best ceil(nprobe / S) + 1 local clusters with the grouped ADC kernel C
(ops/pq_scan.py:pq_grouped_scan_bins, one launch a shard a batch), refines
against its own store, and the [B, S*k] candidates are merged on the mesh's
merge device (parallel/sharded.py:run_shards).

Filtered search defaults to the exact masked scan over the shards' refine
stores (parallel/scan_filter.py); filter_mode="probe" filters the probe pool
instead, with an 8x deeper rerank.

The state is a list of per-shard IVFPQStates (the codebooks and rotation
shared, not copied, between shards on one device), with `c_mask` and
`id_map` lists beside it; save files stack them on a leading shard axis as
JAX's do. Differences from the JAX package, by design: training draws from
the port's generators (`from_numpy` and `load` carry a JAX-built index
across); an append whose padded batch would run past a shard's refine store
writes only the rows that fit (JAX's dynamic_update_slice would move the
write back over live rows; every real row always fits).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..index.ivfpq import (
    _STATE_FIELDS, IVFPQConfig, IVFPQIndex, IVFPQState, _ivfpq_append, ivfpq_search_impl,
    nearest_centroids, state_from_numpy,
)
from ..ops import distance as D
from ..ops import topk as T
from .mesh import SHARD_AXIS, make_mesh
from .scan_filter import make_sharded_masked_scan
from .sharded import merge_span, place_clusters, run_shards

_INF = float("inf")


class ShardedIVFPQ:
    """IVF-PQ index with clusters sharded over a device mesh."""

    def __init__(self, cfg: IVFPQConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one IVFPQState per shard
        self.c_mask: Optional[list] = None       # per shard [C_loc] bool: real clusters
        self.id_map: Optional[list] = None       # per shard [rcap] int32 local -> global
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._cent_host: Optional[np.ndarray] = None   # [C_glob, D]
        self._cluster_of: Optional[np.ndarray] = None  # [C_glob, 2] (shard, local cluster)
        self._owner: Optional[np.ndarray] = None       # [n] global id -> shard
        self._lid: Optional[np.ndarray] = None         # [n] global id -> local id
        self._n_loc: Optional[np.ndarray] = None       # [S] local rows, tombstones included
        self._dead: set[int] = set()
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    def _check_dim(self, x) -> None:
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    # -- construction -----------------------------------------------------
    def build(self, x) -> None:
        """One global single-chip build on the merge device, then the
        cluster placement. Global ids stay dense insertion order; each
        shard's refine store takes its rows in local-id order."""
        if self.cfg.refine == "none":
            raise ValueError(
                "ShardedIVFPQ requires a refine store (the per-shard exact rerank and the "
                "filtered masked scan both read it)")
        single = IVFPQIndex(self.cfg, device=self.device)
        single.build(x)
        self._pending = []
        if single.state is None:
            self.state = None
            self._n = 0
            return
        self._place(single.state)

    def _place(self, st: IVFPQState) -> None:
        """Distribute a built single-chip state over the shards: clusters
        largest first (stable), each to the least-loaded shard; per shard
        the stacked blocks padded to C_loc clusters (c_norms and norms
        +inf, codes 0, ids -1, counts 0), block ids rewritten to local
        ids, the refine rows in local-id order in a store of rcap rows, and
        the id map."""
        s = self.n_shards
        n = int(st.n)
        self._n = n
        self._dead = set()
        members, self._cluster_of = place_clusters(st.counts.cpu().numpy(), s)
        c_loc = max(max(len(m) for m in members), 1)
        self._cent_host = st.centroids.cpu().numpy()

        b_ids = st.b_ids.cpu().numpy()            # global ids at this point
        n_loc = np.asarray([(b_ids[m] >= 0).sum() for m in members], np.int64)
        rcap = max(1024, -(-int(n_loc.max()) // 1024) * 1024 + 1024)
        self._owner = np.full(n, -1, np.int32)
        self._lid = np.full(n, -1, np.int32)
        src = st.codes_blocks.device
        self.state, self.c_mask, self.id_map = [], [], []
        for si, m in enumerate(members):
            dev = self.mesh.shard_device(si)
            mi = torch.as_tensor(m, dtype=torch.long, device=src)

            def stack(t, pad):
                out = t.new_full((c_loc,) + tuple(t.shape[1:]), pad)
                out[:len(m)] = t[mi]
                return out.to(dev)

            bid = np.full((c_loc,) + b_ids.shape[1:], -1, np.int32)
            bid[:len(m)] = b_ids[m]
            sel = bid >= 0
            glob = np.sort(bid[sel])
            bid[sel] = np.searchsorted(glob, bid[sel])
            self._owner[glob] = si
            self._lid[glob] = np.arange(glob.size, dtype=np.int32)
            gt = torch.from_numpy(glob.astype(np.int64)).to(src)
            rr = st.refine.new_zeros((rcap, st.refine.shape[1]))
            rr[:glob.size] = st.refine[gt]
            rrs = st.r_scales.new_ones(rcap)
            rrs[:glob.size] = st.r_scales[gt]
            idmap = np.full(rcap, -1, np.int32)
            idmap[:glob.size] = glob
            mask = np.zeros(c_loc, bool)
            mask[:len(m)] = True
            self.state.append(IVFPQState(
                centroids=stack(st.centroids, 0.0), c_norms=stack(st.c_norms, _INF),
                codes_blocks=stack(st.codes_blocks, 0), norms_blocks=stack(st.norms_blocks, _INF),
                b_ids=torch.from_numpy(bid).to(dev), counts=stack(st.counts, 0),
                codebooks=st.codebooks.to(dev), rot=st.rot.to(dev), refine=rr.to(dev),
                r_scales=rrs.to(dev), n=int(glob.size)))
            self.c_mask.append(torch.from_numpy(mask).to(dev))
            self.id_map.append(torch.from_numpy(idmap).to(dev))
        self._n_loc = n_loc

    # -- search -----------------------------------------------------------
    def _sharded_masked_scan(self, q: torch.Tensor, k: int, av: torch.Tensor):
        """Exact filtered search: the per-shard masked scan over the refine
        stores at "high" and the global merge. av: [n] bool global mask."""
        cfg = self.cfg
        rows, bias, scales = [], [], []
        quantized = cfg.refine in ("int8", "int16")
        for st, im in zip(self.state, self.id_map):
            rn = torch.zeros_like(st.r_scales)
            if cfg.metric == "l2":   # the squared norms of the dequantized rows
                rn = D.sq_norms(st.refine.float())
                if quantized:
                    rn = st.r_scales ** 2 * rn
            scl = st.r_scales if quantized else torch.ones_like(st.r_scales)
            ok = av.to(im.device)[im.clamp(min=0).long()] & (im >= 0)
            rows.append(st.refine)
            bias.append(rn + torch.where(ok, 0.0, _INF))
            scales.append(scl)
        scan = make_sharded_masked_scan(self.mesh, 1, cfg.metric, "high", k,
                                        recorder=self.recorder)
        return scan(rows, bias, scales, self.id_map, q)

    def search(self, q, k: int, nprobe: Optional[int] = None, rerank: Optional[int] = None,
               allowed=None, filter_mode: str = "auto"):
        """Top-k over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device. `nprobe` is a global budget: each shard probes
        its best min(ceil(nprobe / S) + 1, C_loc) local clusters, so the
        union covers at least the single chip's probe set's share a shard.
        Filtered search (`allowed`: bool mask over ids or an id list)
        defaults to the exact masked scan over the refine stores; "auto"
        routes near-all-pass filters on huge corpora to "probe"
        (utils/filter_policy.py)."""
        from ..utils.filter_policy import resolve_filter_mode
        from ..utils.masks import allowed_mask

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
        av = None
        if allowed is not None:
            # dead rows fold into the allow mask here; the unfiltered probe
            # path drops them through the -2-id block ids (_mask_dead)
            av = allowed_mask(allowed, self._n, self._n, self.device)
            if self._dead:
                dead = np.fromiter(self._dead, np.int64, len(self._dead))
                av[torch.from_numpy(dead).to(self.device)] = False
            if filter_mode == "scan":
                return self._sharded_masked_scan(q, k, av)
        p = min(nprobe or cfg.nprobe, int(self._cluster_of.shape[0]))
        p_loc = min(-(-p // self.n_shards) + 1, self.state[0].c_norms.shape[0])
        rr = (rerank if rerank is not None else cfg.rerank) * (8 if av is not None else 1)
        allows = [None] * self.n_shards
        if av is not None:   # a local allow mask a shard: the search filters on local ids
            allows = [av.to(im.device)[im.clamp(min=0).long()] & (im >= 0) for im in self.id_map]

        def local(si, st, cm, im, al, qs):
            return ivfpq_search_impl(
                st, qs, k, p_loc, cfg.metric, cfg.refine, rr, cfg.l_bins, cfg.chunk,
                cfg.per_bin, cfg.scan_precision, cfg.group_slack, allowed=al, id_map=im,
                c_mask=cm)

        s_, i_ = run_shards(self.mesh, local,
                            list(zip(self.state, self.c_mask, self.id_map, allows)), q,
                            self.recorder, split_data=False)
        with merge_span(self.recorder):
            # smaller first: l2 distances ascend, dot/cosine similarities descend
            key = s_.reshape(b, -1) if cfg.metric == "l2" else -s_.reshape(b, -1)
            ms, mi = T.smallest_k(key, i_.reshape(b, -1), k)
        return (ms if cfg.metric == "l2" else -ms), mi

    # -- insert -----------------------------------------------------------
    def add(self, x) -> None:
        """Buffered append, each row routed to the shard owning its nearest
        global centroid (centroids and codebooks frozen, as on the single
        chip). Global ids stay dense insertion order."""
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

    def _flush(self) -> None:
        """Route the buffered rows and append them shard by shard into spare
        block capacity (index/ivfpq.py:_ivfpq_append, in batches padded to
        max(8, the largest shard's share)); a block or refine-store
        overflow rebuilds everything instead (_rebuild_with)."""
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        cfg = self.cfg
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        s, base = self.n_shards, self._n
        glob_assign = nearest_centroids(new, self._cent_host, cfg.metric, self.device)
        shard_of = self._cluster_of[glob_assign, 0]
        local_c = self._cluster_of[glob_assign, 1]
        cap = self.state[0].codes_blocks.shape[2]
        rcap = self.state[0].refine.shape[0]
        cnt = np.stack([st.counts.cpu().numpy() for st in self.state])
        addc = np.zeros_like(cnt)
        np.add.at(addc, (shard_of, local_c), 1)
        per_shard_new = np.bincount(shard_of, minlength=s)
        if int((cnt + addc).max()) > cap or int((self._n_loc + per_shard_new).max()) > rcap:
            self._rebuild_with(new)
            return
        per = max(8, int(per_shard_new.max()))
        for si, st in enumerate(self.state):
            rows = np.flatnonzero(shard_of == si)
            m = min(per, rcap - int(self._n_loc[si]))   # every real row fits: m >= rows.size
            dev = st.codes_blocks.device
            xb = torch.zeros((m, cfg.dim), dtype=torch.float32, device=dev)
            xb[:rows.size] = torch.from_numpy(new[rows]).to(dev)
            ab = torch.zeros(m, dtype=torch.int64, device=dev)
            ab[:rows.size] = torch.from_numpy(local_c[rows].astype(np.int64)).to(dev)
            vb = torch.zeros(m, dtype=torch.bool, device=dev)
            vb[:rows.size] = True
            _ivfpq_append(st, xb, ab, vb, int(self._n_loc[si]), cfg.metric, cfg.refine)
            lo = int(self._n_loc[si])
            self.id_map[si][lo:lo + rows.size] = torch.from_numpy(
                (base + rows).astype(np.int32)).to(dev)
        # local ids are dense a shard, in routed order
        new_lid = np.zeros(new.shape[0], np.int32)
        fill = self._n_loc.copy()
        for i, si in enumerate(shard_of):
            new_lid[i] = fill[si]
            fill[si] += 1
        self._owner = np.concatenate([self._owner, shard_of.astype(np.int32)])
        self._lid = np.concatenate([self._lid, new_lid])
        self._n_loc = fill
        self._n += new.shape[0]

    def _reconstruct_global(self) -> np.ndarray:
        """Stored vectors in global-id order (the dequantized refine rows)."""
        out = np.zeros((self._n, self.cfg.dim), np.float32)
        for si, st in enumerate(self.state):
            g = np.flatnonzero(self._owner == si)
            rows = self._rows(st, self._lid[g])
            out[g] = rows
        return out

    def _rows(self, st: IVFPQState, lids: np.ndarray) -> np.ndarray:
        """Dequantized refine rows of local ids `lids` of one shard."""
        t = torch.from_numpy(np.asarray(lids, np.int64)).to(st.refine.device)
        rows = st.refine[t].float()
        if self.cfg.refine in ("int8", "int16"):
            rows = rows * st.r_scales[t][:, None]
        return rows.cpu().numpy()

    def _rebuild_with(self, new: np.ndarray) -> None:
        """Overflow fallback: a full rebuild from the reconstructed vectors
        and the new rows. Ids stay stable; tombstones survive as masked
        rows."""
        dead = self._dead
        x_all = np.concatenate([self._reconstruct_global(), new], axis=0)
        self.build(x_all)
        if dead:
            self._dead = dead
            self._mask_dead()

    # -- mutation ---------------------------------------------------------
    def _mask_dead(self) -> None:
        """Flip tombstoned rows' block ids to -2-id (every scan keeps only
        ids >= 0): the probe path's delete. The masked scan filters them
        through the allow bias instead. Norms stay, as in JAX."""
        if not self._dead:
            return
        dead = np.fromiter(self._dead, np.int64, len(self._dead))
        lids, owners = self._lid[dead], self._owner[dead]
        for si in np.unique(owners):
            st = self.state[si]
            grid = st.b_ids.cpu().numpy()
            cc, ss = np.nonzero(np.isin(grid, lids[owners == si]))
            grid[cc, ss] = -2 - grid[cc, ss]
            st.b_ids = torch.from_numpy(grid).to(st.b_ids.device)

    def remove(self, ids) -> int:
        """Tombstone by global id (mark-and-filter; ids never renumber).
        Returns the number of rows newly deleted."""
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
        self._mask_dead()
        return int(new.size)

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

    # -- reads ------------------------------------------------------------
    def get(self, ids) -> np.ndarray:
        """Stored (dequantized refine) representation for global ids."""
        self._flush()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        out = np.zeros((ids.size, self.cfg.dim), np.float32)
        owners = self._owner[ids]
        for si in np.unique(owners):
            sel = np.flatnonzero(owners == si)
            out[sel] = self._rows(self.state[si], self._lid[ids[sel]])
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: st_<field> stacked on a
        leading shard axis (a bf16 refine store as its uint16 bits), c_mask,
        id_map, the host maps; tombstones in meta["dead"]."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n, n_shards=self.n_shards,
                    n_loc=[] if self._n_loc is None else [int(v) for v in self._n_loc],
                    dead=sorted(int(i) for i in self._dead))
        arrays = {}
        if self.state is not None:
            for f in _STATE_FIELDS:
                parts = []
                for st in self.state:
                    v = getattr(st, f)
                    if f == "n":
                        parts.append(np.asarray(v, np.int32))
                    elif v.dtype == torch.bfloat16:
                        parts.append(v.cpu().view(torch.int16).numpy().view(np.uint16))
                    else:
                        parts.append(v.cpu().numpy())
                arrays[f"st_{f}"] = np.stack(parts)
            arrays["c_mask"] = np.stack([m.cpu().numpy() for m in self.c_mask])
            arrays["id_map"] = np.stack([m.cpu().numpy() for m in self.id_map])
            arrays["cent_host"] = self._cent_host
            arrays["cluster_of"] = self._cluster_of
            arrays["owner"] = self._owner
            arrays["lid"] = self._lid
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None) -> "ShardedIVFPQ":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg as a dict, n, n_shards, n_loc, dead), `arrays` its
        arrays (st_<IVFPQState field> [S, ...], c_mask, id_map, cent_host,
        cluster_of, owner, lid; absent: an empty index)."""
        cfg = IVFPQConfig(**meta["cfg"])
        idx = cls(cfg, mesh=mesh)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx._n = int(meta["n"])
        idx._dead = set(int(i) for i in meta["dead"])
        if "st_b_ids" not in arrays:
            return idx
        idx.state, idx.c_mask, idx.id_map = [], [], []
        for si in range(idx.n_shards):
            dev = idx.mesh.shard_device(si)
            idx.state.append(state_from_numpy(
                cfg, {f: np.asarray(arrays[f"st_{f}"])[si] for f in _STATE_FIELDS}, dev))
            idx.c_mask.append(torch.from_numpy(np.asarray(arrays["c_mask"][si], bool)).to(dev))
            idx.id_map.append(torch.from_numpy(
                np.asarray(arrays["id_map"][si], np.int32)).to(dev))
        idx._cent_host = np.asarray(arrays["cent_host"], np.float32)
        idx._cluster_of = np.asarray(arrays["cluster_of"], np.int32)
        idx._owner = np.asarray(arrays["owner"], np.int32)
        idx._lid = np.asarray(arrays["lid"], np.int32)
        idx._n_loc = np.asarray(meta["n_loc"], np.int64)
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedIVFPQ":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)
