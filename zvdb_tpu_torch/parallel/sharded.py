"""Sharded HNSW: the corpus partitioned over a device mesh, a graph per
shard, query fan-out and a top-k merge (port of zvdb_tpu/parallel/sharded.py).

  * The corpus axis N is split into S contiguous shards. Each shard holds
    its own HNSW graph (index/hnsw.py's HNSWState) on its mesh cell's
    device, so graph gathers never cross shards.
  * `run_shards` stands in for JAX's shard_map: it runs a shard-local
    function for every shard in turn, one process driving every device
    (JAX's engines are single-controller too), and stacks the per-shard
    results on the mesh's merge device. A [B, S*k] top-k merges them there.
  * With a data axis, the query batch is split over the data rows, as
    shard_map's P("data") query spec splits it; the batch must divide
    evenly, as there. Each shard's state lives once, on its cell in the
    first data row, and every data row's slice runs against it.
  * The bulk build runs index/build.py's batched step over every shard.

Differences from the JAX package, by design:
  * the levels, the anchors and the flushes' levels draw from a
    torch.Generator seeded from ShardedHNSW(seed=...); the anchor sampler
    seeds one generator per shard from one drawn seed plus the shard index,
    where JAX folds the shard index into its key. `from_numpy` and `load`
    carry a JAX-built index across;
  * a flush seeds each base beam with the best SearchConfig.seed_anchors
    anchors beside the descent's row, as the single-chip HNSW's flush does
    (JAX: the descent alone; seed_anchors=0 gives JAX's);
  * a shard whose slice of a batch holds no row skips that batch's step
    (JAX runs it over padding only, which changes nothing);
  * the state is a list of per-shard states, stacked only in save files.
As in JAX, the sharded search passes only expand, max_iters,
max_upper_iters, levels_cap, precision and the dead mask to the search:
search_degree is None and seed_anchors 16 whatever search_cfg says; the
sharded build neither reorders rows diversity-first nor sets an int8 scale
(q_scale stays 1.0).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np
import torch

from ..index.build import _grown, build_batch_step, sample_levels
from ..index.hnsw import (
    FIELDS, HNSWState, init_state, max_level_for, search_state_impl, state_from_numpy,
    state_to_numpy,
)
from ..ops import topk as T
from ..utils.profiling import span
from ..utils.config import HNSWConfig, SearchConfig
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh

_INF = float("inf")


def merge_span(recorder):
    """The span of a sharded search's merge (utils.profiling.span)."""
    return span("merge", recorder)


def run_shards(mesh, local, shard_args, q: torch.Tensor, recorder=None,
               split_data: bool = True):
    """shard_map's stand-in: local(shard_index, *shard_args[s], queries) for
    every shard s, queries moved to the shard's device. Returns each of
    local's outputs, [Bl, ...] per shard, stacked to [B, S, ...] on the
    mesh's merge device. With a data axis of n_data rows and split_data
    (JAX's P("data") query spec) the batch is split into n_data contiguous
    slices (B % n_data must be 0, as JAX's shard_map requires), each run
    over every shard, and the slices concatenated back in order;
    split_data=False (JAX's replicated P() spec) runs the whole batch once.
    Each call runs in a span named "shard <s>" (utils.profiling.span)."""
    n_data, n_shards = mesh.shape[DATA_AXIS] if split_data else 1, mesh.shape[SHARD_AXIS]
    b = q.shape[0]
    if b % n_data:
        raise ValueError(f"a batch of {b} queries is not evenly divisible by the mesh's "
                         f"data axis ({n_data})")
    bl = b // n_data
    merge = mesh.merge_device
    rows = []
    for r in range(n_data):
        qr = q[r * bl:(r + 1) * bl]
        outs = []
        for si in range(n_shards):
            with span(f"shard {si}", recorder):
                out = local(si, *shard_args[si], qr.to(mesh.shard_device(si)))
            outs.append([o.to(merge) for o in out])
        rows.append([torch.stack(parts, dim=1) for parts in zip(*outs)])
    return tuple(torch.cat(parts, dim=0) for parts in zip(*rows))


def place_clusters(counts: np.ndarray, n_shards: int):
    """The cluster-sharded engines' placement (JAX's): clusters largest
    first (a stable sort), each to the shard with the fewest rows so far.
    Returns (members: per shard its global clusters in placement order,
    cluster_of: [C, 2] int32 (shard, local cluster))."""
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, np.int64)
    members = [[] for _ in range(n_shards)]
    for ci in order:
        tgt = int(np.argmin(load))
        members[tgt].append(int(ci))
        load[tgt] += counts[ci]
    cluster_of = np.zeros((counts.shape[0], 2), np.int32)
    for si, m in enumerate(members):
        for li, ci in enumerate(m):
            cluster_of[ci] = (si, li)
    return members, cluster_of


def make_anchor_reseed(mesh, a_count: int):
    """The per-shard anchor (re)sampler: reseed(states, seed) draws a_count
    rows with replacement in [0, max(n, 1)) of each shard (a generator
    seeded seed + shard index) and stores the dequantized rows, their norms
    and their row ids as the shard's anchor table, IN PLACE. Shape-stable,
    so a grown index refreshes its tables the same way; it is also the
    initial attach of the batched build, whose step has no anchors."""

    def reseed(states, seed: int):
        if len(states) != mesh.shape[SHARD_AXIS]:
            raise ValueError(f"{len(states)} states for {mesh.shape[SHARD_AXIS]} shards")
        for si, st in enumerate(states):
            gen = torch.Generator().manual_seed(seed + si)
            rows = torch.randint(0, max(st.n, 1), (a_count,), generator=gen)
            rows = rows.to(st.vectors.device)
            st.anchors = st.vectors[rows].float() * st.q_scale
            st.a_norms = st.norms[rows]
            st.a_rows = rows.to(torch.int32)
        return states

    return reseed


class ShardedHNSW:
    """Mesh-sharded HNSW; the API mirrors the single-chip class (build,
    insert/add/flush, search with allowed=, remove/compact, save/load)."""

    def __init__(self, cfg: HNSWConfig, search_cfg: SearchConfig = SearchConfig(),
                 mesh=None, seed: int = 0):
        self.cfg = cfg
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.n_data = self.mesh.shape.get(DATA_AXIS, 1)
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one HNSWState per shard
        self.levels_cap = 1
        self.shard_cap = 0
        self._gen = torch.Generator().manual_seed(seed)
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._anchor_n = 0   # max per-shard n at the last anchor sample
        self._dead: set[int] = set()                  # tombstoned global ids
        self._dead_mask: Optional[list] = None        # per shard [cap+1] bool by row
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    # -- delete -----------------------------------------------------------
    def remove(self, ids) -> int:
        """Delete by global id (mark-and-filter): tombstoned nodes keep
        routing each shard's beam and leave the results. Ids never
        renumber. Returns the number of rows newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        self._flush()
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        new = np.asarray([int(i) for i in ids if int(i) not in self._dead], np.int64)
        if new.size == 0:
            return 0
        self._sync_dead_mask()
        for st, mask in zip(self.state, self._dead_mask):
            rows = np.flatnonzero(np.isin(st.ext_ids.cpu().numpy(), new))
            mask[torch.as_tensor(rows, device=mask.device)] = True
        self._dead.update(int(i) for i in new)
        return int(new.size)

    def compact(self) -> np.ndarray:
        """Drop tombstones; survivors renumber to [0, L) in former global-id
        order (one rebuild). Returns the survivors' old ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        for st in self.state:
            ext = st.ext_ids.cpu().numpy()
            vecs = st.vectors.float()
            if self.cfg.dtype == "int8":
                vecs = vecs * st.q_scale
            sel = ext >= 0
            x_all[ext[sel]] = vecs.cpu().numpy()[sel]
        self.build(x_all[live])
        return live

    def _sync_dead_mask(self) -> None:
        """Per-shard [cap+1] dead masks, created or padded to the capacity."""
        cap1 = self.state[0].nbr0.shape[0]   # per-shard cap + the trash row
        if self._dead_mask is None:
            self._dead_mask = [torch.zeros(cap1, dtype=torch.bool, device=st.vectors.device)
                               for st in self.state]
        elif self._dead_mask[0].shape[0] < cap1:
            grown = []
            for old in self._dead_mask:
                g = torch.zeros(cap1, dtype=torch.bool, device=old.device)
                g[:old.shape[0]] = old
                grown.append(g)
            self._dead_mask = grown

    # -- build ------------------------------------------------------------
    def _steps(self, batches: list, seed_anchors: int) -> None:
        """One batch step on every shard: batches[s] = (xb, lb, eb, vb) as
        build_batch_step takes them; a shard with no valid row skips it."""
        for st, (xb, lb, eb, vb) in zip(self.state, batches):
            if vb.any():
                build_batch_step(st, torch.from_numpy(xb).to(st.vectors.device), lb, eb, vb,
                                 self.cfg, self.levels_cap, seed_anchors)

    def build(self, x) -> None:
        """Bulk build: a contiguous split of the corpus over the shards,
        each shard's rows sorted by level (descending, stable) and inserted
        by the batched step in batches of min(build_batch, per-shard rows);
        global ids are the rows' positions in x. Then the anchor tables."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        x = np.asarray(x, np.float32)
        n, s, cfg = x.shape[0], self.n_shards, self.cfg
        if n and x.shape[-1] != cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {cfg.dim}, got {x.shape[-1]}")
        per = -(-n // s) if n else 1
        bsz = min(cfg.build_batch, per)
        per_pad = -(-per // bsz) * bsz
        self.shard_cap = per_pad
        self.levels_cap = (cfg.max_level if cfg.max_level is not None
                           else max_level_for(per_pad, cfg.m))
        self._n = n

        # host-side shard prep: slice, level-descending sort, global ids
        all_levels = sample_levels(self._gen, n, cfg.m, self.levels_cap, cfg.ml)
        xs = np.zeros((s, per_pad, cfg.dim), np.float32)
        ls = np.full((s, per_pad), -1, np.int32)
        es = np.full((s, per_pad), -1, np.int32)
        vs = np.zeros((s, per_pad), bool)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            cnt = max(hi - lo, 0)
            if cnt == 0:
                continue
            lv = all_levels[lo:hi]
            order = np.argsort(-lv, kind="stable")
            xs[si, :cnt] = x[lo:hi][order]
            ls[si, :cnt] = lv[order]
            es[si, :cnt] = (lo + order).astype(np.int32)
            vs[si, :cnt] = True
        self.state = [init_state(per_pad, cfg, self.levels_cap, self.mesh.shard_device(si))
                      for si in range(s)]
        for t in range(per_pad // bsz):
            lo, hi = t * bsz, (t + 1) * bsz
            self._steps([(xs[si, lo:hi], ls[si, lo:hi], es[si, lo:hi], vs[si, lo:hi])
                         for si in range(s)], seed_anchors=0)
        # the batched step has no anchor epilogue: attach each shard's table now
        self._attach_anchors(per)
        self._pending = []
        self._dead = set()
        self._dead_mask = None

    def _attach_anchors(self, per: int) -> None:
        """a = 2^clip(ceil(log2(per / 12)), 10, 15) anchors a shard, at most
        the shard capacity, drawn by make_anchor_reseed."""
        a = 1 << max(10, min(15, int(math.ceil(math.log2(max(per, 2) / 12.0)))))
        a = min(a, max(self.shard_cap, 1))
        seed = int(torch.randint(0, 2**31 - 1 - self.n_shards, (1,), generator=self._gen))
        make_anchor_reseed(self.mesh, a)(self.state, seed)
        self._anchor_n = per

    # -- insert -----------------------------------------------------------
    def insert(self, x) -> None:
        """Buffered insert; the rows are split contiguously over the shards
        and appended by the batched step at the next flush (or search).
        Global ids stay dense, in arrival order."""
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
        ceil(rows / S)), in batches of min(build_batch, per); every shard
        grows to max(need, 2 * cap) first when its n plus the batches'
        windows passes the capacity. Once the largest shard's n doubles past
        the last anchor sample, the anchors are drawn again."""
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        s, cfg = self.n_shards, self.cfg
        base = self._n
        per = -(-new.shape[0] // s)
        bsz = min(cfg.build_batch, max(per, 1))
        nb = -(-per // bsz)
        need = max(st.n for st in self.state) + nb * bsz
        if need > self.shard_cap:
            self._grow(max(need, 2 * self.shard_cap))
        levels = sample_levels(self._gen, new.shape[0], cfg.m, self.levels_cap, cfg.ml)
        for t in range(nb):
            batches = []
            for si in range(s):
                xb = np.zeros((bsz, cfg.dim), np.float32)
                lb = np.full(bsz, -1, np.int32)
                eb = np.full(bsz, -1, np.int32)
                vb = np.zeros(bsz, bool)
                lo = si * per + t * bsz
                hi = min(lo + bsz, min((si + 1) * per, new.shape[0]))
                cnt = max(hi - lo, 0)
                if cnt:
                    xb[:cnt] = new[lo:hi]
                    lb[:cnt] = levels[lo:hi]
                    eb[:cnt] = base + np.arange(lo, hi, dtype=np.int32)
                    vb[:cnt] = True
                batches.append((xb, lb, eb, vb))
            self._steps(batches, seed_anchors=self.search_cfg.seed_anchors)
        self._n = base + new.shape[0]
        n_after = max(st.n for st in self.state)
        if self.state[0].anchors.shape[0] > 0 and n_after >= 2 * max(self._anchor_n, 1):
            self._attach_anchors(n_after)

    def _grow(self, new_cap: int) -> None:
        """Every shard's capacity to new_cap rounded up to the batch (the
        trash rows re-created at the new cap)."""
        bsz = min(self.cfg.build_batch, max(new_cap, 1))
        new_cap = -(-new_cap // bsz) * bsz
        self.state = [_grown(st, self.shard_cap, new_cap, self.cfg, self.levels_cap)
                      for st in self.state]
        self.shard_cap = new_cap

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: the per-shard states
        stacked on a leading shard axis (host scalars as [S] arrays, bf16
        vectors as f32), tombstones as `dead_ext`."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg),
                    search_cfg=dataclasses.asdict(self.search_cfg),
                    levels_cap=self.levels_cap, shard_cap=self.shard_cap,
                    n=self._n, n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            per_shard = [state_to_numpy(st) for st in self.state]
            arrays = {f: np.stack([a[f] for a in per_shard]) for f in FIELDS}
            if self._dead:
                arrays["dead_ext"] = np.asarray(sorted(self._dead), np.int64)
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None, seed: int = 0) -> "ShardedHNSW":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg and search_cfg as dicts, levels_cap, shard_cap, n,
        n_shards), `arrays` its arrays ([S, ...] HNSWState fields and an
        optional dead_ext). Shard s goes to the mesh's cell for s."""
        idx = cls(HNSWConfig(**meta["cfg"]), SearchConfig(**meta["search_cfg"]), mesh=mesh,
                  seed=seed)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx.levels_cap = meta["levels_cap"]
        idx.shard_cap = meta["shard_cap"]
        idx._n = meta["n"]
        if "vectors" in arrays:
            idx.state = [state_from_numpy(idx.cfg, {f: np.asarray(arrays[f])[si] for f in FIELDS
                                                    if f in arrays},
                                          idx.mesh.shard_device(si))
                         for si in range(idx.n_shards)]
            idx._anchor_n = int(np.asarray(arrays["n"]).max())
            if "dead_ext" in arrays and len(arrays["dead_ext"]):
                dead = np.asarray(arrays["dead_ext"], np.int64)
                idx._dead = set(int(i) for i in dead)
                idx._sync_dead_mask()
                for st, mask in zip(idx.state, idx._dead_mask):
                    rows = np.flatnonzero(np.isin(st.ext_ids.cpu().numpy(), dead))
                    mask[torch.as_tensor(rows, device=mask.device)] = True
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedHNSW":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)

    # -- search -----------------------------------------------------------
    def _allowed_rows(self, av: torch.Tensor, st: HNSWState) -> torch.Tensor:
        """[cap] bool: the shard's rows whose global id the allowlist passes."""
        ext = st.ext_ids
        return av.to(ext.device)[ext.clamp(min=0).long()] & (ext >= 0)

    def search(self, q, k: int, ef_search: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """kNN over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device; empty slots id -1. allowed: optional allowlist
        over global ids (bool mask or id array). filter_mode "scan" answers
        filtered queries with the exact per-shard masked scan and a global
        merge (parallel/scan_filter.py), "beam" keeps the beam with blocked
        nodes routing but filtered from its final beam, "auto" picks
        (utils/filter_policy.py)."""
        from ..utils.filter_policy import resolve_filter_mode
        from ..utils.masks import allowed_mask

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
        if av is not None and filter_mode == "scan":
            from .scan_filter import make_sharded_masked_scan

            bias, scales = [], []
            for si, st in enumerate(self.state):
                cap = st.vectors.shape[0]
                ok = self._allowed_rows(av, st)
                if self._dead:
                    ok = ok & ~self._dead_mask[si][:cap]
                bias.append(st.norms + torch.where(ok, 0.0, _INF))
                scales.append(torch.full((cap,), st.q_scale, dtype=torch.float32,
                                         device=st.vectors.device))
            scan = make_sharded_masked_scan(self.mesh, self.n_data, cfg.metric, cfg.precision,
                                            k, recorder=self.recorder)
            return scan([st.vectors for st in self.state], bias, scales,
                        [st.ext_ids for st in self.state], q)
        ef = ef_search if ef_search is not None else self.search_cfg.ef_search
        dead = [None] * self.n_shards
        if self._dead:
            dead = list(self._dead_mask)
        if av is not None:
            for si, st in enumerate(self.state):
                block = ~self._allowed_rows(av, st)
                block = torch.cat([block, block.new_ones(st.nbr0.shape[0] - block.shape[0])])
                dead[si] = block if dead[si] is None else dead[si] | block
        sc, levels_cap = self.search_cfg, self.levels_cap

        def local(si, st, dead_rows, qs):
            s, ext, _ = search_state_impl(
                st, qs, k, cfg.metric, ef, expand=sc.expand, max_iters=sc.max_iters,
                max_upper_iters=sc.max_upper_iters, levels_cap=levels_cap,
                precision=cfg.precision, dead=dead_rows)
            return s, ext

        s, ext = run_shards(self.mesh, local, list(zip(self.state, dead)), q, self.recorder)
        with merge_span(self.recorder):
            # smaller first: l2 scores ascend, dot/cosine similarities descend
            b = s.shape[0]
            key = s.reshape(b, -1) if cfg.metric == "l2" else -s.reshape(b, -1)
            mk, mi = T.smallest_k(key, ext.reshape(b, -1), k)
            merged = mk if cfg.metric == "l2" else -mk
        return merged, mi
