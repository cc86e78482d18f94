"""Mesh-sharded product-quantized search (port of zvdb_tpu/parallel/sharded_pq.py).

PQ is the memory-scaling engine (n_sub/2 bytes of codes a row, ops/pq.py).
The corpus is split over the mesh's shard axis; the codebooks (and the OPQ
rotation) are shared, KB-scale. Every shard scans its own rows, reranks its
own candidates against its own refine store (no cross-shard gather), and
the [B, S*k] candidates are merged on the mesh's merge device
(parallel/sharded.py:run_shards). With cfg.scan="pallas" and approx=True a
shard's scan is the fused ADC kernel B (ops/pq_scan.py:pq_scan_topk): one
launch a shard a batch. Otherwise it is the tiled decode scan
(index/pqflat.py:_pq_scan), which selects exactly.

With a refine store each shard refines its own k*rerank candidates, so the
pool is S times wider than the single-chip engine's at equal `rerank`, and
sharded recall is at least the single chip's.

Layout. Each shard's state is a dict on its device: codes, norms [cap]
f32 (+inf on padding and tombstones: the validity bias), refine [cap, D]
(or [cap, 0]), r_scales [cap] f32 and ids [cap] int32 global ids (-1 on
padding). Codes take the single-chip PQState layout: nibble-packed and
transposed, [n_sub/2, cap] uint8, when cfg.packed (n_codes <= 16), which
kernel B reads as it lies; [cap, n_sub] one byte a code otherwise. JAX
stores [per, n_sub] bytes on every config and packs them on every search
call. Save files keep JAX's stacked [S, per, n_sub] layout, so they load in
both packages; index_stats counts the bytes held, so a packed store reports
half of JAX's code bytes.

Differences from the JAX package, by design: the codebooks train on JAX's
numpy sample with the port's trainers (ops/pq.py) seeded by a
torch.Generator, so one seed gives other codebooks (`from_numpy` and `load`
carry a JAX-built index across); approx=True without the kernel selects
exactly (PyTorch has no approx_min_k).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..index.flat import tensor_from_numpy
from ..index.pqflat import PQState, _pq_scan
from ..ops import distance as D
from ..ops import pq as PQ
from ..ops import topk as T
from ..ops.pq_scan import pq_scan_topk
from ..utils.config import PQConfig
from .mesh import SHARD_AXIS, make_mesh
from .sharded import merge_span, run_shards

_INF = float("inf")
_FIELDS = ("codes", "norms", "refine", "r_scales", "ids")


class ShardedPQFlat:
    """Product-quantized index sharded over a device mesh."""

    def __init__(self, cfg: PQConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.device = self.mesh.merge_device     # where results come back
        self.state: Optional[list] = None        # one dict of tensors per shard
        self.codebooks: Optional[torch.Tensor] = None   # [n_sub, C, dsub] f32
        # OPQ rotation ([0, 0] when cfg.opq is off): codes live in x @ rot
        # space, the refine store in the original space
        self.rot = torch.zeros((0, 0), dtype=torch.float32, device=self.device)
        self._trained = False
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._per_shard_n: Optional[np.ndarray] = None   # slots used, tombstones included
        self._dead: set[int] = set()   # tombstoned global ids
        self.recorder = None  # a utils.profiling.PhaseRecorder: per-shard and merge times

    def __len__(self) -> int:
        return self._n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def _refine_d(self) -> int:
        return self.cfg.dim if self.cfg.refine != "none" else 0

    def _check_dim(self, x) -> None:
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    # -- construction -----------------------------------------------------
    def _train(self, x: np.ndarray) -> None:
        """Codebooks (and the OPQ rotation) from a sample of x: JAX's numpy
        sample (cfg.train_sample rows without replacement, in row order),
        trained once and frozen."""
        cfg = self.cfg
        n = x.shape[0]
        xs = x
        if n > cfg.train_sample:
            sel = np.random.default_rng(cfg.seed).choice(n, cfg.train_sample, replace=False)
            xs = x[np.sort(sel)]
        xf = D.preprocess_queries(torch.from_numpy(np.ascontiguousarray(xs)).to(self.device),
                                  cfg.metric)
        gen = torch.Generator().manual_seed(cfg.seed)
        if cfg.opq:
            self.rot, self.codebooks = PQ.train_opq(xf, gen, cfg.n_sub, cfg.n_codes,
                                                    cfg.kmeans_iters, cfg.opq_iters)
        else:
            self.codebooks = PQ.train_codebooks(xf, gen, cfg.n_sub, cfg.n_codes,
                                                cfg.kmeans_iters)
        self._trained = True

    def _encode(self, xs: np.ndarray, ids: np.ndarray, dev):
        """One shard's block of rows xs [m, D] with global ids (-1: padding)
        -> (codes in the shard layout, norms with +inf on padding, refine,
        r_scales, ids) on `dev`."""
        cfg = self.cfg
        m = xs.shape[0]
        xf = D.preprocess_queries(torch.from_numpy(np.ascontiguousarray(xs)).to(dev), cfg.metric)
        cb = self.codebooks.to(dev)
        codes = PQ.encode(PQ.apply_rotation(xf, self.rot.to(dev)), cb)
        if cfg.metric == "l2":
            norms = PQ.decoded_sq_norms(codes, cb)
        else:
            norms = torch.zeros(m, dtype=torch.float32, device=dev)
        idt = torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(dev)
        norms = torch.where(idt >= 0, norms, _INF)
        ones = torch.ones(m, dtype=torch.float32, device=dev)
        if cfg.refine in ("int8", "int16"):
            # JAX encodes a shard's block outside a jit: its scales divide
            rrows, rscales, _ = D.quantize_corpus(xf, cfg.metric,
                                                  bits=8 if cfg.refine == "int8" else 16,
                                                  divide=True)
        elif cfg.refine == "none":
            rrows, rscales = torch.zeros((m, 0), dtype=torch.float32, device=dev), ones
        else:
            rrows, rscales = xf.to(cfg.refine_dtype), ones
        if cfg.packed:
            codes = PQ.pack_nibbles(codes).T.contiguous()
        return codes, norms, rrows, rscales, idt

    def build(self, x) -> None:
        """Replace the contents: train the codebooks on a sample of x, then
        shard s holds rows [s*per, (s+1)*per), per = ceil(n / S), with their
        positions in x as global ids. Padding slots get the norm +inf."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        x = np.asarray(x, np.float32)
        self._check_dim(x)
        n, s = x.shape[0], self.n_shards
        per = -(-max(n, 1) // s)
        self._n = n
        self._train(x)
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
            self.state.append(dict(zip(_FIELDS, self._encode(xs, ids,
                                                             self.mesh.shard_device(si)))))
        self._per_shard_n = counts
        self._pending = []
        self._dead = set()

    # -- incremental insert -----------------------------------------------
    def add(self, x) -> None:
        """Buffered append, flushed on the next search. New rows encode
        against the frozen codebooks and go to the least-loaded shards;
        global ids stay dense, in insertion order."""
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
        cap = self.state[0]["norms"].shape[0]
        if need > cap:
            self._grow(max(need, 2 * cap))
        for si in range(s):
            rows = np.flatnonzero(shard_of == si)
            if rows.size == 0:
                continue
            st = self.state[si]
            codes, norms, rrows, rscales, ids = self._encode(
                new[rows], (self._n + rows).astype(np.int32), st["norms"].device)
            lo, hi = int(self._per_shard_n[si]), int(self._per_shard_n[si]) + rows.size
            if self.cfg.packed:
                st["codes"][:, lo:hi] = codes
            else:
                st["codes"][lo:hi] = codes
            st["refine"][lo:hi] = rrows
            st["r_scales"][lo:hi] = rscales
            st["ids"][lo:hi] = ids
            st["norms"][lo:hi] = norms
        self._per_shard_n = self._per_shard_n + added
        self._n += new.shape[0]

    def _grow(self, new_cap: int) -> None:
        """Every shard to new_cap slots: codes 0, norms +inf, refine 0,
        r_scales 1 and ids -1 past the old capacity."""
        cfg = self.cfg
        grown = []
        for st in self.state:
            cap, dev = st["norms"].shape[0], st["norms"].device
            codes_shape = (cfg.n_sub // 2, new_cap) if cfg.packed else (new_cap, cfg.n_sub)
            g = dict(codes=torch.zeros(codes_shape, dtype=torch.uint8, device=dev),
                     norms=torch.full((new_cap,), _INF, dtype=torch.float32, device=dev),
                     refine=torch.zeros((new_cap, self._refine_d), dtype=st["refine"].dtype,
                                        device=dev),
                     r_scales=torch.ones(new_cap, dtype=torch.float32, device=dev),
                     ids=torch.full((new_cap,), -1, dtype=torch.int32, device=dev))
            if cfg.packed:
                g["codes"][:, :cap] = st["codes"]
            else:
                g["codes"][:cap] = st["codes"]
            for f in _FIELDS[1:]:
                g[f][:cap] = st[f]
            grown.append(g)
        self.state = grown

    # -- mutation ---------------------------------------------------------
    def _ids_np(self):
        return [st["ids"].cpu().numpy() for st in self.state]

    def remove(self, ids) -> int:
        """Delete by global id (tombstone: the rows' norm validity bias
        becomes +inf, which the scan and the refine pass both inherit; ids
        never renumber). Returns the number of rows newly deleted."""
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
        order. Codes and refine rows move verbatim (no re-encode) and
        re-balance contiguously over the shards. Returns the survivors' old
        ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        st = self._stacked()
        ids = st["ids"]
        rr, cc = np.nonzero((ids >= 0) & alive[np.maximum(ids, 0)])
        order = np.argsort(ids[rr, cc], kind="stable")
        rr, cc = rr[order], cc[order]
        n, s = rr.size, self.n_shards
        per = -(-max(n, 1) // s)
        out = {"codes": np.zeros((s, per, self.cfg.n_sub), np.uint8),
               "norms": np.full((s, per), np.inf, np.float32),
               "refine": np.zeros((s, per, self._refine_d), st["refine"].dtype),
               "r_scales": np.ones((s, per), np.float32),
               "ids": np.full((s, per), -1, np.int32)}
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            if hi > lo:
                for f in _FIELDS[:-1]:
                    out[f][si, :hi - lo] = st[f][rr[lo:hi], cc[lo:hi]]
                out["ids"][si, :hi - lo] = np.arange(lo, hi, dtype=np.int32)
        self._set_stacked(out)
        self._n = n
        self._dead = set()
        return live

    # -- persistence ------------------------------------------------------
    def _stacked(self) -> dict:
        """The shards' state as JAX's stacked host arrays: [S, cap, n_sub]
        one-byte codes, bf16 refine rows as f32."""
        out = {f: [] for f in _FIELDS}
        for st in self.state:
            codes = st["codes"]
            if self.cfg.packed:
                codes = PQ.unpack_nibbles(codes.T, self.cfg.n_sub)
            out["codes"].append(codes.cpu().numpy())
            refine = st["refine"]
            out["refine"].append((refine.float() if refine.dtype == torch.bfloat16
                                  else refine).cpu().numpy())
            for f in ("norms", "r_scales", "ids"):
                out[f].append(st[f].cpu().numpy())
        return {f: np.stack(v) for f, v in out.items()}

    def _set_stacked(self, arrays: dict) -> None:
        """The state from JAX's stacked arrays ([S, cap, ...] numpy), shard s
        on the mesh's cell for s; tombstones are the live ids with +inf norms."""
        cfg = self.cfg
        ids = np.asarray(arrays["ids"]).astype(np.int32)
        norms = np.asarray(arrays["norms"], np.float32)
        codes = np.asarray(arrays["codes"], np.uint8)
        refine = np.asarray(arrays["refine"])
        self.state = []
        for si in range(self.n_shards):
            dev = self.mesh.shard_device(si)
            c = tensor_from_numpy(codes[si], dev)
            if cfg.packed:
                c = PQ.pack_nibbles(c).T.contiguous()
            self.state.append(dict(
                codes=c,
                norms=tensor_from_numpy(norms[si], dev),
                refine=tensor_from_numpy(refine[si], dev,
                                         bf16=cfg.refine == "bfloat16").to(cfg.refine_dtype),
                r_scales=tensor_from_numpy(np.asarray(arrays["r_scales"][si], np.float32), dev),
                ids=tensor_from_numpy(ids[si], dev)))
        self._per_shard_n = (ids >= 0).sum(1)
        self._dead = set(int(i) for i in ids[(ids >= 0) & np.isinf(norms)])

    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format: meta (cfg, n, n_shards,
        trained), rot, codebooks and the stacked state; tombstones ride in
        norms (+inf on a row with an id)."""
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n, n_shards=self.n_shards,
                    trained=self._trained)
        arrays = {"rot": self.rot.cpu().numpy()}
        if self.codebooks is not None:
            arrays["codebooks"] = self.codebooks.cpu().numpy()
        if self.state is not None:
            arrays.update(self._stacked())
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, arrays, meta: dict, mesh=None) -> "ShardedPQFlat":
        """An index over the JAX package's stacked state: `meta` is a save
        file's meta (cfg as a dict, n, n_shards, trained), `arrays` maps
        codebooks, rot and the state's codes, norms, refine, r_scales and
        ids ([S, cap, ...]) to numpy arrays (absent: not trained / empty)."""
        cfg = PQConfig(**meta["cfg"])
        idx = cls(cfg, mesh=mesh)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}")
        idx._n = meta["n"]
        idx._trained = bool(meta["trained"])
        if "codebooks" in arrays:
            idx.codebooks = tensor_from_numpy(arrays["codebooks"], idx.device).float()
        if "rot" in arrays:   # absent in files from before OPQ: the sentinel stays
            idx.rot = tensor_from_numpy(arrays["rot"], idx.device).float()
        if "codes" in arrays:
            idx._set_stacked(arrays)
        return idx

    @classmethod
    def load(cls, path: str, mesh=None) -> "ShardedPQFlat":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in z.files if f != "meta"}
        return cls.from_numpy(arrays, meta, mesh=mesh)

    # -- reads ------------------------------------------------------------
    def get(self, ids) -> np.ndarray:
        """Stored representation for global ids -> [K, D] f32 numpy: the
        refine row (dequantized), or without a refine store the PQ
        reconstruction rotated back to the user's space."""
        self._flush()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        grid = np.stack(self._ids_np())
        flat = grid.reshape(-1)
        order = np.argsort(flat, kind="stable")
        rr, cc = np.unravel_index(order[np.searchsorted(flat, ids, sorter=order)], grid.shape)
        out = np.zeros((ids.size, self.cfg.dim), np.float32)
        for si in np.unique(rr):
            sel = np.flatnonzero(rr == si)
            st = self.state[si]
            rows = torch.as_tensor(cc[sel], device=st["norms"].device)
            if self.cfg.refine != "none":
                vecs = st["refine"][rows].float()
                if self.cfg.refine in ("int8", "int16"):
                    vecs = vecs * st["r_scales"][rows][:, None]
            else:
                codes = (PQ.unpack_nibbles(st["codes"][:, rows].T, self.cfg.n_sub)
                         if self.cfg.packed else st["codes"][rows])
                dec = PQ.decode(codes, self.codebooks.to(rows.device))
                # OPQ codes reconstruct x @ rot; rot is orthogonal, so rot.T undoes it
                vecs = PQ.apply_rotation(dec, self.rot.to(rows.device).T)
            out[sel] = vecs.cpu().numpy()
        return out

    # -- search -----------------------------------------------------------
    def search(self, q, k: int, approx: bool = True, allowed=None, rerank: int | None = None):
        """Top-k over every shard: (scores [B, k], global ids [B, k]) on the
        mesh's merge device. allowed: optional allowlist over global ids
        (bool mask or id array), one validity-bias mask a call, exact at any
        selectivity; each shard's refine pool is post-filter. rerank
        overrides cfg.rerank for this call (a shard's pool is k * rerank)."""
        from ..utils.masks import allowed_mask

        self._flush()
        cfg = self.cfg
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None, :]
        self._check_dim(q)
        b, metric = q.shape[0], cfg.metric
        if self.state is None or self._n == 0 or not self._trained:
            return (torch.full((b, k), _INF if metric == "l2" else -_INF, device=self.device),
                    torch.full((b, k), -1, dtype=torch.int32, device=self.device))
        rr = cfg.rerank if rerank is None else int(rerank)
        pool = max(k * rr, k) if cfg.refine != "none" else k
        args = [tuple(st[f] for f in _FIELDS) for st in self.state]
        if allowed is not None:
            av = allowed_mask(allowed, self._n, self._n, self.device)
            for si, (c, nn, rv, rs, ii) in enumerate(args):
                ok = av.to(ii.device)[ii.clamp(min=0).long()] & (ii >= 0)
                args[si] = (c, torch.where(ok, nn, _INF), rv, rs, ii)
        kernel = approx and cfg.scan == "pallas"

        def local(si, c, nn, rv, rs, ii, qs):
            dev = qs.device
            cb = self.codebooks.to(dev)
            # the scan runs in the (OPQ-rotated) code space, the refine
            # rescore in the original space
            qr = PQ.apply_rotation(qs, self.rot.to(dev))
            if kernel:
                ps, pi = pq_scan_topk(
                    PQ.adc_lut(qr, cb), c, nn, pool, l_bins=cfg.l_bins, bq_tile=cfg.pallas_bq,
                    chunk=cfg.pallas_chunk, metric=metric, precision=cfg.scan_precision,
                    per_bin=cfg.per_bin, seg_rows=cfg.seg_rows)
            else:   # the decode scan of qr: the state's rotation is not read
                st = PQState(codes=c, norms=nn, codebooks=cb, rot=self.rot, refine=rv,
                             r_scales=rs, n=nn.shape[0])
                ps, pi = _pq_scan(st, qr, pool, metric, cfg.tile_n, cfg.precision, cfg.packed)
            safe = pi.clamp(min=0).long()
            if cfg.refine != "none":
                cand = rv[safe].float()
                if cfg.refine in ("int8", "int16"):
                    cand = cand * rs[safe][..., None]
                dots = torch.einsum("bd,bcd->bc", qs, cand)
                ex = D.sq_norms(cand) - 2.0 * dots if metric == "l2" else -dots
                ps = torch.where(pi >= 0, ex, _INF)
            gi = torch.where(pi >= 0, ii[safe], -1)
            ts, ti = T.smallest_k(ps, gi, k)
            return ts, torch.where(torch.isfinite(ts), ti, -1)

        qs = D.preprocess_queries(q, metric)
        ts, ti = run_shards(self.mesh, local, args, qs, self.recorder, split_data=False)
        with merge_span(self.recorder):
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), k)
            user = D.finalize_scores(ms, qs, metric)
            user = torch.where(mi >= 0, user, _INF if metric == "l2" else -_INF)
        return user, mi
