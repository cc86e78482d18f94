"""PQ-flat index: product-quantized brute-force scan + optional exact refine
(port of zvdb_tpu/index/pqflat.py).

The memory-scaling engine: 4-bit codes at n_sub=16 are 8 bytes per row,
plus an optional refine store for the exact rerank (int16 by default). A
search runs

    pass 1: the fused ADC scan kernel (ops/pq_scan.py, cfg.scan="pallas") or
            the tiled decode scan (decode a code tile, score it with one
            matmul, keep its top-k, merge), keeping rerank*k candidates;
    pass 2: gather the candidates' refine rows, rescore them in f32, keep k.

Deletes are mark-and-filter through the norms' +inf validity bias; ids never
renumber until compact(). Entry points take `device=None`, which means
"cuda"; without a CUDA device they raise unless the caller asks for "cpu".
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import numpy as np
import torch

from ..ops import approx_topk as AK
from ..ops import distance as D
from ..ops import pq as PQ
from ..ops import topk as T
from ..ops.pq_scan import pq_scan_topk
from ..utils.config import PQConfig
from ..utils.masks import allowed_mask
from .flat import _empty_result, _pad_k, _user_scores, resolve_device, tensor_from_numpy

_INF = float("inf")


@dataclasses.dataclass
class PQState:
    """Device-resident PQ index state."""

    codes: torch.Tensor      # [cap, S] uint8; packed configs (cfg.packed) store the
                             # transposed nibble bytes [S/2, cap] the fused scan reads
    norms: torch.Tensor      # [cap] f32 ||decoded row||^2 for l2, 0 otherwise; +inf = invalid
    codebooks: torch.Tensor  # [S, C, dsub] f32, frozen after training
    rot: torch.Tensor        # [D, D] f32 OPQ rotation, or [0, 0] for plain PQ
    refine: torch.Tensor     # [cap, D] refine rows (int8/int16/f32/bf16) or [cap, 0]
    r_scales: torch.Tensor   # [cap] f32 per-vector dequant scales (int8/int16 refine)
    n: int                   # slots used, tombstones included; a host int


def init_state(capacity: int, cfg: PQConfig, device, codebooks=None, rot=None) -> PQState:
    if codebooks is None:
        codebooks = torch.zeros((cfg.n_sub, cfg.n_codes, cfg.dsub), dtype=torch.float32,
                                device=device)
    if rot is None:
        rot = torch.zeros((0, 0), dtype=torch.float32, device=device)
    codes_shape = (cfg.codes_width, capacity) if cfg.packed else (capacity, cfg.n_sub)
    refine_d = cfg.dim if cfg.refine != "none" else 0
    return PQState(
        codes=torch.zeros(codes_shape, dtype=torch.uint8, device=device),
        norms=torch.full((capacity,), _INF, dtype=torch.float32, device=device),
        codebooks=codebooks,
        rot=rot,
        refine=torch.zeros((capacity, refine_d), dtype=cfg.refine_dtype, device=device),
        r_scales=torch.ones((capacity,), dtype=torch.float32, device=device),
        n=0,
    )


def _ingest(state: PQState, x: torch.Tensor, metric: str, refine: str, packed: bool) -> PQState:
    """Encode rows x and append them at state.n, IN PLACE (the JAX version
    donates and copies); the caller has made room. Codes quantize the
    rotated rows under OPQ, the refine store keeps the original rows. Norms
    are written last, so a concurrent reader sees each new row either as
    +inf (invalid) or complete."""
    xf = D.preprocess_queries(x, metric)
    codes = PQ.encode(PQ.apply_rotation(xf, state.rot), state.codebooks)
    if metric == "l2":
        norms = PQ.decoded_sq_norms(codes, state.codebooks)
    else:
        norms = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    lo, hi = state.n, state.n + x.shape[0]
    if refine in ("int8", "int16"):
        rrows, rscales, _ = D.quantize_corpus(xf, metric, bits=8 if refine == "int8" else 16)
        state.refine[lo:hi] = rrows
        state.r_scales[lo:hi] = rscales
    elif refine != "none":   # float stores keep their r_scales of 1 from init_state
        state.refine[lo:hi] = xf.to(state.refine.dtype)
    if packed:
        state.codes[:, lo:hi] = PQ.pack_nibbles(codes).T
    else:
        state.codes[lo:hi] = codes
    state.norms[lo:hi] = norms
    state.n = hi
    return state


def _pq_scan(state: PQState, qs: torch.Tensor, k: int, metric: str, tile_n: int,
             precision: str, packed: bool, approx: bool = False, recall_target: float = 0.95):
    """Pass 1 without the kernel: decode each code tile, score it with one
    matmul at `precision`, keep its top-k, merge into the running top-k.
    Any n_codes. approx=True keeps each tile's k with ops/approx_topk.py:
    approx_min_k at recall_target, as JAX's lax.approx_min_k (the binned
    kernel on the card, the exact top-k on the CPU; a short last tile padded
    with +inf to the tile's width, as JAX pads the codes); approx=False
    selects exactly. Returns (surrogate scores [B, k], ids [B, k]); invalid
    slots +inf / -1."""
    cap = state.norms.shape[0]
    tile = min(tile_n, cap)
    n_sub = state.codebooks.shape[0]
    b = qs.shape[0]
    best_s = torch.full((b, k), _INF, dtype=torch.float32, device=qs.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=qs.device)
    for t0 in range(0, cap, tile):
        if packed:
            codes = PQ.unpack_nibbles(state.codes[:, t0:t0 + tile].T, n_sub)
        else:
            codes = state.codes[t0:t0 + tile]
        xhat = PQ.decode(codes, state.codebooks)
        s = D.pairwise_scores(qs, xhat, state.norms[t0:t0 + tile], metric, precision=precision)
        if approx:
            if s.shape[1] < tile:
                s = torch.nn.functional.pad(s, (0, tile - s.shape[1]), value=_INF)
            ts, tp = AK.approx_min_k(s, min(k, tile), recall_target=recall_target)
        else:
            ts, tp = T.smallest_k_dense(s, min(k, s.shape[1]))
        ti = torch.where(torch.isfinite(ts), tp.to(torch.int32) + t0, -1)
        ts = torch.where(ti >= 0, ts, _INF)
        ts, ti = _pad_k(ts, ti, k)
        best_s, best_i = T.merge_topk(best_s, best_i, ts, ti, k)
    return best_s, best_i


def _pq_search(state: PQState, q: torch.Tensor, k: int, cfg: PQConfig, approx: bool):
    """Full search: the codes pass (+ the exact refine rerank when a refine
    store exists). approx=True with cfg.scan="pallas" takes the fused ADC
    kernel; otherwise the decode scan. Returns user-facing (scores, ids)."""
    metric, refine, rerank = cfg.metric, cfg.refine, cfg.rerank
    qs = D.preprocess_queries(q, metric)
    # the codes pass runs in the (OPQ-rotated) code space, the rerank in the
    # original space; ||qr|| == ||qs||, so finalize_scores works on either
    qr = PQ.apply_rotation(qs, state.rot)
    kk = k if refine == "none" else max(k * rerank, k)
    if approx and cfg.scan == "pallas":
        lut = PQ.adc_lut(qr, state.codebooks)
        s1, i1 = pq_scan_topk(
            lut, state.codes, state.norms, kk, l_bins=cfg.l_bins, bq_tile=cfg.pallas_bq,
            chunk=cfg.pallas_chunk, metric=metric, precision=cfg.scan_precision,
            per_bin=cfg.per_bin, seg_rows=cfg.seg_rows)
    else:
        s1, i1 = _pq_scan(state, qr, kk, metric, cfg.tile_n, cfg.precision, cfg.packed,
                          approx=approx, recall_target=cfg.recall_target)
    if refine == "none":
        return _user_scores(s1, i1, qs, metric), i1
    safe = i1.clamp(min=0).long()
    rv = state.refine[safe].float()
    if refine in ("int8", "int16"):
        rv = rv * state.r_scales[safe][..., None]
    dots = torch.einsum("bd,bcd->bc", qs, rv)
    ex = D.sq_norms(rv) - 2.0 * dots if metric == "l2" else -dots
    ex = torch.where(i1 >= 0, ex, _INF)
    best_s, best_i = T.smallest_k(ex, i1, k)
    return _user_scores(best_s, best_i, qs, metric), best_i


def state_from_numpy(cfg: PQConfig, codes, norms, codebooks, rot, refine, r_scales, n,
                     device) -> PQState:
    """The JAX package's PQState arrays, as numpy, -> the port's state on
    `device`. A bf16 refine store may arrive as ml_dtypes.bfloat16 or as the
    uint16 view a save file holds."""
    return PQState(
        codes=tensor_from_numpy(codes, device),
        norms=tensor_from_numpy(norms, device).float(),
        codebooks=tensor_from_numpy(codebooks, device).float(),
        rot=tensor_from_numpy(rot, device).float(),
        refine=tensor_from_numpy(refine, device, bf16=cfg.refine == "bfloat16"),
        r_scales=tensor_from_numpy(r_scales, device).float(),
        n=int(np.asarray(n)),
    )


class PQFlatIndex:
    """Product-quantized scan index (codes + optional refine store).

    build/add/search/remove/compact/save/load/get, filtered search through
    `allowed`. Codebooks are trained on the first build/add and frozen;
    later adds encode against them.
    """

    def __init__(self, cfg: PQConfig, capacity: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.state: Optional[PQState] = (
            init_state(self.capacity, cfg, self.device) if capacity else None)
        self._trained = False
        self._dead: set[int] = set()
        # Guards mutations; searches read self.state once and take no lock.
        self._write_lock = threading.RLock()

    def __len__(self) -> int:
        return self._n_total - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def _n_total(self) -> int:
        return 0 if self.state is None else self.state.n

    def _as_f32(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")
        return x

    # -- construction ------------------------------------------------------

    def _train(self, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(codebooks, rot) from a sample of xf (f32, metric-preprocessed),
        drawn from a generator seeded with cfg.seed. rot is the [0, 0]
        sentinel unless cfg.opq."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        n = xf.shape[0]
        xs = xf
        if n > cfg.train_sample:
            sel = torch.randperm(n, generator=gen)[:cfg.train_sample]
            xs = xf[sel.to(xf.device)]
        if cfg.opq:
            rot, cb = PQ.train_opq(xs, gen, cfg.n_sub, cfg.n_codes, cfg.kmeans_iters,
                                   cfg.opq_iters)
            return cb, rot
        return (PQ.train_codebooks(xs, gen, cfg.n_sub, cfg.n_codes, cfg.kmeans_iters),
                torch.zeros((0, 0), dtype=torch.float32, device=xf.device))

    def _ensure_capacity(self, extra: int):
        need = self._n_total + extra
        if self.state is None:
            self.capacity = max(need, 1024)
            self.state = init_state(self.capacity, self.cfg, self.device)
        elif need > self.capacity:
            new_cap = max(need, 2 * self.capacity)
            old = self.state
            grown = init_state(new_cap, self.cfg, self.device, codebooks=old.codebooks,
                               rot=old.rot)
            if self.cfg.packed:
                grown.codes[:, : self.capacity] = old.codes
            else:
                grown.codes[: self.capacity] = old.codes
            grown.norms[: self.capacity] = old.norms
            grown.refine[: self.capacity] = old.refine
            grown.r_scales[: self.capacity] = old.r_scales
            grown.n = old.n
            self.state = grown
            self.capacity = new_cap

    def add(self, x) -> None:
        """Insert a batch [B, D] (or a single vector [D]). The first add on an
        untrained index trains the codebooks from this batch."""
        x = self._as_f32(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] == 0:
            return
        with self._write_lock:
            self._ensure_capacity(x.shape[0])
            if not self._trained:
                cb, rot = self._train(D.preprocess_queries(x, self.cfg.metric))
                self.state.codebooks, self.state.rot = cb, rot
                self._trained = True
            self.state = _ingest(self.state, x, self.cfg.metric, self.cfg.refine,
                                 self.cfg.packed)

    insert = add

    def build(self, x) -> None:
        """Replace contents with corpus x: train codebooks on a sample of x,
        then encode and ingest it."""
        with self._write_lock:
            self.state = None
            self.capacity = 0
            self._dead = set()
            self._trained = False
            self.add(x)

    # -- mutation ----------------------------------------------------------

    def remove(self, ids) -> int:
        """Tombstone by external id: the rows' norm bias becomes +inf, which
        both passes inherit. Returns the number of rows newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._write_lock:
            n = self._n_total
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            new = [int(i) for i in ids if int(i) not in self._dead]
            if not new:
                return 0
            rows = torch.as_tensor(new, dtype=torch.long, device=self.device)
            self.state.norms[rows] = _INF   # in place
            self._dead.update(new)
            return len(new)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and renumber the survivors to [0, L) in their
        former order; returns the survivors' old ids. Codes move verbatim and
        the codebooks stay."""
        with self._write_lock:
            n = self._n_total
            live = np.ones(n, bool)
            if self._dead:
                live[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live_np = np.flatnonzero(live)
            if self.state is not None and live_np.size < n:
                st = self.state
                if live_np.size == 0:
                    self.state = None
                    self.capacity = 0
                    if self._trained:   # keep the trained codebooks for later adds
                        self.capacity = 1024
                        self.state = init_state(self.capacity, self.cfg, self.device,
                                                codebooks=st.codebooks, rot=st.rot)
                else:
                    rows = torch.as_tensor(live_np, device=self.device)
                    self.state = PQState(
                        codes=st.codes[:, rows] if self.cfg.packed else st.codes[rows],
                        norms=st.norms[rows], codebooks=st.codebooks, rot=st.rot,
                        refine=st.refine[rows], r_scales=st.r_scales[rows],
                        n=int(live_np.size))
                    self.capacity = int(live_np.size)
            self._dead = set()
            return live_np

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format (a bf16 refine store as
        its uint16 bits). Tombstones ride in `norms` (+inf rows)."""
        if self.state is None:
            raise ValueError("empty index")
        st = self.state
        refine = st.refine.cpu()
        if refine.dtype == torch.bfloat16:
            refine = refine.view(torch.int16).numpy().view(np.uint16)
        else:
            refine = refine.numpy()
        np.savez(
            path,
            cfg=json.dumps(dataclasses.asdict(self.cfg)),
            capacity=np.int64(self.capacity),
            trained=np.bool_(self._trained),
            codes=st.codes.cpu().numpy(),
            norms=st.norms.cpu().numpy(),
            codebooks=st.codebooks.cpu().numpy(),
            rot=st.rot.cpu().numpy(),
            refine=refine,
            r_scales=st.r_scales.cpu().numpy(),
            n=np.int32(st.n),
        )

    @classmethod
    def from_numpy(cls, cfg, codes, norms, codebooks, rot, refine, r_scales, n,
                   device=None, trained: bool = True) -> "PQFlatIndex":
        """An index over the JAX package's state. `cfg` is a PQConfig or
        dataclasses.asdict of the JAX package's one; the arrays are its
        PQState's fields as numpy (a save file's contents)."""
        if isinstance(cfg, dict):
            cfg = PQConfig(**cfg)
        idx = cls(cfg, device=device)
        idx.state = state_from_numpy(cfg, codes, norms, codebooks, rot, refine, r_scales, n,
                                     idx.device)
        idx.capacity = int(idx.state.norms.shape[0])
        idx._trained = trained
        dead = np.flatnonzero(np.isinf(np.asarray(norms)[: idx.state.n]))
        idx._dead = set(int(i) for i in dead)
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "PQFlatIndex":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            rot = z["rot"] if "rot" in z else np.zeros((0, 0), np.float32)
            idx = cls.from_numpy(json.loads(str(z["cfg"])), z["codes"], z["norms"],
                                 z["codebooks"], rot, z["refine"], z["r_scales"], z["n"],
                                 device=device, trained=bool(z["trained"]))
            idx.capacity = int(z["capacity"])
        return idx

    # -- reads -------------------------------------------------------------

    def get(self, ids) -> np.ndarray:
        """Stored representation for external ids -> [K, D] f32 numpy: the
        refine row (dequantized), or without a refine store the PQ
        reconstruction rotated back to the user's space."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        n = self._n_total
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= n).any():
            raise IndexError(f"ids must be in [0, {n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        rows = torch.as_tensor(ids, device=self.device)
        st = self.state
        if self.cfg.refine != "none":
            vecs = st.refine[rows].float()
            if self.cfg.refine in ("int8", "int16"):
                vecs = vecs * st.r_scales[rows][:, None]
            return vecs.cpu().numpy()
        if self.cfg.packed:
            codes = PQ.unpack_nibbles(st.codes[:, rows].T, self.cfg.n_sub)
        else:
            codes = st.codes[rows]
        dec = PQ.decode(codes, st.codebooks)
        # OPQ codes reconstruct x @ rot; rot is orthogonal, so rot.T undoes it
        return PQ.apply_rotation(dec, st.rot.T).cpu().numpy()

    def search(self, q, k: int, approx: bool = True, allowed=None, rerank: int | None = None):
        """Top-k. q: [B, D] or [D]. Returns (scores [B, k] f32, ids [B, k]
        int32) as tensors on the index's device.

        approx=True (default) takes the configured codes pass (the fused
        kernel under scan="pallas"); approx=False the exact-selection decode
        scan. Both are approximate against the original vectors (PQ
        quantization); the refine rerank repairs the ranking. rerank
        overrides cfg.rerank for this call. allowed: optional allowlist (bool
        mask over ids, or an int id array), exact at any selectivity.

        Empty index -> all ids -1; k > n -> trailing ids -1.
        """
        q = self._as_f32(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        state = self.state
        if state is not None and allowed is not None:
            mask = allowed_mask(allowed, self._n_total, state.norms.shape[0], self.device)
            state = dataclasses.replace(state, norms=torch.where(mask, state.norms, _INF))
        if state is None or not self._trained:
            s, i = _empty_result(q.shape[0], k, self.device)
        else:
            cfg = self.cfg
            if rerank is not None and rerank != cfg.rerank:
                cfg = dataclasses.replace(cfg, rerank=rerank)
            s, i = _pq_search(state, q, k, cfg, approx)
        if squeeze:
            return s[0], i[0]
        return s, i
