"""Flat (brute-force) index: exact kNN (port of zvdb_tpu/index/flat.py).

Serves as the recall oracle for the other engines, the distance code they
reuse, and a fast exact path for small corpora. The corpus axis is tiled so
[B, N] score matrices stay bounded; tiles are scanned with a running top-k
merge. With FlatConfig(scan="pallas") the approximate path runs the fused
scan kernel of ops/flat_scan.py instead.

Entry points take `device=None`, which means "cuda"; without a CUDA device
they raise unless the caller asks for device="cpu".
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
from ..ops import topk as T
from ..ops.flat_scan import flat_scan_topk
from ..utils.config import FlatConfig
from ..utils.masks import allowed_mask

_INF = float("inf")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means "cuda". Raises when CUDA is
    asked for and absent: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: zvdb_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class FlatState:
    """Device-resident flat index state."""

    vectors: torch.Tensor   # [cap, D] storage dtype (f32/bf16/int8 codes)
    norms: torch.Tensor     # [cap] f32 squared norms (zeros unless l2); +inf = invalid
    scales: torch.Tensor    # [cap] f32 dequant scales (1.0 for float dtypes)
    n: int                  # slots used; a host int (the JAX state keeps a device scalar)


def init_state(capacity: int, cfg: FlatConfig, device) -> FlatState:
    # norms double as the validity bias: +inf until a row is ingested (all
    # metrics), so search never materializes a [B, N] mask
    return FlatState(
        vectors=torch.zeros((capacity, cfg.dim), dtype=cfg.storage_dtype, device=device),
        norms=torch.full((capacity,), _INF, dtype=torch.float32, device=device),
        scales=torch.ones((capacity,), dtype=torch.float32, device=device),
        n=0,
    )


def _ingest(state: FlatState, x: torch.Tensor, metric: str, dtype_name: str) -> FlatState:
    """Append rows x at state.n. Updates the state's tensors IN PLACE (the JAX
    version's dynamic_update_slice returns copies); the caller has made room.
    Norms are written last, so a concurrent reader sees each new row either
    as +inf (invalid) or complete."""
    if dtype_name == "int8":
        stored, scales, norms = D.quantize_corpus(x, metric)
    else:
        stored, norms = D.preprocess_corpus(x, metric, {"float32": torch.float32,
                                                        "bfloat16": torch.bfloat16}[dtype_name])
        scales = torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    lo, hi = state.n, state.n + x.shape[0]
    state.vectors[lo:hi] = stored
    state.scales[lo:hi] = scales
    state.norms[lo:hi] = norms
    state.n = hi
    return state


def _pad_k(s: torch.Tensor, i: torch.Tensor, k: int):
    if s.shape[-1] == k:
        return s, i
    b, w = s.shape
    return (torch.cat([s, s.new_full((b, k - w), _INF)], dim=1),
            torch.cat([i, i.new_full((b, k - w), -1)], dim=1))


def _user_scores(best_s, best_i, qs, metric):
    out = D.finalize_scores(best_s, qs, metric)
    return torch.where(best_i >= 0, out, _INF if metric == "l2" else -_INF)


def _search(
    state: FlatState, q: torch.Tensor, k: int, metric: str, tile_n: int,
    approx: bool = False, recall_target: float = 0.95, precision: str = "highest",
):
    """Top-k: scan corpus tiles, merge running top-k. Returns (scores, ids).

    approx=True selects each tile's candidates with ops/approx_topk.py:
    approx_min_k at recall_target, as the JAX version uses lax.approx_min_k:
    on the card its kernel folds each [B, tile] score row into bins and
    keeps the best bins; on the CPU it selects exactly, as JAX's does there.
    A short last tile is padded with +inf to the tile's width first, as
    JAX pads the corpus, so its bins are the TPU's. Scores are user-facing
    (squared L2 distance, or similarity for dot/cosine).
    """
    cap = state.vectors.shape[0]
    tile = min(tile_n, cap)
    qs = D.preprocess_queries(q, metric)
    b = qs.shape[0]
    best_s = torch.full((b, k), _INF, dtype=torch.float32, device=qs.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=qs.device)
    for t0 in range(0, cap, tile):
        # un-ingested rows carry norms=+inf, so their scores are +inf: no
        # [B, tile] id/mask arrays are ever materialized
        s = D.pairwise_scores(qs, state.vectors[t0:t0 + tile], state.norms[t0:t0 + tile],
                              metric, precision=precision,
                              x_scales=state.scales[t0:t0 + tile])
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
    return _user_scores(best_s, best_i, qs, metric), best_i


def _rerank(state: FlatState, qs: torch.Tensor, cand: torch.Tensor, k: int, metric: str):
    """Second pass shared by every two-pass path: gather the candidates'
    stored rows, rescore them in f32 and keep the k best. Plain tensor code."""
    safe = cand.clamp(min=0).long()
    rv = state.vectors[safe].float() * state.scales[safe][..., None]   # [B, C, D]
    rn = state.norms[safe]
    dots = torch.einsum("bd,bcd->bc", qs, rv)
    ex = rn - 2.0 * dots if metric == "l2" else rn - dots
    ex = torch.where(cand >= 0, ex, _INF)
    best_s, best_i = T.smallest_k(ex, cand, k)
    return _user_scores(best_s, best_i, qs, metric), best_i


def _search_rerank(
    state: FlatState, q: torch.Tensor, k: int, metric: str, tile_n: int,
    recall_target: float = 0.95, scan_precision: str = "default", rerank: int = 4,
):
    """Two-pass approx search: a scan at `scan_precision` keeping rerank*k
    candidates, then an exact f32 rescore of those rows."""
    kk = max(k * rerank, k)
    qs = D.preprocess_queries(q, metric)
    _, i1 = _search(state, q, kk, metric, tile_n, approx=True,
                    recall_target=recall_target, precision=scan_precision)
    return _rerank(state, qs, i1, k, metric)


def _search_pallas_rerank(
    state: FlatState, q: torch.Tensor, k: int, metric: str, l_bins: int,
    bq_tile: int, chunk: int, scan_precision: str, rerank: int,
):
    """Two-pass fused path: the scan kernel at `scan_precision` keeps
    rerank*k bin winners, and the exact f32 rescore repairs the bf16
    ranking noise (float dtypes only; int8 takes the tiled path in search())."""
    qs = D.preprocess_queries(q, metric)
    kk = max(k * rerank, k)
    _, i1 = flat_scan_topk(
        qs, state.vectors, state.norms, kk, l_bins=l_bins, bq_tile=bq_tile,
        chunk=chunk, metric=metric, precision=scan_precision)
    return _rerank(state, qs, i1, k, metric)


def _search_pca_rerank(
    proj: FlatState, state: FlatState, basis: torch.Tensor, mean: torch.Tensor,
    q: torch.Tensor, k: int, metric: str, tile_n: int, recall_target: float,
    rerank: int,
):
    """PCA-filtered two-pass search: pass 1 scans the projected corpus
    (D -> p cuts the dominant matmul by D/p), pass 2 rescores the rerank*k
    survivors exactly in full dimension."""
    kk = max(k * rerank, k)
    qs = D.preprocess_queries(q, metric)   # cosine: normalize BEFORE project
    qp = (qs - mean[None, :]) @ basis      # [B, p]
    _, i1 = _search(proj, qp, kk, metric, tile_n, approx=True,
                    recall_target=recall_target, precision="default")
    return _rerank(state, qs, i1, k, metric)


def _project_corpus(state: FlatState, basis: torch.Tensor, mean: torch.Tensor,
                    metric: str) -> FlatState:
    """Projected shadow of the corpus for the PCA first pass. +inf rows
    (uningested/tombstoned) stay +inf, so the projected scan masks exactly
    what the full scan would."""
    vecs = state.vectors.float() * state.scales[:, None]
    pv = (vecs - mean[None, :]) @ basis                   # [cap, p]
    pn = D.sq_norms(pv) if metric == "l2" else pv.new_zeros(pv.shape[0])
    pn = torch.where(torch.isinf(state.norms), _INF, pn)
    return FlatState(vectors=pv, norms=pn, scales=torch.ones_like(pn), n=state.n)


def _count_range(state: FlatState, q: torch.Tensor, radius: float, metric: str,
                 tile_n: int, precision: str) -> torch.Tensor:
    """Exact in-range neighbor count per query [B] int32 (squared-L2 <= radius
    for l2, similarity >= radius for dot/cosine); +inf rows never count."""
    cap = state.vectors.shape[0]
    tile = min(tile_n, cap)
    qs = D.preprocess_queries(q, metric)
    # surrogate-space threshold: l2 user = surrogate + ||q||^2; dot/cos user = -surrogate
    thr = (radius - D.sq_norms(qs)) if metric == "l2" \
        else torch.full((qs.shape[0],), -radius, dtype=torch.float32, device=qs.device)
    counts = torch.zeros((qs.shape[0],), dtype=torch.int32, device=qs.device)
    for t0 in range(0, cap, tile):
        s = D.pairwise_scores(qs, state.vectors[t0:t0 + tile], state.norms[t0:t0 + tile],
                              metric, precision=precision,
                              x_scales=state.scales[t0:t0 + tile])
        counts += (s <= thr[:, None]).sum(dim=1, dtype=torch.int32)
    return counts


def _empty_result(b: int, k: int, device):
    return (torch.full((b, k), _INF, dtype=torch.float32, device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device))


def tensor_from_numpy(a, device, bf16: bool = False) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on `device`. bf16 arrives as
    ml_dtypes.bfloat16 (from np.asarray of a JAX array) or as the raw 2-byte
    void dtype np.savez writes for it; both are read as bits, so ml_dtypes is
    never imported. bf16=True also reads any other 2-byte array (the uint16
    view a PQ save file holds) as bf16 bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V" or bf16):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(vectors, norms, scales, n, device) -> FlatState:
    """The JAX package's FlatState arrays, as numpy, -> the port's state on
    `device`."""
    return FlatState(vectors=tensor_from_numpy(vectors, device),
                     norms=tensor_from_numpy(norms, device).float(),
                     scales=tensor_from_numpy(scales, device).float(), n=int(np.asarray(n)))


class FlatIndex:
    """Exact kNN index with batched insert/search, deletes and filtered search."""

    def __init__(self, cfg: FlatConfig, capacity: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.state: Optional[FlatState] = (
            init_state(self.capacity, cfg, self.device) if capacity else None
        )
        self._dead: set[int] = set()   # tombstoned external ids (host mirror)
        # Guards mutations (add/remove/compact/build). Searches take no lock:
        # they read self.state once, and every write lands in a row that
        # searches treat as invalid until its norm is written.
        self._write_lock = threading.RLock()
        # PCA-filter derived state (cfg.pca_dim > 0): projected corpus +
        # basis, rebuilt lazily when contents change; never persisted
        self._proj: Optional[FlatState] = None
        self._proj_basis: Optional[torch.Tensor] = None   # [D, p]
        self._proj_mean: Optional[torch.Tensor] = None    # [D] (zeros for dot)
        self._proj_rev = None   # mutation counter the projection reflects
        self._mutations = 0      # bumped on every content change

    def __len__(self) -> int:
        """Live count (inserted minus deleted)."""
        return self._n_total - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def _n_total(self) -> int:
        """Slots used, including tombstones (== the next insert id)."""
        return 0 if self.state is None else self.state.n

    def _as_f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _check_dim(self, x: torch.Tensor):
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    def _ensure_capacity(self, extra: int):
        need = self._n_total + extra
        if self.state is None:
            self.capacity = max(need, 1024)
            self.state = init_state(self.capacity, self.cfg, self.device)
        elif need > self.capacity:
            new_cap = max(need, 2 * self.capacity)
            old = self.state
            grown = init_state(new_cap, self.cfg, self.device)
            grown.vectors[: self.capacity] = old.vectors
            grown.norms[: self.capacity] = old.norms
            grown.scales[: self.capacity] = old.scales
            grown.n = old.n
            self.state = grown
            self.capacity = new_cap

    def add(self, x) -> None:
        """Insert a batch [B, D] (or a single vector [D])."""
        x = self._as_f32(x)
        if x.ndim == 1:
            x = x[None, :]
        self._check_dim(x)
        with self._write_lock:
            self._ensure_capacity(x.shape[0])
            self.state = _ingest(self.state, x, self.cfg.metric, self.cfg.dtype)
            self._mutations += 1

    insert = add

    def build(self, x) -> None:
        """Replace contents with corpus x (engine-uniform bulk-build API)."""
        with self._write_lock:
            self.state = None
            self.capacity = 0
            self._dead = set()
            self.add(x)

    def remove(self, ids) -> int:
        """Delete by external id (tombstone): the rows' norm bias becomes +inf,
        which every search path treats as an invalid row. Ids never renumber
        and freed slots are not reused; compact() reclaims memory. Returns the
        number of rows newly deleted."""
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
            self._mutations += 1
            return len(new)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and renumber the survivors to [0, L) in their
        former order. Returns the survivors' old ids ([L] int64), so
        new_id == position in the returned array. Stored rows move verbatim."""
        with self._write_lock:
            n = self._n_total
            live = np.ones(n, bool)
            if self._dead:
                live[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live_np = np.flatnonzero(live)
            if self.state is not None and live_np.size < n:
                if live_np.size == 0:   # everything deleted -> empty index
                    self.state = None
                    self.capacity = 0
                else:
                    rows = torch.as_tensor(live_np, device=self.device)
                    self.state = FlatState(
                        vectors=self.state.vectors[rows],
                        norms=self.state.norms[rows],
                        scales=self.state.scales[rows],
                        n=int(live_np.size),
                    )
                    self.capacity = int(live_np.size)
            self._dead = set()
            self._mutations += 1
            return live_np

    def save(self, path: str) -> None:
        """npz snapshot (config + arrays) in the JAX package's format.
        Tombstones ride in `norms` (+inf rows)."""
        if self.state is None:
            raise ValueError("empty index")
        vectors = self.state.vectors.cpu()
        if vectors.dtype == torch.bfloat16:   # the 2-byte void dtype JAX's file holds
            vectors = vectors.view(torch.int16).numpy().view(np.dtype("V2"))
        else:
            vectors = vectors.numpy()
        np.savez(
            path,
            cfg=json.dumps(dataclasses.asdict(self.cfg)),
            capacity=np.int64(self.capacity),
            vectors=vectors,
            norms=self.state.norms.cpu().numpy(),
            scales=self.state.scales.cpu().numpy(),
            n=np.int32(self.state.n),
        )

    @classmethod
    def from_numpy(cls, cfg_dict: dict, arrays, device=None) -> "FlatIndex":
        """An index over the JAX package's state: `cfg_dict` is
        dataclasses.asdict of its FlatConfig, `arrays` maps vectors, norms,
        scales and n to numpy arrays (a save file's contents)."""
        idx = cls(FlatConfig(**cfg_dict), device=device)
        idx.state = state_from_numpy(arrays["vectors"], arrays["norms"],
                                     arrays["scales"], arrays["n"], idx.device)
        idx.capacity = idx.state.vectors.shape[0]
        n = idx.state.n
        dead = np.flatnonzero(np.isinf(np.asarray(arrays["norms"])[:n]))
        idx._dead = set(int(i) for i in dead)
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "FlatIndex":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            idx = cls.from_numpy(json.loads(str(z["cfg"])), z, device=device)
            idx.capacity = int(z["capacity"])
        return idx

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids (row order = insertion order) ->
        [K, D] f32 numpy; dequantized for int8, normalized for cosine."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        n = self._n_total
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= n).any():
            raise IndexError(f"ids must be in [0, {n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        rows = torch.as_tensor(ids, device=self.device)
        vecs = self.state.vectors[rows].float()
        if self.cfg.dtype == "int8":
            vecs = vecs * self.state.scales[rows][:, None]
        return vecs.cpu().numpy()

    def _ensure_projection(self) -> None:
        """(Re)build the PCA basis + projected corpus when contents changed.
        Basis: top pca_dim right singular vectors of a corpus sample
        (centered for l2; uncentered for dot/cosine, where centering would
        corrupt dots)."""
        rev = self._mutations
        if self._proj is not None and self._proj_rev == rev:
            return
        cfg = self.cfg
        n = self._n_total
        p = min(cfg.pca_dim, cfg.dim)
        sample_rows = torch.as_tensor(np.linspace(
            0, max(n - 1, 0), num=min(n, 16384), dtype=np.int64), device=self.device)
        sample = (self.state.vectors[sample_rows].float()
                  * self.state.scales[sample_rows][:, None]).cpu().numpy()
        mean = sample.mean(0) if cfg.metric == "l2" \
            else np.zeros(cfg.dim, np.float32)
        _, _, vt = np.linalg.svd(sample - mean, full_matrices=False)
        self._proj_basis = torch.from_numpy(vt[:p].T.astype(np.float32)).to(self.device)
        self._proj_mean = torch.from_numpy(mean.astype(np.float32)).to(self.device)
        self._proj = _project_corpus(
            self.state, self._proj_basis, self._proj_mean, cfg.metric)
        self._proj_rev = rev

    def _search_pallas(self, q: torch.Tensor, k: int):
        """The fused scan kernel (ops/flat_scan.py): bin-parallel partial
        selection. With cfg.rerank: a bf16 scan + exact f32 rerank."""
        cfg = self.cfg
        if cfg.rerank:
            return _search_pallas_rerank(
                self.state, q, k, cfg.metric, cfg.l_bins, cfg.pallas_bq,
                cfg.pallas_chunk, cfg.scan_precision, cfg.rerank,
            )
        qs = D.preprocess_queries(q, cfg.metric)
        s, i = flat_scan_topk(
            qs, self.state.vectors, self.state.norms, k,
            l_bins=cfg.l_bins, bq_tile=cfg.pallas_bq, chunk=cfg.pallas_chunk,
            metric=cfg.metric, precision=cfg.precision,
        )
        return _user_scores(s, i, qs, cfg.metric), i

    def search(self, q, k: int, approx: bool = False, allowed=None):
        """Top-k. q: [B, D] or [D]. Returns (scores [B,k] f32, ids [B,k] int32)
        as tensors on the index's device.

        approx=True takes the configured approximate path (two-pass rerank,
        PCA filter, or the fused scan kernel under scan="pallas").
        allowed: optional allowlist (bool mask over external ids, or an int
        id array); only listed ids can appear in results. Exact for every
        selectivity (one validity-bias mask on the full scan).

        Empty index -> all ids are -1. k > n -> trailing slots have id -1.
        """
        q = self._as_f32(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        self._check_dim(q)
        state = self.state
        proj = None
        if state is not None and allowed is not None:
            mask = allowed_mask(allowed, self._n_total, state.vectors.shape[0],
                                self.device)
            state = dataclasses.replace(state, norms=torch.where(mask, state.norms, _INF))
            if approx and self.cfg.pca_dim > 0:
                self._ensure_projection()
                proj = dataclasses.replace(
                    self._proj, norms=torch.where(mask, self._proj.norms, _INF))
        if state is None:
            s, i = _empty_result(q.shape[0], k, self.device)
        elif approx and self.cfg.pca_dim > 0:
            if proj is None:
                self._ensure_projection()
                proj = self._proj
            s, i = _search_pca_rerank(
                proj, state, self._proj_basis, self._proj_mean,
                q, k, self.cfg.metric, self.cfg.tile_n,
                self.cfg.recall_target, max(self.cfg.rerank, 4),
            )
        elif approx and self.cfg.scan == "pallas" and self.cfg.dtype != "int8" \
                and allowed is None:
            # handles cfg.rerank internally; filtered search takes the tiled
            # path (same contract)
            s, i = self._search_pallas(q, k)
        elif approx and self.cfg.rerank:
            s, i = _search_rerank(
                state, q, k, self.cfg.metric, self.cfg.tile_n,
                recall_target=self.cfg.recall_target,
                scan_precision=self.cfg.scan_precision,
                rerank=self.cfg.rerank,
            )
        else:
            s, i = _search(
                state, q, k, self.cfg.metric, self.cfg.tile_n,
                approx=approx, recall_target=self.cfg.recall_target,
                precision=self.cfg.precision,
            )
        if squeeze:
            return s[0], i[0]
        return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius`: squared-L2 <= radius for l2, or
        similarity >= radius for dot/cosine. Returns (scores [B, R], ids
        [B, R], counts [B]) with R = max_results; counts is the exact number
        of in-range neighbors, and when it exceeds R the row holds the R best.
        Invalid slots: id -1."""
        q = self._as_f32(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        self._check_dim(q)
        if self.state is None:
            s, i = _empty_result(q.shape[0], max_results, self.device)
            c = torch.zeros((q.shape[0],), dtype=torch.int32, device=self.device)
        else:
            s, i = _search(
                self.state, q, max_results, self.cfg.metric, self.cfg.tile_n,
                approx=False, precision=self.cfg.precision,
            )
            if self.cfg.metric == "l2":
                in_r = (s <= radius) & (i >= 0)
            else:
                in_r = (s >= radius) & (i >= 0)
            i = torch.where(in_r, i, -1)
            s = torch.where(in_r, s, _INF if self.cfg.metric == "l2" else -_INF)
            c = _count_range(self.state, q, float(radius), self.cfg.metric,
                             self.cfg.tile_n, self.cfg.precision)
        if squeeze:
            return s[0], i[0], c[0]
        return s, i, c


def masked_exact_search(vectors, norms_bias, scales, q, k: int, metric: str,
                        tile_n: int = 131072, precision: str = "high",
                        approx: bool = True, recall_target: float = 0.97):
    """Exact-scoring top-k over an arbitrary (vectors, norms+validity-bias,
    scales) view: the masked scan other engines route filtered search
    through. norms_bias carries +inf for every blocked/dead/padding row."""
    st = FlatState(vectors=vectors, norms=norms_bias, scales=scales,
                   n=int(vectors.shape[0]))
    # graph-engine configs say "float32" where the flat scan says "highest"
    precision = {"float32": "highest"}.get(precision, precision)
    return _search(st, q, k, metric, tile_n, approx=approx,
                   recall_target=recall_target, precision=precision)


def exact_ground_truth(corpus, queries, k: int, metric: str = "l2",
                       tile_n: int = 65536, device=None):
    """One-shot exact kNN for recall evaluation. Returns numpy (scores, ids)."""
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    cfg = FlatConfig(dim=int(corpus.shape[-1]), metric=metric, tile_n=tile_n)
    idx = FlatIndex(cfg, capacity=int(corpus.shape[0]), device=device)
    idx.add(corpus)
    s, i = idx.search(queries, k)
    return s.cpu().numpy(), i.cpu().numpy()
