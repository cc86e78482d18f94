"""IVF-PQ index: cluster-blocked 4-bit PQ codes + the grouped ADC scan
(port of zvdb_tpu/index/ivfpq.py).

The sublinear scale tier. The corpus is grouped into k-means clusters stored
as contiguous blocks of nibble-packed PQ codes; a search picks each query's
nprobe nearest centroids, slots the (query, cluster) pairs per cluster, and
the grouped pair scan (ops/pq_scan.py:pq_grouped_scan_pairs, in
csrc/pq_scan.cu) scores every probed cluster against only the queries that
probed it, writing each (query, probe) pool in place. The per-bin winners
form a candidate pool that an exact rescore over the refine store (int16 by
default) cuts to k.

Codes are non-residual (one global codebook set, trained on a sample), so a
row's ADC score does not depend on its cluster: the cluster decides only
whether the row is scanned.

Entry points take `device=None`, which means "cuda"; without a CUDA device
they raise unless the caller asks for "cpu". Training (PQ codebooks, k-means)
draws from torch.Generators seeded from cfg.seed, which cannot reproduce the
JAX package's PRNG; `IVFPQIndex.from_numpy` and `load` carry a JAX-built
index across.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..ops import distance as D
from ..ops import pq as PQ
from ..ops import topk as T
from ..ops.pq_scan import grouped_geometry, pq_grouped_scan_pairs
from ..utils.config import _VALID_METRICS
from ..utils.filter_policy import resolve_filter_mode
from ..utils.masks import allowed_mask
from .flat import masked_exact_search, resolve_device, tensor_from_numpy
from .ivf import _assign, _ivf_range, _slot_pairs, split_oversized_device
from .knn_graph import _kmeans_device

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class IVFPQConfig:
    """Config for the IVF-PQ scale engine (fields, defaults and validation
    as in the JAX package, so save files load in both).

    4-bit codes (n_codes=16, which the fused scan requires), an int8 table
    for the scan, an int16 refine store for the exact rerank."""

    dim: int
    metric: str = "l2"
    # PQ geometry: n_sub/2 bytes of packed codes per vector; a multiple of 8.
    n_sub: int = 16
    # IVF geometry: clusters default to ~4*sqrt(N) (pow2-rounded) at build.
    n_clusters: Optional[int] = None
    nprobe: int = 16
    # Refine store for the exact rerank: "int16" (2D+4 B/vec), "int8",
    # "float32", "bfloat16", or "none" (codes only).
    refine: str = "int16"
    # Candidates per result entering the refine rerank.
    rerank: int = 16
    # PQ codebook training (once, frozen; adds encode against them).
    train_sample: int = 32768
    pq_kmeans_iters: int = 8
    opq: bool = False
    opq_iters: int = 8
    # IVF k-means.
    ivf_kmeans_iters: int = 12
    kmeans_sample: int = 131072
    max_cluster_factor: float = 2.0
    block_headroom: float = 1.25
    # Grouped-scan geometry: a (query, cluster) pool of per_bin*l_bins rows;
    # chunk sets the padded cluster capacity (grouped_geometry).
    l_bins: int = 256
    chunk: int = 512
    per_bin: int = 2
    # Table precision of the scan: "int8", "default" (bf16), "high" (hi/lo).
    scan_precision: str = "int8"
    # Per-cluster query-slot capacity = slack * B * P / C; pairs past a hot
    # cluster's capacity are dropped, its highest-rank probes first.
    group_slack: float = 4.0
    # Expected final corpus size for chunked builds: block capacity and the
    # refine store are pre-sized so later add() chunks append without a
    # repack. None = size for the built corpus only.
    expected_rows: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(
                f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.dim % self.n_sub != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by n_sub ({self.n_sub})")
        if self.n_sub % 8 != 0:
            raise ValueError("n_sub must be a multiple of 8 (kernel layout)")
        if self.refine not in ("none", "int8", "int16", "float32", "bfloat16"):
            raise ValueError(f"invalid refine {self.refine!r}")
        if self.l_bins % 128 != 0:
            raise ValueError("l_bins must be a multiple of 128")
        if self.chunk % self.l_bins != 0:
            raise ValueError("chunk must be a multiple of l_bins")
        if self.per_bin not in (1, 2):
            raise ValueError("per_bin must be 1 or 2")
        if self.scan_precision not in ("default", "high", "int8"):
            raise ValueError(f"invalid scan_precision {self.scan_precision!r}")

    @property
    def dsub(self) -> int:
        return self.dim // self.n_sub

    @property
    def nb(self) -> int:
        return self.n_sub // 2

    @property
    def refine_dtype(self) -> torch.dtype:
        return {"int8": torch.int8, "int16": torch.int16, "float32": torch.float32,
                "bfloat16": torch.bfloat16, "none": torch.float32}[self.refine]

    @property
    def bytes_per_vector(self) -> int:
        """Device bytes per vector (codes + norm + id + refine store)."""
        refine = {"none": 0, "int8": self.dim + 4, "int16": 2 * self.dim + 4,
                  "float32": 4 * self.dim, "bfloat16": 2 * self.dim}[self.refine]
        return self.n_sub // 2 + 8 + refine


@dataclasses.dataclass
class IVFPQState:
    """Device-resident IVF-PQ state (the JAX package's IVFPQState fields)."""

    centroids: torch.Tensor     # [C, D] f32
    c_norms: torch.Tensor       # [C] f32 (squared norms for l2; zeros otherwise)
    codes_blocks: torch.Tensor  # [C, S/2, cap] uint8 nibble-packed PQ codes
    norms_blocks: torch.Tensor  # [C, cap] f32 decoded squared norms; +inf invalid
    b_ids: torch.Tensor         # [C, cap] int32 ext ids; -1 pad, -2-id tombstone
    counts: torch.Tensor        # [C] int32
    codebooks: torch.Tensor     # [S, 16, dsub] f32 (frozen after training)
    rot: torch.Tensor           # [D, D] OPQ rotation or [0, 0]
    refine: torch.Tensor        # [rcap, D] refine rows (ext-id order) or [rcap, 0]
    r_scales: torch.Tensor      # [rcap] f32 dequant scales (int refine)
    n: int                      # rows ingested (tombstones included); a host int


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(IVFPQState))

# Repacks up to this size take the device split (one upload); larger ones
# stream host segments and skip the split (tests shrink it to exercise the
# streamed path at CPU scale).
_REPACK_SPLIT_MAX_ROWS = 4_000_000


# ---------------------------------------------------------------------------
# pack (in place: the JAX versions donate their carries and return copies)


def _pack_rows(xo, ids, sa, slot, codes_blocks, norms_blocks, b_ids, codebooks, rot,
               metric: str) -> None:
    """Encode one segment's rows xo [S, D] and scatter their packed codes,
    decoded norms and external ids `ids` into (cluster sa, slot `slot`) of
    the blocks, in place (the JAX package's _pack_rows_core behind its two
    jitted segment packs, which donate their carries). Segments are never
    padded here, so every row is written."""
    codes = PQ.encode(PQ.apply_rotation(xo, rot), codebooks)
    if metric == "l2":
        norms = PQ.decoded_sq_norms(codes, codebooks)
    else:
        norms = torch.zeros(xo.shape[0], dtype=torch.float32, device=xo.device)
    wa, ws = sa.long(), slot.long()
    # advanced indices around a slice: the indexed shape is [rows, nb]
    codes_blocks[wa, :, ws] = PQ.pack_nibbles(codes)
    norms_blocks[wa, ws] = norms
    b_ids[wa, ws] = ids.to(torch.int32)


def _refine_segment(seg, rr, rrs, lo: int, metric: str, refine: str) -> None:
    """Fill one refine-store segment at ext-id offset lo, in place."""
    if refine in ("int8", "int16"):
        rows, scales, _ = D.quantize_corpus(seg, metric, bits=8 if refine == "int8" else 16)
    else:
        rows = D.preprocess_queries(seg, metric)
        scales = torch.ones(seg.shape[0], dtype=torch.float32, device=seg.device)
    rr[lo:lo + seg.shape[0]] = rows.to(rr.dtype)
    rrs[lo:lo + seg.shape[0]] = scales


# ---------------------------------------------------------------------------
# search


def _q_cap(b: int, p: int, c: int, group_slack: float, scan_precision: str) -> int:
    """Slots per cluster: slack * B * P / C, aligned as the TPU's operand
    tiles are (32 rows for int8, 8 otherwise), at most B * P aligned."""
    q_align = 32 if scan_precision == "int8" else 8
    q_cap = max(q_align, int(group_slack * b * p / max(c, 1)))
    return min(-(-q_cap // q_align) * q_align, -(-(b * p) // q_align) * q_align)


def _probe_slots(state: IVFPQState, qp: torch.Tensor, nprobe: int, group_slack: float,
                 scan_precision: str, metric: str, c_mask: Optional[torch.Tensor] = None):
    """The grouped scan's slot table for preprocessed queries qp: each
    query's exact top-p clusters (ties to the lower cluster, as lax.top_k),
    slotted per cluster. Returns (p, qslot, pslot)."""
    c = state.codes_blocks.shape[0]
    p = min(nprobe, c)
    cs = D.pairwise_scores(qp, state.centroids, state.c_norms, metric)    # [B, C]
    if c_mask is not None:
        cs = torch.where(c_mask[None, :], cs, _INF)
    _, probes = T.smallest_k_dense(cs, p)                                  # [B, P]
    b = qp.shape[0]
    qslot, pslot = _slot_pairs(probes, b, p, c, _q_cap(b, p, c, group_slack, scan_precision))
    return p, qslot, pslot


def ivfpq_search_impl(
    state: IVFPQState, q: torch.Tensor, k: int, nprobe: int,
    metric: str, refine: str, rerank: int,
    l_bins: int, chunk: int, per_bin: int, scan_precision: str,
    group_slack: float,
    allowed: Optional[torch.Tensor] = None,
    id_map: Optional[torch.Tensor] = None,
    c_mask: Optional[torch.Tensor] = None,
):
    """Batched IVF-PQ search. Returns (user scores [B, k], ext ids [B, k]).

    Probe scores -> exact top-p clusters (ties to the lower cluster) ->
    per-cluster slotting -> the pair scan over probed blocks, into flat
    positions per (query, probe) -> a top-(k*rerank) pool ->
    exact refine rescore -> top-k. `id_map` / `c_mask` serve a sharded
    wrapper (local ids, padded cluster slots), as in the JAX package."""
    qp = D.preprocess_queries(q, metric)
    qr = PQ.apply_rotation(qp, state.rot)
    b = qp.shape[0]
    c, _, cap = state.codes_blocks.shape
    p, qslot, pslot = _probe_slots(state, qp, nprobe, group_slack, scan_precision, metric,
                                   c_mask)

    lut = PQ.adc_lut(qr, state.codebooks)                                  # [B, S, 16]
    # each (query, probe) pool of the grouped scan, written in place: the
    # pool carries flat positions (cluster * capp + pos), not ids, and only
    # the k*rerank survivors of the pool cut pay the id-table gather
    merged_s, merged_i = pq_grouped_scan_pairs(
        lut, qslot, pslot, state.codes_blocks, state.norms_blocks, p, l_bins=l_bins,
        chunk=chunk, metric=metric, precision=scan_precision, per_bin=per_bin)
    lw = per_bin * l_bins                                                  # [B, p * lw]
    _, capp = grouped_geometry(cap, l_bins, chunk)
    ids_p = state.b_ids if capp == cap else torch.cat(
        [state.b_ids, state.b_ids.new_full((c, capp - cap), -1)], dim=1)

    def map_ids(pos):
        mapped = ids_p.reshape(-1)[pos.clamp(min=0).long()]
        # padding (-1) and tombstones (-2-id) both come back negative
        return torch.where(pos >= 0, mapped.clamp(min=-1), -1)

    if allowed is not None:
        # filtered probe mode: the allowlist needs external ids, so the
        # whole pool pays the id gather
        merged_i = map_ids(merged_i)
        ok = allowed[merged_i.clamp(min=0).long()] & (merged_i >= 0)
        merged_s = torch.where(ok, merged_s, _INF)
        merged_i = torch.where(ok, merged_i, -1)

    # each row lives in one (cluster, bin) pool and a pool holds distinct
    # rows, so the merged entries are duplicate-free per query
    kk = min(max(k * rerank, k) if refine != "none" else k, p * lw)
    if kk > 64:
        cand_s, cand_i = T.sort_smallest_k(merged_s, merged_i, kk)
        cand_s = torch.where(cand_i >= 0, cand_s, _INF)
    else:
        cand_s, cand_i = T.smallest_k(merged_s, merged_i, kk)
    if allowed is None:
        cand_i = map_ids(cand_i)                  # survivors only
    cand_s = torch.where(cand_i >= 0, cand_s, _INF)

    if refine != "none":
        safe = cand_i.clamp(min=0).long()
        rv = state.refine[safe].float()
        if refine in ("int8", "int16"):
            rv = rv * state.r_scales[safe][..., None]
        dots = torch.einsum("bd,bcd->bc", qp, rv)
        ex = D.sq_norms(rv) - 2.0 * dots if metric == "l2" else -dots
        ex = torch.where(cand_i >= 0, ex, _INF)
        best_s, best_i = T.smallest_k(ex, cand_i, k)
    else:
        best_s, best_i = T.smallest_k(cand_s, cand_i, k)

    user = D.finalize_scores(best_s, qp, metric)
    user = torch.where(best_i >= 0, user, _INF if metric == "l2" else -_INF)
    if id_map is not None:
        best_i = torch.where(best_i >= 0, id_map[best_i.clamp(min=0).long()], -1)
    return user, best_i


# ---------------------------------------------------------------------------
# incremental append


def _ivfpq_append(state: IVFPQState, x: torch.Tensor, assign: torch.Tensor,
                  valid: torch.Tensor, ext0: int, metric: str, refine: str) -> IVFPQState:
    """Append a batch into spare per-cluster capacity, in place: O(batch),
    not O(N). The batch is cluster-sorted (stably); a row's slot is its
    cluster's count plus its rank within the cluster. Rows with valid False
    (padding) are not written. The caller guarantees no overflow."""
    b = x.shape[0]
    c, _, cap = state.codes_blocks.shape
    dev = x.device
    key = torch.where(valid, assign.long(), c)
    order = torch.argsort(key, stable=True)
    sa = key[order]
    rank = torch.arange(b, device=dev) - torch.searchsorted(sa, sa, side="left")
    counts_ext = torch.cat([state.counts.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    slot = counts_ext[sa] + rank
    xo = x[order]
    vo = valid[order]
    ext = ext0 + order

    codes = PQ.encode(PQ.apply_rotation(xo, state.rot), state.codebooks)
    packed = PQ.pack_nibbles(codes)
    norms = (PQ.decoded_sq_norms(codes, state.codebooks) if metric == "l2"
             else torch.zeros(b, dtype=torch.float32, device=dev))
    w = vo & (slot < cap)                 # JAX drops the rest as out-of-range writes
    wc, ws = sa[w], slot[w]
    state.codes_blocks[wc, :, ws] = packed[w]
    state.norms_blocks[wc, ws] = norms[w]
    state.b_ids[wc, ws] = ext[w].to(torch.int32)
    state.counts += torch.bincount(sa[vo], minlength=c)[:c].to(torch.int32)
    if refine != "none":
        _refine_segment(x, state.refine, state.r_scales, ext0, metric, refine)
    state.n += int(vo.sum())
    return state


def _centroid_scores(x: np.ndarray, cent, metric: str, device) -> torch.Tensor:
    """pairwise_scores of host rows x against the centroids, with the
    centroids' squared norms as the norms term for every metric (as the JAX
    package assigns)."""
    cent = torch.as_tensor(cent, dtype=torch.float32, device=device)
    return D.pairwise_scores(torch.from_numpy(np.ascontiguousarray(x)).to(device), cent,
                             D.sq_norms(cent), metric)


def nearest_centroids(x: np.ndarray, cent, metric: str, device) -> np.ndarray:
    """Each host row's nearest centroid (int64), in chunks of 16384 rows."""
    out = [torch.argmin(_centroid_scores(x[lo:lo + 16384], cent, metric, device),
                        dim=-1).cpu().numpy() for lo in range(0, x.shape[0], 16384)]
    return np.concatenate(out).astype(np.int64) if out else np.zeros((0,), np.int64)


def state_from_numpy(cfg: IVFPQConfig, arrays, device) -> IVFPQState:
    """The JAX package's IVFPQState arrays, as numpy (a save file's
    contents), -> the port's state on `device`. A bf16 refine store may
    arrive as ml_dtypes.bfloat16 or as the uint16 view a save file holds;
    both are read as bits."""
    t = {f: tensor_from_numpy(arrays[f], device) for f in _STATE_FIELDS
         if f not in ("refine", "n")}
    refine = tensor_from_numpy(arrays["refine"], device, bf16=cfg.refine == "bfloat16")
    for f in ("centroids", "c_norms", "norms_blocks", "codebooks", "rot", "r_scales"):
        t[f] = t[f].float()
    return IVFPQState(refine=refine.to(cfg.refine_dtype), n=int(np.asarray(arrays["n"])), **t)


# ---------------------------------------------------------------------------
# public class


class IVFPQIndex:
    """IVF-PQ scale engine: build/add/search/remove/compact/save/load/get,
    filtered search via `allowed`, exact search_range over the refine store.
    """

    def __init__(self, cfg: IVFPQConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Optional[IVFPQState] = None
        # k-means draws advance this generator build after build, as the JAX
        # package splits its key
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._trained = False
        self._dead: set[int] = set()

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else self.state.n
            return n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _check_dim(self, x) -> None:
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}")

    # -- training -----------------------------------------------------------

    def _train(self, xf: torch.Tensor):
        """(codebooks, rot) from a sample of xf drawn from a generator seeded
        with cfg.seed; rot is the [0, 0] sentinel unless cfg.opq."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        n = xf.shape[0]
        xs = xf
        if n > cfg.train_sample:
            xs = xf[torch.randperm(n, generator=gen)[:cfg.train_sample].to(xf.device)]
        if cfg.opq:
            rot, cb = PQ.train_opq(xs, gen, cfg.n_sub, 16, cfg.pq_kmeans_iters, cfg.opq_iters)
            return cb, rot
        return (PQ.train_codebooks(xs, gen, cfg.n_sub, 16, cfg.pq_kmeans_iters),
                torch.zeros((0, 0), dtype=torch.float32, device=xf.device))

    # -- build --------------------------------------------------------------

    def build(self, x) -> None:
        """Bulk build on the device: PQ training, IVF k-means, assignment,
        the split of oversized clusters and the packed-code scatter. x may be
        numpy or a tensor (on the index's device: no upload). With
        ZVDB_BUILD_TRACE=1 it prints the time of each stage."""
        trace = os.environ.get("ZVDB_BUILD_TRACE", "") not in ("", "0")
        marks = [("start", time.perf_counter())]

        def mark(name):
            if trace:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                marks.append((name, time.perf_counter()))

        xd = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        n = xd.shape[0]
        with self._lock:
            self._pending = []
            self._n_inserted = n
            self._dead = set()
            self._trained = False
            self.state = None
            if n == 0:
                return
            self._check_dim(xd)
            cfg = self.cfg
            if cfg.metric == "cosine":
                xd = xd / torch.clamp(torch.linalg.norm(xd, dim=1, keepdim=True), min=1e-12)
            cb, rot = self._train(xd)
            self._trained = True
            mark("pq-train")

            n_plan = max(n, cfg.expected_rows or 0)
            c = cfg.n_clusters or max(
                8, 1 << int(round(math.log2(4 * math.sqrt(max(n_plan, 1))))))
            c = min(c, max(8, n))
            cent = _kmeans_device(xd, c, cfg.ivf_kmeans_iters, self._gen,
                                  sample=min(n, cfg.kmeans_sample))
            mark("kmeans")
            xn = D.sq_norms(xd) if cfg.metric == "l2" else xd.new_zeros(n)
            assign = _assign(xd, xn, cent, D.sq_norms(cent)).cpu().numpy().astype(np.int64)
            mark("assign+pull")
            cap_split = int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
            cap_split = max(cap_split, 8)
            cent_np, assign = split_oversized_device(xd, cent.cpu().numpy(), assign, cap_split)
            mark("split")
            c2 = len(cent_np)
            max_count = int(np.bincount(assign, minlength=c2).max())
            grow = max(1.0, (cfg.expected_rows or 0) / n)
            cap = max(8, int(math.ceil(cfg.block_headroom * grow * max(max_count, 1) / 8.0)) * 8)
            if n >= 500_000:
                order = torch.argsort(torch.as_tensor(assign, dtype=torch.int32,
                                                      device=self.device),
                                      stable=True).cpu().numpy().astype(np.int32)
            else:
                order = np.argsort(assign, kind="stable").astype(np.int32)
            sa = assign[order].astype(np.int32)
            first = np.searchsorted(sa, np.arange(c2), side="left")
            slot = (np.arange(n) - first[sa]).astype(np.int32)
            mark("order")
            self.state = self._pack(xd, cent_np, order, sa, slot, c2, cap, cb, rot)
            mark("pack")
            if trace:
                total = marks[-1][1] - marks[0][1]
                parts = "  ".join(f"{nm}={t1 - t0:.2f}s" for (_, t0), (nm, t1)
                                  in zip(marks, marks[1:]))
                print(f"[ivfpq build n={n}] total={total:.2f}s  {parts}", flush=True)

    def _pack(self, xd, cent_np, order, sa, slot, c: int, cap: int, cb, rot,
              segment: int = 2_000_000) -> IVFPQState:
        """xd is a device tensor (bulk build: device gathers) or a host
        ndarray (the repack path: segments are gathered on the host and
        streamed, so the whole corpus never sits on the device beside the
        blocks)."""
        cfg = self.cfg
        dev = self.device
        n = xd.shape[0]
        host_corpus = isinstance(xd, np.ndarray)
        cent = torch.as_tensor(cent_np, dtype=torch.float32, device=dev)
        codes_blocks = torch.zeros((c, cfg.nb, cap), dtype=torch.uint8, device=dev)
        norms_blocks = torch.full((c, cap), _INF, dtype=torch.float32, device=dev)
        b_ids = torch.full((c, cap), -1, dtype=torch.int32, device=dev)
        for lo in range(0, n, segment):
            hi = min(lo + segment, n)
            o = torch.from_numpy(np.ascontiguousarray(order[lo:hi])).to(dev)
            # a host corpus is gathered on the host and streamed segment by segment
            xo = (torch.from_numpy(xd[order[lo:hi]]).to(dev) if host_corpus
                  else xd[o.long()])
            _pack_rows(xo, o, torch.from_numpy(sa[lo:hi]).to(dev),
                       torch.from_numpy(slot[lo:hi]).to(dev), codes_blocks, norms_blocks, b_ids,
                       cb, rot, cfg.metric)
        counts = torch.bincount(torch.from_numpy(sa.astype(np.int64)).to(dev),
                                minlength=c)[:c].to(torch.int32)

        refine_d = cfg.dim if cfg.refine != "none" else 0
        n_plan = max(n, cfg.expected_rows or 0)
        rcap = max(1024, -(-n_plan // 1024) * 1024 + 1024) if refine_d else 1
        rr = torch.zeros((rcap, refine_d), dtype=cfg.refine_dtype, device=dev)
        rrs = torch.ones(rcap, dtype=torch.float32, device=dev)
        if refine_d:
            for lo in range(0, n, segment):
                hi = min(lo + segment, n)
                seg_rows = (torch.from_numpy(np.ascontiguousarray(xd[lo:hi])).to(dev)
                            if host_corpus else xd[lo:hi])
                _refine_segment(seg_rows, rr, rrs, lo, cfg.metric, cfg.refine)
        return IVFPQState(
            centroids=cent,
            c_norms=D.sq_norms(cent) if cfg.metric == "l2" else cent.new_zeros(c),
            codes_blocks=codes_blocks, norms_blocks=norms_blocks, b_ids=b_ids, counts=counts,
            codebooks=cb, rot=rot, refine=rr, r_scales=rrs, n=n)

    # -- incremental add ----------------------------------------------------

    def add(self, x) -> None:
        """Buffered incremental insert (centroids and codebooks frozen once
        trained). The first insert on an empty index trains and builds."""
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        self._check_dim(x)
        with self._lock:
            self._pending.append(x)
            self._n_inserted += x.shape[0]

    insert = add

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
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
        base = self._n_inserted - new.shape[0]
        st = self.state
        c, _, cap = st.codes_blocks.shape
        assign = nearest_centroids(new, st.centroids, cfg.metric, self.device)
        counts = st.counts.cpu().numpy()
        addc = np.bincount(assign, minlength=c)
        bsz = new.shape[0]
        # pow2 padding of the batch, unless that overshoots an exactly
        # pre-sized refine store where 1024-multiple padding fits (then the
        # store never has to grow)
        chunk = 1 << max(10, int(math.ceil(math.log2(max(bsz, 1)))))
        if cfg.refine != "none" and base + chunk > st.refine.shape[0]:
            chunk_1k = -(-bsz // 1024) * 1024
            if base + chunk_1k <= st.refine.shape[0]:
                chunk = chunk_1k
            else:
                self._grow_refine(base + chunk)
                st = self.state
        if int((counts + addc).max()) > cap:
            # Spill-to-neighbour: rows whose nearest cluster is full go to
            # their next-nearest centroid with spare capacity; repack (O(N))
            # only when spill fails, the blocks are > 90% full, or more than
            # 20% of the batch would move.
            spilled = self._assign_with_spill(new, assign, counts, cap)
            occupancy = (int(counts.sum()) + bsz) / float(c * cap)
            frac = (np.count_nonzero(spilled != assign) / max(bsz, 1)
                    if spilled is not None else 1.0)
            if spilled is None or occupancy > 0.90 or frac > 0.20:
                self._repack_with_new(new, base)
                return
            assign = spilled
        dev = self.device
        xb = torch.zeros((chunk, cfg.dim), dtype=torch.float32, device=dev)
        xb[:bsz] = torch.from_numpy(new).to(dev)
        ab = torch.zeros(chunk, dtype=torch.int64, device=dev)
        ab[:bsz] = torch.from_numpy(assign.astype(np.int64)).to(dev)
        vb = torch.zeros(chunk, dtype=torch.bool, device=dev)
        vb[:bsz] = True
        self.state = _ivfpq_append(st, xb, ab, vb, base, cfg.metric, cfg.refine)

    def _topk_assign(self, x: np.ndarray, cent, t: int) -> np.ndarray:
        """[n, t] nearest-centroid ids per row, best first (spill candidates)."""
        t = min(t, cent.shape[0])
        out = [T.smallest_k_dense(_centroid_scores(x[lo:lo + 16384], cent, self.cfg.metric,
                                                   self.device), t)[1].cpu().numpy()
               for lo in range(0, x.shape[0], 16384)]
        return np.concatenate(out).astype(np.int64) if out else np.zeros((0, t), np.int64)

    def _assign_with_spill(self, new: np.ndarray, assign: np.ndarray, counts: np.ndarray,
                           cap: int, t: int = 8) -> Optional[np.ndarray]:
        """Resolve per-cluster block overflow by walking each displaced row
        down its top-t centroid list until it finds spare capacity: within an
        overfull cluster the batch rows ranked past the free slots move to
        their next candidate, up to t-1 rounds. Returns the adjusted
        assignment, or None if rows remain unplaced (the caller repacks)."""
        c = counts.shape[0]
        cand = self._topk_assign(new, self.state.centroids, t)
        b = new.shape[0]
        rows = np.arange(b)
        cur = np.zeros(b, np.int64)
        assign = cand[rows, 0]
        free = np.maximum(cap - counts, 0)
        for _ in range(cand.shape[1] - 1):
            order = np.argsort(assign, kind="stable")
            sa = assign[order]
            first = np.searchsorted(sa, np.arange(c), side="left")
            rank = np.arange(b) - first[sa]
            over = np.zeros(b, bool)
            over[order] = rank >= free[sa]
            if not over.any():
                return assign
            movable = over & (cur < cand.shape[1] - 1)
            if not movable.any():
                return None
            cur[movable] += 1
            assign[movable] = cand[rows[movable], cur[movable]]
        addc = np.bincount(assign, minlength=c)
        return assign if int((counts + addc).max()) <= cap else None

    def _grow_refine(self, need: int) -> None:
        """Grow the refine store (new allocation + copy): refine overflow
        never needs the O(N) cluster repack."""
        st = self.state
        rcap = max(1024, -(-int(need * 1.25) // 1024) * 1024 + 1024)
        old = st.refine.shape[0]
        rr = torch.zeros((rcap, st.refine.shape[1]), dtype=st.refine.dtype, device=self.device)
        rr[:old] = st.refine
        rrs = torch.ones(rcap, dtype=torch.float32, device=self.device)
        rrs[:old] = st.r_scales
        self.state = dataclasses.replace(st, refine=rr, r_scales=rrs)

    def _reconstruct_all(self) -> np.ndarray:
        """Stored vectors in external-id order [n, D]: dequantized from the
        refine store, else the PQ reconstruction."""
        st, cfg = self.state, self.cfg
        n = st.n
        if cfg.refine != "none":
            rows = st.refine[:n].float()
            if cfg.refine in ("int8", "int16"):
                rows = rows * st.r_scales[:n, None]
            return rows.cpu().numpy()
        ids = st.b_ids.cpu().numpy()
        ids = np.where(ids <= -2, -2 - ids, ids)
        mask = ids >= 0
        c, nb, cap = st.codes_blocks.shape
        codes = PQ.unpack_nibbles(st.codes_blocks.transpose(1, 2).reshape(-1, nb), cfg.n_sub)
        dec = PQ.apply_rotation(PQ.decode(codes, st.codebooks), st.rot.T).cpu().numpy()
        out = np.zeros((n, cfg.dim), np.float32)
        out[ids[mask]] = dec.reshape(c, cap, cfg.dim)[mask]
        return out

    def _repack_with_new(self, new: np.ndarray, base: int) -> None:
        """Overflow path: re-pack the stored vectors (refine-store order, so
        every returned id stays valid) and the new rows against the existing
        centroids and codebooks, splitting clusters that no longer fit. The
        corpus goes to the host and the old state is freed first; past
        _REPACK_SPLIT_MAX_ROWS the pack streams host segments and skips the
        device split (cap then comes from the post-assign max count)."""
        x_all = np.concatenate([self._reconstruct_all(), new], axis=0)
        cfg = self.cfg
        n = x_all.shape[0]
        cent = self.state.centroids.cpu().numpy()
        cb, rot = self.state.codebooks, self.state.rot
        self.state = None                     # frees the blocks and the refine store
        assign = nearest_centroids(x_all, cent, cfg.metric, self.device)
        c = cent.shape[0]
        if n <= _REPACK_SPLIT_MAX_ROWS:
            xd = torch.from_numpy(x_all).to(self.device)
            cap_split = max(8, int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8)
            cent_np, assign = split_oversized_device(xd, cent, assign, cap_split)
        else:
            xd = x_all                        # host corpus -> streamed pack
            cent_np = cent
        c2 = len(cent_np)
        max_count = int(np.bincount(assign, minlength=c2).max())
        # geometric growth: a repack means the sizing is exhausted, so size
        # for >= 1.5x the corpus (or the expected_rows ratio if larger)
        grow = max(1.5, (cfg.expected_rows or 0) / max(n, 1))
        cap = max(8, int(math.ceil(cfg.block_headroom * grow * max(max_count, 1) / 8.0)) * 8)
        order = np.argsort(assign, kind="stable").astype(np.int32)
        sa = assign[order].astype(np.int32)
        first = np.searchsorted(sa, np.arange(c2), side="left")
        slot = (np.arange(n) - first[sa]).astype(np.int32)
        self.state = self._pack(xd, cent_np, order, sa, slot, c2, cap, cb, rot)
        self._apply_tombstones()

    def _tombstone(self, cc: np.ndarray, ss: np.ndarray, ids: np.ndarray) -> None:
        """Mark slots (cc, ss) holding ext ids `ids` deleted, in place: the
        id becomes -2-id and the norm +inf (the scan's validity channel)."""
        cc_t = torch.from_numpy(cc).to(self.device)
        ss_t = torch.from_numpy(ss).to(self.device)
        self.state.b_ids[cc_t, ss_t] = torch.from_numpy(
            (-2 - ids).astype(np.int32)).to(self.device)
        self.state.norms_blocks[cc_t, ss_t] = _INF

    def _apply_tombstones(self) -> None:
        if not self._dead or self.state is None:
            return
        ids_np = self.state.b_ids.cpu().numpy()
        dec = np.where(ids_np <= -2, -2 - ids_np, ids_np)
        hit = np.isin(dec, np.asarray(sorted(self._dead), np.int64)) & (dec >= 0) & (ids_np >= 0)
        if hit.any():
            cc, ss = np.nonzero(hit)
            self._tombstone(cc, ss, dec[cc, ss])

    # -- delete -------------------------------------------------------------

    def remove(self, ids) -> int:
        """Tombstone by external id (ids never renumber); freed slots are
        not reused until compact(). Returns the number newly deleted."""
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
            self._dead.update(new)
            ids_np = self.state.b_ids.cpu().numpy()
            cc, ss = np.nonzero(np.isin(ids_np, np.asarray(new, np.int64)))
            self._tombstone(cc, ss, ids_np[cc, ss])
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without tombstoned rows; survivors renumber to [0, L) in
        former order. Returns the survivors' old external ids."""
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else self.state.n
            alive = np.ones(n, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or not self._dead:
                return live
            vecs = self._reconstruct_all()[live]
        self.build(vecs)
        return live

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids [K, D] f32 numpy (near-exact from
        the refine store; the PQ reconstruction under refine='none')."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if self.state is None or ids.size == 0:
                return np.zeros((ids.size, self.cfg.dim), np.float32)
            n = self.state.n
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            return self._reconstruct_all()[ids]

    # -- search -------------------------------------------------------------

    def _refine_view(self):
        """(rows, squared norms, per-row scales) over the refine store for
        the exact masked-scan and range paths: integer codes ride through
        pairwise_scores' x_scales, so no corpus-sized f32 copy is made. The
        norms are of the dequantized rows."""
        st, cfg = self.state, self.cfg
        nr = st.refine.shape[0]
        zeros = torch.zeros(nr, dtype=torch.float32, device=self.device)
        if cfg.refine in ("int8", "int16"):
            rn = (st.r_scales ** 2 * D.sq_norms(st.refine.float())
                  if cfg.metric == "l2" else zeros)
            return st.refine, rn, st.r_scales
        rn = D.sq_norms(st.refine.float()) if cfg.metric == "l2" else zeros
        return st.refine, rn, torch.ones(nr, dtype=torch.float32, device=self.device)

    def _empty(self, b: int, k: int):
        return (torch.full((b, k), _INF if self.cfg.metric == "l2" else -_INF,
                           dtype=torch.float32, device=self.device),
                torch.full((b, k), -1, dtype=torch.int32, device=self.device))

    def _live_rows(self) -> torch.Tensor:
        """bool [refine rows]: ingested and not deleted."""
        st = self.state
        nr = st.refine.shape[0]
        ok = torch.arange(nr, device=self.device) < st.n
        if self._dead:
            dead = np.fromiter(self._dead, np.int64, len(self._dead))
            ok[torch.from_numpy(dead).to(self.device)] = False
        return ok

    def search(self, q, k: int, nprobe: Optional[int] = None, rerank: Optional[int] = None,
               allowed=None, filter_mode: str = "auto"):
        """Top-k: (scores [B, k], ids [B, k] int32) as tensors on the index's
        device. nprobe / rerank override the config for this call. Filtered
        search (`allowed`: bool mask over ids or an id list) defaults to the
        exact masked scan over the refine store; "auto" keeps the scan below
        the crossover and routes near-all-pass filters on huge corpora to
        "probe" (utils/filter_policy.py), which filters the probe pool
        instead (raise nprobe for selective filters)."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock:
            self._flush_locked()
            if filter_mode == "auto":
                filter_mode = resolve_filter_mode("auto", allowed, self._n_inserted, alt="probe")
            q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
            squeeze = q.ndim == 1
            if squeeze:
                q = q[None, :]
            self._check_dim(q)
            cfg = self.cfg
            st = self.state
            if st is None:
                s, i = self._empty(q.shape[0], k)
            elif allowed is not None and filter_mode == "scan" and cfg.refine != "none":
                nr = st.refine.shape[0]
                av = allowed_mask(allowed, self._n_inserted, max(self._n_inserted, 1),
                                  self.device)
                ok = torch.zeros(nr, dtype=torch.bool, device=self.device)
                ok[:min(nr, av.shape[0])] = av[:nr]
                ok &= self._live_rows()
                rows, rn, scl = self._refine_view()
                s, i = masked_exact_search(rows, torch.where(ok, rn, _INF), scl, q, k,
                                           cfg.metric, precision="high")
            else:
                allow_t = None
                if allowed is not None:
                    allow_t = allowed_mask(allowed, st.n, max(st.n, 1), self.device)
                s, i = ivfpq_search_impl(
                    st, q, k, min(nprobe or cfg.nprobe, st.centroids.shape[0]),
                    cfg.metric, cfg.refine,
                    (rerank if rerank is not None else cfg.rerank)
                    * (8 if allow_t is not None else 1),
                    cfg.l_bins, cfg.chunk, cfg.per_bin, cfg.scan_precision, cfg.group_slack,
                    allowed=allow_t)
            if squeeze:
                return s[0], i[0]
            return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """Exact radius query over the refine store (FlatIndex.search_range's
        contract; requires refine != 'none': codes cannot bound an exact
        radius). Returns (scores [B, R], ids [B, R], counts [B])."""
        with self._lock:
            self._flush_locked()
            if self.cfg.refine == "none":
                raise ValueError(
                    "search_range on IVF-PQ requires a refine store "
                    "(IVFPQConfig(refine=...)): codes alone cannot answer "
                    "an exact radius query")
            q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
            squeeze = q.ndim == 1
            if squeeze:
                q = q[None, :]
            self._check_dim(q)
            if self.state is None:
                s, i = self._empty(q.shape[0], max_results)
                c = torch.zeros(q.shape[0], dtype=torch.int32, device=self.device)
            else:
                rows, rn, scl = self._refine_view()
                nr = rows.shape[0]
                bi = torch.arange(nr, dtype=torch.int32, device=self.device)
                bi = torch.where(self._live_rows(), bi, -1)
                s, i, c = _ivf_range(rows, rn, bi, scl, q, float(radius), self.cfg.metric,
                                     max_results, "float32")
            if squeeze:
                return s[0], i[0], c[0]
            return s, i, c

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """npz snapshot in the JAX package's format (a bf16 refine store as
        its uint16 bits); tombstones ride in b_ids."""
        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg), n_inserted=self._n_inserted,
                        trained=self._trained)
            arrays = {}
            if self.state is not None:
                for f in _STATE_FIELDS:
                    v = getattr(self.state, f)
                    if f == "n":
                        arrays[f] = np.asarray(v, np.int32)
                    elif v.dtype == torch.bfloat16:
                        arrays[f] = v.cpu().view(torch.int16).numpy().view(np.uint16)
                    else:
                        arrays[f] = v.cpu().numpy()
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def from_numpy(cls, cfg, arrays=None, n_inserted: Optional[int] = None,
                   trained: bool = True, device=None) -> "IVFPQIndex":
        """An index over the JAX package's state. `cfg` is an IVFPQConfig or
        dataclasses.asdict of the JAX package's one; `arrays` maps its
        IVFPQState's fields to numpy arrays (a save file's contents), None
        for an empty index. Tombstones are read from b_ids (-2-id), as the
        JAX package's load reads them; n_inserted defaults to n."""
        if isinstance(cfg, dict):
            cfg = IVFPQConfig(**cfg)
        idx = cls(cfg, device=device)
        idx._trained = trained
        if arrays is None:
            idx._n_inserted = int(n_inserted or 0)
            return idx
        idx.state = state_from_numpy(cfg, arrays, idx.device)
        enc = np.asarray(arrays["b_ids"])
        idx._dead = set(int(-2 - v) for v in enc[enc <= -2])
        idx._n_inserted = idx.state.n if n_inserted is None else int(n_inserted)
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "IVFPQIndex":
        """Read a save file written by either package."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {f: z[f] for f in _STATE_FIELDS} if "b_ids" in z else None
        return cls.from_numpy(meta["cfg"], arrays, n_inserted=meta["n_inserted"],
                              trained=meta["trained"], device=device)
