"""Fused 4-bit PQ (ADC) scans with a per-bin top-1/top-2 fold (port of
zvdb_tpu/ops/pallas_pq.py:pq_scan_bins, pq_scan_topk, grouped_geometry and
pq_grouped_scan_bins).

Codes are nibble-packed and transposed, codes_t [S/2, N] (ops/pq.py). For a
query batch the per-query table lut [B, S, 16] (ops/pq.py:adc_lut) gives each
row's surrogate score norms[c] - f * sum_s lut[b, s, code(c, s)], f = 2 for
l2 and 1 otherwise. Row c belongs to bin c % L of segment c // seg_rows; each
(query, segment, bin) keeps its best row, and with per_bin=2 its runner-up,
with the TPU kernel's tie rules (the lower row wins, an equal score lands in
slot 2). One small exact selection over the n_seg*per_bin*L pool gives the
top-k. Scores never reach device memory: traffic is the packed codes, the
norms and the pool.

`pq_grouped_scan_bins` is the IVF-PQ probe scan: the same scores and fold
over cluster blocks codes_blocks [C, S/2, cap], each scored only against the
queries slotted to it in qslot [C, qcap]. Row `pos` of a cluster falls in
bin pos % L, and the outputs hold positions within the cluster, not ids.

On a CUDA tensor `pq_scan_bins` launches kernel B, chosen by precision
alone: "int8" (the engines' default) runs on the tensor cores
(csrc/pq_scan_mma.cu, int8 mma.sync over a one-hot built in registers),
"default" and "high" on the CUDA cores (csrc/pq_scan.cu, table lookups from
shared memory). `pq_grouped_scan_bins` launches kernel C, the second entry
point of csrc/pq_scan.cu, in every precision. Each source is built with nvcc
at first use into build/kernels/ and bound with ctypes. On a CPU tensor they
run `_pq_scan_bins_plain` and `_pq_grouped_scan_bins_plain`, the same
functions in plain PyTorch, which the tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from . import topk as T
from .pq import unpack_nibbles

_PRECISION_CODE = {"default": 0, "high": 1, "int8": 2}
_QT = 16                   # queries per block in the CUDA-core kernel
_MMA_BL = 8                # bins per block in the tensor-core kernel
_MAX_SMEM = 232448         # shared memory a block may use on Hopper
_INV127 = float(np.float32(1.0) / np.float32(127.0))

# lut, scales, codes_t, norms, out_s, out_i, B, N, n_sub, L, seg_len, n_seg,
# factor, precision, per_bin, stream: both entry points of kernel B
_SCAN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
build_info: dict = {}       # pq_scan.cu: path, seconds, ptxas report of this process's build
build_info_mma: dict = {}   # pq_scan_mma.cu: the same


def build():
    """Compile csrc/pq_scan.cu (once per source and flags; it holds kernel
    B's CUDA-core route and kernel C), load it and return kernel B's entry
    point ("default" and "high")."""
    fn, info = cuda_build.load("pq_scan.cu", "zvdb_pq_scan_bins", _SCAN_ARGTYPES)
    build_info.update(info)
    return fn


def build_mma():
    """Compile csrc/pq_scan_mma.cu, load it and return kernel B's tensor-core
    entry point ("int8")."""
    fn, info = cuda_build.load("pq_scan_mma.cu", "zvdb_pq_scan_bins_mma", _SCAN_ARGTYPES)
    build_info_mma.update(info)
    return fn


def build_grouped():
    """The grouped scan's entry point in the same library as `build`."""
    fn, info = cuda_build.load(
        "pq_scan.cu", "zvdb_pq_grouped_scan_bins",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    build_info.update(info)
    return fn


def _check_args(lut, codes_t, l_bins, bq_tile, chunk, metric, precision, per_bin, seg_rows):
    if per_bin not in (1, 2):
        raise ValueError(f"per_bin must be 1 or 2, got {per_bin}")
    if lut.dim() != 3 or lut.shape[2] != 16:
        raise ValueError("the fused PQ scan requires a [B, S, 16] table (n_codes <= 16)")
    n_sub = lut.shape[1]
    if codes_t.dim() != 2 or codes_t.shape[0] * 2 != n_sub:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not hold {n_sub} nibble codes per row")
    if n_sub % 8 != 0:
        raise ValueError("n_sub must be a multiple of 8 for the fused PQ scan")
    if l_bins < 1 or bq_tile < 1:
        raise ValueError("l_bins and bq_tile must be >= 1")
    if chunk % l_bins != 0:
        raise ValueError("chunk must be a multiple of l_bins")
    if seg_rows and seg_rows % chunk != 0:
        raise ValueError("seg_rows must be a multiple of chunk")
    if precision not in _PRECISION_CODE:
        raise ValueError(f"precision must be one of {tuple(_PRECISION_CODE)}, got {precision!r}")
    if metric not in ("l2", "dot", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")


def segments(n: int, chunk: int, seg_rows: int) -> tuple[int, int]:
    """(n_seg, rows per segment). As in the JAX package, the segment count
    comes from the row count padded to a multiple of chunk."""
    n_chunks = max(1, -(-n // chunk))
    cps = seg_rows // chunk if seg_rows else n_chunks
    return -(-n_chunks // cps), cps * chunk


def _prep_lut(lut: torch.Tensor, precision: str):
    """The table in the precision's form, made once per batch: for "int8" a
    per-query symmetric quantization, scale = max(max|lut|, 1e-30) / 127 and
    round half to even (the floor keeps an all-zero row from dividing 0 by 0);
    otherwise the f32 table as it is (the kernel rounds it to bf16).

    The division by 127 is a product with f32(1/127): XLA compiles the JAX
    package's `/ 127.0` that way, and the scale differs from a true division
    in the last bit for some rows.

    Returns (lut_k [B, S, 16] int8 | f32, scales [B] f32)."""
    lut = lut.float()
    if precision == "int8":
        scales = torch.clamp(lut.abs().amax(dim=(1, 2)), min=1e-30) * _INV127
        return torch.round(lut / scales[:, None, None]).to(torch.int8), scales
    return lut, torch.ones(lut.shape[0], dtype=torch.float32, device=lut.device)


def _planes(lut_k: torch.Tensor, precision: str) -> list:
    """[B, S*16] f32 tables whose sums make the precision's dot products:
    the int8 table, or the bf16-rounded table and, for "high", its bf16
    residual."""
    b = lut_k.shape[0]
    if precision == "int8":
        planes = [lut_k.float()]
    else:
        hi = lut_k.to(torch.bfloat16).float()
        planes = [hi] if precision == "default" else [hi, (lut_k - hi).to(torch.bfloat16).float()]
    return [p.reshape(b, -1) for p in planes]


def _fold(sm, im, s1, i1, s2, i2, per_bin: int):
    """Fold one L-wide slice (scores sm, ids im) into the bins in place, the
    TPU kernel's rules: strict <, so the earlier row wins a tie and an equal
    score lands in slot 2. sm may be narrower than the bins (a ragged tail)."""
    w = sm.shape[-1]
    c1, d1 = s1[..., :w], i1[..., :w]
    take1 = sm < c1
    if per_bin == 2:
        c2, d2 = s2[..., :w], i2[..., :w]
        take2 = ~take1 & (sm < c2)
        s2[..., :w] = torch.where(take1, c1, torch.where(take2, sm, c2))
        i2[..., :w] = torch.where(take1, d1, torch.where(take2, im, d2))
    s1[..., :w] = torch.where(take1, sm, c1)
    i1[..., :w] = torch.where(take1, im, d1)


def _pq_scan_bins_plain(lut, codes_t, norms, l_bins: int, chunk: int, metric: str,
                        precision: str, per_bin: int, seg_rows: int):
    """The same function in plain PyTorch. Each row chunk is scored with one
    f32 product of the table by a 0/1 one-hot of the codes: exact for the
    int8 table (|sum| <= S*127 < 2**24), and exact products summed in f32 for
    the bf16-rounded ones. Then each L-wide slice folds into the bins with
    strict <, in row order (not torch.min, whose index on a tie is
    unspecified). f32 products on the card assume TF32 is off."""
    b, n_sub, _ = lut.shape
    n = codes_t.shape[1]
    lut_k, scales = _prep_lut(lut, precision)
    planes = _planes(lut_k, precision)
    f = 2.0 if metric == "l2" else 1.0
    n_seg, seg_len = segments(n, chunk, seg_rows)
    lw = per_bin * l_bins
    out_s = torch.full((b, n_seg * lw), float("inf"), dtype=torch.float32, device=lut.device)
    out_i = torch.full((b, n_seg * lw), -1, dtype=torch.int32, device=lut.device)
    col = torch.arange(l_bins, dtype=torch.int32, device=lut.device)
    big = l_bins * max(1, (1 << 25) // max(1, b * l_bins))   # rows per product
    for seg in range(n_seg):
        s1, i1 = out_s[:, seg * lw:seg * lw + l_bins], out_i[:, seg * lw:seg * lw + l_bins]
        s2, i2 = out_s[:, seg * lw + l_bins:(seg + 1) * lw], out_i[:, seg * lw + l_bins:(seg + 1) * lw]
        for lo in range(seg * seg_len, min((seg + 1) * seg_len, n), big):
            hi_row = min(lo + big, (seg + 1) * seg_len, n)
            codes = unpack_nibbles(codes_t[:, lo:hi_row].T, n_sub).long()       # [r, S]
            oh = F.one_hot(codes, 16).reshape(hi_row - lo, n_sub * 16).float().T
            dots = None
            for p in planes:
                d = p @ oh
                dots = d if dots is None else dots + d
            if precision == "int8":
                dots = dots * scales[:, None]
            s = norms[None, lo:hi_row] - f * dots
            for m0 in range(0, hi_row - lo, l_bins):
                sm = s[:, m0:m0 + l_bins]
                im = (lo + m0 + col[:sm.shape[1]]).expand_as(sm)
                _fold(sm, im, s1, i1, s2, i2, per_bin)
    return out_s, out_i


def pq_scan_bins(
    lut: torch.Tensor,        # [B, S, 16] f32 ADC table (adc_lut of rotated queries)
    codes_t: torch.Tensor,    # [S/2, N] uint8 nibble-packed codes, transposed
    norms: torch.Tensor,      # [N] f32 decoded squared norms (l2) or 0; +inf invalid
    l_bins: int = 256,
    bq_tile: int = 512,
    chunk: int = 1024,
    metric: str = "l2",
    precision: str = "default",
    per_bin: int = 1,
    seg_rows: int = 0,
):
    """Fold the PQ-coded corpus into [B, n_seg*per_bin*l_bins] bin minima.

    Returns (bin_scores f32 surrogates, bin_ids int32, -1 where a bin saw no
    valid row). Segment z's columns [z*per_bin*L, (z+1)*per_bin*L) hold its
    best row per bin, then (per_bin=2) the runners-up. Surrogates: l2 =
    ||xhat||^2 - 2 q.xhat (query norm not added), dot/cosine = -q.xhat.
    `chunk` sets the segment geometry as in the JAX package; it and
    `bq_tile` do not change which rows win.

    The route is chosen by precision alone. On a CUDA tensor "int8" launches
    csrc/pq_scan_mma.cu (tensor cores; counted by `launches` and
    `launches_mma`), "default" and "high" csrc/pq_scan.cu (CUDA cores;
    `launches` only); a shape the route cannot take raises ValueError. A CPU
    tensor takes the plain version and counts nothing.
    """
    _check_args(lut, codes_t, l_bins, bq_tile, chunk, metric, precision, per_bin, seg_rows)
    if lut.device.type == "cpu":
        return _pq_scan_bins_plain(lut, codes_t, norms, l_bins, chunk, metric, precision,
                                   per_bin, seg_rows)
    dev = lut.device
    if dev.type != "cuda" or codes_t.device != dev or norms.device != dev:
        raise ValueError("pq_scan_bins: lut, codes_t and norms must lie on one CUDA device")
    if lut.dtype != torch.float32 or norms.dtype != torch.float32:
        raise TypeError("pq_scan_bins: lut and norms must be float32")
    if codes_t.dtype != torch.uint8:
        raise TypeError(f"pq_scan_bins: codes_t must be uint8, got {codes_t.dtype}")
    b, n_sub, _ = lut.shape
    n = codes_t.shape[1]
    if norms.shape != (n,):
        raise ValueError(f"pq_scan_bins: norms {tuple(norms.shape)} do not match N={n}")
    n_seg, _ = segments(n, chunk, seg_rows)
    if n >= 2**31 or n_seg > 65535:
        raise ValueError("pq_scan_bins: needs N < 2**31 (int32 ids) and at most 65535 segments")
    mma = precision == "int8"
    if mma:
        if -(-l_bins // _MMA_BL) > 65535 or n_sub > 256:
            raise ValueError(f"pq_scan_bins: int8 needs at most 65535 slices of {_MMA_BL} bins "
                             "and n_sub <= 256")
    else:
        # shared-memory words of the query tile's table: hi and lo planes for "high"
        words = (2 if precision == "high" else 1) * _QT * n_sub * 16
        if -(-l_bins // 256) > 65535 or (words + _QT) * 4 > _MAX_SMEM:
            raise ValueError("pq_scan_bins: needs at most 65535 slices of 256 bins and the "
                             "query tile's table in shared memory")
    if b == 0:
        width = n_seg * per_bin * l_bins
        return (torch.empty((0, width), dtype=torch.float32, device=dev),
                torch.empty((0, width), dtype=torch.int32, device=dev))
    out = launch(build_mma() if mma else build(), lut, codes_t, norms, l_bins, chunk, metric,
                 precision, per_bin, seg_rows)
    pq_scan_bins.launches += 1
    pq_scan_bins.launches_mma += mma
    return out


pq_scan_bins.launches = 0       # every launch of kernel B
pq_scan_bins.launches_mma = 0   # the launches on the tensor cores ("int8")


def launch(kernel, lut, codes_t, norms, l_bins: int, chunk: int, metric: str, precision: str,
           per_bin: int, seg_rows: int):
    """Run one of kernel B's entry points on CUDA tensors already checked by
    `pq_scan_bins` (B >= 1) and return (bin_scores, bin_ids); counts nothing.
    Raises RuntimeError if the launch fails."""
    dev = lut.device
    b, n_sub, _ = lut.shape
    n = codes_t.shape[1]
    n_seg, seg_len = segments(n, chunk, seg_rows)
    lut_k, scales = _prep_lut(lut, precision)
    lut_k = lut_k.contiguous()
    codes_t = codes_t.contiguous()
    norms = norms.contiguous()
    width = n_seg * per_bin * l_bins
    out_s = torch.empty((b, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            lut_k.data_ptr(), scales.data_ptr(), codes_t.data_ptr(), norms.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), b, n, n_sub, l_bins, min(seg_len, max(n, 1)),
            n_seg, 2.0 if metric == "l2" else 1.0, _PRECISION_CODE[precision], per_bin, stream)
    if rc != 0:
        raise RuntimeError(f"pq_scan_bins: kernel launch failed with CUDA error {rc}")
    return out_s, out_i


def pq_scan_topk(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    norms: torch.Tensor,
    k: int,
    l_bins: int = 256,
    bq_tile: int = 512,
    chunk: int = 1024,
    metric: str = "l2",
    precision: str = "default",
    per_bin: int = 1,
    seg_rows: int = 0,
):
    """Fused PQ top-k: the bin fold + one small exact selection over the
    pool. Returns (surrogate scores [B, k], ids [B, k]); invalid slots +inf / -1.

    Two selection routes, as in the JAX package, with different tie rules:
    up to 64 a stable sort of the pool (ties to the lower pool position, as
    lax.top_k), above 64 `sort_smallest_k` (ties to the lower id)."""
    bin_s, bin_i = pq_scan_bins(
        lut, codes_t, norms, l_bins=l_bins, bq_tile=bq_tile, chunk=chunk, metric=metric,
        precision=precision, per_bin=per_bin, seg_rows=seg_rows)
    kk = min(k, bin_s.shape[1])
    if kk > 64:
        scores, ids = T.sort_smallest_k(bin_s, bin_i, kk)
    else:
        scores, p = torch.sort(bin_s, dim=-1, stable=True)
        scores, p = scores[:, :kk], p[:, :kk]
        ids = torch.gather(bin_i, -1, p)
    scores = torch.where(ids >= 0, scores, float("inf"))
    if kk < k:
        b = scores.shape[0]
        scores = torch.cat([scores, scores.new_full((b, k - kk), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
    return scores, ids


def grouped_geometry(cap: int, l_bins: int, chunk: int) -> tuple[int, int]:
    """Effective (chunk, padded cap) of the grouped scan for a cluster
    capacity, as in the JAX package: callers map the kernel's positions onto
    their id tables through rows of capp."""
    chunk = min(chunk, -(-cap // l_bins) * l_bins)
    return chunk, -(-cap // chunk) * chunk


def _check_grouped_args(lut, qslot, codes_blocks, norms_blocks, l_bins, chunk, metric,
                        precision, per_bin):
    """The JAX wrapper's asserts, as ValueErrors."""
    if per_bin not in (1, 2):
        raise ValueError(f"per_bin must be 1 or 2, got {per_bin}")
    if lut.dim() != 3 or lut.shape[2] != 16:
        raise ValueError("the grouped PQ scan requires a [B, S, 16] table (n_codes <= 16)")
    n_sub = lut.shape[1]
    if codes_blocks.dim() != 3 or codes_blocks.shape[1] * 2 != n_sub:
        raise ValueError(f"codes_blocks {tuple(codes_blocks.shape)} does not hold {n_sub} "
                         "nibble codes per row")
    c, _, cap = codes_blocks.shape
    if n_sub % 8 != 0:
        raise ValueError("n_sub must be a multiple of 8 for the grouped PQ scan")
    if l_bins < 128 or l_bins % 128 != 0:
        raise ValueError("l_bins must be a multiple of 128")
    if chunk % l_bins != 0:
        raise ValueError("chunk must be a multiple of l_bins")
    if qslot.dim() != 2 or qslot.shape[0] != c:
        raise ValueError(f"qslot {tuple(qslot.shape)} must be [C={c}, qcap]")
    if tuple(norms_blocks.shape) != (c, cap):
        raise ValueError(f"norms_blocks {tuple(norms_blocks.shape)} must be [{c}, {cap}]")
    if precision not in _PRECISION_CODE:
        raise ValueError(f"precision must be one of {tuple(_PRECISION_CODE)}, got {precision!r}")
    if metric not in ("l2", "dot", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    # the TPU's operand tiling: int8 rows come in 32s, f32/bf16 in 8s. The
    # engine rounds q_cap up to it, which decides which probe pairs it drops
    q_align = 32 if precision == "int8" else 8
    if qslot.shape[1] % q_align != 0:
        raise ValueError(f"qcap must be a multiple of {q_align}")


def _pq_grouped_scan_bins_plain(lut, qslot, codes_blocks, norms_blocks, l_bins: int,
                                chunk: int, metric: str, precision: str, per_bin: int):
    """The grouped scan in plain PyTorch. Each step scores a run of clusters
    against their slots' tables with one batched f32 product by a 0/1 one-hot
    of the codes (exact for int8; exact products summed in f32 for the bf16
    planes), then folds each cluster's L-wide position slices into the bins
    in increasing position. Positions past cap are the JAX wrapper's padding,
    with +inf norms: never taken, so not scored. Empty slots score query 0's
    table, as on the TPU, and are masked to +inf / -1 at the end."""
    b, n_sub, _ = lut.shape
    c, nb, cap = codes_blocks.shape
    qcap = qslot.shape[1]
    lut_k, scales = _prep_lut(lut, precision)
    planes = _planes(lut_k, precision)
    f = 2.0 if metric == "l2" else 1.0
    lw = per_bin * l_bins
    dev = lut.device
    out_s = torch.full((c, qcap, lw), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((c, qcap, lw), -1, dtype=torch.int32, device=dev)
    safe = qslot.clamp(min=0).long()
    col = torch.arange(l_bins, dtype=torch.int32, device=dev)
    sc = n_sub * 16
    step = max(1, (1 << 26) // max(1, cap * sc + qcap * (cap + sc)))   # clusters per product
    for c0 in range(0, c, step):
        c1 = min(c0 + step, c)
        codes = unpack_nibbles(codes_blocks[c0:c1].transpose(1, 2), n_sub).long()  # [cc, cap, S]
        oh = F.one_hot(codes, 16).reshape(c1 - c0, cap, sc).float()
        dots = None
        for p in planes:
            d = torch.bmm(p[safe[c0:c1]], oh.transpose(1, 2))                # [cc, qcap, cap]
            dots = d if dots is None else dots + d
        if precision == "int8":
            dots = dots * scales[safe[c0:c1]][..., None]
        s = norms_blocks[c0:c1, None, :].float() - f * dots
        s1, i1 = out_s[c0:c1, :, :l_bins], out_i[c0:c1, :, :l_bins]
        s2, i2 = out_s[c0:c1, :, l_bins:], out_i[c0:c1, :, l_bins:]
        for m0 in range(0, cap, l_bins):
            sm = s[..., m0:m0 + l_bins]
            _fold(sm, (m0 + col[:sm.shape[-1]]).expand_as(sm), s1, i1, s2, i2, per_bin)
    live = (qslot >= 0)[..., None]
    return (torch.where(live, out_s, float("inf")), torch.where(live, out_i, -1))


def pq_grouped_scan_bins(
    lut: torch.Tensor,            # [B, S, 16] f32 ADC table (adc_lut of rotated queries)
    qslot: torch.Tensor,          # [C, qcap] int32 query of each slot; -1 empty
    codes_blocks: torch.Tensor,   # [C, S/2, cap] uint8 nibble-packed codes per cluster
    norms_blocks: torch.Tensor,   # [C, cap] f32 decoded squared norms; +inf invalid
    l_bins: int = 128,
    chunk: int = 512,
    metric: str = "l2",
    precision: str = "default",
    per_bin: int = 2,
):
    """Cluster-grouped fused ADC scan: the IVF-PQ probe kernel.

    Returns (bin_scores [C, qcap, per_bin*l_bins] f32 surrogates, bin_pos
    int32 positions within the cluster, -1 where a bin saw no valid row).
    Empty slots come back +inf / -1. Surrogates as in `pq_scan_bins`. The
    table is quantized once per batch (`_prep_lut`); qslot entries lie in
    [-1, B). `chunk` only sets the padded geometry (`grouped_geometry`); it
    does not change which rows win.
    """
    _check_grouped_args(lut, qslot, codes_blocks, norms_blocks, l_bins, chunk, metric,
                        precision, per_bin)
    c, qcap, lw = qslot.shape[0], qslot.shape[1], per_bin * l_bins
    if lut.shape[0] == 0:   # no query: every slot is empty
        return (torch.full((c, qcap, lw), float("inf"), device=lut.device),
                torch.full((c, qcap, lw), -1, dtype=torch.int32, device=lut.device))
    if lut.device.type == "cpu":
        return _pq_grouped_scan_bins_plain(lut, qslot, codes_blocks, norms_blocks, l_bins,
                                           chunk, metric, precision, per_bin)
    dev = lut.device
    if dev.type != "cuda" or any(t.device != dev for t in (qslot, codes_blocks, norms_blocks)):
        raise ValueError("pq_grouped_scan_bins: every input must lie on one CUDA device")
    if lut.dtype != torch.float32 or norms_blocks.dtype != torch.float32:
        raise TypeError("pq_grouped_scan_bins: lut and norms_blocks must be float32")
    if codes_blocks.dtype != torch.uint8 or qslot.dtype != torch.int32:
        raise TypeError("pq_grouped_scan_bins: codes_blocks must be uint8 and qslot int32")
    b, n_sub, _ = lut.shape
    c, _, cap = codes_blocks.shape
    qcap = qslot.shape[1]
    words = {"int8": _QT // 2, "default": _QT, "high": 2 * _QT}[precision] * n_sub * 16
    if (c >= 2**31 or cap >= 2**31 or -(-qcap // _QT) > 65535 or -(-l_bins // 256) > 65535
            or (words + 2 * _QT) * 4 > _MAX_SMEM or (precision == "int8" and n_sub > 256)):
        raise ValueError("pq_grouped_scan_bins: needs C and cap < 2**31, at most 65535 slot "
                         "tiles and bin slices, the slot tile's table in shared memory and, "
                         "for int8, n_sub <= 256")
    out_s = torch.empty((c, qcap, lw), dtype=torch.float32, device=dev)
    out_i = torch.empty((c, qcap, lw), dtype=torch.int32, device=dev)
    if c == 0 or qcap == 0:
        return out_s, out_i
    lut_k, scales = _prep_lut(lut, precision)
    lut_k = lut_k.contiguous()
    qslot = qslot.contiguous()
    codes_blocks = codes_blocks.contiguous()
    norms_blocks = norms_blocks.contiguous()
    kernel = build_grouped()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            lut_k.data_ptr(), scales.data_ptr(), qslot.data_ptr(), codes_blocks.data_ptr(),
            norms_blocks.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, c, qcap, cap, n_sub,
            l_bins,
            2.0 if metric == "l2" else 1.0, _PRECISION_CODE[precision], per_bin, stream)
    if rc != 0:
        raise RuntimeError(f"pq_grouped_scan_bins: kernel launch failed with CUDA error {rc}")
    pq_grouped_scan_bins.launches += 1
    return out_s, out_i


pq_grouped_scan_bins.launches = 0
