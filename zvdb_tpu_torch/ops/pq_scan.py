"""Fused 4-bit PQ (ADC) scan with a per-bin top-1/top-2 fold (port of
zvdb_tpu/ops/pallas_pq.py:pq_scan_bins and pq_scan_topk).

Codes are nibble-packed and transposed, codes_t [S/2, N] (ops/pq.py). For a
query batch the per-query table lut [B, S, 16] (ops/pq.py:adc_lut) gives each
row's surrogate score norms[c] - f * sum_s lut[b, s, code(c, s)], f = 2 for
l2 and 1 otherwise. Row c belongs to bin c % L of segment c // seg_rows; each
(query, segment, bin) keeps its best row, and with per_bin=2 its runner-up,
with the TPU kernel's tie rules (the lower row wins, an equal score lands in
slot 2). One small exact selection over the n_seg*per_bin*L pool gives the
top-k. Scores never reach device memory: traffic is the packed codes, the
norms and the pool.

On a CUDA tensor `pq_scan_bins` launches the hand-written kernel in
csrc/pq_scan.cu (built with nvcc at first use, bound with ctypes); on a CPU
tensor it runs `_pq_scan_bins_plain`, the same function in plain PyTorch,
which the tests hold against the JAX package.
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
_QT = 16                   # queries per block in the kernel
_MAX_SMEM = 232448         # shared memory a block may use on Hopper
_INV127 = float(np.float32(1.0) / np.float32(127.0))

build_info: dict = {}   # path, seconds, ptxas report of this process's build


def build():
    """Compile csrc/pq_scan.cu (once per source and flags), load it and
    return its entry point."""
    fn, info = cuda_build.load(
        "pq_scan.cu", "zvdb_pq_scan_bins",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
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
    if precision == "int8":
        planes = [lut_k.float()]
    else:
        hi = lut_k.to(torch.bfloat16).float()
        planes = [hi] if precision == "default" else [hi, (lut_k - hi).to(torch.bfloat16).float()]
    planes = [p.reshape(b, n_sub * 16) for p in planes]
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
                w = sm.shape[1]
                im = (lo + m0 + col[:w]).expand_as(sm)
                c1, d1 = s1[:, :w], i1[:, :w]
                take1 = sm < c1
                if per_bin == 2:
                    c2, d2 = s2[:, :w], i2[:, :w]
                    take2 = ~take1 & (sm < c2)
                    s2[:, :w] = torch.where(take1, c1, torch.where(take2, sm, c2))
                    i2[:, :w] = torch.where(take1, d1, torch.where(take2, im, d2))
                s1[:, :w] = torch.where(take1, sm, c1)
                i1[:, :w] = torch.where(take1, im, d1)
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
    n_seg, seg_len = segments(n, chunk, seg_rows)
    # shared-memory words of the query tile's table: one per query pair for
    # int8 (whose 16-bit pair sums hold S <= 256 subspaces), hi and lo planes for high
    words = {"int8": _QT // 2, "default": _QT, "high": 2 * _QT}[precision] * n_sub * 16
    if n >= 2**31 or n_seg > 65535 or -(-l_bins // 256) > 65535 \
            or (words + _QT) * 4 > _MAX_SMEM or (precision == "int8" and n_sub > 256):
        raise ValueError("pq_scan_bins: needs N < 2**31 (int32 ids), at most 65535 "
                         "segments and bin slices, the query tile's table in shared memory "
                         "and, for int8, n_sub <= 256")
    lut_k, scales = _prep_lut(lut, precision)
    lut_k = lut_k.contiguous()
    codes_t = codes_t.contiguous()
    norms = norms.contiguous()
    width = n_seg * per_bin * l_bins
    out_s = torch.empty((b, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, width), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    kernel = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            lut_k.data_ptr(), scales.data_ptr(), codes_t.data_ptr(), norms.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), b, n, n_sub, l_bins, min(seg_len, max(n, 1)),
            n_seg, 2.0 if metric == "l2" else 1.0, _PRECISION_CODE[precision], per_bin, stream)
    if rc != 0:
        raise RuntimeError(f"pq_scan_bins: kernel launch failed with CUDA error {rc}")
    pq_scan_bins.launches += 1
    return out_s, out_i


pq_scan_bins.launches = 0


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
