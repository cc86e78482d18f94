"""Fused flat scan: scoring + bin-parallel partial top-k (port of
zvdb_tpu/ops/pallas_topk.py).

Each query keeps L bins; corpus row c belongs to bin c % L. The whole corpus
folds into [B, L] per-query bin minima (strict <, so the lower row wins a
tie), and one small exact top-k over the L bins gives the final top-k.
Overall selection recall is the bin collision bound L/k*(1-(1-1/L)^k)
(k=10: 0.983 at L=256, 0.996 at L=1024). Scores never reach device memory:
traffic is the corpus, the queries and the [B, L] bins.

On a CUDA tensor `flat_scan_bins` launches kernel A, chosen by precision
alone: "default" (the engine's rerank path) and "high" run on the tensor
cores (csrc/flat_scan_mma.cu, bf16 mma.sync with the bin fold on the
accumulator fragments), "highest" on the CUDA cores' f32 pipes
(csrc/flat_scan.cu), since f32 products cannot use the bf16 tensor cores.
Each source is built with nvcc at first use into build/kernels/ and bound
with ctypes. On a CPU tensor it runs `_flat_scan_bins_plain`, the same
function in plain PyTorch, which the tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import distance as D

_PRECISION_CODE = {"highest": 0, "high": 1, "default": 2}
_MAX_BINS = 65535 * 64   # both kernels' grids hold L/64 bin slices in gridDim.y
# q, x, x_is_bf16, norms, out_s, out_i, B, N, D, L, factor, precision, stream:
# both entry points of kernel A
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

build_info: dict = {}       # flat_scan.cu: path, seconds, ptxas report of this process's build
build_info_mma: dict = {}   # flat_scan_mma.cu: the same


def build():
    """Compile csrc/flat_scan.cu (once per source and flags; it holds kernel
    A's and kernel D's CUDA-core entry points), load it and return kernel
    A's ("highest")."""
    fn, info = cuda_build.load("flat_scan.cu", "zvdb_flat_scan_bins", _ARGTYPES)
    build_info.update(info)
    return fn


def build_mma():
    """Compile csrc/flat_scan_mma.cu, load it and return kernel A's
    tensor-core entry point ("default" and "high")."""
    fn, info = cuda_build.load("flat_scan_mma.cu", "zvdb_flat_scan_bins_mma", _ARGTYPES)
    build_info_mma.update(info)
    return fn


def _entry_point(precision: str):
    """Kernel A's build function for `precision`: the tensor cores
    (`build_mma`) for "default" and "high", the CUDA cores (`build`) for
    "highest"."""
    return build if precision == "highest" else build_mma


def _check_args(l_bins: int, bq_tile: int, chunk: int, metric: str, precision: str):
    if l_bins < 1:
        raise ValueError(f"l_bins must be >= 1, got {l_bins}")
    if bq_tile < 1:
        raise ValueError(f"bq_tile must be >= 1, got {bq_tile}")
    if chunk % l_bins != 0:
        raise ValueError("chunk must be a multiple of l_bins")
    if precision not in _PRECISION_CODE:
        raise ValueError(f"precision must be one of {tuple(_PRECISION_CODE)}, got {precision!r}")
    if metric not in ("l2", "dot", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")


def _flat_scan_bins_plain(q, vectors, norms, l_bins: int, metric: str, precision: str):
    """The same function in plain PyTorch: score row chunks with one matmul at
    `precision`, then fold each L-wide slice into the bins with the strict <
    of the TPU kernel (not torch.min, whose index on a tie is unspecified)."""
    b, n = q.shape[0], vectors.shape[0]
    big = l_bins * max(1, (1 << 25) // max(1, b * l_bins))   # rows per matmul
    best_s = torch.full((b, l_bins), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.full((b, l_bins), -1, dtype=torch.int32, device=q.device)
    col = torch.arange(l_bins, dtype=torch.int32, device=q.device)
    for lo in range(0, n, big):
        s = D.pairwise_scores(q, vectors[lo:lo + big], norms[lo:lo + big], metric,
                              precision=precision)
        for m0 in range(0, s.shape[1], l_bins):
            sm = s[:, m0:m0 + l_bins]
            w = sm.shape[1]
            take = sm < best_s[:, :w]
            best_s[:, :w] = torch.where(take, sm, best_s[:, :w])
            best_i[:, :w] = torch.where(take, lo + m0 + col[:w], best_i[:, :w])
    return best_s, best_i


def flat_scan_bins(
    q: torch.Tensor,          # [B, D] f32 preprocessed queries
    vectors: torch.Tensor,    # [N, D] f32 or bf16 corpus (storage rows)
    norms: torch.Tensor,      # [N] f32 squared norms; +inf marks invalid rows
    l_bins: int = 256,
    bq_tile: int = 512,
    chunk: int = 2048,
    metric: str = "l2",
    precision: str = "high",
):
    """Fold the whole corpus into [B, l_bins] per-query bin minima.

    Returns (bin_scores [B, L] f32 surrogate scores, bin_ids [B, L] int32,
    -1 where a bin never saw a valid row). Surrogate scores follow the repo
    convention: ||x||^2 - 2 q.x for l2 (query norm not added), -q.x otherwise.
    `chunk` and `bq_tile` are validated as the JAX package does; they do not
    change results.

    The route is chosen by precision alone. On a CUDA tensor "default" and
    "high" launch csrc/flat_scan_mma.cu (tensor cores; counted by `launches`
    and `launches_mma`), "highest" csrc/flat_scan.cu (CUDA cores; `launches`
    only). A CPU tensor takes the plain version and counts nothing.
    """
    _check_args(l_bins, bq_tile, chunk, metric, precision)
    if q.device.type == "cpu":
        return _flat_scan_bins_plain(q, vectors, norms, l_bins, metric, precision)
    if q.device.type != "cuda" or vectors.device != q.device or norms.device != q.device:
        raise ValueError("flat_scan_bins: q, vectors and norms must lie on one CUDA device")
    if q.dtype != torch.float32 or norms.dtype != torch.float32:
        raise TypeError("flat_scan_bins: q and norms must be float32")
    if vectors.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flat_scan_bins: vectors must be float32 or bfloat16, got {vectors.dtype}")
    b, d = q.shape
    n = vectors.shape[0]
    if vectors.shape[1] != d or norms.shape != (n,):
        raise ValueError(f"flat_scan_bins: shapes q {tuple(q.shape)}, vectors "
                         f"{tuple(vectors.shape)}, norms {tuple(norms.shape)} disagree")
    if l_bins > _MAX_BINS or n >= 2**31:
        raise ValueError(f"flat_scan_bins: needs l_bins <= {_MAX_BINS} and N < 2**31 (int32 ids)")
    if b == 0:
        return (torch.empty((0, l_bins), dtype=torch.float32, device=q.device),
                torch.empty((0, l_bins), dtype=torch.int32, device=q.device))
    build_fn = _entry_point(precision)
    out = launch(build_fn(), q, vectors, norms, l_bins, metric, precision)
    flat_scan_bins.launches += 1
    flat_scan_bins.launches_mma += build_fn is build_mma
    return out


flat_scan_bins.launches = 0       # every launch of kernel A
flat_scan_bins.launches_mma = 0   # the launches on the tensor cores ("default", "high")


def launch(kernel, q, vectors, norms, l_bins: int, metric: str, precision: str):
    """Run one of kernel A's entry points on CUDA tensors already checked by
    `flat_scan_bins` (B >= 1) and return (bin_scores, bin_ids); counts
    nothing. Raises RuntimeError if the launch fails."""
    b, d = q.shape
    n = vectors.shape[0]
    q = q.contiguous()
    vectors = vectors.contiguous()
    norms = norms.contiguous()
    out_s = torch.empty((b, l_bins), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, l_bins), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(
            q.data_ptr(), vectors.data_ptr(), int(vectors.dtype == torch.bfloat16),
            norms.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, l_bins,
            2.0 if metric == "l2" else 1.0, _PRECISION_CODE[precision], stream)
    if rc != 0:
        raise RuntimeError(f"flat_scan_bins: kernel launch failed with CUDA error {rc}")
    return out_s, out_i


def flat_scan_topk(
    q: torch.Tensor,
    vectors: torch.Tensor,
    norms: torch.Tensor,
    k: int,
    l_bins: int = 256,
    bq_tile: int = 512,
    chunk: int = 2048,
    metric: str = "l2",
    precision: str = "high",
):
    """Fused brute-force top-k: the bin fold + one small exact top-k over L.

    Returns (scores [B, k] surrogate, ids [B, k] int32); invalid slots +inf / -1.
    Ties among bins go to the lower bin position, as lax.top_k orders them.
    """
    bin_s, bin_i = flat_scan_bins(
        q, vectors, norms, l_bins=l_bins, bq_tile=bq_tile, chunk=chunk,
        metric=metric, precision=precision)
    kk = min(k, l_bins)
    scores, p = torch.sort(bin_s, dim=-1, stable=True)
    scores, p = scores[:, :kk], p[:, :kk]
    ids = torch.gather(bin_i, -1, p)
    scores = torch.where(ids >= 0, scores, float("inf"))
    if kk < k:
        b = scores.shape[0]
        scores = torch.cat([scores, scores.new_full((b, k - kk), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
    return scores, ids
