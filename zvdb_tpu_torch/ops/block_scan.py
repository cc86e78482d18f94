"""Block scorer of the graph build: intra-block pairwise scores + bin-parallel
partial top-k (port of zvdb_tpu/ops/pallas_block.py).

The cluster-kNN build (index/knn_graph.py:_block_knn_scatter, sel="pallas")
scores every row of a k-means block against the whole block and keeps
candidates per row. Here each row folds its block's scores into [L]
modular-bin minima by column m*L + l (strict <, so the lower column wins a
tie), the self-pair excluded, and the [cc, B, B] score tensor never reaches
device memory; a small sort over the L bins then picks the candidates.

On a CUDA tensor `block_bins` launches kernel D, the second entry point of
csrc/flat_scan.cu (built with nvcc at first use into build/kernels/ and
bound with ctypes); on a CPU tensor it runs `block_bins_plain`, the same
function in plain PyTorch, which the tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import distance as D
from .flat_scan import _PRECISION_CODE, build_info

_INF = float("inf")


def build():
    """Compile csrc/flat_scan.cu (shared with kernel A), load it and return
    kernel D's entry point."""
    fn, info = cuda_build.load(
        "flat_scan.cu", "zvdb_block_bins",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p])
    build_info.update(info)
    return fn


def _check_args(l_bins: int, bq: int, metric: str, precision: str):
    if l_bins < 1 or bq % l_bins != 0:
        raise ValueError(f"bq ({bq}) must be a positive multiple of l_bins ({l_bins})")
    if precision not in _PRECISION_CODE:
        raise ValueError(f"precision must be one of {tuple(_PRECISION_CODE)}, got {precision!r}")
    if metric not in ("l2", "dot", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")


def block_bins_plain(v: torch.Tensor, vn: torch.Tensor, l_bins: int = 128,
                     metric: str = "l2", precision: str = "high"):
    """The same function in plain PyTorch: the [cc, B, B] block products at
    `precision` (for "high" the bf16 splits hi*hi + hi*lo + lo*hi, summed in
    that order), the self-pairs set to +inf, then each L-wide column slice
    folded into the bins in ascending order with the strict < of the TPU
    kernel."""
    cc, b, _ = v.shape
    f = 2.0 if metric == "l2" else 1.0
    dots = D._sum_products(D._operand_pairs(v, v, precision),
                           lambda a, c: torch.bmm(a, c.transpose(1, 2)))
    s = vn.float()[:, None, :] - f * dots
    s.diagonal(dim1=1, dim2=2).fill_(_INF)
    best_s = torch.full((cc, b, l_bins), _INF, dtype=torch.float32, device=v.device)
    best_i = torch.full((cc, b, l_bins), -1, dtype=torch.int32, device=v.device)
    col = torch.arange(l_bins, dtype=torch.int32, device=v.device)
    for m0 in range(0, b, l_bins):
        sm = s[:, :, m0:m0 + l_bins]
        w = sm.shape[2]
        take = sm < best_s[:, :, :w]
        best_s[:, :, :w] = torch.where(take, sm, best_s[:, :, :w])
        best_i[:, :, :w] = torch.where(take, m0 + col[:w], best_i[:, :, :w])
    return best_s, torch.where(torch.isfinite(best_s), best_i, -1)


def block_bins(
    v: torch.Tensor,     # [cc, B, D] f32 block vectors (pre-gathered)
    vn: torch.Tensor,    # [cc, B] f32 norms; +inf marks invalid slots
    l_bins: int = 128,
    bq: int = 256,
    metric: str = "l2",
    precision: str = "high",
):
    """Per row of each block: [L] bin-minimum scores and within-block column
    ids (-1 where a bin saw only invalid or self entries). Scores follow the
    repo's surrogate convention: vn - 2 v.w for l2, vn - v.w for dot/cosine
    (vn zero on valid slots). Returns ([cc, B, L] f32, [cc, B, L] int32).

    `bq` is the TPU kernel's row tile: validated as the JAX package does (a
    multiple of l_bins), it does not change results. The TPU pads B to a
    multiple of bq and D to 128 with zeros and +inf norms; the padding never
    wins a bin, so neither version makes the padded copy."""
    _check_args(l_bins, bq, metric, precision)
    if v.device.type == "cpu":
        return block_bins_plain(v, vn, l_bins, metric, precision)
    if v.device.type != "cuda" or vn.device != v.device:
        raise ValueError("block_bins: v and vn must lie on one CUDA device")
    if v.dtype != torch.float32 or vn.dtype != torch.float32:
        raise TypeError("block_bins: v and vn must be float32")
    if v.dim() != 3 or vn.shape != v.shape[:2]:
        raise ValueError(f"block_bins: shapes v {tuple(v.shape)}, vn {tuple(vn.shape)} disagree")
    cc, b, d = v.shape
    if cc > 65535 or l_bins > 65535 * 64:
        raise ValueError("block_bins: needs cc <= 65535 and l_bins <= 65535*64 (grid limits)")
    v = v.contiguous()
    vn = vn.contiguous()
    out_s = torch.empty((cc, b, l_bins), dtype=torch.float32, device=v.device)
    out_i = torch.empty((cc, b, l_bins), dtype=torch.int32, device=v.device)
    if cc == 0 or b == 0:
        return out_s, out_i
    kernel = build()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = kernel(v.data_ptr(), vn.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), cc, b, d,
                    l_bins, 2.0 if metric == "l2" else 1.0, _PRECISION_CODE[precision], stream)
    if rc != 0:
        raise RuntimeError(f"block_bins: kernel launch failed with CUDA error {rc}")
    block_bins.launches += 1
    return out_s, out_i


block_bins.launches = 0
