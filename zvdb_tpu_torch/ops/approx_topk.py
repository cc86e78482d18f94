"""Binned partial top-k, smallest first: the port of `jax.lax.approx_min_k`.

On a TPU, approx_min_k is the TPU-KNN partial reduce (PAPERS.md), run by
XLA in hardware: each row of the operand is folded into L bins by keeping
the minimum of each bin, and an exact top-k is then taken over the L
winners. The JAX package calls it at seven places (the flat engine's
approximate scan, the sharded flat and PQ decode scans, the IVF probes and
pair-scan cut, the graph build's per-block cut, CAGRA's seed anchors).

`reduction_output_size` is the port's copy of XLA's rule for L (its
`ApproxTopKReductionOutputSize`, read off JAX's shapes): L depends on the
operand's rank through the TPU's tile (1024 columns for rank 1, 128 above),
is N itself for a short row or for recall_target 1.0, and is otherwise
ceil(N / 128 / 2^s) * 128 for the largest reduction s that keeps the
expected recall ((1 - 1/M)^(k-1) for M = N / 2^s windows) above the target.

The bin rule here is kernel A's (zvdb_tpu/ops/pallas_topk.py: bin = c % L)
and the graph build's "binfold" rule: column c goes to bin c % L, a bin keeps
its minimum, a tie goes to the lower column, and the k smallest (value,
column) pairs are returned in ascending order. The TPU's own assignment of
columns to bins cannot be seen from here: JAX on the CPU sorts instead of
reducing (jax/_src/lax/ann.py: "For other device types it fallbacks to sort
and slice"), so the rule is chosen, not read off the TPU.

On a CUDA tensor `approx_min_k` launches the kernel of csrc/approx_topk.cu,
built with nvcc at first use into build/kernels/ and bound with ctypes. On a
CPU tensor it returns what JAX's approx_min_k returns on the CPU: the exact
top-k, ties to the lower position (ops/topk.py:smallest_k_dense). The device
of the tensor is the only switch. `_approx_min_k_plain` is the kernel's
function in plain PyTorch, which the tests and chip_smoke.py hold it to.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from . import cuda_build
from . import topk as T

_INF = float("inf")
# The kernel's largest L (csrc/approx_topk.cu checks it too): its select
# stage sorts a row's bins in shared memory, 8 bytes a bin padded to a power
# of two (128 KB at 16384).
MAX_BINS = 16384
# Blocks the fold aims to start: rows times splits of each row's windows.
_FOLD_BLOCKS = 2048
# s, part, vals, pos, rows, n, L, k, splits, windows per split, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]
build_info: dict = {}   # approx_topk.cu: path, seconds, ptxas report of this process's build


def _log2_ceil(x: int) -> int:
    return (x - 1).bit_length()


def reduction_output_size(n: int, rank: int, k: int, recall_target: float) -> int:
    """L, the number of bins approx_min_k reduces a row of n columns to, for
    an operand of `rank` dimensions: XLA's rule, which JAX reports as the
    last dimension of approx_min_k(..., aggregate_to_topk=False)."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")
    tiling = 1024 if rank == 1 else 128
    if n <= tiling:
        return n
    tiles = -(-n // tiling)
    if k == 1:
        shift = _log2_ceil(tiles)
    else:
        if recall_target == 1.0:
            return n
        # XLA takes recall_target as a float32 and the logarithm in float64
        r32 = struct.unpack("f", struct.pack("f", recall_target))[0]
        m = min(max(int((1.0 - k) / math.log(r32)), tiling), n)
        shift = (n // m).bit_length() - 1
        if shift == 0:
            return n
        shift = min(shift, _log2_ceil(n // tiling))
    return -(-tiles // (1 << shift)) * tiling


def fold_bins(s: torch.Tensor, l_bins: int):
    """[..., W] scores -> ([..., L] minima, [..., L] int32 columns m*L + l):
    column c goes to bin c % L, by a strict < fold over the windows in order
    (the lower column keeps a tie, -0.0 and +0.0 tie, and a bin of only +inf
    keeps column l, as an argmin does); columns past W count as +inf."""
    col = torch.arange(l_bins, dtype=torch.int32, device=s.device)
    best = s.new_full(s.shape[:-1] + (l_bins,), _INF)
    best_c = col.expand(best.shape).clone()
    for m0 in range(0, s.shape[-1], l_bins):
        sm = s[..., m0:m0 + l_bins]
        w = sm.shape[-1]
        take = sm < best[..., :w]
        best[..., :w] = torch.where(take, sm, best[..., :w])
        best_c[..., :w] = torch.where(take, m0 + col[:w], best_c[..., :w])
    return best, best_c


def _approx_min_k_plain(s: torch.Tensor, k: int, l_bins: int):
    """The kernel's function in plain PyTorch, over the last axis of s.

    The row is padded with +inf to a multiple of L and folded into L bins by
    `fold_bins`. The k smallest (value, column) pairs of the bins come back
    in ascending order, -0.0 ordered as +0.0, each value as the row holds
    it: (values f32 [..., k], positions int64 [..., k]). With L >= N this is
    lax.top_k's selection, ties to the lower position. Inputs hold no NaN
    (the callers mark invalid entries +inf)."""
    n = s.shape[-1]
    if not 1 <= k <= l_bins:
        raise ValueError(f"needs 1 <= k <= L, got k={k}, L={l_bins}")
    lead = s.shape[:-1]
    best, best_c = fold_bins(s.reshape(-1, n), l_bins)
    _, pos, vals = T._lexsort(best + 0.0, best_c, best)
    return vals[:, :k].reshape(*lead, k), pos[:, :k].long().reshape(*lead, k)


def build():
    """Compile csrc/approx_topk.cu, load it and return its entry point."""
    fn, info = cuda_build.load("approx_topk.cu", "zvdb_approx_min_k", _ARGTYPES)
    build_info.update(info)
    return fn


def fold_splits(rows: int, windows: int) -> tuple[int, int]:
    """(splits, windows per split): each row's windows are cut into splits
    folded by blocks of their own, so that few long rows still start
    about _FOLD_BLOCKS blocks."""
    splits = min(windows, max(1, -(-_FOLD_BLOCKS // max(rows, 1))), 65535)
    per = -(-windows // splits)
    return -(-windows // per), per


def approx_min_k(s: torch.Tensor, k: int, recall_target: float = 0.95):
    """The k smallest entries over the last axis of s, selected as
    lax.approx_min_k selects them: (values f32 [..., k], positions int64
    [..., k]), ascending. Any leading shape; L comes from
    `reduction_output_size` with the operand's rank.

    On a CUDA tensor: the kernel (the bin fold and the exact top-k of the
    bins, `_approx_min_k_plain`'s function bit for bit); raises ValueError
    when L exceeds MAX_BINS. On a CPU tensor: the exact top-k, as JAX's
    approx_min_k on the CPU."""
    n = s.shape[-1]
    l_bins = reduction_output_size(n, s.dim(), k, recall_target)
    if s.device.type == "cpu":
        return T.smallest_k_dense(s, k)
    if s.device.type != "cuda":
        raise ValueError(f"approx_min_k: s must lie on a CUDA device or the CPU, not {s.device}")
    if s.dtype != torch.float32:
        raise TypeError(f"approx_min_k: s must be float32, got {s.dtype}")
    if not 1 <= k <= l_bins:
        raise ValueError(f"approx_min_k: k={k} must lie in [1, L={l_bins}] (N={n})")
    if l_bins > MAX_BINS:
        raise ValueError(f"approx_min_k: L={l_bins} bins exceeds the kernel's {MAX_BINS} "
                         f"(N={n}, k={k}, recall_target={recall_target})")
    if n >= 2**31:
        raise ValueError(f"approx_min_k: the last axis ({n}) must be below 2^31")
    lead = s.shape[:-1]
    rows = lead.numel()
    vals = torch.empty((rows, k), dtype=torch.float32, device=s.device)
    pos = torch.empty((rows, k), dtype=torch.int64, device=s.device)
    if rows == 0:
        return vals.reshape(*lead, k), pos.reshape(*lead, k)
    if rows >= 2**31:
        raise ValueError(f"approx_min_k: {rows} rows exceed the grid")
    s = s.contiguous()
    splits, per = fold_splits(rows, -(-n // l_bins))
    part = torch.empty((rows, splits, l_bins), dtype=torch.int64, device=s.device)
    kernel = build()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = kernel(s.data_ptr(), part.data_ptr(), vals.data_ptr(), pos.data_ptr(), rows, n,
                    l_bins, k, splits, per, stream)
    if rc != 0:
        raise RuntimeError(f"approx_min_k: kernel launch failed with CUDA error {rc}")
    approx_min_k.launches += 1
    return vals.reshape(*lead, k), pos.reshape(*lead, k)


approx_min_k.launches = 0   # every launch of the kernel
