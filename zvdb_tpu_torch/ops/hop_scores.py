"""Fused graph-hop scorer (port of examples/exp_r3_hopkernel.py).

    scores[b, j] = q[b] . x[idx[b, j]]      in f32

A beam-search hop scores each query against its candidate rows. The plain
form gathers the candidates into a [B, K, D] tensor and contracts it
(`_hop_scores_plain`, the counterpart of the example's `xla_hop_scores`); the
fused form never writes the gather to device memory. On the TPU the fused
Pallas kernel lost 31x to XLA's hardware gather (one DMA per row); on a GPU
a row gather is an ordinary coalesced load. The graph engines do not call
it: the JAX CAGRA does not either.

What bounds it is bytes: each distinct candidate row once, plus the ids, q
and the output (0.1141 ms at the experiment's B=4992, K=256 over 1M x 128d
rows, where 1.28M uniform ids name ~721k distinct rows). A scorer that takes
the ids in their order reads a repeated row from device memory again, since
L2 holds a tenth of such a corpus. So kernel G (csrc/hop_scores.cu) has two
routes, both counted by `fused_hop_scores.launches`:
  - "direct": each warp scores 32 candidates of one query in idx's order,
    the query row in registers. For lists with few repeats, such as the
    cagra_1m hop (B=2048, K=128 over 1M rows).
  - "grouped" (also counted by `fused_hop_scores.launches_grouped`): a
    counting pass orders the B*K pairs by row window, stably (its plain
    version is `_window_order_plain`; `window_order` runs it alone), and
    the scorer walks that order, so a row's repeats mostly hit L2. For
    lists with many repeats, such as the experiment's shape.
`choose_route` picks one from (B, K, N) alone: the expected share of
repeated ids of B*K uniform draws from N rows, against REPEAT_SHARE, where
the two routes' times cross on an H100 (hop_route_sweep.py). That both
routes stay above the bound because one operand of every pair crosses from
L2 to the SMs is inferred from times (PERF.md section 6), not read from the
card's byte counters.

On a CUDA tensor `fused_hop_scores` launches the kernel (built with nvcc at
first use into build/kernels/ and bound with ctypes); on a CPU tensor it runs
`_hop_scores_plain`. The TPU wrapper's shape asserts (B % 8 == 0,
K % 128 == 0) are kept as ValueErrors. An id outside [0, N) is the caller's
error: the kernel reads nothing for it and scores NaN.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

BT = 8     # the TPU kernel's query tile: B must be a multiple
CH = 128   # its candidate chunk: K must be a multiple
REPEAT_SHARE = 0.30        # the grouped route from this expected share of repeated ids
WINDOW_BYTES = 8 << 20     # the grouped route's row window, at most (a part of the 50 MB L2)

build_info: dict = {}   # path, seconds, ptxas report of this process's build
_entries: dict = {}     # symbol -> its entry point, once loaded


def _load(symbol: str, argtypes: list, restype=ctypes.c_int):
    if symbol not in _entries:
        fn, info = cuda_build.load("hop_scores.cu", symbol, argtypes)
        fn.restype = restype
        build_info.update(info)
        _entries[symbol] = fn
    return _entries[symbol]


def build():
    """Compile csrc/hop_scores.cu (once per source and flags), load it and
    return its direct route's entry point."""
    return _load("zvdb_hop_scores", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def build_grouped():
    """The grouped route's entry point, and the scratch size it needs."""
    fn = _load("zvdb_hop_scores_grouped",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_longlong,
                                                              ctypes.c_void_p])
    fn.scratch_ints = _load("zvdb_hop_scratch_ints", [ctypes.c_int] * 3, ctypes.c_longlong)
    return fn


def build_window_order():
    """The grouped route's counting pass alone (for its tests)."""
    return _load("zvdb_hop_window_order",
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_void_p])


def repeat_share(b: int, k: int, n: int) -> float:
    """The expected share of B*K uniform draws from N rows that repeat an
    earlier draw: 1 - (1 - e^-r) / r, r = B*K/N."""
    if b * k == 0 or n == 0:
        return 0.0
    r = b * k / n
    return 1.0 - (1.0 - math.exp(-r)) / r


def choose_route(b: int, k: int, n: int) -> str:
    """The route for a [B, K] hop over N rows, from those ints alone (no
    look at the ids, no sync)."""
    return "grouped" if repeat_share(b, k, n) >= REPEAT_SHARE else "direct"


def window_shift(n: int, d: int, scratch_ints) -> int:
    """log2 of the grouped route's rows a window: the most rows of D f32s
    within WINDOW_BYTES, raised until the counting pass takes the window
    count (`scratch_ints`, the kernel's zvdb_hop_scratch_ints, is >= 0)."""
    shift = max(0, (WINDOW_BYTES // (4 * max(d, 1))).bit_length() - 1)
    while scratch_ints(0, n, shift) < 0:
        if shift >= 30:
            raise ValueError(f"window_shift: the counting pass takes no window of N={n}")
        shift += 1
    return shift


def _hop_scores_plain(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather + batched dot in f32 (the example's `xla_hop_scores` at
    Precision.HIGHEST); on the card TF32 must be off, as everywhere in the
    package (ops/distance.py)."""
    return torch.einsum("bd,bkd->bk", q.float(), x.float()[idx.long()])


def _window_order_plain(idx: torch.Tensor, n: int, shift: int):
    """The counting pass's result: the flat positions b*K + j of idx in
    stable order of window (id >> shift for ids in [0, N), after the last
    window for the rest), their ids, and the [W + 1] counts a window."""
    ids = idx.reshape(-1)
    windows = (n + (1 << shift) - 1) >> shift
    w = torch.where((ids >= 0) & (ids < n), ids.long() >> shift, windows)
    pos = torch.sort(w, stable=True).indices
    return pos.int(), ids[pos], torch.bincount(w, minlength=windows + 1).int()


def window_order(idx: torch.Tensor, n: int, shift: int):
    """`_window_order_plain` on the card: the grouped route's counting pass
    (three kernels) alone; counted by `window_order.launches`."""
    if idx.device.type == "cpu":
        return _window_order_plain(idx, n, shift)
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError("window_order: needs contiguous int32 ids")
    fn, p = build_grouped(), idx.numel()
    if p == 0:
        return _window_order_plain(idx, n, shift)
    need = fn.scratch_ints(p, n, shift)
    if need < 0:
        raise ValueError(f"window_order: no window order for N={n}, shift={shift}")
    scratch = torch.empty(need, dtype=torch.int32, device=idx.device)
    kernel = build_window_order()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = kernel(idx.data_ptr(), p, n, shift, scratch.data_ptr(), need, stream)
    if rc != 0:
        raise RuntimeError(f"window_order: kernel launch failed with CUDA error {rc}")
    window_order.launches += 1
    windows = (n + (1 << shift) - 1) >> shift
    order = scratch[:2 * p].view(p, 2)
    return order[:, 0], order[:, 1], scratch[need - windows - 1:]   # the counts come last


window_order.launches = 0


def fused_hop_scores(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """scores [B, K] f32 for idx [B, K] int32, q [B, D] f32, x [N, D] f32;
    on the card through the route `choose_route` picks."""
    if idx.dim() != 2 or q.dim() != 2 or x.dim() != 2:
        raise ValueError("fused_hop_scores: idx, q and x must be 2-d")
    b, k = idx.shape
    if b % BT or k % CH:
        raise ValueError(f"fused_hop_scores: needs B % {BT} == 0 and K % {CH} == 0, "
                         f"got B={b}, K={k}")
    if q.shape[0] != b or q.shape[1] != x.shape[1]:
        raise ValueError(f"fused_hop_scores: shapes idx {tuple(idx.shape)}, q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)} disagree")
    if q.device.type == "cpu":
        return _hop_scores_plain(idx, q, x)
    if q.device.type != "cuda" or idx.device != q.device or x.device != q.device:
        raise ValueError("fused_hop_scores: idx, q and x must lie on one CUDA device")
    if idx.dtype != torch.int32 or q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"fused_hop_scores: needs int32 idx and float32 q, x; got "
                        f"{idx.dtype}, {q.dtype}, {x.dtype}")
    if not (idx.is_contiguous() and q.is_contiguous() and x.is_contiguous()):
        raise ValueError("fused_hop_scores: idx, q and x must be contiguous")
    n, d = x.shape
    if n >= 2**31 or b * k >= 2**31:
        raise ValueError("fused_hop_scores: needs N < 2**31 and B * K < 2**31 (int32 ids)")
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    route = choose_route(b, k, n)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "direct":
            rc = build()(idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k, n, d,
                         stream)
        else:
            kernel = build_grouped()
            shift = window_shift(n, d, kernel.scratch_ints)
            need = kernel.scratch_ints(b * k, n, shift)
            scratch = torch.empty(need, dtype=torch.int32, device=q.device)
            rc = kernel(idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k, n, d,
                        shift, scratch.data_ptr(), need, stream)
    if rc != 0:
        raise RuntimeError(f"fused_hop_scores: kernel launch failed with CUDA error {rc}")
    fused_hop_scores.launches += 1
    fused_hop_scores.launches_grouped += route == "grouped"
    return out


fused_hop_scores.launches = 0
fused_hop_scores.launches_grouped = 0
