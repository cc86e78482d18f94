"""Exact flat top-k scans (ports of examples/pallas_scan_v1.py and
examples/pallas_scan_v2.py, the repo's first two fused-scan attempts).

`flat_topk_pallas` (kernel E) and `flat_topk_pallas2` (kernel F) compute one
function: an exact top-k over the whole corpus. For each query the chunks of
`chunk` rows are taken in order against a k-slot buffer that starts at
(+inf, -1). Per chunk, s = ||x||^2 - 2 q.x for metric "l2" (the norms
recomputed in f32 from the chunk) and s = -q.x for any other metric string;
rows at or past N score +inf. Each of k rounds takes the chunk's minimum and
its first argmin; when that is strictly below the buffer's maximum, it
replaces the buffer's first argmax slot; the column is set to +inf either
way. Ids are -1 wherever the final score is not finite. The output is in
slot order, not sorted: `q_tile` changes nothing, `chunk` changes the slot
order, and k > chunk is legal (the extra rounds take nothing).

Precision: the TPU kernels pass no precision, so their dot is the backend's
default (bf16 on a TPU, f32 in interpret mode). The port computes f32: FMAs
in the kernels, and f32 matmuls in the plain version, which on the card
assume TF32 is off as everywhere in the package (ops/distance.py). This is
an exact oracle.

On a CUDA tensor each entry point launches a hand-written kernel (built with
nvcc at first use into build/kernels/ and bound with ctypes). E runs
csrc/scan_topk_mma.cu: a pre-pass splits the corpus into bf16 hi/lo planes
and its exact f32 norms, then one block per 16-query tile walks every chunk,
filters each chunk's columns on the tensor cores (bf16x3 `mma.sync`) against
each query's running k-th score plus a proven margin (`filter_margin`), and
re-scores the survivors with the exact f32 FMA chain, so E's output equals
the CUDA-core kernel's and F's bit for bit. Every legal shape takes that
route. The CUDA-core E (`zvdb_flat_topk_v1`, csrc/scan_topk.cu) stays
reachable through `launch`, uncounted. F runs the same source's second entry
point: E's pre-pass; a filter pass over all (64-query tile, chunk) pairs in
parallel, on the tensor cores, against a bound found inside the chunk (an
upper bound s~ + margin of k of its columns: for k <= 32 the k-th smallest of
32 lanes' minima, else by a select); a select pass that re-scores the
survivors with the exact f32 chain and writes each chunk's k smallest pairs
into a scratch; a fold that replays them per query. So F too equals the
CUDA-core kernels bit for bit. The CUDA-core F (`zvdb_flat_topk_v2_passes`,
csrc/scan_topk.cu) stays reachable through `launch_f_passes`, uncounted. On a
CPU tensor both run `_flat_topk_plain`, the same function in plain PyTorch.

The filter's margin. With u = 2^-24, DP = D rounded up to 16 and
P = sum_d |q_d x_d| <= ||q|| ||x||, the filter's score s~ (three bf16
products summed by the tensor cores) and the exact score s (the FMA chain)
differ by at most u((1557 + 8.15 DP) P + 2 nrm) + 2^-100 DP (1 + ||q|| +
||x||): the split drops <= 776 u P, the tensor cores' accumulation (taken
as <= 16 u of its operands' magnitude per mma, 3 DP / 16 mmas) <= 3.06 DP
u P, the chain itself <= 1.0001 D u P, both scores round nrm - 2a once, and
the last term covers subnormals. `filter_margin` doubles every term (the
derivation in full heads csrc/scan_topk_mma.cu). A column whose s~ exceeds
T + margin, T the query's buffer worst at the start of the chunk, has an
exact score above T and can never be taken, so the filter is exact. F's
filter pass keeps a column while s~ - margin <= T, T at least the k-th
smallest s~ + margin of k of the chunk's columns: those k columns have exact
scores <= T, so a column dropped has an exact score above the chunk's k-th
smallest.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_CHUNK = 4096   # the kernels keep a chunk's scores in shared memory
MAX_K = 256        # ... and each query's k-slot buffer
MAX_DIM = 1024     # ... and the query tile

build_info: dict = {}       # scan_topk.cu: path, seconds, ptxas report of this process's build
build_info_mma: dict = {}   # scan_topk_mma.cu: the same

_INF = float("inf")
_STATS = ("candidates", "most_in_a_list", "overflowed", "cold", "lists")
_STATS_F = ("pushed", "most_in_a_list", "overflowed", "rescored", "refreshes")
# kernel F's parts, for `launch_f_passes`: the tensor-core route's pre-pass,
# filter pass and select pass (together its pairs pass), and the fold
PREP, FILTER, FOLD, SELECT = 1, 2, 4, 8
PAIRS = FILTER | SELECT


def filter_margin(q_norm, x_norm, d: int):
    """The tensor-core filter's margin for a query of norm `q_norm` against
    rows of norm `x_norm` at depth `d` (floats or tensors): twice every term
    of the proven bound on |filter score - exact score| (module docstring).
    The kernel evaluates it with `x_norm ** 2` as the row's exact f32 norm."""
    dp = -(-d // 16) * 16
    u = 2.0 ** -24
    return (u * ((4096 + 18 * dp) * q_norm * x_norm + 5 * x_norm * x_norm)
            + 2.0 ** -100 * dp * (1 + q_norm + x_norm))


def build_v1():
    """Compile csrc/scan_topk.cu (once per source and flags), load it and
    return kernel E's entry point."""
    fn, info = cuda_build.load(
        "scan_topk.cu", "zvdb_flat_topk_v1",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    build_info.update(info)
    return fn


def build_v1_mma():
    """Compile csrc/scan_topk_mma.cu, load it and return kernel E's
    tensor-core entry point, with its scratch size function (B, N, D, k,
    chunk -> bytes, -1 when refused) as `.scratch_bytes` and its pre-pass
    alone as `.prep` (for `launch_prep`)."""
    fn, info = cuda_build.load(
        "scan_topk_mma.cu", "zvdb_flat_topk_v1_mma",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    size, _ = cuda_build.load("scan_topk_mma.cu", "zvdb_flat_topk_v1_mma_scratch",
                              [ctypes.c_int] * 5)
    size.restype = ctypes.c_longlong
    fn.scratch_bytes = size
    fn.prep, _ = cuda_build.load("scan_topk_mma.cu", "zvdb_flat_topk_v1_mma_prep",
                                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    build_info_mma.update(info)
    return fn


def build_v2_mma():
    """Kernel F's tensor-core entry point, from csrc/scan_topk_mma.cu (E's
    library), with its scratch size function as `.scratch_bytes`
    (`launch_f_passes` runs it)."""
    fn, info = cuda_build.load(
        "scan_topk_mma.cu", "zvdb_flat_topk_v2_mma",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int])
    size, _ = cuda_build.load("scan_topk_mma.cu", "zvdb_flat_topk_v2_mma_scratch",
                              [ctypes.c_int] * 5)
    size.restype = ctypes.c_longlong
    fn.scratch_bytes = size
    build_info_mma.update(info)
    return fn


def build_v2_passes():
    """The CUDA-core F's pass-selecting entry point, from csrc/scan_topk.cu
    (E's CUDA-core library): for `launch_f_passes`."""
    fn, info = cuda_build.load(
        "scan_topk.cu", "zvdb_flat_topk_v2_passes",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int])
    build_info.update(info)
    return fn


def _check_args(k: int, q_tile: int, chunk: int):
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if q_tile < 1 or chunk < 1:
        raise ValueError(f"q_tile and chunk must be >= 1, got {q_tile}, {chunk}")


def _flat_topk_plain(q: torch.Tensor, vectors: torch.Tensor, k: int, metric: str = "l2",
                     q_tile: int = 256, chunk: int = 2048):
    """The same function in plain PyTorch. Round r of a chunk extracts its
    r-th smallest (score, index) pair, ties to the lower index, whatever the
    buffer holds, so each chunk's k smallest pairs come from one stable sort
    and are replayed in order against the buffer (first argmax slot, strict
    <). A replay stops at the first pair no query takes: the buffer's worst
    never rises, so no later pair of that chunk could be taken."""
    _check_args(k, q_tile, chunk)
    q = q.float()
    x = vectors.float()
    b, n = q.shape[0], x.shape[0]
    dev = q.device
    best_s = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    kcol = torch.arange(k, device=dev)
    kk = min(k, chunk)
    group = max(1, (1 << 24) // max(1, b * chunk))   # chunks per product
    for lo in range(0, n, group * chunk):
        xs = x[lo:lo + group * chunk]
        nch = -(-xs.shape[0] // chunk)
        dots = q @ xs.T
        s = (xs * xs).sum(1)[None, :] - 2.0 * dots if metric == "l2" else -dots
        pad = nch * chunk - xs.shape[0]
        if pad:
            s = torch.cat([s, s.new_full((b, pad), _INF)], dim=1)
        vals, pos = torch.sort(s.view(b, nch, chunk), dim=2, stable=True)
        vals, pos = vals[:, :, :kk], pos[:, :, :kk]
        ids = (lo + chunk * torch.arange(nch, device=dev)[None, :, None] + pos).to(torch.int32)
        for j in range(nch):
            for r in range(kk):
                m = vals[:, j, r]
                worst = best_s.max(dim=1).values
                take = m < worst
                if not bool(take.any()):
                    break
                aw = torch.where(best_s == worst[:, None], kcol, k).min(dim=1).values
                rt, at = rows[take], aw[take]
                best_s[rt, at] = m[take]
                best_i[rt, at] = ids[:, j, r][take]
    return best_s, torch.where(torch.isfinite(best_s), best_i, -1)


def _launch(name: str, q, vectors, k: int, chunk: int):
    """Checks and allocations shared by the two entry points: (q, x, out_s,
    out_i, B, N, D) ready for a kernel."""
    if q.device.type != "cuda" or vectors.device != q.device:
        raise ValueError(f"{name}: q and vectors must lie on one CUDA device")
    if q.dim() != 2 or vectors.dim() != 2 or vectors.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, vectors {tuple(vectors.shape)} "
                         "disagree")
    if not (q.is_floating_point() and vectors.is_floating_point()):
        raise TypeError(f"{name}: q and vectors must be floating point")
    b, d = q.shape
    n = vectors.shape[0]
    if k > MAX_K or chunk > MAX_CHUNK or d > MAX_DIM or d < 1:
        raise ValueError(f"{name}: the kernel takes k <= {MAX_K}, chunk <= {MAX_CHUNK} and "
                         f"1 <= D <= {MAX_DIM}; got k={k}, chunk={chunk}, D={d}")
    if n >= 2**31 or -(-n // chunk) > 65535:
        raise ValueError(f"{name}: needs N < 2**31 (int32 ids) and N / chunk <= 65535")
    q = q.float().contiguous()         # the TPU kernels cast both to f32
    x = vectors.float().contiguous()
    out_s = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    return q, x, out_s, out_i, b, n, d


def flat_topk_pallas(q: torch.Tensor, vectors: torch.Tensor, k: int, metric: str = "l2",
                     q_tile: int = 256, chunk: int = 2048):
    """Exact top-k over the full corpus (kernel E, one pass). Returns
    (scores [B, k] f32 surrogate, ids [B, k] int32) in slot order.

    On a CUDA tensor every legal shape launches the tensor-core kernel
    (csrc/scan_topk_mma.cu), counted by `launches` and `launches_mma`. A CPU
    tensor takes the plain version and counts nothing."""
    _check_args(k, q_tile, chunk)
    if q.device.type == "cpu":
        return _flat_topk_plain(q, vectors, k, metric, q_tile, chunk)
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas", q, vectors, k, chunk)
    if b == 0:
        return out_s, out_i
    out = launch(build_v1_mma(), q, x, k, metric, chunk)
    flat_topk_pallas.launches += 1
    flat_topk_pallas.launches_mma += 1
    return out


flat_topk_pallas.launches = 0       # every launch of kernel E
flat_topk_pallas.launches_mma = 0   # the launches on the tensor cores (all of them)


def launch(kernel, q, vectors, k: int, metric: str = "l2", chunk: int = 2048, stats=None):
    """Run one of kernel E's entry points, `build_v1_mma()` (tensor cores) or
    `build_v1()` (CUDA cores), on CUDA tensors and return (scores, ids);
    counts nothing. `stats`, for the tensor-core entry point only, is None or
    a zeroed int64 CUDA tensor of 5 that the kernel adds to: candidates
    pushed, the most in one list, lists that overflowed, cold (query, chunk)
    pairs re-scored in full, and lists replayed. Raises RuntimeError if the
    launch fails."""
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas", q, vectors, k, chunk)
    if b == 0:
        return out_s, out_i
    mma = kernel.__name__.endswith("_mma")
    if stats is not None and (not mma or stats.dtype != torch.int64 or stats.numel() != 5
                              or stats.device != q.device):
        raise ValueError("launch: stats is a 5-element int64 tensor on q's device, for the "
                         "tensor-core entry point")
    l2 = int(metric == "l2")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            scratch = _mma_scratch(kernel, b, n, d, k, chunk, q.device)
            rc = kernel(q.data_ptr(), x.data_ptr(), scratch.data_ptr(), out_s.data_ptr(),
                        out_i.data_ptr(), 0 if stats is None else stats.data_ptr(), b, n, d, k,
                        chunk, l2, stream)
        else:
            rc = kernel(q.data_ptr(), x.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d,
                        k, chunk, l2, stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk_pallas: kernel launch failed with CUDA error {rc}")
    return out_s, out_i


def flat_topk_pallas2(q: torch.Tensor, vectors: torch.Tensor, k: int, metric: str = "l2",
                      q_tile: int = 256, chunk: int = 2048):
    """Exact top-k over the full corpus (kernel F, two passes through a
    [B, ceil(N/chunk), k] scratch of each chunk's smallest pairs). Same
    results as `flat_topk_pallas`.

    On a CUDA tensor every legal shape launches the tensor-core kernel
    (csrc/scan_topk_mma.cu), counted by `launches` and `launches_mma`. A CPU
    tensor takes the plain version and counts nothing."""
    _check_args(k, q_tile, chunk)
    if q.device.type == "cpu":
        return _flat_topk_plain(q, vectors, k, metric, q_tile, chunk)
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas2", q, vectors, k, chunk)
    if b == 0:
        return out_s, out_i
    out_s, out_i, _, _ = launch_f_passes(build_v2_mma(), q, x, k, metric, chunk)
    flat_topk_pallas2.launches += 1
    flat_topk_pallas2.launches_mma += 1
    return out_s, out_i


flat_topk_pallas2.launches = 0       # every launch of kernel F
flat_topk_pallas2.launches_mma = 0   # the launches on the tensor cores (all of them)


def _mma_scratch(kernel, b: int, n: int, d: int, k: int, chunk: int, device):
    nbytes = kernel.scratch_bytes(b, n, d, k, chunk)
    if nbytes < 0:
        raise ValueError(f"{kernel.__name__}: the tensor-core kernel refuses B={b}, N={n}, "
                         f"D={d}, k={k}, chunk={chunk}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def launch_prep(q, vectors, k: int, chunk: int = 2048):
    """Run the tensor-core E's pre-pass alone (the bf16 planes and norms of
    `vectors`) on CUDA tensors, uncounted, to time its share of E."""
    q, x, _, _, b, n, d = _launch("flat_topk_pallas", q, vectors, k, chunk)
    kernel = build_v1_mma()
    scratch = _mma_scratch(kernel, b, n, d, k, chunk, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel.prep(x.data_ptr(), scratch.data_ptr(), b, n, d, k, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk_pallas: pre-pass launch failed with CUDA error {rc}")


def launch_f_passes(kernel, q, vectors, k: int, metric: str = "l2", chunk: int = 2048,
                    passes: int = PREP | PAIRS | FOLD, pairs=None, scratch=None, stats=None):
    """Run parts of kernel F through `kernel`, `build_v2_mma()` (tensor
    cores) or `build_v2_passes()` (CUDA cores), on CUDA tensors, uncounted.
    `passes` is a sum of PREP (the tensor-core route's pre-pass: the bf16
    planes and norms, into `scratch`), FILTER and SELECT (the tensor-core
    route's pairs pass, PAIRS: each chunk's survivors into `scratch`, then
    its k smallest pairs into `pairs`; the CUDA-core route's one pairs pass
    for either) and FOLD (their replay into the output). `pairs` =
    (pair_s, pair_i) and `scratch` from an earlier call are reused, so a part
    alone runs on what the others wrote. `stats`, for the tensor-core route
    only, is None or a zeroed int64 CUDA tensor of 5 that the filter pass
    adds to: entries pushed to the lists, the longest list at a bound or a
    chunk's end, lists that overflowed (their chunk re-scored in full),
    survivors re-scored by the select pass, and lists compacted (k <= 32) or
    refreshed by a select (k > 32). Returns (scores, ids, pairs, scratch).
    Raises RuntimeError if a launch fails."""
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas2", q, vectors, k, chunk)
    nc = -(-n // chunk)
    if pairs is None:
        pairs = (torch.empty((b, nc, k), dtype=torch.float32, device=q.device),
                 torch.empty((b, nc, k), dtype=torch.int32, device=q.device))
    if b == 0:
        return out_s, out_i, pairs, scratch
    mma = kernel.__name__.endswith("_mma")
    if stats is not None and (not mma or stats.dtype != torch.int64 or stats.numel() != 5
                              or stats.device != q.device):
        raise ValueError("launch_f_passes: stats is a 5-element int64 tensor on q's device, "
                         "for the tensor-core entry point")
    l2 = int(metric == "l2")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            if scratch is None:
                scratch = _mma_scratch(kernel, b, n, d, k, chunk, q.device)
            rc = kernel(q.data_ptr(), x.data_ptr(), scratch.data_ptr(), pairs[0].data_ptr(),
                        pairs[1].data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                        0 if stats is None else stats.data_ptr(), b, n, d, k, chunk, l2, stream,
                        passes)
        else:
            rc = kernel(q.data_ptr(), x.data_ptr(), pairs[0].data_ptr(), pairs[1].data_ptr(),
                        out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, chunk, l2, stream,
                        (1 if passes & PAIRS else 0) | (2 if passes & FOLD else 0))
    if rc != 0:
        raise RuntimeError(f"flat_topk_pallas2: kernel launch failed with CUDA error {rc}")
    return out_s, out_i, pairs, scratch
