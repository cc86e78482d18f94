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

On a CUDA tensor each entry point launches its hand-written kernel in
csrc/scan_topk.cu (built with nvcc at first use into build/kernels/ and bound
with ctypes): E walks every chunk inside one block per query tile, F scores
all (query tile, chunk) pairs in parallel into a scratch of each chunk's k
smallest pairs and replays them per query. On a CPU tensor both run
`_flat_topk_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_CHUNK = 4096   # the kernels keep a chunk's scores in shared memory
MAX_K = 256        # ... and each query's k-slot buffer
MAX_DIM = 1024     # ... and the query tile

build_info: dict = {}   # path, seconds, ptxas report of this process's build

_INF = float("inf")


def build_v1():
    """Compile csrc/scan_topk.cu (once per source and flags), load it and
    return kernel E's entry point."""
    fn, info = cuda_build.load(
        "scan_topk.cu", "zvdb_flat_topk_v1",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    build_info.update(info)
    return fn


def build_v2():
    """Kernel F's entry point, from the same library as kernel E."""
    fn, info = cuda_build.load(
        "scan_topk.cu", "zvdb_flat_topk_v2",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
    (scores [B, k] f32 surrogate, ids [B, k] int32) in slot order."""
    _check_args(k, q_tile, chunk)
    if q.device.type == "cpu":
        return _flat_topk_plain(q, vectors, k, metric, q_tile, chunk)
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas", q, vectors, k, chunk)
    if b == 0:
        return out_s, out_i
    kernel = build_v1()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(q.data_ptr(), x.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, k,
                    chunk, int(metric == "l2"), stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk_pallas: kernel launch failed with CUDA error {rc}")
    flat_topk_pallas.launches += 1
    return out_s, out_i


flat_topk_pallas.launches = 0


def flat_topk_pallas2(q: torch.Tensor, vectors: torch.Tensor, k: int, metric: str = "l2",
                      q_tile: int = 256, chunk: int = 2048):
    """Exact top-k over the full corpus (kernel F, two passes through a
    [B, ceil(N/chunk), k] scratch of each chunk's smallest pairs). Same
    results as `flat_topk_pallas`."""
    _check_args(k, q_tile, chunk)
    if q.device.type == "cpu":
        return _flat_topk_plain(q, vectors, k, metric, q_tile, chunk)
    q, x, out_s, out_i, b, n, d = _launch("flat_topk_pallas2", q, vectors, k, chunk)
    if b == 0:
        return out_s, out_i
    nc = -(-n // chunk)
    pair_s = torch.empty((b, nc, k), dtype=torch.float32, device=q.device)
    pair_i = torch.empty((b, nc, k), dtype=torch.int32, device=q.device)
    kernel = build_v2()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(q.data_ptr(), x.data_ptr(), pair_s.data_ptr(), pair_i.data_ptr(),
                    out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, chunk, int(metric == "l2"),
                    stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk_pallas2: kernel launch failed with CUDA error {rc}")
    flat_topk_pallas2.launches += 1
    return out_s, out_i


flat_topk_pallas2.launches = 0
