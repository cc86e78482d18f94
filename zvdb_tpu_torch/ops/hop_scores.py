"""Fused graph-hop scorer (port of examples/exp_r3_hopkernel.py).

    scores[b, j] = q[b] . x[idx[b, j]]      in f32

A beam-search hop scores each query against its candidate rows. The plain
form gathers the candidates into a [B, K, D] tensor and contracts it
(`_hop_scores_plain`, the counterpart of the example's `xla_hop_scores`); the
fused form reads each candidate row once and never writes the gather to
device memory. On the TPU the fused Pallas kernel lost 31x to XLA's hardware
gather (one DMA per row); on a GPU a row gather is an ordinary coalesced
load. The graph engines do not call it: the JAX CAGRA does not either.

On a CUDA tensor `fused_hop_scores` launches kernel G in csrc/hop_scores.cu
(built with nvcc at first use into build/kernels/ and bound with ctypes); on
a CPU tensor it runs `_hop_scores_plain`. The TPU wrapper's shape asserts
(B % 8 == 0, K % 128 == 0) are kept as ValueErrors. An id outside [0, N) is
the caller's error: the kernel reads nothing for it and scores NaN.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BT = 8     # the TPU kernel's query tile: B must be a multiple
CH = 128   # its candidate chunk: K must be a multiple

build_info: dict = {}   # path, seconds, ptxas report of this process's build


def build():
    """Compile csrc/hop_scores.cu (once per source and flags), load it and
    return its entry point."""
    fn, info = cuda_build.load(
        "hop_scores.cu", "zvdb_hop_scores",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build_info.update(info)
    return fn


def _hop_scores_plain(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather + batched dot in f32 (the example's `xla_hop_scores` at
    Precision.HIGHEST); on the card TF32 must be off, as everywhere in the
    package (ops/distance.py)."""
    return torch.einsum("bd,bkd->bk", q.float(), x.float()[idx.long()])


def fused_hop_scores(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """scores [B, K] f32 for idx [B, K] int32, q [B, D] f32, x [N, D] f32."""
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
    if n >= 2**31:
        raise ValueError("fused_hop_scores: needs N < 2**31 (int32 ids)")
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    kernel = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(idx.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(), b, k, n, d,
                    stream)
    if rc != 0:
        raise RuntimeError(f"fused_hop_scores: kernel launch failed with CUDA error {rc}")
    fused_hop_scores.launches += 1
    return out


fused_hop_scores.launches = 0
