"""Batched distances in matmul form (port of zvdb_tpu/ops/distance.py).

    ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2

The engine ranks by a monotone surrogate where smaller is always better, so
one code path serves every metric:

    l2     : ||x||^2 - 2 q.x          (||q||^2 is added back only for reported values)
    dot    : -q.x
    cosine : -q_hat.x_hat             (vectors normalized at ingest)

`precision` names how a product is computed, as on the TPU:
    "highest" (or None)  plain f32;
    "high"               bf16x3: hi = bf16(v), lo = bf16(v - hi), hi*hi + hi*lo + lo*hi;
    "default"            bf16-rounded inputs, f32 products and sums.
The JAX package's None means the backend's default (bf16 on a TPU); here it
means f32, PyTorch's own default with TF32 off. f32 matmuls on the card assume
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

PRECISIONS = ("highest", "high", "default")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _operand_pairs(a: torch.Tensor, b: torch.Tensor, precision: Optional[str]):
    """(a_i, b_i) f32 pairs whose products, summed, give a.b at `precision`."""
    a = a.float()
    b = b.float()
    if precision is None or precision == "highest":
        return [(a, b)]
    if precision == "default":
        return [(_bf16(a), _bf16(b))]
    if precision == "high":
        a_hi, b_hi = _bf16(a), _bf16(b)
        a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
        return [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)]
    raise ValueError(f"precision must be one of {PRECISIONS} or None, got {precision!r}")


def _sum_products(pairs, product):
    out = None
    for a, b in pairs:
        p = product(a, b)
        out = p if out is None else out + p
    return out


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norms along the last axis, computed in f32."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis (cosine metric ingest path)."""
    xf = x.float()
    n = torch.sqrt((xf * xf).sum(dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


def preprocess_corpus(x: torch.Tensor, metric: str, dtype=torch.float32):
    """Returns (stored_vectors, stored_sq_norms) for a corpus under `metric`.

    For cosine the stored vectors are normalized so search is a plain dot
    product. Norms are kept in f32 regardless of storage dtype.
    """
    if metric == "cosine":
        x = normalize(x)
    stored = x.to(dtype)
    norms = sq_norms(stored) if metric == "l2" else x.new_zeros(x.shape[:-1], dtype=torch.float32)
    return stored, norms


def quantize_corpus_global(x: torch.Tensor, metric: str, scale):
    """Per-tensor symmetric int8 quantization with a fixed scale (an f32
    value). Returns (codes int8, sq_norms f32); norms are of the dequantized
    codes, so scores are exact squared distances to the stored points. The
    norms' scale * scale is an f32 product, as in JAX (a host float product
    would round once, in double, and differ by an ulp)."""
    xf = x.float()
    if metric == "cosine":
        xf = normalize(xf)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    if metric == "l2":
        norms = float(np.float32(scale) * np.float32(scale)) * sq_norms(codes.float())
    else:
        norms = xf.new_zeros(xf.shape[:-1])
    return codes, norms


def quantize_corpus(x: torch.Tensor, metric: str, bits: int = 8):
    """Symmetric per-vector integer quantization.

    bits=8 -> int8 codes (levels +-127); bits=16 -> int16 (+-32767).
    Returns (codes [..., D], scales f32 [...], sq_norms f32 [...]).
    Reconstruction: x_i ~= scales_i * codes_i; norms are exact (from f32).
    The scales multiply by f32(1 / lim): every JAX caller is jitted, and XLA
    compiles its `/ lim` so (a division would differ by an ulp on ~1% of
    rows).
    """
    lim, dtype = {8: (127.0, torch.int8), 16: (32767.0, torch.int16)}[bits]
    xf = x.float()
    if metric == "cosine":
        xf = normalize(xf)
    amax = xf.abs().amax(dim=-1)
    scales = torch.clamp(amax, min=1e-12) * (1.0 / lim)
    codes = torch.clamp(torch.round(xf / scales[..., None]), -lim, lim).to(dtype)
    norms = sq_norms(xf) if metric == "l2" else xf.new_zeros(xf.shape[:-1])
    return codes, scales, norms


def preprocess_queries(q: torch.Tensor, metric: str, compute_dtype=torch.float32) -> torch.Tensor:
    if metric == "cosine":
        q = normalize(q)
    return q.to(compute_dtype)


def pairwise_scores(
    q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor, metric: str,
    precision: Optional[str] = None, x_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Surrogate scores between query batch [B, D] and corpus [N, D] -> [B, N].

    Smaller is better for every metric. x_norms doubles as the validity bias:
    +inf rows score +inf, so callers never build a [B, N] mask.
    """
    dots = _sum_products(_operand_pairs(q, x, precision), lambda a, b: a @ b.T)
    if x_scales is not None:  # int8 codes: dequantize the dot product
        dots = dots * x_scales[None, :]
    if metric == "l2":
        return x_norms[None, :] - 2.0 * dots
    return x_norms[None, :] - dots


def gathered_scores(
    q: torch.Tensor, cand_vecs: torch.Tensor, cand_norms: torch.Tensor, metric: str,
    precision: Optional[str] = None, scale=None,
) -> torch.Tensor:
    """Scores between queries [B, D] and per-query candidates [B, C, D] -> [B, C].

    `scale`: per-tensor dequant scalar for int8 candidate codes (x ~= scale*codes);
    applied to the dot products only, norms are stored exact.
    """
    dots = _sum_products(_operand_pairs(q, cand_vecs, precision),
                         lambda a, b: torch.einsum("bd,bcd->bc", a, b))
    if scale is not None:
        dots = dots * scale
    if metric == "l2":
        return cand_norms - 2.0 * dots
    return -dots


def finalize_scores(scores: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """Surrogate scores -> user-facing values: squared L2 distance for l2,
    similarity (higher is better) for dot/cosine."""
    if metric == "l2":
        return scores + sq_norms(q)[..., None]
    return -scores


def brute_force_scores(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Full [B, N] user-facing scores (testing / tiny corpora)."""
    if metric == "cosine":
        q = normalize(q)
        x = normalize(x)
    norms = sq_norms(x) if metric == "l2" else x.new_zeros(x.shape[0], dtype=torch.float32)
    s = pairwise_scores(q.float(), x, norms, metric)
    return finalize_scores(s, q, metric)
