"""Product quantization (PQ): train / encode / decode (port of
zvdb_tpu/ops/pq.py).

PQ splits a vector into n_sub subspaces of dsub = D / n_sub coordinates and
stores, per subspace, the index of the nearest of n_codes centroids: n_sub
bytes per vector, or n_sub/2 when 16 codewords let two codes share a byte.
Scoring is asymmetric (ADC): exact f32 queries against decoded corpus rows,
or, in the fused scan, a per-query table of q_s . centroid sums.

Every float product here is plain f32; on the card that assumes
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default), which
is what the JAX package's Precision.HIGHEST asks for.

Training draws from an explicit torch.Generator. It cannot reproduce the JAX
package's PRNG, so the two packages train different codebooks from the same
seed; state_from_numpy (index/pqflat.py) carries trained state across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def train_codebooks(xs: torch.Tensor, gen: torch.Generator, n_sub: int, n_codes: int,
                    iters: int) -> torch.Tensor:
    """Per-subspace k-means codebooks from a training sample.

    xs: [m, D] f32 sample (already metric-preprocessed: normalized for
    cosine). Returns codebooks [n_sub, n_codes, D // n_sub] f32.

    Each subspace draws its own initial centroids (without replacement
    unless m < n_codes). All subspaces run one batched Lloyd loop: the
    assignment is a distance product + argmin (first minimum on a tie), the
    update onehot^T @ x (deterministic, no atomics). Empty clusters keep
    their previous centroid."""
    m, d = xs.shape
    dsub = d // n_sub
    x_s = xs.float().reshape(m, n_sub, dsub).transpose(0, 1)      # [S, m, dsub]
    if m < n_codes:
        sel = torch.randint(0, m, (n_sub, n_codes), generator=gen)
    else:
        sel = torch.stack([torch.randperm(m, generator=gen)[:n_codes] for _ in range(n_sub)])
    sel = sel.to(xs.device)
    cent = torch.gather(x_s, 1, sel[:, :, None].expand(-1, -1, dsub))   # [S, C, dsub]
    for _ in range(iters):
        cn = (cent * cent).sum(-1)                                     # [S, C]
        dots = torch.bmm(x_s, cent.transpose(1, 2))                    # [S, m, C]
        a = torch.argmin(cn[:, None, :] - 2.0 * dots, dim=-1)          # [S, m]
        oh = F.one_hot(a, n_codes).float()                             # [S, m, C]
        sums = torch.bmm(oh.transpose(1, 2), x_s)                      # [S, C, dsub]
        cnt = oh.sum(1)                                                # [S, C]
        new = sums / cnt.clamp(min=1.0)[..., None]
        cent = torch.where((cnt > 0)[..., None], new, cent)
    return cent.contiguous()


def train_opq(xs: torch.Tensor, gen: torch.Generator, n_sub: int, n_codes: int,
              iters: int, opq_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimized PQ: an orthogonal rotation R that lowers the quantization
    error, by alternating Lloyd codebook updates with an orthogonal
    Procrustes solve. Returns (rot [D, D] f32, codebooks quantizing x @ rot).

    The rotation starts as the Q of a Gaussian matrix's QR. Every
    alternation retrains its codebooks from the same initial draw (4 Lloyd
    iterations); the final codebooks get the full `iters`."""
    m, d = xs.shape
    xs = xs.float()
    g = torch.randn((d, d), generator=gen).to(xs.device)
    cb_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    rot = torch.linalg.qr(g).Q
    for _ in range(opq_iters):
        xr = xs @ rot
        cb = train_codebooks(xr, _seeded(cb_seed), n_sub, n_codes, iters=4)
        xhat = decode(encode(xr, cb), cb)
        # argmin over orthogonal R of ||X R - Xhat||_F is U V^T, X^T Xhat = U S V^T
        u, _, vt = torch.linalg.svd(xs.T @ xhat, full_matrices=False)
        rot = u @ vt
    return rot, train_codebooks(xs @ rot, _seeded(cb_seed), n_sub, n_codes, iters)


def apply_rotation(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x @ rot, or x itself for the empty [0, 0] rotation of plain PQ."""
    if rot.shape[0] == 0:
        return x
    return x @ rot


def encode(x: torch.Tensor, codebooks: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Nearest centroid per subspace (first minimum on a tie): [B, D] f32 ->
    [B, S] uint8. Tiled so the [chunk, S, C] distance block stays bounded."""
    b = x.shape[0]
    n_sub, _, dsub = codebooks.shape
    cn = (codebooks * codebooks).sum(-1)                               # [S, C]
    out = torch.empty((b, n_sub), dtype=torch.uint8, device=x.device)
    for lo in range(0, b, chunk):
        xt = x[lo:lo + chunk].float().reshape(-1, n_sub, dsub)
        dots = torch.einsum("tsd,scd->tsc", xt, codebooks)
        out[lo:lo + chunk] = torch.argmin(cn[None] - 2.0 * dots, dim=-1).to(torch.uint8)
    return out


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct rows: [T, S] uint8 codes -> [T, D] f32. A gather of the
    codewords, which is what the JAX package's one-hot product computes
    exactly (one nonzero term per output)."""
    n_sub = codebooks.shape[0]
    sub = torch.arange(n_sub, device=codes.device)
    return codebooks[sub[None, :], codes.long()].reshape(codes.shape[0], -1)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[B, S] uint8 codes (< 16) -> [B, S//2] bytes: byte j holds subspace
    2j in the low nibble and 2j+1 in the high nibble."""
    lo = codes[:, 0::2].to(torch.uint8)
    hi = codes[:, 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor, n_sub: int) -> torch.Tensor:
    """[B, S//2] packed bytes -> [B, S] uint8 codes (inverse of pack_nibbles)."""
    out = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return out.reshape(*packed.shape[:-1], n_sub)


def adc_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query ADC table: [B, D] queries (rotated for OPQ) x [S, C, dsub]
    codebooks -> [B, S, C] f32 with lut[b, s, c] = q_s[b] . codebook[s, c]."""
    b = q.shape[0]
    n_sub, _, dsub = codebooks.shape
    return torch.einsum("bsd,scd->bsc", q.float().reshape(b, n_sub, dsub), codebooks)


def decoded_sq_norms(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """||decode(codes)||^2 per row: [B, S] -> [B] f32, as a sum of
    per-subspace squared codeword norms (subspaces are disjoint)."""
    cn = (codebooks * codebooks).sum(-1)                               # [S, C]
    sub = torch.arange(codebooks.shape[0], device=codes.device)
    return cn[sub[None, :], codes.long()].sum(-1)
