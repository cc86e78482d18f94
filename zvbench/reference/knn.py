"""The plain reference: exact k-nearest neighbours under squared L2.

Plain PyTorch in blocks, so that it fits beside the corpus: scores are
||x||^2 - 2 q.x in float32 with TF32 off, the k smallest per row by
torch.topk. `precision="tf32"` rounds both operands to TF32 (10 mantissa
bits, round to nearest even) and `"bf16"` to bfloat16 (7 bits) before the
same float32 product: what the card's TF32 or bf16 tensor cores compute, on
any device. Those are the controls, the reference one precision step below
what a configuration states (its file's "control"): TF32 below plain float32,
bf16 below the bf16x3 split ("high"). Imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import torch

PRECISIONS = ("float32", "tf32", "bf16")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept as float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    return tf32_round(x) if precision == "tf32" else x.float()


def no_tf32() -> None:
    """Plain float32 products on the card (PyTorch's default, made sure)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int, precision: str = "float32",
              block: int = 1024, exclude_self: Optional[torch.Tensor] = None):
    """(squared distances [B, k] f32, ids [B, k] int64) of q's k nearest
    rows of x, nearest first. exclude_self: [B] row ids that row b of q may
    not return (a graph's own row)."""
    no_tf32()
    xo = _operand(x, precision)
    xn = (xo * xo).sum(1)
    out_d, out_i = [], []
    for lo in range(0, q.shape[0], block):
        qo = _operand(q[lo:lo + block], precision)
        s = xn[None, :] - 2.0 * (qo @ xo.T)
        if exclude_self is not None:
            s[torch.arange(s.shape[0], device=s.device), exclude_self[lo:lo + block]] = float("inf")
        d, i = torch.topk(s, k, dim=1, largest=False)
        out_d.append(d + (qo * qo).sum(1, keepdim=True))
        out_i.append(i)
        del s
    return torch.cat(out_d), torch.cat(out_i)


def pair_distances(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """||q_b - x_ids[b, j]||^2 in float64, [B, J]; ids must lie in [0, N)."""
    diff = q[:, None, :].double() - x[ids.long()].double()
    return (diff * diff).sum(-1)


class ExactIndex:
    """The reference in the program's place (the control): `build` keeps the
    rows, `search` is the exact scan at `precision`, and `graph_edges` gives
    a row's exact nearest other rows, as a graph build's edges would be."""

    def __init__(self, precision: str = "tf32", device=None):
        self.precision = precision
        self.device = device
        self.x: Optional[torch.Tensor] = None

    def build(self, x) -> None:
        self.x = torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def search(self, q, k: int, **_unused):
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        d, i = exact_knn(self.x, q, k, self.precision)
        return d, i.to(torch.int32)

    def graph_edges(self, rows: torch.Tensor, degree: int):
        d, i = exact_knn(self.x, self.x[rows.long()], degree, self.precision,
                         exclude_self=rows.long())
        return i.to(torch.int32), d
