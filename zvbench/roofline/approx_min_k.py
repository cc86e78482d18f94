"""The byte bound of one call of kernel H (approx_min_k, the binned partial
top-k): its float32 operand read once and its k (value, position) pairs a
row written once, 4 + 8 bytes each, at the H100 SXM's 3.35 TB/s. The
kernel's operations are a compare a column, far below the bytes' time, so
the bytes bound it."""
from __future__ import annotations

HBM_BYTES_S = 3.35e12   # NVIDIA H100 SXM data sheet, device memory rate


def bound_s(numel: int, rows: int, k: int) -> float:
    """Least seconds a call over an operand of `numel` f32 values in `rows`
    rows, returning k pairs a row, can take."""
    return (numel * 4 + rows * k * 12) / HBM_BYTES_S
