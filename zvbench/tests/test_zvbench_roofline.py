"""The byte bound of kernel H at its eight site operands, as PERF.md's table
of kernels gives them (ms)."""
import pytest

from zvbench.roofline.approx_min_k import bound_s

SITES = [  # (shape, k, bound ms)
    ((10000, 100000), 10, 1.194), ((2048, 500000), 40, 1.223),
    ((2048, 250000), 10, 0.6114), ((2048, 250000), 16, 0.6115),
    ((2048, 4096), 8, 0.0101), ((4096, 2456), 10, 0.0122),
    ((12, 1640, 1640), 16, 0.0397), ((2048, 16384), 120, 0.0409),
]


@pytest.mark.parametrize("shape,k,ms", SITES)
def test_bound_of_each_site(shape, k, ms):
    numel = 1
    for d in shape:
        numel *= d
    got = bound_s(numel, numel // shape[-1], k) * 1e3
    assert round(got, 4 if ms < 1 else 3) == ms
