"""zvdb_tpu_torch.ops.block_scan against the Pallas block scorer it replaces.

On the CPU `block_bins` runs its plain PyTorch version; the JAX side runs
zvdb_tpu.ops.pallas_block in interpret mode, which rounds to bf16 exactly as
the TPU does, so all three precisions are compared. Tolerance: bin scores
within 1e-4 absolute (test_pallas_topk.py's), ids equal except where two
columns of a bin tie within that tolerance (checked in f64 on the operands
as the precision rounds them).

The gpu-marked tests need the card and skip without one:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_block_scan.py
There "high" and "default" run on the tensor cores (csrc/block_bins.cu) and
"highest" on the CUDA cores (csrc/flat_scan.cu); both are held against
`block_bins_plain` with scores within 1e-5 of the score scale ("highest",
"high") or 1e-3 ("default"): the kernels sum the same exact products in
another order, and a "high" that dropped its hi.lo and lo.hi products would
fall outside its limit.
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import block_scan as BS
from zvdb_tpu_torch.ops import distance as D

ATOL = 1e-4


def _inputs(cc, b, d, metric, seed, invalid_every=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((cc, b, d)).astype(np.float32)
    vn = (v * v).sum(-1) if metric == "l2" else np.zeros((cc, b), np.float32)
    vn = vn.astype(np.float32)
    if invalid_every:
        vn.reshape(-1)[::invalid_every] = np.inf
    return v, vn


def _jax_bins(v, vn, **kw):
    import jax.numpy as jnp
    from zvdb_tpu.ops.pallas_block import block_bins

    s, i = block_bins(jnp.asarray(v), jnp.asarray(vn), interpret=True, **kw)
    return np.array(s), np.array(i)


def _scores64(v, vn, metric, precision):
    """[cc, B, B] block scores in f64 over the operands as `precision`
    rounds them; self-pairs +inf."""
    vt = torch.from_numpy(v)
    dots = sum(torch.bmm(a.double(), b.double().transpose(1, 2))
               for a, b in D._operand_pairs(vt, vt, precision)).numpy()
    s = vn[:, None, :].astype(np.float64) - (2.0 if metric == "l2" else 1.0) * dots
    idx = np.arange(v.shape[1])
    s[:, idx, idx] = np.inf
    return s


def _assert_bins_agree(v, vn, metric, precision, ts, ti, js, ji):
    assert ts.shape == js.shape and ti.dtype == np.int32
    np.testing.assert_array_equal(ti < 0, ji < 0)
    fin = ji >= 0
    assert np.isinf(ts[~fin]).all()
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=ATOL)
    diff = np.argwhere(ti != ji)
    if diff.size:   # only ties within the tolerance may pick another column
        s = _scores64(v, vn, metric, precision)
        for c, r, l in diff:
            assert abs(s[c, r, ti[c, r, l]] - s[c, r, ji[c, r, l]]) <= ATOL, (c, r, l)
    cols = np.arange(ti.shape[1])[None, :, None]
    assert not (ti == cols).any(), "a row took its own column"
    bins = np.arange(ti.shape[2])[None, None, :]
    assert ((ti % ti.shape[2] == bins) | (ti < 0)).all()


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_bins_match_pallas(precision, metric):
    # cc=3 blocks of B=300 rows (no multiple of bq=128 or of L=64), D=13,
    # invalid slots every 7th
    v, vn = _inputs(3, 300, 13, metric, seed=len(precision) + 3 * len(metric), invalid_every=7)
    ts, ti = (a.numpy() for a in BS.block_bins(torch.from_numpy(v), torch.from_numpy(vn),
                                               l_bins=64, bq=128, metric=metric,
                                               precision=precision))
    js, ji = _jax_bins(v, vn, l_bins=64, bq=128, metric=metric, precision=precision)
    assert ts.shape == (3, 300, 64)
    _assert_bins_agree(v, vn, metric, precision, ts, ti, js, ji)
    invalid = np.isinf(vn)
    for c in range(3):   # invalid slots never win a bin
        assert not np.isin(ti[c], np.flatnonzero(invalid[c])).any()


@pytest.mark.parametrize("precision", ["high", "default"])
def test_single_block_narrower_than_the_bins(precision):
    # cc=1 and B=40 < L=128: bins past the block's width stay +inf / -1
    v, vn = _inputs(1, 40, 16, "l2", seed=5, invalid_every=9)
    ts, ti = (a.numpy() for a in BS.block_bins(torch.from_numpy(v), torch.from_numpy(vn),
                                               l_bins=128, bq=256, precision=precision))
    js, ji = _jax_bins(v, vn, l_bins=128, bq=256, precision=precision)
    _assert_bins_agree(v, vn, "l2", precision, ts, ti, js, ji)
    assert (ti[:, :, 40:] == -1).all() and np.isinf(ts[:, :, 40:]).all()


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tie_goes_to_the_lower_column(precision):
    # rows L..2L-1 repeat rows 0..L-1: for row r every bin l != r holds two
    # equal scores (columns l and l+L) and the lower must win; bin r holds
    # the row's own column (skipped) and its copy r+L
    v, vn = _inputs(2, 32, 8, "l2", seed=4)
    v, vn = np.concatenate([v, v], axis=1), np.concatenate([vn, vn], axis=1)
    _, ti = BS.block_bins(torch.from_numpy(v), torch.from_numpy(vn), l_bins=32, bq=32,
                          precision=precision)
    _, ji = _jax_bins(v, vn, l_bins=32, bq=32, precision=precision)
    want = np.broadcast_to(np.arange(32), (2, 64, 32)).copy()
    r = np.arange(32)
    want[:, r, r] = r + 32
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_array_equal(ji, want)


def test_argument_checks():
    v, vn = (torch.from_numpy(a) for a in _inputs(1, 10, 4, "l2", seed=0))
    with pytest.raises(ValueError):
        BS.block_bins(v, vn, l_bins=128, bq=192)      # bq % l_bins != 0
    with pytest.raises(ValueError):
        BS.block_bins(v, vn, l_bins=32, bq=64, precision="fast")
    with pytest.raises(ValueError):
        BS.block_bins(v, vn, l_bins=32, bq=64, metric="hamming")


def test_cpu_tensors_take_the_plain_version():
    v, vn = (torch.from_numpy(a) for a in _inputs(2, 50, 8, "dot", seed=1))
    before = BS.block_bins.launches
    a = BS.block_bins(v, vn, l_bins=16, bq=32, metric="dot")
    b = BS.block_bins_plain(v, vn, 16, "dot", "high")
    assert BS.block_bins.launches == before
    for u, w in zip(a, b):
        assert torch.equal(u, w)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_tensors_leave_both_counters(precision):
    # the precision route picks a kernel only for CUDA tensors: on the CPU no
    # precision launches anything or moves either counter
    v, vn = (torch.from_numpy(a) for a in _inputs(1, 70, 20, "l2", seed=2, invalid_every=6))
    before = (BS.block_bins.launches, BS.block_bins.launches_mma)
    a = BS.block_bins(v, vn, l_bins=32, bq=64, precision=precision)
    b = BS.block_bins_plain(v, vn, 32, "l2", precision)
    assert (BS.block_bins.launches, BS.block_bins.launches_mma) == before
    for u, w in zip(a, b):
        assert torch.equal(u, w)


def _tolerance(precision, scale):
    """Kernel-against-plain score tolerance: f32 sum-order error, 1e-5 of the
    score scale, where the kernel sums the same exact f32 products ("highest")
    or bf16 products ("high") in another order; 1e-3 for "default"."""
    return (1e-3 if precision == "default" else 1e-5) * scale


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_high_tolerance_rejects_the_single_product(metric):
    # "high" without its hi.lo and lo.hi products is "default": the "high"
    # limit must not let that pass
    v, vn = (torch.from_numpy(a) for a in _inputs(2, 300, 128, metric, seed=8, invalid_every=7))
    hs, hi = BS.block_bins_plain(v, vn, 64, metric, "high")
    ds, _ = BS.block_bins_plain(v, vn, 64, metric, "default")
    fin = hi >= 0
    scale = float(hs[fin].abs().max())
    assert float((ds - hs).abs()[fin].max()) > 10 * _tolerance("high", scale)


def _check_against_plain(v, vn, l_bins, metric, precision, ks, ki, ps, pi):
    """Bins of the kernel (ks, ki) against the plain version's (ps, pi): the
    same empty bins, scores within `_tolerance` of the score scale, every id
    in its bin and never the row's own column, and each chosen column's
    score, recomputed in f64 over the rounded operands, within the same
    tolerance of the bin minimum the kernel reports."""
    b = v.shape[1]
    fin = pi >= 0
    assert torch.equal(ki >= 0, fin)
    assert bool(torch.isinf(ks[~fin]).all())
    tol = _tolerance(precision, float(ps[fin].abs().max()))
    assert float((ks - ps).abs()[fin].max()) <= tol
    ids = ki.long()
    bins = torch.arange(l_bins, device=ki.device)
    assert bool(((ids % l_bins) == bins)[fin].all())
    assert not bool((ids == torch.arange(b, device=ki.device)[None, :, None]).any())
    dots = sum(torch.bmm(x.double(), y.double().transpose(1, 2))
               for x, y in D._operand_pairs(v, v, precision))
    s64 = vn.double()[:, None, :] - (2.0 if metric == "l2" else 1.0) * dots
    chosen = torch.gather(s64, 2, ids.clamp(min=0))
    assert float((chosen - ks.double()).abs()[fin].max()) <= tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (cc, B, D, L, metric, invalid_every)
GPU_SHAPES = [
    (3, 700, 40, 128, "l2", 7),       # B no multiple of 64, invalid slots
    (2, 700, 130, 64, "l2", 5),       # D no multiple of 16 (nor of 4), L=64
    (2, 333, 40, 64, "dot", 4),       # dot (factor 1), L=64
    (1, 40, 16, 128, "l2", 9),        # B < L: empty bins
    (1, 300, 300, 64, "l2", 0),       # D past one shared-memory chunk (two chunks)
    (12, 1640, 128, 128, "l2", 11),   # the graph build's shape
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision, shape):
    cc, b, d, l_bins, metric, inv = shape
    v, vn = _inputs(cc, b, d, metric, seed=b + d, invalid_every=inv)
    v, vn = torch.from_numpy(v).to(cuda_device), torch.from_numpy(vn).to(cuda_device)
    before, before_mma = BS.block_bins.launches, BS.block_bins.launches_mma
    ks, ki = BS.block_bins(v, vn, l_bins=l_bins, bq=2 * l_bins, metric=metric,
                           precision=precision)
    ps, pi = BS.block_bins_plain(v, vn, l_bins, metric, precision)
    torch.cuda.synchronize()
    assert BS.block_bins.launches == before + 1
    # the tensor cores take "high" and "default", the CUDA cores "highest"
    assert BS.block_bins.launches_mma == before_mma + (precision != "highest")
    _check_against_plain(v, vn, l_bins, metric, precision, ks, ki, ps, pi)
    if precision == "default":   # one bf16 product stays outside the "high" limit
        hs, hi = BS.block_bins_plain(v, vn, l_bins, metric, "high")
        fin = hi >= 0
        assert float((ks - hs).abs()[fin].max()) > _tolerance("high", float(hs[fin].abs().max()))
    if b < l_bins:
        assert bool((ki[:, :, b:] == -1).all()) and bool(torch.isinf(ks[:, :, b:]).all())
        return
    # duplicated rows tie in every bin: the lower column wins, and bin r of
    # row r takes the copy r + L of its own (skipped) column
    vd = torch.cat([v[:, :l_bins], v[:, :l_bins]], dim=1)
    nd = torch.where(torch.isinf(vn[:, :l_bins]), 0.0, vn[:, :l_bins])
    _, di = BS.block_bins(vd, torch.cat([nd, nd], 1), l_bins=l_bins, bq=2 * l_bins,
                          metric=metric, precision=precision)
    want = torch.arange(l_bins, device=cuda_device, dtype=torch.int32)
    want = want.expand(cc, 2 * l_bins, l_bins).clone()
    r = torch.arange(l_bins, device=cuda_device)
    want[:, r, r] = r.int() + l_bins
    assert torch.equal(di, want)
