"""zvdb_tpu_torch.ops.block_scan against the Pallas block scorer it replaces.

On the CPU `block_bins` runs its plain PyTorch version; the JAX side runs
zvdb_tpu.ops.pallas_block in interpret mode, which rounds to bf16 exactly as
the TPU does, so all three precisions are compared. Tolerance: bin scores
within 1e-4 absolute (test_pallas_topk.py's), ids equal except where two
columns of a bin tie within that tolerance (checked in f64 on the operands
as the precision rounds them).

`test_kernel_matches_plain_on_gpu` needs the card and skips without one:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_block_scan.py
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision):
    v, vn = _inputs(3, 700, 40, "l2", seed=9, invalid_every=7)
    v, vn = torch.from_numpy(v).to(cuda_device), torch.from_numpy(vn).to(cuda_device)
    before = BS.block_bins.launches
    ks, ki = BS.block_bins(v, vn, l_bins=128, bq=256, precision=precision)
    ps, pi = BS.block_bins_plain(v, vn, 128, "l2", precision)
    torch.cuda.synchronize()
    assert BS.block_bins.launches == before + 1
    fin = pi >= 0
    assert torch.equal(ki >= 0, fin)
    assert bool(((ki.long() % 128) == torch.arange(128, device=cuda_device))[fin].all())
    assert not bool((ki.long() == torch.arange(700, device=cuda_device)[None, :, None]).any())
    scale = float(ps[fin].abs().max())
    tol = 1e-5 * scale if precision == "highest" else 1e-3 * scale
    assert float((ks - ps).abs()[fin].max()) <= tol
    # duplicated rows tie in every bin: the lower column wins
    vd, nd = torch.cat([v[:, :128], v[:, :128]], dim=1), torch.cat([vn[:, :128], vn[:, :128]], 1)
    nd = torch.where(torch.isinf(nd), 0.0, nd)
    _, di = BS.block_bins(vd, nd, l_bins=128, bq=256, precision=precision)
    want = torch.arange(128, device=cuda_device, dtype=torch.int32).expand(3, 256, 128).clone()
    r = torch.arange(128, device=cuda_device)
    want[:, r, r] = r.int() + 128
    assert torch.equal(di, want)
