"""zvdb_tpu_torch.ops.flat_scan against the Pallas kernel it replaces.

On the CPU `flat_scan_bins` runs its plain PyTorch version; the JAX side runs
zvdb_tpu.ops.pallas_topk in interpret mode, which rounds to bf16 exactly as
the TPU does, so all three precisions are compared. Tolerance: ids exact,
bin scores rtol 1e-5 / atol 1e-4 (other summation orders).

`test_kernel_matches_plain_on_gpu` needs the card and skips without one. The
JAX side is imported inside the tests that use it, so that the card test also
runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_flat_scan.py
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import flat_scan as FT

TOL = dict(rtol=1e-5, atol=1e-4)


def _inputs(b, n, d, metric, seed, invalid_every=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    norms = (x * x).sum(1) if metric == "l2" else np.zeros(n, np.float32)
    if invalid_every:
        norms[::invalid_every] = np.inf
    return q, x, norms.astype(np.float32)


def _pallas():
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_topk

    return jnp, pallas_topk


def _run_both(fn_t, name_j, q, x, norms, **kw):
    jnp, pj = _pallas()
    t = fn_t(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms), **kw)
    j = getattr(pj, name_j)(jnp.asarray(q), jnp.asarray(x), jnp.asarray(norms),
                            interpret=True, **kw)
    return [a.numpy() for a in t], [np.array(a) for a in j]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_bins_match_pallas(precision, metric):
    # N=450 is no multiple of L=32 or of chunk=64; B=13 no multiple of 8; D=13 odd
    q, x, norms = _inputs(13, 450, 13, metric, seed=len(precision) + len(metric),
                          invalid_every=7)
    (ts, ti), (js, ji) = _run_both(FT.flat_scan_bins, "flat_scan_bins", q, x, norms,
                                   l_bins=32, chunk=64, bq_tile=8, metric=metric,
                                   precision=precision)
    assert ts.shape == (13, 32) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)
    assert not np.isin(ti, np.arange(0, 450, 7)).any()   # invalid rows never win


@pytest.mark.parametrize("b", [1, 9])
def test_bins_with_empty_bins_and_single_query(b):
    # N < L: some bins see no row and must come back +inf / -1
    q, x, norms = _inputs(b, 40, 16, "l2", seed=b, invalid_every=5)
    (ts, ti), (js, ji) = _run_both(FT.flat_scan_bins, "flat_scan_bins", q, x, norms,
                                   l_bins=64, chunk=64, bq_tile=8, precision="high")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ti[:, 40:] == -1).all() and np.isinf(ts[:, 40:]).all()


def test_bins_bf16_storage():
    jnp, pj = _pallas()
    q, x, norms = _inputs(10, 300, 24, "l2", seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    nb = (xb.float() ** 2).sum(1)
    ts, ti = FT.flat_scan_bins(torch.from_numpy(q), xb, nb, l_bins=32, chunk=64,
                               precision="default")
    js, ji = pj.flat_scan_bins(jnp.asarray(q), jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(nb.numpy()), l_bins=32, chunk=64, bq_tile=8,
                               precision="default", interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.array(ji))
    np.testing.assert_allclose(ts.numpy(), np.array(js), **TOL)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_tie_goes_to_the_lower_row(precision):
    # rows L..2L-1 repeat rows 0..L-1: every bin sees two equal scores, and
    # the strict < of the fold keeps the lower row, as the Pallas kernel does
    q, x, norms = _inputs(5, 32, 8, "l2", seed=4)
    x, norms = np.concatenate([x, x]), np.concatenate([norms, norms])
    (ts, ti), (js, ji) = _run_both(FT.flat_scan_bins, "flat_scan_bins", q, x, norms,
                                   l_bins=32, chunk=32, bq_tile=8, precision=precision)
    np.testing.assert_array_equal(ti, np.broadcast_to(np.arange(32), ti.shape))
    np.testing.assert_array_equal(ji, ti)


@pytest.mark.parametrize("k", [5, 40])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_topk_matches_pallas(k, precision):
    # k=40 > L=32: trailing slots pad with +inf / -1
    q, x, norms = _inputs(11, 500, 13, "dot", seed=k, invalid_every=11)
    (ts, ti), (js, ji) = _run_both(FT.flat_scan_topk, "flat_scan_topk", q, x, norms, k=k,
                                   l_bins=32, chunk=96, bq_tile=8, metric="dot",
                                   precision=precision)
    assert ts.shape == (11, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)
    if k > 32:
        assert (ti[:, 32:] == -1).all() and np.isinf(ts[:, 32:]).all()


def test_exact_when_bins_cover_corpus():
    # N <= L: each bin holds one row, so the top-k is the exact top-k
    q, x, norms = _inputs(7, 50, 17, "l2", seed=0)
    s, ids = FT.flat_scan_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
                               k=5, l_bins=64, chunk=64, bq_tile=8, precision="highest")
    ref = norms[None, :] - 2.0 * (q.astype(np.float64) @ x.T.astype(np.float64))
    np.testing.assert_array_equal(ids.numpy(), np.argsort(ref, axis=1, kind="stable")[:, :5])


def test_argument_checks():
    q, x, norms = (torch.from_numpy(a) for a in _inputs(2, 10, 4, "l2", seed=0))
    with pytest.raises(ValueError):
        FT.flat_scan_bins(q, x, norms, l_bins=32, chunk=48)    # chunk % l_bins != 0
    with pytest.raises(ValueError):
        FT.flat_scan_bins(q, x, norms, l_bins=0, chunk=0)
    with pytest.raises(ValueError):
        FT.flat_scan_bins(q, x, norms, l_bins=8, chunk=8, precision="fast")


def test_cpu_tensors_take_the_plain_version():
    q, x, norms = (torch.from_numpy(a) for a in _inputs(3, 100, 8, "l2", seed=1))
    before = FT.flat_scan_bins.launches
    a = FT.flat_scan_bins(q, x, norms, l_bins=16, chunk=16)
    b = FT._flat_scan_bins_plain(q, x, norms, 16, "l2", "high")
    assert FT.flat_scan_bins.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision):
    q, x, norms = _inputs(70, 5000, 13, "l2", seed=9, invalid_every=7)
    q, x, norms = (torch.from_numpy(a).to(cuda_device) for a in (q, x, norms))
    before = FT.flat_scan_bins.launches
    ks, ki = FT.flat_scan_bins(q, x, norms, l_bins=128, chunk=128, precision=precision)
    ps, pi = FT._flat_scan_bins_plain(q, x, norms, 128, "l2", precision)
    torch.cuda.synchronize()
    assert FT.flat_scan_bins.launches == before + 1
    fin = pi >= 0
    assert torch.equal(ki >= 0, fin)
    assert bool(((ki.long() % 128) == torch.arange(128, device=cuda_device))[fin].all())
    scale = float(ps[fin].abs().max())
    tol = 1e-5 * scale if precision == "highest" else 1e-3 * scale
    assert float((ks - ps).abs()[fin].max()) <= tol
    # duplicated rows tie in every bin: the lower row wins
    xd, nd = torch.cat([x[:128], x[:128]]), torch.cat([norms[:128], norms[:128]])
    _, di = FT.flat_scan_bins(q, xd, nd, l_bins=128, chunk=128, precision=precision)
    valid = torch.isfinite(nd[:128])
    assert torch.equal(di[:, valid], torch.arange(128, device=cuda_device)[valid].int().expand(70, -1))
