"""zvdb_tpu_torch.ops.flat_scan against the Pallas kernel it replaces.

On the CPU `flat_scan_bins` runs its plain PyTorch version; the JAX side runs
zvdb_tpu.ops.pallas_topk in interpret mode, which rounds to bf16 exactly as
the TPU does, so all three precisions are compared. Tolerance: ids exact,
bin scores rtol 1e-5 / atol 1e-4 (other summation orders).

The gpu-marked tests need the card and skip without one: on a CUDA tensor
"default" and "high" run on the tensor cores (csrc/flat_scan_mma.cu),
"highest" on the CUDA cores (csrc/flat_scan.cu). The JAX side is imported
inside the tests that use it, so that the card tests also run where JAX is
absent:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_flat_scan.py
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import distance as D
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


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_tensors_leave_both_counters(precision):
    # the precision route picks a kernel only for CUDA tensors: on the CPU no
    # precision reaches an entry point or moves either counter
    q, x, norms = (torch.from_numpy(a) for a in _inputs(4, 130, 20, "l2", seed=2,
                                                       invalid_every=6))
    before = (FT.flat_scan_bins.launches, FT.flat_scan_bins.launches_mma)
    a = FT.flat_scan_bins(q, x, norms, l_bins=32, chunk=64, precision=precision)
    b = FT._flat_scan_bins_plain(q, x, norms, 32, "l2", precision)
    assert (FT.flat_scan_bins.launches, FT.flat_scan_bins.launches_mma) == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("precision,route", [("highest", "cuda cores"), ("high", "tensor cores"),
                                             ("default", "tensor cores")])
def test_precision_picks_the_entry_point(monkeypatch, precision, route):
    # f32 products ("highest") cannot use the bf16 tensor cores
    monkeypatch.setattr(FT, "build", lambda: "cuda cores")
    monkeypatch.setattr(FT, "build_mma", lambda: "tensor cores")
    assert FT._entry_point(precision)() == route


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
    before, before_mma = FT.flat_scan_bins.launches, FT.flat_scan_bins.launches_mma
    ks, ki = FT.flat_scan_bins(q, x, norms, l_bins=128, chunk=128, precision=precision)
    ps, pi = FT._flat_scan_bins_plain(q, x, norms, 128, "l2", precision)
    torch.cuda.synchronize()
    assert FT.flat_scan_bins.launches == before + 1
    assert FT.flat_scan_bins.launches_mma == before_mma + (precision != "highest")
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


def _check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi):
    """Kernel bins (ks, ki) against reference bins (ps, pi) that sum the same
    exact products in another order: the same empty bins (+inf, -1), scores
    within 1e-5 ("high") or 1e-3 ("default") of the score scale, every id in
    its bin and naming a valid row, and each chosen row's score, recomputed
    in f64 over the rounded operands, within the same tolerance of the bin
    minimum the kernel reports."""
    fin = pi >= 0
    assert torch.equal(ki >= 0, fin)
    assert bool(torch.isinf(ks[~fin]).all())
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0
    tol = (1e-5 if precision == "high" else 1e-3) * scale
    assert float((ks - ps).abs()[fin].max()) <= tol
    ids = ki.long()
    bins = torch.arange(l_bins, device=ki.device).expand_as(ids)
    assert bool(((ids % l_bins) == bins)[fin].all())
    assert bool(torch.isfinite(norms[ids[fin]]).all())
    rows = x[ids.clamp(min=0)]
    dots = sum((a.double()[:, None, :] * r.double()).sum(-1)
               for a, r in D._operand_pairs(q, rows, precision))
    s64 = norms[ids.clamp(min=0)].double() - (2.0 if metric == "l2" else 1.0) * dots
    assert float((s64 - ks.double()).abs()[fin].max()) <= tol


# (B, N, D, L, metric, storage, invalid_every)
MMA_SHAPES = [
    (37, 5000, 13, 128, "l2", "float32", 7),        # ragged B and D (D < 16)
    (1, 3001, 128, 1024, "cosine", "float32", 0),   # one query, B < the query tile
    (8, 2048, 33, 2048, "dot", "float32", 5),       # N < L: empty bins
    (70, 4099, 128, 100, "l2", "bfloat16", 5),      # bf16 storage, L no multiple of 64
    (70, 4099, 36, 100, "dot", "bfloat16", 0),      # bf16 rows not in 16-byte pieces
    (300, 3000, 300, 64, "l2", "float32", 9),       # D past one shared-memory chunk
    (257, 20000, 128, 96, "l2", "float32", 11),     # one query past a 256-query tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MMA_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["high", "default"])
def test_mma_matches_plain_and_cuda_cores_on_gpu(cuda_device, precision, shape):
    b, n, d, l_bins, metric, storage, inv = shape
    q, x, norms = _inputs(b, n, d, metric, seed=b + d, invalid_every=inv)
    q, x = (torch.from_numpy(a).to(cuda_device) for a in (q, x))
    x = x.to(getattr(torch, storage))
    norms = torch.from_numpy(norms).to(cuda_device)
    before, before_mma = FT.flat_scan_bins.launches, FT.flat_scan_bins.launches_mma
    ks, ki = FT.flat_scan_bins(q, x, norms, l_bins=l_bins, chunk=l_bins, metric=metric,
                               precision=precision)
    ps, pi = FT._flat_scan_bins_plain(q, x, norms, l_bins, metric, precision)
    cs, ci = FT.launch(FT.build(), q, x, norms, l_bins, metric, precision)
    torch.cuda.synchronize()
    assert (FT.flat_scan_bins.launches, FT.flat_scan_bins.launches_mma) == (before + 1,
                                                                            before_mma + 1)
    _check_bins(q, x, norms, l_bins, metric, precision, ks, ki, ps, pi)
    _check_bins(q, x, norms, l_bins, metric, precision, ks, ki, cs, ci)
    if n < l_bins:
        assert bool((ki[:, n:] == -1).all()) and bool(torch.isinf(ks[:, n:]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_mma_tie_goes_to_the_lower_row_on_gpu(cuda_device, precision, storage):
    # rows L..2L-1 repeat rows 0..L-1 (L = 96, no multiple of the 64-bin
    # slice), so every bin holds two equal scores: the lower row must win
    q, x, _ = _inputs(70, 96, 40, "l2", seed=6)
    q = torch.from_numpy(q).to(cuda_device)
    x = torch.from_numpy(np.concatenate([x, x])).to(cuda_device).to(getattr(torch, storage))
    _, ki = FT.flat_scan_bins(q, x, D.sq_norms(x), l_bins=96, chunk=96, precision=precision)
    assert torch.equal(ki, torch.arange(96, device=cuda_device, dtype=torch.int32).expand(70, -1))
