"""zvdb_tpu_torch.ops.scan_topk against the two Pallas exact scans it replaces
(examples/pallas_scan_v1.py:flat_topk_pallas, kernel E, and
examples/pallas_scan_v2.py:flat_topk_pallas2, kernel F).

On the CPU both entry points run `_flat_topk_plain`; the JAX side runs the
example kernels in interpret mode (f32 dots), loaded by path as
tests/test_pallas_scan.py loads them. Ids must be equal id for id, in slot
order. Scores within rtol 1e-5, atol 1e-4: the f32 dot sums in another order.

The `gpu`-marked tests need the card and skip without one:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_scan_topk.py
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import scan_topk as ST

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load(name, fname):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_EX, fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_both(q, x, k, **kw):
    """JAX's E and F in interpret mode; asserts they agree (one contract)."""
    import jax.numpy as jnp

    e = _load("pallas_scan_v1", "pallas_scan_v1.py").flat_topk_pallas
    f = _load("pallas_scan_v2", "pallas_scan_v2.py").flat_topk_pallas2
    es, ei = (np.asarray(a) for a in e(jnp.asarray(q), jnp.asarray(x), k, interpret=True, **kw))
    fs, fi = (np.asarray(a) for a in f(jnp.asarray(q), jnp.asarray(x), k, interpret=True, **kw))
    np.testing.assert_array_equal(ei, fi)
    np.testing.assert_array_equal(es, fs)
    return es, ei


def _inputs(n, d, b, seed, dup=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dup:   # rows 300 .. 300+dup-2 repeat row 0, and query 0 is row 0
        x[300:300 + dup - 1] = x[0]
        q[0] = x[0]
    return q, x


def _assert_same(ts, ti, js, ji):
    assert ts.shape == js.shape and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-4)


CASES = [
    # (n, d, b, k, metric, chunk)
    (3000, 32, 64, 10, "l2", 512),
    (3000, 32, 64, 10, "l2", 256),
    (3000, 32, 64, 10, "dot", 512),
    (3000, 32, 64, 10, "dot", 256),
    (2777, 32, 61, 10, "l2", 256),     # ragged N and ragged B
    (3000, 32, 64, 1, "l2", 512),      # k = 1
    (7, 32, 64, 10, "l2", 256),        # N < k: slots past N stay +inf / -1
    (40, 32, 16, 10, "dot", 8),        # k > chunk: the extra rounds take nothing
]


@pytest.mark.parametrize("n,d,b,k,metric,chunk", CASES)
def test_plain_matches_pallas(n, d, b, k, metric, chunk):
    q, x = _inputs(n, d, b, seed=n + b + k + chunk)
    js, ji = _jax_both(q, x, k, metric=metric, q_tile=32, chunk=chunk)
    for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2):
        ts, ti = fn(torch.from_numpy(q), torch.from_numpy(x), k, metric=metric, q_tile=32,
                    chunk=chunk)
        _assert_same(ts, ti, js, ji)
    if n < k:
        assert (ji[:, n:] == -1).all() and np.isinf(js[:, n:]).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ties_match_pallas(metric):
    # 40 equal rows (row 0 and rows 300..338): the first argmin takes the
    # lower row, the first argmax slot is replaced, and an equal score is
    # never taken, so query 0 (= row 0) ends with [0, 308, 307, ..., 300]
    q, x = _inputs(1000, 16, 32, seed=11, dup=40)
    js, ji = _jax_both(q, x, 10, metric=metric, q_tile=32, chunk=256)
    ts, ti = ST.flat_topk_pallas(torch.from_numpy(q), torch.from_numpy(x), 10, metric=metric,
                                 q_tile=32, chunk=256)
    _assert_same(ts, ti, js, ji)
    if metric == "l2":
        assert ti[0].tolist() == [0, 308, 307, 306, 305, 304, 303, 302, 301, 300]


def test_q_tile_changes_nothing_and_chunk_only_the_order():
    q, x = _inputs(1500, 8, 20, seed=3)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    s1, i1 = ST.flat_topk_pallas(qt, xt, 10, q_tile=8, chunk=128)
    s2, i2 = ST.flat_topk_pallas(qt, xt, 10, q_tile=256, chunk=128)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    _, i3 = ST.flat_topk_pallas(qt, xt, 10, chunk=1024)
    assert torch.equal(torch.sort(i1, 1).values, torch.sort(i3, 1).values)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.sort(np.argsort(d2, axis=1, kind="stable")[:, :10], 1)
    np.testing.assert_array_equal(torch.sort(i1, 1).values.numpy(), gt)


def test_argument_checks_and_cpu_path():
    q, x = (torch.from_numpy(a) for a in _inputs(50, 4, 3, seed=0))
    with pytest.raises(ValueError):
        ST.flat_topk_pallas(q, x, 0)
    with pytest.raises(ValueError):
        ST.flat_topk_pallas2(q, x, 5, chunk=0)
    before = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches)
    a = ST.flat_topk_pallas(q, x, 5, chunk=16)
    b = ST._flat_topk_plain(q, x, 5, chunk=16)
    assert (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches) == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tie_aware(q, x, metric, ks, ki, ps, pi):
    """Kernel against plain: equal where both are empty; elsewhere scores
    within 1e-5 of the score scale and every differing id a near-tie in f64."""
    assert torch.equal(ki < 0, pi < 0)
    fin = pi >= 0
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0
    tol = 1e-5 * scale + 1e-5
    assert float((ks - ps).abs()[fin].max()) <= tol if bool(fin.any()) else True
    bad = fin & (ki != pi)
    if bool(bad.any()):
        xd, qd = x.double(), q.double()
        f = 2.0 if metric == "l2" else 1.0
        nrm = (xd * xd).sum(1) if metric == "l2" else torch.zeros_like(xd[:, 0])
        r, c = torch.nonzero(bad, as_tuple=True)
        sk = nrm[ki[r, c].long()] - f * (qd[r] * xd[ki[r, c].long()]).sum(1)
        sp = nrm[pi[r, c].long()] - f * (qd[r] * xd[pi[r, c].long()]).sum(1)
        assert float((sk - sp).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,k,metric,chunk", [
    (5000, 128, 37, 10, "l2", 2048), (5003, 40, 70, 100, "dot", 256),
    (3000, 33, 1, 1, "l2", 256), (5, 16, 9, 10, "l2", 256)])
def test_kernels_match_plain_on_gpu(cuda_device, n, d, b, k, metric, chunk):
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _inputs(n, d, b, seed=n + k))
    ps, pi = ST._flat_topk_plain(q, x, k, metric, chunk=chunk)
    before = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches)
    es, ei = ST.flat_topk_pallas(q, x, k, metric, chunk=chunk)
    fs, fi = ST.flat_topk_pallas2(q, x, k, metric, chunk=chunk)
    torch.cuda.synchronize()
    assert (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(ei, fi) and torch.equal(es, fs)
    _tie_aware(q, x, metric, es, ei, ps, pi)


@pytest.mark.gpu
def test_kernel_ties_on_gpu(cuda_device):
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _inputs(1000, 16, 32, seed=11, dup=40))
    _, pi = ST._flat_topk_plain(q, x, 10, chunk=256)
    for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2):
        _, ki = fn(q, x, 10, chunk=256)
        assert torch.equal(ki[0], pi[0])
        assert ki[0].tolist() == [0, 308, 307, 306, 305, 304, 303, 302, 301, 300]
