"""The IVF building blocks of the port's IVF-PQ engine against the JAX package.

`_assign`, `_update_centroids`, `split_oversized_device`, `_ivf_range`
(zvdb_tpu/index/ivf.py) and `_slot_pairs` (zvdb_tpu/index/ivfpq.py) get the
same numpy inputs in both packages. Assignments, slots and positions must be
equal; centroids agree within rtol 1e-5 (f32 sums in another order).
`_kmeans_device` draws from torch's generator, so it is held to its
contract: the same seed gives the same centroids, no cluster is empty on
clustered data, and the inertia is within 1.1x of the JAX package's.
`utils/filter_policy.py` must make the JAX package's decisions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zvdb_tpu.index import ivf as JI
from zvdb_tpu.index import ivfpq as JQ
from zvdb_tpu.index import knn_graph as JK
from zvdb_tpu.utils import filter_policy as JF
from zvdb_tpu_torch.index import ivf as TI
from zvdb_tpu_torch.index import ivfpq as TQ
from zvdb_tpu_torch.index import knn_graph as TK
from zvdb_tpu_torch.utils import filter_policy as TF

CTOL = dict(rtol=1e-5, atol=1e-5)


def _clustered(seed, n=3000, d=16, k=24, spread=0.3):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(k, d)).astype(np.float32) * 3
    x = (cents[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))).astype(np.float32)
    return x, cents


def _sq(a):
    return (a * a).sum(-1)


def test_assign_equals_jax():
    x, _ = _clustered(0)
    cent = x[np.random.default_rng(1).choice(len(x), 40, replace=False)] + 0.01
    ja = np.asarray(JI._assign(jnp.asarray(x), jnp.asarray(_sq(x)), jnp.asarray(cent),
                               jnp.asarray(_sq(cent)), tile=1024))
    ta = TI._assign(torch.from_numpy(x), torch.from_numpy(_sq(x)), torch.from_numpy(cent),
                    torch.from_numpy(_sq(cent)), tile=1024)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), ja)


def test_update_centroids_matches_jax():
    x, _ = _clustered(2)
    rng = np.random.default_rng(3)
    cent = rng.normal(size=(50, 16)).astype(np.float32)
    assign = rng.integers(0, 48, len(x)).astype(np.int32)    # clusters 48, 49 stay empty
    jc = np.asarray(JI._update_centroids(jnp.asarray(x), jnp.asarray(assign), jnp.asarray(cent)))
    tc = TI._update_centroids(torch.from_numpy(x), torch.from_numpy(assign),
                              torch.from_numpy(cent), tile=512).numpy()
    np.testing.assert_allclose(tc, jc, **CTOL)
    np.testing.assert_array_equal(tc[48:], cent[48:])        # empty clusters keep theirs


def test_batched_two_means_matches_jax():
    x, _ = _clustered(4, n=600)
    members = np.full((4, 256), -1, np.int32)
    for j, (lo, m) in enumerate([(0, 256), (256, 100), (356, 9), (365, 200)]):
        members[j, :m] = np.arange(lo, lo + m)
    j0, j1, js = (np.asarray(a) for a in JI._batched_two_means(jnp.asarray(x),
                                                               jnp.asarray(members)))
    t0, t1, ts = (a.numpy() for a in TI._batched_two_means(torch.from_numpy(x),
                                                           torch.from_numpy(members)))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(t0, j0, **CTOL)
    np.testing.assert_allclose(t1, j1, **CTOL)


@pytest.mark.parametrize("cap", [160, 64])
def test_split_oversized_matches_jax(cap):
    # 3000 rows in 8 clusters (~375 each): every cluster splits, and at
    # cap=64 they split again over several rounds
    x, _ = _clustered(5)
    cent = x[:8].copy()
    assign = np.asarray(JI._assign(jnp.asarray(x), jnp.asarray(_sq(x)), jnp.asarray(cent),
                                   jnp.asarray(_sq(cent)))).astype(np.int64)
    jc, ja = JI.split_oversized_device(jnp.asarray(x), cent, assign, cap)
    tc, ta = TI.split_oversized_device(torch.from_numpy(x), cent, assign, cap)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, **CTOL)
    assert np.bincount(ta, minlength=len(tc)).max() <= cap and len(tc) > 8


def test_kmeans_contract():
    x, cents = _clustered(6, n=4000, k=32, spread=0.2)
    xt = torch.from_numpy(x)
    a = TK._kmeans_device(xt, 32, 10, torch.Generator().manual_seed(3), sample=2000)
    b = TK._kmeans_device(xt, 32, 10, torch.Generator().manual_seed(3), sample=2000)
    assert torch.equal(a, b) and a.shape == (32, 16)         # same seed, same centroids

    def inertia(c):
        d = _sq(x)[:, None] - 2 * x @ c.T + _sq(c)[None]
        return float(d.min(1).sum())

    import jax
    j = np.asarray(JK._kmeans_device(jnp.asarray(x), 32, 10, jax.random.PRNGKey(3),
                                     sample=2000))
    assert inertia(a.numpy()) <= 1.1 * inertia(j)
    ta = TI._assign(xt, None, a, TI.D.sq_norms(a)).numpy()
    assert np.bincount(ta, minlength=32).min() > 0           # no empty cluster
    # fewer sample rows than centroids: initial draws with replacement
    small = TK._kmeans_device(xt[:10], 16, 2, torch.Generator().manual_seed(0))
    assert small.shape == (16, 16) and torch.isfinite(small).all()


def _probes(seed, b, c, p, hot=False):
    rng = np.random.default_rng(seed)
    pr = np.stack([rng.choice(c, p, replace=False) for _ in range(b)]).astype(np.int32)
    if hot:
        pr[:, 0] = 3          # every query probes cluster 3 first: it overflows
    return pr


@pytest.mark.parametrize("b,p,c,q_cap,hot", [(40, 4, 16, 32, False), (64, 4, 16, 32, True),
                                             (5, 3, 8, 8, False)])
def test_slot_pairs_equal_jax(b, p, c, q_cap, hot):
    probes = _probes(b + p, b, c, p, hot)
    jq, jp = (np.asarray(a) for a in JQ._slot_pairs(jnp.asarray(probes), b, p, c, q_cap))
    tq, tp = (a.numpy() for a in TQ._slot_pairs(torch.from_numpy(probes), b, p, c, q_cap))
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tp, jp)
    if hot:   # the hot cluster kept the q_cap rank-0 probes of the first queries
        np.testing.assert_array_equal(tq[3], np.arange(q_cap))
        assert (tp[3] == 0).all()


@pytest.mark.parametrize("b,p,c,slack,prec", [(2048, 8, 4096, 4.0, "int8"), (7, 3, 10, 4.0, "int8"),
                                              (100, 16, 64, 2.0, "high"), (1, 1, 8, 4.0, "default")])
def test_q_cap_as_jax_computes_it(b, p, c, slack, prec):
    q_align = 32 if prec == "int8" else 8
    want = max(q_align, int(slack * b * p / max(c, 1)))
    want = min(-(-want // q_align) * q_align, -(-(b * p) // q_align) * q_align)
    assert TQ._q_cap(b, p, c, slack, prec) == want


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivf_range_equals_jax(metric):
    x, _ = _clustered(7, n=900)
    rng = np.random.default_rng(8)
    q = x[:6] + 0.05 * rng.normal(size=(6, 16)).astype(np.float32)
    ids = np.arange(900, dtype=np.int32)
    ids[::5] = -1                                   # dead / padding rows never count
    norms = _sq(x) if metric == "l2" else np.zeros(900, np.float32)
    scales = np.ones(900, np.float32)
    radius = 2.0 if metric == "l2" else 30.0
    js, ji, jc = (np.asarray(a) for a in JI._ivf_range(
        jnp.asarray(x), jnp.asarray(norms), jnp.asarray(ids), jnp.asarray(scales),
        jnp.asarray(q), jnp.asarray(radius, jnp.float32), metric, 16, "float32", tile=256))
    ts, ti, tc = (a.numpy() for a in TI._ivf_range(
        *(torch.from_numpy(a) for a in (x, norms, ids, scales, q)), radius, metric, 16,
        "float32", tile=256))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    assert (tc > 0).all() and not np.isin(ti, np.arange(0, 900, 5)).any()


def test_filter_policy_decides_as_jax():
    assert TF.N_CROSSOVER == JF.N_CROSSOVER and TF.SEL_NEAR_ALL == JF.SEL_NEAR_ALL
    big = JF.N_CROSSOVER
    mask_hi = np.ones(big, bool)
    mask_hi[: big // 20] = False          # 95% pass
    mask_lo = np.zeros(big, bool)
    mask_lo[: big // 2] = True            # 50% pass
    cases = [("scan", None, 10), ("probe", mask_lo, 10), ("auto", None, big),
             ("auto", mask_hi, 1000), ("auto", mask_hi, big), ("auto", mask_lo, big),
             ("auto", np.arange(big - 10), big), ("auto", [1, 2], big)]
    for mode, allowed, n in cases:
        for alt in ("beam", "probe"):
            assert TF.resolve_filter_mode(mode, allowed, n, alt) == \
                JF.resolve_filter_mode(mode, allowed, n, alt)
    # a bool tensor costs one scalar pull, as a JAX device array does
    m = torch.arange(80) < 60
    assert TF.mask_selectivity(m, 80) == pytest.approx(0.75)
    assert TF.mask_selectivity(torch.arange(30), 100) == pytest.approx(0.3)
    assert TF.mask_selectivity(np.zeros(0, bool), 0) == 1.0
    assert TF.resolve_filter_mode("auto", torch.from_numpy(mask_hi), big, "probe") == "probe"
