"""zvdb_tpu_torch's ShardedFlat (parallel/sharded_flat.py) on the CPU, against the JAX package.

JAX's ShardedFlat runs on 4 of the 8 virtual CPU devices of
tests/conftest.py, the port's on make_mesh(n_shards=4, devices=["cpu"])
(every shard on the one CPU). ShardedFlat draws nothing at random, so the
same build, adds and remove give the same grids: ids and the +inf
validity bias equal, vectors equal (cosine: within 4 ulps, since the
normalizing norm sums in another order and is an ulp apart), squared
norms within rtol 1e-6 (summation order again: half the rows are an ulp
apart, as between JAX's own eager and jitted runs). On an index JAX built
and saved (or handed over by from_numpy), exact search, filtered search
and range search give JAX's ids and counts, scores within rtol 1e-5 /
atol 1e-4; the port's save files load in JAX. The rest mirrors
tests/test_sharded_flat.py and the flat case of
tests/test_sharded_equivalence.py against the port's own FlatIndex.
"""
import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu.parallel.sharded_flat import ShardedFlat as JaxShardedFlat
from zvdb_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-4)
D = 16


def port_mesh(n_shards=4):
    return make_mesh(n_shards=n_shards, devices=["cpu"])


def data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((32, D)).astype(np.float32))


def pair(metric="l2", n=2000, seed=0, writes=True):
    """The JAX and port indexes after the same build over n rows and, with
    writes, two adds (the second grows every shard) and a remove."""
    x, q = data(n, seed)
    rng = np.random.default_rng(seed + 1)
    adds = [rng.standard_normal((n // 2 + 7, D)).astype(np.float32),
            rng.standard_normal((n + 5, D)).astype(np.float32)]
    j = JaxShardedFlat(ZJ.FlatConfig(dim=D, metric=metric), mesh=jax_mesh(n_shards=4))
    t = ZT.ShardedFlat(ZT.FlatConfig(dim=D, metric=metric), mesh=port_mesh())
    for idx in (j, t):
        idx.build(x)
        if writes:
            idx.add(adds[0])
            idx.flush()
            idx.add(adds[1])
            assert idx.remove([0, 5, n + 3, 2 * n]) == 4
    return j, t, q


def jax_arrays(j):
    return {f: np.asarray(v, np.float32) if f == "vectors" else np.asarray(v)
            for f, v in j.state.items()}


def meta(idx):
    import dataclasses

    return dict(cfg=dataclasses.asdict(idx.cfg), n=idx._n, n_shards=idx.n_shards)


def assert_results(t, j):
    """Port results (tensors) against JAX's: equal ids, close scores."""
    *ts, ti = (a.numpy() for a in t[:2])
    js, ji = (np.asarray(a) for a in j[:2])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts[0], js, **TOL)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("n", [123, 2000])
def test_grids_equal_jax_after_build_add_grow_remove(tmp_path, metric, n):
    j, t, _ = pair(metric, n)
    j.save(str(tmp_path / "j.npz"))
    t.save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zt["ids"].shape == zj["ids"].shape and zt["ids"].shape[0] == 4
    np.testing.assert_array_equal(zt["ids"], zj["ids"])
    np.testing.assert_array_equal(np.isinf(zt["norms"]), np.isinf(zj["norms"]))
    fin = np.isfinite(zj["norms"])
    np.testing.assert_allclose(zt["norms"][fin], zj["norms"][fin], rtol=1e-6)
    if metric == "cosine":
        np.testing.assert_array_max_ulp(zt["vectors"], zj["vectors"], maxulp=4)
    else:
        np.testing.assert_array_equal(zt["vectors"], zj["vectors"])
    assert len(t) == len(j) == n + n // 2 + 7 + n + 5 - 4
    np.testing.assert_array_equal(t._per_shard_n, j._per_shard_n)
    assert t._dead == j._dead


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_carried_index_searches_as_jax(tmp_path, metric):
    j, _, q = pair(metric, 2000, seed=3)
    path = str(tmp_path / "j.npz")
    j.save(path)
    t = ZT.ShardedFlat.load(path, mesh=port_mesh())
    assert t._dead == j._dead and len(t) == len(j)
    mask = np.zeros(j._n, bool)
    mask[::3] = True
    id_list = np.random.default_rng(4).choice(j._n, 300, replace=False)
    for kw in ({}, {"allowed": mask}, {"allowed": id_list}):
        assert_results(t.search(q, 10, approx=False, **kw), j.search(q, 10, approx=False, **kw))
    # from_numpy carries the in-memory state without a file
    t2 = ZT.ShardedFlat.from_numpy(jax_arrays(j), meta(j), mesh=port_mesh())
    assert_results(t2.search(q, 10), j.search(q, 10, approx=False))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_search_range_equals_jax(metric):
    j, t, _ = pair(metric, 2000, seed=5)
    x, _ = data(2000, 5)
    q = x[:32] + 0.01
    radius = 16.0 if metric == "l2" else 8.0
    for r in (8, 64):
        got = t.search_range(q, radius, max_results=r)
        want = j.search_range(q, radius, max_results=r)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert_results(got, want)
    assert (got[2].numpy() > 8).any()   # some rows were truncated at r=8


def test_port_save_loads_in_jax(tmp_path):
    _, t, q = pair("l2", 2000, seed=6)
    path = str(tmp_path / "t.npz")
    t.save(path)
    j = JaxShardedFlat.load(path, mesh=jax_mesh(n_shards=4))
    assert j._dead == t._dead and j._n == t._n
    assert_results(t.search(q, 10), j.search(q, 10, approx=False))
    # and back: the JAX load's save reads in the port
    j.save(str(tmp_path / "j.npz"))
    back = ZT.ShardedFlat.load(str(tmp_path / "j.npz"), mesh=port_mesh())
    assert torch.equal(back.search(q, 10)[1], t.search(q, 10)[1])


def test_bf16_round_trip(tmp_path):
    x, q = data(500, 7)
    j = JaxShardedFlat(ZJ.FlatConfig(dim=D, dtype="bfloat16"), mesh=jax_mesh(n_shards=4))
    j.build(x)
    j.save(str(tmp_path / "j.npz"))
    t = ZT.ShardedFlat.load(str(tmp_path / "j.npz"), mesh=port_mesh())
    assert t.state[0]["vectors"].dtype == torch.bfloat16
    assert_results(t.search(q, 5), j.search(q, 5, approx=False))


def test_empty_and_k_greater_than_n():
    t = ZT.ShardedFlat(ZT.FlatConfig(dim=8), mesh=port_mesh())
    s, ids = t.search(np.zeros((2, 8), np.float32), 3)
    assert (ids.numpy() == -1).all() and torch.isinf(s).all() and ids.shape == (2, 3)
    s, ids, c = t.search_range(np.zeros((2, 8), np.float32), 1.0, max_results=4)
    assert (ids.numpy() == -1).all() and (c.numpy() == 0).all()
    x, _ = data(10, 8)
    j = JaxShardedFlat(ZJ.FlatConfig(dim=D), mesh=jax_mesh(n_shards=4))
    t = ZT.ShardedFlat(ZT.FlatConfig(dim=D), mesh=port_mesh())
    for idx in (j, t):
        idx.build(x)
        idx.remove([4])
    s, ids = t.search(x[:3], 11)            # k > n: 9 live rows of 4 x 3 slots
    assert_results((s, ids), j.search(x[:3], 11, approx=False))
    assert ((ids.numpy() >= 0).sum(1) == 9).all() and (ids.numpy()[:, -2:] == -1).all()
    assert np.isinf(s.numpy()[:, -2:]).all()
    with pytest.raises(ValueError, match="dimension mismatch"):
        t.search(np.zeros((1, D + 1), np.float32), 3)
    with pytest.raises(IndexError):
        t.remove([10])


def test_cosine_self_hit_first():
    x, _ = data(123, 9)
    t = ZT.ShardedFlat(ZT.FlatConfig(dim=D, metric="cosine"), mesh=port_mesh(8))
    t.build(x)
    _, ids = t.search(x[:5], 7)
    assert (ids.numpy()[:, 0] == np.arange(5)).all() and ids.shape == (5, 7)


def assert_same(sa, ia, sb, ib, atol=1e-3):
    """tests/test_sharded_equivalence.py's rule: scores equal slot by slot,
    and an id may differ only where both sides score the slot equal."""
    sa, ia, sb, ib = (a.numpy() for a in (sa, ia, sb, ib))
    fin = np.isfinite(sa) | np.isfinite(sb)
    np.testing.assert_allclose(np.where(fin, sa, 0.0), np.where(fin, sb, 0.0), rtol=1e-3,
                               atol=atol)
    neq = (ia != ib) & fin
    assert np.allclose(sa[neq], sb[neq], rtol=1e-3, atol=atol)


def test_equal_to_the_single_chip_engine():
    rng = np.random.default_rng(42)
    cents = rng.standard_normal((24, 24)).astype(np.float32) * 4
    x = (cents[rng.integers(0, 24, 2000)] + rng.standard_normal((2000, 24))).astype(np.float32)
    q = (x[rng.integers(0, 2000, 48)] + 0.05 * rng.standard_normal((48, 24))).astype(np.float32)
    cfg = ZT.FlatConfig(dim=24, precision="highest")
    single = ZT.FlatIndex(cfg, capacity=2000, device="cpu")
    single.add(x)
    sh = ZT.ShardedFlat(cfg, mesh=port_mesh())
    sh.build(x)
    assert_same(*single.search(q, 10), *sh.search(q, 10, approx=False))
    dead = np.unique(np.argmin(((q[:4, None] - x[None]) ** 2).sum(-1), axis=1))
    assert single.remove(dead) == sh.remove(dead) == dead.size
    assert_same(*single.search(q, 10), *sh.search(q, 10))
    allowed = np.arange(0, 2000, 3)
    assert_same(*single.search(q, 10, allowed=allowed), *sh.search(q, 10, allowed=allowed))
    got, want = sh.search_range(q, 30.0, max_results=16), single.search_range(q, 30.0, 16)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    assert_same(got[0], got[1], want[0], want[1])
    # compact renumbers the survivors in order, as the single-chip engine does
    live = sh.compact()
    np.testing.assert_array_equal(live, single.compact())
    assert_same(*single.search(q, 10), *sh.search(q, 10))


def test_adds_route_to_the_least_loaded_shards():
    x, _ = data(100, 10)
    t = ZT.ShardedFlat(ZT.FlatConfig(dim=D), mesh=port_mesh())
    t.build(x[:90])                        # 23, 23, 23, 21 rows
    t.add(x[90:])
    t.flush()
    np.testing.assert_array_equal(t._per_shard_n, [26, 26, 24, 24])
    assert int(t.state[3]["ids"][21]) == 90   # the least-loaded shard takes the first chunk
    _, ids = t.search(x, 1)
    np.testing.assert_array_equal(ids.numpy()[:, 0], np.arange(100))


def test_a_data_axis_does_not_split_the_queries():
    """JAX's ShardedFlat replicates the queries over a data axis (its P()
    query spec), so any batch size runs on a (data=2, shard=4) mesh."""
    x, q = data(300, 11)
    t1 = ZT.ShardedFlat(ZT.FlatConfig(dim=D), mesh=port_mesh())
    t2 = ZT.ShardedFlat(ZT.FlatConfig(dim=D), mesh=make_mesh(n_shards=4, n_data=2,
                                                             devices=["cpu"]))
    for idx in (t1, t2):
        idx.build(x)
    for b in (3, 32):
        assert torch.equal(t2.search(q[:b], 5)[1], t1.search(q[:b], 5)[1])
    assert torch.equal(t2.search_range(q[:3], 16.0, 8)[2], t1.search_range(q[:3], 16.0, 8)[2])
