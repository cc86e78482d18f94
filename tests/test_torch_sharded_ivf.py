"""zvdb_tpu_torch's ShardedIVF (parallel/sharded_ivf.py) on the CPU, against the JAX package.

JAX's ShardedIVF runs on 4 of the 8 virtual CPU devices of
tests/conftest.py, the port's on make_mesh(n_shards=4, devices=["cpu"]).
k-means draws from each package's own generator, so the deterministic
stages are compared on carried states:
  * the placement: a JAX single-chip IVFIndex carried by
    IVFIndex.from_numpy goes through the port's placement step and gives
    JAX's ShardedIVF.build save file bit for bit (every array and meta), for
    f32 l2, int8 + rerank and dot;
  * search: a JAX-built index carried by its save file searches as JAX's
    (ids equal, scores within rtol 1e-5 / atol 1e-4) at global nprobe 2
    and 8, after remove, under allowed= in "probe" mode and, up to
    near-ties, in "scan" mode;
  * the append: the same add on both packages (through the conversion of a
    global-id index to local ids and an id map, and on a rerank index)
    leaves the same save file (f32 squared norms within rtol 1e-6: sums in
    another order), and the port's file loads in JAX.
The overflow rebuild and compact retrain, so they are held by their
contract. The rest mirrors tests/test_sharded_ivf.py, the IVF cases of
tests/test_sharded_round2.py, test_delete.py's sharded IVF case and the IVF
part of test_filtered.py::test_sharded_filtered_all_engines, and holds the
port's sharded build to its single-chip IVFIndex on an exhaustive pool.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu.parallel.sharded_ivf import ShardedIVF as JaxShardedIVF
from zvdb_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, K = 3000, 32, 10
CFG = dict(dim=DIM, n_clusters=32, nprobe=8, kmeans_iters=6)
# the three placement and search cases: f32 l2, int8 residual codes with the
# shadow-store rerank, and dot (where only the c_mask keeps padded clusters
# out of the probes' ranking besides their +inf norms)
CASES = [dict(), dict(dtype="int8", rerank=4), dict(metric="dot")]
NORMS = ("c_norms", "b_norms", "rerank_norms")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((60, DIM)).astype(np.float32)
    x = (cents[rng.integers(0, 60, N)] + 0.2 * rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, 48)] + 0.05 * rng.standard_normal((48, DIM))).astype(np.float32)
    return x, q


def port_mesh(s=4):
    return make_mesh(n_shards=s, devices=["cpu"])


_BUILT = {}


def jax_index(data, **kw):
    """A JAX ShardedIVF over the module's rows per configuration (built
    once; tests that mutate an index load a copy of its save file)."""
    key = tuple(sorted(kw.items()))
    if key not in _BUILT:
        j = JaxShardedIVF(ZJ.IVFConfig(**{**CFG, **kw}), mesh=jax_mesh(n_shards=4))
        j.build(data[0])
        _BUILT[key] = j
    return _BUILT[key]


def _save(idx, tmp_path, name):
    path = str(tmp_path / name)
    idx.save(path)
    return path


def carried(j, tmp_path, name="j.npz"):
    return ZT.ShardedIVF.load(_save(j, tmp_path, name), mesh=port_mesh())


def jax_copy(j, tmp_path, name="jc.npz"):
    return JaxShardedIVF.load(_save(j, tmp_path, name), mesh=jax_mesh(n_shards=4))


def assert_results(t, j):
    ts, ti = (a.numpy() for a in t)
    js, ji = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)


def assert_near_ties(t, j):
    """The masked exact scan: scores within rtol 1e-5 / atol 1e-4, ids
    equal except at most 1% of slots, each where two scores of its row
    tie within 1e-5 of the score scale (summation order)."""
    (ts, ti), (js, ji) = (tuple(np.asarray(a) for a in r) for r in (t, j))
    np.testing.assert_allclose(ts, js, **TOL)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= 0.01 * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for row, col in bad:
        others = np.delete(js[row], col)
        assert col == js.shape[1] - 1 or np.abs(others - js[row, col]).min() <= tie, (row, col)


def assert_same_files(tmp_path, t, j, exact_norms=False):
    """The two indexes' save files: every array equal (the f32 squared
    norms within rtol 1e-6 unless exact_norms) and the same meta."""
    zt = np.load(_save(t, tmp_path, "t_cmp.npz"))
    zj = np.load(_save(j, tmp_path, "j_cmp.npz"))
    assert sorted(zt.files) == sorted(zj.files)
    for f in zj.files:
        if f == "meta":
            assert json.loads(str(zt[f])) == json.loads(str(zj[f]))
            continue
        assert zt[f].dtype == zj[f].dtype and zt[f].shape == zj[f].shape, f
        if f in NORMS and not exact_norms:
            np.testing.assert_array_equal(np.isinf(zt[f]), np.isinf(zj[f]), err_msg=f)
            fin = np.isfinite(zj[f])
            np.testing.assert_allclose(zt[f][fin], zj[f][fin], rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)


@pytest.mark.parametrize("kw", CASES, ids=["f32", "int8_rerank", "dot"])
def test_placement_equals_jax_build_file(tmp_path, data, kw):
    x, _ = data
    cfg = ZJ.IVFConfig(**{**CFG, **kw})
    single = ZJ.IVFIndex(cfg)
    single.build(x)
    arrays = {f: np.asarray(getattr(single.state, f)) for f in single.state._fields}
    st = ZT.IVFIndex.from_numpy(dataclasses.asdict(cfg), arrays, device="cpu").state
    t = ZT.ShardedIVF(ZT.IVFConfig(**{**CFG, **kw}), mesh=port_mesh())
    t._place(st, x)
    j = jax_index(data, **kw)
    assert len(t) == len(j) == N
    assert [s.n for s in t.state] == np.asarray(j.state.n).tolist()
    if kw.get("metric") == "dot":   # a shard with fewer clusters than C_loc
        assert not all(bool(m.all()) for m in t.c_mask)
    assert_same_files(tmp_path, t, j, exact_norms=True)


@pytest.mark.parametrize("kw", CASES, ids=["f32", "int8_rerank", "dot"])
def test_carried_index_searches_as_jax(tmp_path, data, kw):
    x, q = data
    j = jax_copy(jax_index(data, **kw), tmp_path)
    t = carried(j, tmp_path)
    for p in (2, 8):
        assert_results(t.search(q, K, nprobe=p), j.search(q, K, nprobe=p))
    gone = np.unique(np.asarray(j.search(q[:16], 3)[1]))
    assert t.remove(gone) == j.remove(gone) == gone.size
    assert t._dead == j._dead and len(t) == len(j) == N - gone.size
    assert_results(t.search(q, K), j.search(q, K))
    allow = np.zeros(N, bool)
    allow[::3] = True
    assert_near_ties(t.search(q, K, allowed=allow, filter_mode="scan"),
                     j.search(q, K, allowed=allow, filter_mode="scan"))
    # the probe filter converts a global-id index to the id-map layout first
    assert_results(t.search(q, K, nprobe=8, allowed=allow, filter_mode="probe"),
                   j.search(q, K, nprobe=8, allowed=allow, filter_mode="probe"))
    assert (t.id_map is None) == (j.id_map is None)
    ti = t.search(q, K, allowed=allow, filter_mode="probe")[1].numpy()
    assert np.isin(ti[ti >= 0], np.flatnonzero(allow)).all() and not np.isin(ti, gone).any()
    assert_results(t.search(q, K, nprobe=2), j.search(q, K, nprobe=2))


@pytest.mark.parametrize("kw", [dict(), dict(dtype="int8", rerank=4)], ids=["f32", "int8_rerank"])
def test_append_leaves_jax_state(tmp_path, data, kw):
    x, q = data
    j = jax_copy(jax_index(data, **kw), tmp_path)
    t = carried(j, tmp_path)
    assert t.remove([5, 17]) == j.remove([5, 17]) == 2
    extra = x[100:160] + np.float32(0.01)
    t.add(extra)
    j.add(extra)
    t.flush()
    j.flush()
    assert t.id_map is not None and len(t) == len(j) == N + 58
    assert_same_files(tmp_path, t, j)
    assert_results(t.search(q, K), j.search(q, K))
    found = t.search(extra[:8], K)[1].numpy()
    assert all(N + i in found[i] for i in range(8))
    # a second add onto the local-id layout, then the port's file in JAX
    t.add(extra[:9] - np.float32(0.02))
    j.add(extra[:9] - np.float32(0.02))
    assert_same_files(tmp_path, t, j)
    back = JaxShardedIVF.load(_save(t, tmp_path, "t.npz"), mesh=jax_mesh(n_shards=4))
    assert back._dead == t._dead == {5, 17} and len(back) == len(t)
    assert_results(t.search(q, K), back.search(q, K))


def test_overflow_rebuild_and_compact_contract(data):
    x, _ = data
    t = ZT.ShardedIVF(ZT.IVFConfig(**{**CFG, "rerank": 2}), mesh=port_mesh())
    t.build(x[:1000])
    assert t.remove([3, 700]) == 2
    cap = t.state[0].blocks.shape[1]
    t.add(x[1000:])                         # 2,000 rows into blocks sized for 1,000
    t.flush()
    assert t.state[0].blocks.shape[1] != cap and len(t) == N - 2
    assert t._dead == {3, 700}
    ids = t.search(x[[3, 700, 1500, 2999]], 3)[1].numpy()
    assert not np.isin(ids, [3, 700]).any()
    found = t.search(x[1000:1064], K)[1].numpy()
    assert np.mean([1000 + i in found[i] for i in range(64)]) >= 0.95
    old = t.compact()
    assert old.size == N - 2 and not np.isin(old, [3, 700]).any() and len(t) == N - 2
    assert int(t.search(x[2999], 1)[1][0, 0]) == N - 3     # renumbered, order kept


@pytest.mark.parametrize("kw", [dict(), dict(metric="dot")], ids=["l2", "dot"])
def test_port_build_equals_port_single_chip_on_an_exhaustive_pool(kw):
    """Every cluster probed: each shard's pool is its clusters' exact top-k,
    so the merge is the single chip's exhaustive answer."""
    rng = np.random.default_rng(42)
    cents = rng.standard_normal((24, 24)).astype(np.float32) * 4
    x = (cents[rng.integers(0, 24, 2000)] + rng.standard_normal((2000, 24))).astype(np.float32)
    q = (x[rng.integers(0, 2000, 48)] + 0.05 * rng.standard_normal((48, 24))).astype(np.float32)
    cfg = ZT.IVFConfig(dim=24, n_clusters=16, nprobe=16, **kw)
    single = ZT.IVFIndex(cfg, device="cpu")
    single.build(x)
    sh = ZT.ShardedIVF(cfg, mesh=port_mesh())
    sh.build(x)

    def same(a, b):
        (sa, ia), (sb, ib) = (tuple(t.numpy() for t in r) for r in (a, b))
        np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-4)
        tie = ia != ib
        assert np.allclose(sa[tie], sb[tie], rtol=1e-5, atol=1e-4)

    same(single.search(q, K, nprobe=10 ** 6), sh.search(q, K, nprobe=10 ** 6))
    dead = np.unique(np.asarray(single.search(q[:4], 1)[1]))
    assert single.remove(dead) == sh.remove(dead) == dead.size
    same(single.search(q, K, nprobe=10 ** 6), sh.search(q, K, nprobe=10 ** 6))
    allowed = np.arange(0, 2000, 3)
    for mode in ("scan", "probe"):
        same(single.search(q, K, nprobe=10 ** 6, allowed=allowed, filter_mode=mode),
             sh.search(q, K, nprobe=10 ** 6, allowed=allowed, filter_mode=mode))


def test_empty_and_dimension_mismatch():
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=8, n_clusters=8), mesh=port_mesh())
    s, i = idx.search(np.zeros((2, 8), np.float32), 3)
    assert (i == -1).all() and torch.isinf(s).all() and len(idx) == 0
    with pytest.raises(ValueError, match="dimension"):
        idx.search(np.zeros((2, 5), np.float32), 3)
    with pytest.raises(ValueError, match="dimension"):
        idx.add(np.zeros((1, 5), np.float32))
    # the first add builds
    x = clustered(400, 8, seed=9)
    idx.add(x)
    assert len(idx) == 400 and int(idx.search(x[7], 1)[1][0, 0]) == 7


# -- mirrors of the JAX package's sharded IVF tests, at this file's size ----


def recall_at_k(ids, gt, k):
    return np.mean([len(set(ids[r, :k]) & set(gt[r, :k])) / k for r in range(ids.shape[0])])


def test_recall_sorted_global_ids():
    """tests/test_sharded_ivf.py::test_sharded_ivf_recall (at 4,000 rows)."""
    n, d = 4000, 32
    x = clustered(n, d, seed=1)
    rng = np.random.default_rng(0)
    q = (x[rng.integers(0, n, 128)] + 0.05 * rng.standard_normal((128, d))).astype(np.float32)
    _, gt = ZT.exact_ground_truth(x, q, K, device="cpu")
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=d, n_clusters=64, nprobe=16), mesh=port_mesh())
    idx.build(x)
    assert len(idx) == n
    s, ids = (a.numpy() for a in idx.search(q, K))
    assert recall_at_k(ids, np.asarray(gt), K) >= 0.92
    assert (ids >= 0).all() and (ids < n).all()
    assert all(len(set(row.tolist())) == K for row in ids)
    assert (np.diff(s, axis=1) >= -1e-5).all()


def test_int8_rerank_recall_and_rerank_add():
    """tests/test_sharded_round2.py: int8 + rerank recall, and rerank + add
    on 2 shards."""
    n, d = 4000, 32
    x = clustered(n, d, seed=1)
    rng = np.random.default_rng(1)
    q = (x[rng.integers(0, n, 128)] + 0.05 * rng.standard_normal((128, d))).astype(np.float32)
    _, gt = ZT.exact_ground_truth(x, q, K, device="cpu")
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=d, n_clusters=64, nprobe=16, dtype="int8", rerank=4),
                        mesh=port_mesh())
    idx.build(x)
    ids = idx.search(q, K)[1].numpy()
    assert recall_at_k(ids, np.asarray(gt), K) >= 0.9 and int(ids.max()) < n
    x2 = clustered(2000, 16, seed=4)
    two = ZT.ShardedIVF(ZT.IVFConfig(dim=16, n_clusters=16, nprobe=16, rerank=4),
                        mesh=port_mesh(2))
    two.build(x2)
    two.add(clustered(300, 16, seed=5))
    assert (two.search(x2[:64], 1)[1].numpy()[:, 0] == np.arange(64)).mean() >= 0.99


def test_add_keeps_ids_and_roundtrip(tmp_path):
    """tests/test_sharded_round2.py::test_sharded_ivf_add_and_roundtrip."""
    n, d = 3000, 16
    x = clustered(n, d, seed=2)
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=d, n_clusters=32, nprobe=32), mesh=port_mesh())
    idx.build(x)
    probe = x[:128]
    assert (idx.search(probe, 1)[1].numpy()[:, 0] == np.arange(128)).mean() >= 0.99
    extra = clustered(400, d, seed=3)
    idx.add(extra)
    assert len(idx) == n + 400
    ids1 = idx.search(probe, 1)[1].numpy()
    assert (ids1[:, 0] == np.arange(128)).mean() >= 0.99
    assert (idx.search(extra[:64], 1)[1].numpy()[:, 0] == n + np.arange(64)).mean() >= 0.9
    loaded = ZT.ShardedIVF.load(_save(idx, tmp_path, "sivf.npz"), mesh=port_mesh())
    np.testing.assert_array_equal(ids1, loaded.search(probe, 1)[1].numpy())
    loaded.add(extra[:16] + 0.3)
    assert len(loaded) == n + 400 + 16
    loaded.search(probe[:4], 1)


def test_remove_append_and_roundtrip(tmp_path):
    """tests/test_delete.py::test_sharded_ivf_remove_append_and_roundtrip."""
    n, d = 2000, 16
    x = clustered(n, d, seed=19)
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=d, n_clusters=16), mesh=port_mesh())
    idx.build(x)
    dead = set(range(0, 200, 2))
    assert idx.remove(sorted(dead)) == len(dead) and len(idx) == n - len(dead)
    assert not np.isin(idx.search(x[:200], 5, nprobe=8)[1].numpy(), sorted(dead)).any()
    alive = np.asarray([r for r in range(200) if r not in dead])
    assert (idx.search(x[alive], 1, nprobe=8)[1].numpy()[:, 0] == alive).mean() >= 0.95
    idx.add(x[:4] + 0.001)    # the append converts to local ids and an id map
    assert not np.isin(idx.search(x[:200], 5, nprobe=8)[1].numpy(), sorted(dead)).any()
    assert idx.id_map is not None
    back = ZT.ShardedIVF.load(_save(idx, tmp_path, "si.npz"), mesh=port_mesh())
    assert back._dead == dead
    assert not np.isin(back.search(x[:200], 5, nprobe=8)[1].numpy(), sorted(dead)).any()


def test_filtered_search():
    """The IVF part of tests/test_filtered.py::test_sharded_filtered_all_engines."""
    n, d, k = 2400, 16, 5
    x = clustered(n, d, seed=35)
    q = x[:96] + 0.01
    allow = np.arange(0, n, 2)
    d2 = ((q[:, None, :] - x[None, allow]) ** 2).sum(-1)
    gt = allow[np.argsort(d2, axis=1)[:, :k]]
    idx = ZT.ShardedIVF(ZT.IVFConfig(dim=d, n_clusters=16), mesh=port_mesh())
    idx.build(x)
    for mode in ("scan", "probe"):
        i = idx.search(q, k, allowed=allow, nprobe=8, filter_mode=mode)[1].numpy()
        assert np.isin(i[i >= 0], allow).all()
        assert np.mean([len(set(i[r]) & set(gt[r])) / k for r in range(96)]) >= 0.9
    assert (idx.search(x[:32], 1, nprobe=8)[1].numpy()[:, 0] == np.arange(32)).mean() >= 0.9
