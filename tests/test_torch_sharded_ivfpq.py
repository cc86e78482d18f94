"""zvdb_tpu_torch's ShardedIVFPQ (parallel/sharded_ivfpq.py) on the CPU, against the JAX package.

JAX's ShardedIVFPQ runs on 4 of the 8 virtual CPU devices of
tests/conftest.py, the port's on make_mesh(n_shards=4, devices=["cpu"]).
Training draws from each package's own generator, so the deterministic
stages are compared on carried states:
  * the placement: a JAX single-chip IVFPQIndex carried by
    IVFPQIndex.from_numpy goes through the port's placement step and gives
    JAX's ShardedIVFPQ.build grids (blocks, c_mask, id_map, the cluster,
    owner and local-id maps, the refine stores) on the same rows;
  * search: a JAX-built index carried by its save file searches as JAX's
    (JAX's kernel C in interpret mode against the port's plain version of
    it, one launch a shard): ids equal, scores within rtol 1e-5 / atol
    1e-4, after remove, under allowed= in "probe" mode and, up to
    near-ties, in "scan" mode (the masked scan at "high": JAX's CPU dots
    are f32, the port rounds to bf16x3); the append path leaves JAX's
    states; the port's save files load in JAX.
The overflow rebuild and compact retrain, so they are held by their
contract. The rest mirrors tests/test_sharded_ivfpq.py and the IVF-PQ case
of tests/test_sharded_equivalence.py against the port's own IVFPQIndex.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu.parallel.sharded_ivfpq import ShardedIVFPQ as JaxShardedIVFPQ
from zvdb_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, K = 3000, 32, 10
CFG = dict(dim=DIM, n_sub=8, n_clusters=32, nprobe=8, rerank=12, l_bins=128, chunk=128,
           train_sample=1024, kmeans_sample=2048, pq_kmeans_iters=4, ivf_kmeans_iters=6)
GRIDS = ("centroids", "c_norms", "codes_blocks", "b_ids", "counts", "codebooks", "rot",
         "refine", "r_scales", "n")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((60, DIM)).astype(np.float32)
    x = (cents[rng.integers(0, 60, N)] + 0.2 * rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, 48)] + 0.05 * rng.standard_normal((48, DIM))).astype(np.float32)
    return x, q


def port_mesh():
    return make_mesh(n_shards=4, devices=["cpu"])


_BUILT = {}


def jax_index(data, **kw):
    """A JAX ShardedIVFPQ over the module's rows per configuration."""
    key = tuple(sorted(kw.items()))
    if key not in _BUILT:
        j = JaxShardedIVFPQ(ZJ.IVFPQConfig(**{**CFG, **kw}), mesh=jax_mesh(n_shards=4))
        j.build(data[0])
        _BUILT[key] = j
    return _BUILT[key]


def carried(j, tmp_path, name="j.npz"):
    path = str(tmp_path / name)
    j.save(path)
    return ZT.ShardedIVFPQ.load(path, mesh=port_mesh())


def assert_results(t, j):
    ts, ti = (a.numpy() for a in t)
    js, ji = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)


def assert_same_files(tmp_path, t, j, exact_norms=False):
    """The two indexes' save files: every array equal (decoded norms within
    rtol 1e-6 unless exact_norms) and the same meta."""
    t.save(str(tmp_path / "t_cmp.npz"))
    j.save(str(tmp_path / "j_cmp.npz"))
    zt, zj = np.load(tmp_path / "t_cmp.npz"), np.load(tmp_path / "j_cmp.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for f in zj.files:
        if f == "meta":
            mt, mj = (eval_meta(z["meta"]) for z in (zt, zj))
            assert mt == mj
        elif f == "st_norms_blocks" and not exact_norms:
            np.testing.assert_array_equal(np.isinf(zt[f]), np.isinf(zj[f]))
            fin = np.isfinite(zj[f])
            np.testing.assert_allclose(zt[f][fin], zj[f][fin], rtol=1e-6)
        else:
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)


def eval_meta(s):
    import json

    return json.loads(str(s))


def test_placement_equals_jax_build(tmp_path, data):
    x, _ = data
    cfg = ZJ.IVFPQConfig(**CFG)
    single = ZJ.IVFPQIndex(cfg)
    single.build(x)
    arrays = {f: np.asarray(getattr(single.state, f)) for f in single.state._fields}
    st = ZT.IVFPQIndex.from_numpy(dataclasses.asdict(cfg), arrays, device="cpu").state
    t = ZT.ShardedIVFPQ(ZT.IVFPQConfig(**CFG), mesh=port_mesh())
    t._place(st)
    j = jax_index(data)
    assert len(t) == len(j) == N and [s.n for s in t.state] == list(j._n_loc)
    np.testing.assert_array_equal(t._cluster_of, j._cluster_of)
    for f in ("_owner", "_lid", "_n_loc"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for si in range(4):
        np.testing.assert_array_equal(t.c_mask[si].numpy(), np.asarray(j.c_mask)[si])
        np.testing.assert_array_equal(t.id_map[si].numpy(), np.asarray(j.id_map)[si])
        for f in GRIDS:
            want = np.asarray(getattr(j.state, f))[si]
            np.testing.assert_array_equal(np.asarray(getattr(t.state[si], f)), want, err_msg=f)
    assert_same_files(tmp_path, t, j, exact_norms=True)


@pytest.mark.parametrize("metric,refine", [("l2", "int16"), ("dot", "int8")])
def test_carried_index_searches_as_jax(tmp_path, data, metric, refine):
    _, q = data
    j = jax_index(data, metric=metric, refine=refine)
    t = carried(j, tmp_path)
    assert_results(t.search(q, K), j.search(q, K))
    assert_results(t.search(q, 5, nprobe=3, rerank=4), j.search(q, 5, nprobe=3, rerank=4))
    allow = np.arange(0, N, 3)
    assert_results(t.search(q, K, allowed=allow, filter_mode="probe"),
                   j.search(q, K, allowed=allow, filter_mode="probe"))


def test_remove_filters_add_and_save_as_jax(tmp_path, data):
    x, q = data
    j0 = jax_index(data)
    j = JaxShardedIVFPQ.load(_save(j0, tmp_path, "j0.npz"), mesh=jax_mesh(n_shards=4))
    t = carried(j0, tmp_path)
    gone = np.unique(np.asarray(j.search(q[:16], 3)[1]))
    assert t.remove(gone) == j.remove(gone) == gone.size
    assert t._dead == j._dead and len(t) == len(j) == N - gone.size
    assert_results(t.search(q, K), j.search(q, K))
    allow = np.zeros(N, bool)
    allow[::4] = True
    assert_results(t.search(q, K, allowed=allow, filter_mode="probe"),
                   j.search(q, K, allowed=allow, filter_mode="probe"))
    # the exact masked scan: the port's "high" rounds, JAX's CPU dots do not
    ts, ti = (a.numpy() for a in t.search(q, K, allowed=allow, filter_mode="scan"))
    js, ji = (np.asarray(a) for a in j.search(q, K, allowed=allow, filter_mode="scan"))
    differ = ti != ji
    assert differ.mean() <= 0.01
    np.testing.assert_allclose(ts, js, rtol=1e-3, atol=1e-3)
    assert np.isin(ti[ti >= 0], np.flatnonzero(allow)).all() and not np.isin(ti, gone).any()
    np.testing.assert_allclose(t.get([1, 2, 2999]), j.get([1, 2, 2999]), rtol=1e-6, atol=1e-6)
    # the append path: 40 rows into spare block capacity, no rebuild
    extra = x[100:140] + 0.01
    t.add(extra)
    j.add(extra)
    assert_results(t.search(q, K), j.search(q, K))
    assert_same_files(tmp_path, t, j)
    found = t.search(extra[:8], K)[1].numpy()
    assert all(N + i in found[i] for i in range(8))
    # the port's save file in JAX
    back = JaxShardedIVFPQ.load(_save(t, tmp_path, "t.npz"), mesh=jax_mesh(n_shards=4))
    assert back._dead == t._dead and len(back) == len(t)
    assert_results(t.search(q, K), back.search(q, K))


def _save(idx, tmp_path, name):
    path = str(tmp_path / name)
    idx.save(path)
    return path


def test_overflow_rebuild_and_compact_contract(data):
    x, q = data
    t = ZT.ShardedIVFPQ(ZT.IVFPQConfig(**CFG), mesh=port_mesh())
    t.build(x[:1000])
    assert t.remove([3, 700]) == 2
    cap = t.state[0].codes_blocks.shape[2]
    t.add(x[1000:])                         # 2,000 rows into blocks sized for 1,000
    t.flush()
    assert t.state[0].codes_blocks.shape[2] != cap and len(t) == N - 2
    assert t._dead == {3, 700}
    ids = t.search(x[[3, 700, 1500, 2999]], 3)[1].numpy()
    assert not np.isin(ids, [3, 700]).any()
    found = t.search(x[1000:1064], K)[1].numpy()
    assert np.mean([1000 + i in found[i] for i in range(64)]) >= 0.95
    np.testing.assert_allclose(t.get([0, 1500, 2999]), x[[0, 1500, 2999]], atol=1e-3)
    old = t.compact()
    assert old.size == N - 2 and not np.isin(old, [3, 700]).any() and len(t) == N - 2
    assert int(t.search(x[2999], 1)[1][0, 0]) == N - 3     # renumbered, order kept
    np.testing.assert_allclose(t.get([N - 3]), x[[2999]], atol=1e-3)


def test_port_build_equals_port_single_chip_on_an_exhaustive_pool():
    """tests/test_sharded_equivalence.py's IVF-PQ rule on the port's own
    builds: exhaustive probes, one bin a row (l_bins >= any cluster) and an
    f32 refine pool covering the corpus make both exact over the stored rows."""
    rng = np.random.default_rng(42)
    cents = rng.standard_normal((24, 24)).astype(np.float32) * 4
    x = (cents[rng.integers(0, 24, 2000)] + rng.standard_normal((2000, 24))).astype(np.float32)
    q = (x[rng.integers(0, 2000, 48)] + 0.05 * rng.standard_normal((48, 24))).astype(np.float32)
    cfg = ZT.IVFPQConfig(dim=24, n_sub=8, n_clusters=8, nprobe=8, refine="float32",
                         rerank=256, l_bins=1024, chunk=1024, train_sample=1024,
                         kmeans_sample=1024)
    single = ZT.IVFPQIndex(cfg, device="cpu")
    single.build(x)
    sh = ZT.ShardedIVFPQ(cfg, mesh=port_mesh())
    sh.build(x)

    def same(a, b):
        (sa, ia), (sb, ib) = (tuple(t.numpy() for t in r) for r in (a, b))
        np.testing.assert_allclose(sa, sb, rtol=1e-3, atol=1e-3)
        tie = ia != ib
        assert np.allclose(sa[tie], sb[tie], rtol=1e-3, atol=1e-3)

    same(single.search(q, K, nprobe=8), sh.search(q, K, nprobe=10 ** 6))
    d2 = ((q[:4, None, :] - x[None]) ** 2).sum(-1)
    dead = np.unique(np.argmin(d2, axis=1))
    assert single.remove(dead) == sh.remove(dead) == dead.size
    same(single.search(q, K, nprobe=8), sh.search(q, K, nprobe=10 ** 6))
    allowed = np.arange(0, 2000, 3)
    same(single.search(q, K, nprobe=8, allowed=allowed),
         sh.search(q, K, nprobe=10 ** 6, allowed=allowed))


def test_empty_refine_none_and_dim():
    idx = ZT.ShardedIVFPQ(ZT.IVFPQConfig(dim=16, n_sub=8, n_clusters=8), mesh=port_mesh())
    s, i = idx.search(np.zeros((2, 16), np.float32), 3)
    assert (i == -1).all() and torch.isinf(s).all() and len(idx) == 0
    with pytest.raises(ValueError, match="refine store"):
        ZT.ShardedIVFPQ(ZT.IVFPQConfig(dim=16, n_sub=8, refine="none"),
                        mesh=port_mesh()).build(np.zeros((64, 16), np.float32))
    with pytest.raises(ValueError):
        idx.add(np.zeros((1, 8), np.float32))
