"""zvdb_tpu_torch's ShardedCagra (parallel/sharded_cagra.py) and
build_knn_graph_multi (index/knn_graph.py) on the CPU, against the JAX package.

A port build cannot equal JAX's (the graph's and the anchors' draws come
from other random streams), so builds are held to their contract and the
deterministic parts to JAX through carried save files:
  * build_knn_graph_multi equals build_knn_graph run shard by shard with
    equally seeded generators, a shard small enough for the dense
    `_tiny_graph` path included;
  * one JAX ShardedCagra at JAX's own test size (2 shards, 1500 x 12d,
    degree 8, build_batch 128, precision "highest") carried by its save
    file searches as JAX's: scores within TOL, ids equal up to near-ties
    (at most 1%), also after remove and under allowed= in "beam" and
    "scan" modes (the masked scan at "highest");
  * the same insert on both packages (two steps of build_batch, a capacity
    growth, under the anchor reseed's threshold) leaves JAX's nbrs and
    ext_ids (the scatters' trash row apart); the port's files load in JAX.
The rest mirrors tests/test_sharded_cagra.py and the CAGRA part of
test_filtered.py::test_sharded_filtered_all_engines.
"""
import json

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu.parallel.sharded_cagra import ShardedCagra as JaxShardedCagra
from zvdb_tpu_torch.index import knn_graph as TK
from zvdb_tpu_torch.parallel.mesh import make_mesh
from zvdb_tpu_torch.parallel.sharded_cagra import shard_generators

TOL = dict(rtol=1e-5, atol=1e-4)
JCFG = dict(dim=12, degree=8, build_batch=128, precision="highest")


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


def port_mesh(s):
    return make_mesh(n_shards=s, devices=["cpu"])


def _save(idx, tmp_path, name):
    path = str(tmp_path / name)
    idx.save(path)
    return path


@pytest.fixture(scope="module")
def jax_built():
    """JAX's test_sharded_cagra_insert_and_roundtrip index, built once."""
    x = clustered(1500, 12, seed=4)
    j = JaxShardedCagra(ZJ.CagraConfig(**JCFG), mesh=jax_mesh(n_shards=2))
    j.build(x)
    return j, x


def jax_copy(j, tmp_path, name="jc.npz"):
    return JaxShardedCagra.load(_save(j, tmp_path, name), mesh=jax_mesh(n_shards=2))


def _same(t, j):
    """Scores equal within TOL slot by slot; ids equal except at most 1% of
    slots, each where its score ties another of its row (or is the k-th)
    within 1e-5 of the score scale (the rule of test_torch_cagra.py)."""
    (ts, ti), (js, ji) = (tuple(np.asarray(a) for a in r) for r in (t, j))
    np.testing.assert_allclose(ts, js, **TOL)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= 0.01 * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for row, col in bad:
        others = np.delete(js[row], col)
        assert col == js.shape[1] - 1 or np.abs(others - js[row, col]).min() <= tie, (row, col)


# -- the multi-shard graph build ----------------------------------------------


@pytest.mark.parametrize("block_topk", ["exact", "pallas"])
def test_build_knn_graph_multi_equals_per_shard_builds(block_topk):
    xs = [clustered(700, 16, seed=1), clustered(500, 16, seed=2), clustered(20, 16, seed=3)]
    kw = dict(metric="l2", block=128, passes=2, kc_per_view=8, prune_cap=32,
              block_topk=block_topk, precision="highest")
    stats = [{} for _ in xs]
    multi = TK.build_knn_graph_multi(xs, 16, [torch.Generator().manual_seed(s) for s in (5, 6, 7)],
                                     devices=["cpu"] * 3, stats=stats, **kw)
    for x, seed, got, st in zip(xs, (5, 6, 7), multi, stats):
        one = {}
        want = TK.build_knn_graph(x, 16, torch.Generator().manual_seed(seed), device="cpu",
                                  stats=one, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert st.get("c_blocks") == one.get("c_blocks")
    n_small = xs[2].shape[0]     # the dense _tiny_graph path: every other row a neighbour
    assert multi[2][0].shape == (n_small + 1, 16) and not stats[2]
    assert ((multi[2][0][:n_small] >= 0).sum(1) == 16).all()


# -- carried JAX indexes -----------------------------------------------------


def test_carried_index_searches_as_jax(tmp_path, jax_built):
    j0, x = jax_built
    j = jax_copy(j0, tmp_path)
    t = ZT.ShardedCagra.load(_save(j, tmp_path, "t.npz"), mesh=port_mesh(2))
    assert t.shard_cap == j.shard_cap and len(t) == len(j) == 1500
    q = x[:200] + np.float32(0.01)
    _same(t.search(q, 10), j.search(q, 10))
    _same(t.search(q, 5, ef_search=48), j.search(q, 5, ef_search=48))
    gone = np.unique(np.asarray(j.search(q[:20], 3)[1]))
    assert t.remove(gone) == j.remove(gone) == gone.size
    assert t._dead == j._dead
    _same(t.search(q, 10), j.search(q, 10))
    ti = t.search(q, 10)[1].numpy()
    assert not np.isin(ti, gone).any()
    allow = np.arange(0, 1500, 3)
    _same(t.search(q, 10, allowed=allow, filter_mode="beam"),
          j.search(q, 10, allowed=allow, filter_mode="beam"))
    _same(t.search(q, 10, allowed=allow, filter_mode="scan"),
          j.search(q, 10, allowed=allow, filter_mode="scan"))
    ti = t.search(q, 10, allowed=allow, filter_mode="scan")[1].numpy()
    assert np.isin(ti[ti >= 0], allow).all() and not np.isin(ti, gone).any()
    # the port's save file (with dead_ext) in JAX
    back = JaxShardedCagra.load(_save(t, tmp_path, "t2.npz"), mesh=jax_mesh(n_shards=2))
    assert back._dead == t._dead and len(back) == len(t)
    _same(t.search(q, 10), back.search(q, 10))


def test_insert_on_carried_index_leaves_jax_graph(tmp_path, jax_built):
    j0, x = jax_built
    j = jax_copy(j0, tmp_path)
    t = ZT.ShardedCagra.load(_save(j, tmp_path, "t.npz"), mesh=port_mesh(2))
    extra = clustered(300, 12, seed=5)    # 150 a shard: two steps of 128, a growth
    t.insert(extra)
    j.insert(extra)
    t.flush()
    j.flush()
    assert t.shard_cap == j.shard_cap == 1536 and len(t) == len(j) == 1800
    assert t._anchor_n == j._anchor_n == 750           # under the reseed's threshold
    zt = np.load(_save(t, tmp_path, "t_cmp.npz"))
    zj = np.load(_save(j, tmp_path, "j_cmp.npz"))
    assert sorted(zt.files) == sorted(zj.files)
    assert json.loads(str(zt["meta"])) == json.loads(str(zj["meta"]))
    # row cap of nbrs and dists is the scatters' trash row, which JAX's
    # dropped reverse-edge writes fill and no search reads
    for f in ("nbrs", "ext_ids", "vectors", "a_rows", "n", "q_scale"):
        a, b = (z[f][:, :-1] if f == "nbrs" else z[f] for z in (zt, zj))
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("dists", "norms", "anchors", "a_norms"):
        a, b = (z[f][:, :-1] if f == "dists" else z[f] for z in (zt, zj))
        # squared distances summed in another order: the l2 surrogate
        # cancels terms far larger than the distance
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)
    q = extra[:64] + np.float32(0.01)
    _same(t.search(q, 10), j.search(q, 10))
    hit = (t.search(extra[:64], 1, ef_search=48)[1].numpy()[:, 0] == 1500 + np.arange(64))
    assert hit.mean() >= 0.9


# -- contracts of the port's own builds --------------------------------------


@pytest.fixture(scope="module")
def port_built():
    x = clustered(4000, 16, seed=3)
    idx = ZT.ShardedCagra(ZT.CagraConfig(dim=16, degree=32, block_topk="pallas"),
                          mesh=port_mesh(4))
    idx.build(x)
    return idx, x


def test_build_contract(port_built):
    idx, x = port_built
    assert len(idx) == 4000 and idx.shard_cap == 1000 and len(idx.build_stats) == 4
    assert (idx.search(x[:128], 1, ef_search=32)[1].numpy()[:, 0] == np.arange(128)).mean() >= 0.9
    assert idx.search(x[:64], 5, ef_search=32)[1].numpy().max() >= 1000   # every shard answers
    for si, (st, ext) in enumerate(zip(idx.state, idx.ext_ids)):
        nb = st.nbrs.numpy()[:st.n]
        assert ((nb >= 0).sum(1) > 0).all(), "no isolated node"
        xs = x[si * 1000:(si + 1) * 1000]
        d2 = ((xs[:, None, :] - xs[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        gt = np.argsort(d2, axis=1)[:, :10]
        hit = np.mean([len(set(nb[i]) & set(gt[i])) / 10 for i in range(0, 1000, 5)])
        assert hit >= 0.90, f"shard {si} edge 10-NN recall {hit:.3f}"
        np.testing.assert_array_equal(ext.numpy()[:1000], np.arange(si * 1000, (si + 1) * 1000))
        # anchors: the stored rows the anchor table names (1000 rows: all of them)
        rows = st.a_rows.long()
        np.testing.assert_array_equal(st.anchors.numpy(), st.vectors[rows].numpy())
    assert len({st.anchors.shape[0] for st in idx.state}) == 1


def test_build_streams_follow_the_seeding_rule():
    """Shard s's graph is build_knn_graph over its rows with the generator
    seeded 2 * (cfg.seed + s)."""
    x = clustered(900, 8, seed=7)
    cfg = ZT.CagraConfig(dim=8, degree=8, seed=11, block=128)
    idx = ZT.ShardedCagra(cfg, mesh=port_mesh(3))
    idx.build(x)
    gen, _ = shard_generators(cfg.seed, 1)
    nbrs = TK.build_knn_graph(
        x[300:600], 8, gen, metric="l2", block=128, spill=cfg.spill, passes=cfg.passes,
        kmeans_iters=cfg.kmeans_iters, alpha=cfg.alpha, precision=cfg.precision,
        reps=cfg.seed_reps, n_long=cfg.n_long, kc_per_view=cfg.kc_per_view,
        prune_cap=cfg.prune_cap, block_topk=cfg.block_topk, kmeans_sample=cfg.kmeans_sample,
        device="cpu")[0]
    assert torch.equal(idx.state[1].nbrs[:300], nbrs[:300])


def test_small_n_padded_anchors_and_first_flush(rng):
    """tests/test_sharded_cagra.py::test_sharded_cagra_small_n: tail shards
    empty, every point findable; the anchor tables padded to shard 0's
    count with +inf norms; a first flush of fewer rows than shards."""
    d = 8
    for n in (2, 9):
        x = rng.standard_normal((n, d)).astype(np.float32)
        idx = ZT.ShardedCagra(ZT.CagraConfig(dim=d, degree=8), mesh=port_mesh(4))
        idx.build(x)
        assert len(idx) == n
        assert (idx.search(x, 1, ef_search=16)[1].numpy()[:, 0] == np.arange(n)).all()
        a = idx.state[0].anchors.shape[0]
        for st in idx.state:
            assert st.anchors.shape[0] == a
            assert torch.isinf(st.a_norms[st.n:]).all() if st.n < a else True
        assert idx.state[-1].n == 0 and torch.isinf(idx.state[-1].a_norms).all()
    idx = ZT.ShardedCagra(ZT.CagraConfig(dim=d, degree=8), mesh=port_mesh(4))
    idx.insert(rng.standard_normal((3, d)).astype(np.float32))
    ids = idx.search(np.zeros((1, d), np.float32), 3, ef_search=16)[1].numpy()
    assert (ids >= 0).sum() == 3 and len(idx) == 3


def test_empty_dim_mismatch_and_port_files_in_jax(tmp_path, rng):
    idx = ZT.ShardedCagra(ZT.CagraConfig(dim=8, degree=8), mesh=port_mesh(2))
    s, ids = idx.search(np.zeros((3, 8), np.float32), 4)
    assert (ids == -1).all() and torch.isinf(s).all()
    with pytest.raises(ValueError, match="dimension"):
        idx.search(np.zeros((3, 5), np.float32), 2)
    with pytest.raises(ValueError, match="dimension"):
        idx.insert(np.zeros((1, 5), np.float32))
    x = clustered(600, 8, seed=8)
    idx.build(x)
    idx.remove([3, 4])
    back = JaxShardedCagra.load(_save(idx, tmp_path, "p.npz"), mesh=jax_mesh(n_shards=2))
    assert back._dead == {3, 4} and len(back) == 598 and back.shard_cap == idx.shard_cap
    ids = np.asarray(back.search(x[:32], 1, ef_search=32)[1])[:, 0]
    assert not np.isin(ids, [3, 4]).any()
    assert (ids[5:] == np.arange(5, 32)).mean() >= 0.9


def test_insert_grow_reseed_remove_compact(tmp_path):
    """tests/test_sharded_cagra.py::test_sharded_cagra_insert_and_roundtrip
    on the port's build, past the reseed threshold, then remove and
    compact."""
    x = clustered(1500, 12, seed=4)
    idx = ZT.ShardedCagra(ZT.CagraConfig(dim=12, degree=8, build_batch=128), mesh=port_mesh(2))
    idx.build(x)
    a_rows = [st.a_rows.clone() for st in idx.state]
    extra = clustered(1600, 12, seed=5)
    idx.insert(extra)
    assert len(idx) == 3100
    assert (idx.search(extra[:64], 1, ef_search=48)[1].numpy()[:, 0]
            == 1500 + np.arange(64)).mean() >= 0.9
    assert (idx.search(x[:64], 1, ef_search=48)[1].numpy()[:, 0] == np.arange(64)).mean() >= 0.9
    assert idx._anchor_n == 1550 and not torch.equal(idx.state[0].a_rows, a_rows[0])
    loaded = ZT.ShardedCagra.load(_save(idx, tmp_path, "sc.npz"), mesh=port_mesh(2))
    assert len(loaded) == 3100
    assert torch.equal(idx.search(x[:16], 5, ef_search=32)[1],
                       loaded.search(x[:16], 5, ef_search=32)[1])
    assert idx.remove(np.arange(0, 100)) == 100
    assert not np.isin(idx.search(x[:100], 5, ef_search=32)[1].numpy(), np.arange(100)).any()
    old = idx.compact()
    assert old.size == 3000 and old[0] == 100 and len(idx) == 3000
    assert int(idx.search(x[100], 1, ef_search=32)[1][0, 0]) == 0


def test_filtered_search():
    """The CAGRA part of tests/test_filtered.py::test_sharded_filtered_all_engines."""
    n, d, k = 2400, 16, 5
    x = clustered(n, d, seed=35)
    q = x[:96] + 0.01
    allow = np.arange(0, n, 2)
    d2 = ((q[:, None, :] - x[None, allow]) ** 2).sum(-1)
    gt = allow[np.argsort(d2, axis=1)[:, :k]]
    idx = ZT.ShardedCagra(ZT.CagraConfig(dim=d, degree=16), mesh=port_mesh(4))
    idx.build(x)
    for mode, floor in (("auto", 0.9), ("beam", 0.9), ("scan", 1.0)):
        i = idx.search(q, k, allowed=allow, ef_search=48, filter_mode=mode)[1].numpy()
        assert np.isin(i[i >= 0], allow).all()
        assert np.mean([len(set(i[r]) & set(gt[r])) / k for r in range(96)]) >= floor, mode
    assert (idx.search(x[:32], 1, ef_search=48)[1].numpy()[:, 0] == np.arange(32)).mean() >= 0.9
