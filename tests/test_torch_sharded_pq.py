"""zvdb_tpu_torch's ShardedPQFlat (parallel/sharded_pq.py) on the CPU, against the JAX package.

JAX's ShardedPQFlat runs on 4 of the 8 virtual CPU devices of
tests/conftest.py, the port's on make_mesh(n_shards=4, devices=["cpu"]).
Training draws from each package's own generator, so JAX builds and its
index is carried into the port by `from_numpy` or by its save file. Then
both packages run the same adds (the second grows every shard) and remove,
and their save files (JAX's stacked [S, cap, n_sub] layout in both) must
match: codes and ids equal, integer refine rows and scales bit for bit,
decoded norms within rtol 1e-6 (the subspaces sum in another order), cosine
refine rows within 4 ulps (the normalizing norm, likewise). On a carried
index the kernel route (JAX's Pallas kernel B in interpret mode, the
port's plain version of kernel B) and the decode scan at "highest" give
JAX's ids, scores within rtol 1e-5 / atol 1e-4, also under allowed=, after
remove and compact, with OPQ and without a refine store; the port's save
files load in JAX. The rest mirrors tests/test_sharded_pq.py and the PQ case
of tests/test_sharded_equivalence.py against the port's own PQFlatIndex.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu.parallel.sharded_pq import ShardedPQFlat as JaxShardedPQFlat
from zvdb_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, K = 3000, 32, 10
# the kernel route of tests/test_sharded_pq.py::test_pallas_scan_per_shard
KERNEL = dict(scan="pallas", n_codes=16, l_bins=128, pallas_chunk=512, per_bin=2)
BASE = dict(dim=DIM, n_sub=8, rerank=8, train_sample=1024, kmeans_iters=4, tile_n=512)


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
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((50, DIM)).astype(np.float32)
    x = (cents[rng.integers(0, 50, N)] + 0.15 * rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, 48)] + 0.05 * rng.standard_normal((48, DIM))).astype(np.float32)
    return x, q


def port_mesh():
    return make_mesh(n_shards=4, devices=["cpu"])


def jax_index(x, **kw):
    j = JaxShardedPQFlat(ZJ.PQConfig(**{**BASE, **kw}), mesh=jax_mesh(n_shards=4))
    j.build(x)
    return j


def carried(j):
    """The port's index over JAX's in-memory state (from_numpy)."""
    arrays = {k: np.asarray(v, np.float32) if str(v.dtype) == "bfloat16" else np.asarray(v)
              for k, v in j.state.items()}
    arrays.update(codebooks=np.asarray(j.codebooks), rot=np.asarray(j.rot))
    meta = dict(cfg=dataclasses.asdict(j.cfg), n=j._n, n_shards=j.n_shards, trained=j._trained)
    return ZT.ShardedPQFlat.from_numpy(arrays, meta, mesh=port_mesh())


def assert_results(t, j):
    """Port results (tensors) against JAX's: equal ids, close scores."""
    ts, ti = (a.numpy() for a in t)
    js, ji = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("metric,refine", [("l2", "int8"), ("dot", "int16"),
                                           ("cosine", "float32")])
def test_grids_equal_jax_after_add_grow_remove(tmp_path, data, metric, refine):
    x, _ = data
    j = jax_index(x[:1000], metric=metric, refine=refine, **KERNEL)
    t = carried(j)
    for idx in (j, t):
        idx.add(x[1000:1300])
        idx.flush()                        # fits: 75 rows a shard
        idx.add(x[1300:])                  # 1,700 rows: every shard grows
        assert idx.remove([0, 5, 1100, 2999]) == 4
    j.save(str(tmp_path / "j.npz"))
    t.save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zt["ids"].shape == zj["ids"].shape and zt["ids"].shape[0] == 4
    for f in ("codes", "ids"):
        np.testing.assert_array_equal(zt[f], zj[f])
    if refine == "float32":
        np.testing.assert_array_max_ulp(zt["refine"], zj["refine"], maxulp=4)
        np.testing.assert_array_equal(zt["r_scales"], zj["r_scales"])
    else:
        for f in ("refine", "r_scales"):
            np.testing.assert_array_equal(zt[f], zj[f])
    np.testing.assert_array_equal(np.isinf(zt["norms"]), np.isinf(zj["norms"]))
    fin = np.isfinite(zj["norms"])
    np.testing.assert_allclose(zt["norms"][fin], zj["norms"][fin], rtol=1e-6)
    np.testing.assert_array_equal(t._per_shard_n, j._per_shard_n)
    assert t._dead == j._dead and len(t) == len(j) == N - 4


@pytest.mark.parametrize("seg_rows", [0, 512])
def test_kernel_route_searches_as_jax(data, seg_rows):
    """JAX's kernel B in interpret mode against the port's plain version of
    it, one launch a shard, on a carried index: plain, a rerank override,
    an allowlist, after remove."""
    x, q = data
    j = jax_index(x, refine="int8", seg_rows=seg_rows, **KERNEL)
    t = carried(j)
    assert t.state[0]["codes"].shape == (4, 750)   # packed and transposed, as kernel B reads
    assert_results(t.search(q, K), j.search(q, K))
    assert_results(t.search(q[:16], 5, rerank=3), j.search(q[:16], 5, rerank=3))
    allow = np.arange(0, N, 3)
    assert_results(t.search(q, K, allowed=allow), j.search(q, K, allowed=allow))
    gone = np.unique(np.asarray(j.search(q[:16], 2)[1]))
    assert t.remove(gone) == j.remove(gone) == gone.size
    assert_results(t.search(q, K), j.search(q, K))


def test_decode_scan_get_and_compact_as_jax(data):
    """approx=False: the decode scan at "highest" (JAX's CPU dots are f32),
    one-byte codes; allowed as a mask; get; compact renumbers as JAX does."""
    x, q = data
    j = jax_index(x, n_codes=256, refine="int16", precision="highest")
    t = carried(j)
    assert t.state[0]["codes"].shape == (750, 8)
    assert_results(t.search(q, K, approx=False), j.search(q, K, approx=False))
    mask = np.zeros(N, bool)
    mask[:900] = True
    assert_results(t.search(q, K, approx=False, allowed=mask),
                   j.search(q, K, approx=False, allowed=mask))
    probe = [0, 7, 1500, 2999]
    np.testing.assert_array_equal(t.get(probe), j.get(probe))
    gone = np.unique(np.asarray(j.search(q[:16], 3, approx=False)[1]))
    assert t.remove(gone) == j.remove(gone) == gone.size
    with pytest.raises(IndexError):
        t.get(gone[:1])
    np.testing.assert_array_equal(t.compact(), j.compact())
    np.testing.assert_array_equal(t._per_shard_n, j._per_shard_n)
    assert_results(t.search(q, K, approx=False), j.search(q, K, approx=False))
    probe = [0, 7, 1500, len(t) - 1]
    np.testing.assert_array_equal(t.get(probe), j.get(probe))


def test_opq_and_codes_only_as_jax(tmp_path, data):
    """OPQ without a refine store: the rotation rides the save file, the
    kernel route gives JAX's ids, get reconstructs in the user's space."""
    x, q = data
    j = jax_index(x, refine="none", opq=True, opq_iters=2, **KERNEL)
    j.save(str(tmp_path / "opq.npz"))
    t = ZT.ShardedPQFlat.load(str(tmp_path / "opq.npz"), mesh=port_mesh())
    assert t.rot.shape == (DIM, DIM)
    assert_results(t.search(q, K), j.search(q, K))
    np.testing.assert_allclose(t.get(np.arange(20)), np.asarray(j.get(np.arange(20))),
                               rtol=1e-5, atol=1e-5)


def test_port_save_loads_in_jax(tmp_path, data):
    x, q = data
    j = jax_index(x[:2000], refine="int8", **KERNEL)
    t = carried(j)
    t.add(x[2000:])
    t.remove([3, 2500])
    path = str(tmp_path / "t.npz")
    t.save(path)
    back = JaxShardedPQFlat.load(path, mesh=jax_mesh(n_shards=4))
    assert back._dead == t._dead == {3, 2500} and back._n == t._n == N
    assert_results(t.search(q, K), back.search(q, K))


def test_port_build_equals_port_single_chip_on_a_full_pool(data):
    """tests/test_sharded_equivalence.py's PQ rule on the port's own builds:
    an f32 refine pool covering the corpus (rerank=256 at k=10, 2000 rows)
    makes both exact over the stored rows, whatever their codebooks (the
    decode scan: kernel B's pool is its bins)."""
    x, q = data
    cfg = ZT.PQConfig(**{**BASE, "refine": "float32", "rerank": 256, "n_codes": 256})
    single = ZT.PQFlatIndex(cfg, device="cpu")
    single.build(x[:2000])
    sh = ZT.ShardedPQFlat(cfg, mesh=port_mesh())
    sh.build(x[:2000])
    for kw in ({}, {"allowed": np.arange(0, 2000, 3)}):
        ss, si = single.search(q, K, **kw)
        ts, ti = sh.search(q, K, **kw)
        np.testing.assert_allclose(ts.numpy(), ss.numpy(), rtol=1e-4, atol=1e-4)
        tie = ti.numpy() != si.numpy()
        assert np.allclose(ts.numpy()[tie], ss.numpy()[tie], rtol=1e-4, atol=1e-4)
    victims = np.unique(si.numpy()[:4, 0])
    assert single.remove(victims) == sh.remove(victims) == victims.size
    np.testing.assert_allclose(sh.search(q, K)[0].numpy(), single.search(q, K)[0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_port_surface_empty_k_gt_n_and_dim(data):
    x, q = data
    idx = ZT.ShardedPQFlat(ZT.PQConfig(dim=DIM, n_sub=8, train_sample=64), mesh=port_mesh())
    s, i = idx.search(q[:3], 5)
    assert (i == -1).all() and torch.isinf(s).all()
    idx.add(x[:7])                     # the first flush trains and builds
    _, i = idx.search(x[:2], 10)
    assert (i[:, :7] >= 0).all() and (i[:, 7:] == -1).all()
    assert int(idx.search(x[3], 1)[1][0, 0]) == 3
    with pytest.raises(ValueError):
        idx.search(np.zeros((1, 8), np.float32), 3)
    with pytest.raises(ValueError):
        idx.add(np.zeros((1, 8), np.float32))
    with pytest.raises(IndexError):
        idx.get([99])
    big = ZT.ShardedPQFlat(ZT.PQConfig(**{**BASE, "refine": "int8", "n_codes": 256}),
                           mesh=port_mesh())
    big.build(x[:2000])
    big.add(x[2000:])
    assert len(big) == N
    spread = big._per_shard_n.max() - big._per_shard_n.min()
    hit = (big.search(x[2000:2064], 1)[1][:, 0].numpy() == np.arange(2000, 2064)).mean()
    assert spread <= 1 and hit >= 0.95
