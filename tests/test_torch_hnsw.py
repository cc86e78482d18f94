"""zvdb_tpu_torch.HNSW's search and engine surface on the CPU, against the JAX package.

The JAX package builds one HNSW per module (l2, f32) on 3000 x 32d
clustered rows with m=8, build_batch=1024 and precision="float32"; the
cosine, dot, bf16 and int8 indexes are JAX's own ingest of the rows under
that graph (see `jax_built`);
`HNSW.from_numpy` (or a save file) carries its state across, so both
packages search the same graph, anchors and entry point. The port's own
build is held to its contract in test_torch_hnsw_build.py.

At precision="float32" both compute f32 products (the port's "highest"),
summed in other orders, so ids must be equal up to near-ties (`_same`: a
differing id must tie another of its row within 1e-5 of the score scale, at
most 1% of ids) and scores within rtol 1e-5 / atol 1e-4. At "high" the port
rounds to bf16x3 as the TPU does while JAX's CPU dots stay f32; the share of
equal ids is held to >= 0.97.
"""
import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index import hnsw as JH
from zvdb_tpu.index import knn_graph as JKG
from zvdb_tpu.ops import distance as JD
from zvdb_tpu.utils.stats import index_stats as j_index_stats
from zvdb_tpu_torch.index import hnsw as TH
from zvdb_tpu_torch.ops import distance as TD
from zvdb_tpu_torch.utils.stats import index_stats as t_index_stats

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM = 3000, 32


def clustered(n, d, seed, nc=50, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    x = clustered(N, DIM, seed=2)
    rng = np.random.default_rng(0)
    q = (x[rng.integers(0, N, 200)] + 0.05 * rng.standard_normal((200, DIM))).astype(np.float32)
    return x, q


_JAX_BUILT: dict = {}
_GRAPH = ("nbr0", "nbrU", "dist0", "distU", "levels", "entry", "max_level")


def _no_graph(x, degree, key, **kw):
    """Stand-in for JAX's build_knn_graph: every edge empty."""
    n = x.shape[0]
    return (jnp.full((n + 1, degree), -1, jnp.int32),
            jnp.full((n + 1, degree), jnp.inf, jnp.float32), None, None, None)


def jax_built(corpus, metric="l2", dtype="float32"):
    """A JAX-built index (precision "float32"), one per (metric, dtype) per
    module. One JAX graph build (l2, f32) per module: the others are JAX's
    own ingest of the corpus in their metric and dtype (its build with the
    graph builder stubbed out: stored rows, norms, q_scale, anchors) under
    that build's graph, levels and entry point. The search reads any graph
    alike, and one graph build saves ~4 of them (~15 s each alone)."""
    key = (metric, dtype)
    if key not in _JAX_BUILT:
        cfg = ZJ.HNSWConfig(dim=DIM, m=8, build_batch=1024, metric=metric, dtype=dtype,
                            precision="float32")
        idx = ZJ.HNSW(cfg, seed=3)
        if key == ("l2", "float32"):
            idx.build(corpus[0])
        else:
            base = jax_built(corpus)
            idx.cfg = dataclasses.replace(cfg, diverse_rows=False)
            with mock.patch.object(JKG, "build_knn_graph", _no_graph):
                idx.build(corpus[0])
            idx.cfg = cfg
            idx.state = idx.state._replace(**{f: getattr(base.state, f) for f in _GRAPH})
        _JAX_BUILT[key] = idx
    return _JAX_BUILT[key]


def _arrays(jidx):
    return {f: np.asarray(getattr(jidx.state, f)) for f in JH.HNSWState._fields}


def _variant(jidx, cfg=None, search_cfg=None):
    """The JAX index with other configs (a shallow copy: the same state)."""
    j = copy.copy(jidx)
    j.cfg = cfg or jidx.cfg
    j.search_cfg = search_cfg or jidx.search_cfg
    j._packed_table = j._packed_src = None
    return j


def _port_of(jidx):
    return ZT.HNSW.from_numpy(dataclasses.asdict(jidx.cfg), _arrays(jidx),
                              search_cfg=dataclasses.asdict(jidx.search_cfg),
                              capacity=jidx.capacity, levels_cap=jidx.levels_cap,
                              n_inserted=jidx._n_inserted, device=CPU)


def _same(t, j, max_share=0.01):
    """Scores equal within TOL slot by slot; ids equal except where a result
    ties another of its row (or is the k-th) within 1e-5 of the score scale.
    Returns the number of differing ids."""
    (ts, ti), (js, ji) = t, j
    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, **TOL)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= max_share * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for pos in bad:
        row, col = js[tuple(pos[:-1])], pos[-1]
        others = np.delete(row, col)
        assert col == row.shape[0] - 1 or np.abs(others - row[col]).min() <= tie, pos
    return len(bad)


@pytest.mark.parametrize("search_degree", [24, None])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_from_numpy_same_ids(corpus, metric, search_degree):
    x, q = corpus
    j0 = jax_built(corpus, metric)
    jidx = _variant(j0, search_cfg=ZJ.SearchConfig(search_degree=search_degree))
    tidx = _port_of(jidx)
    st = tidx.state
    assert st.n == N and st.nbr0.dtype == torch.int32 and tidx.capacity == 3072
    assert tidx.levels_cap == j0.levels_cap and st.entry == int(j0.state.entry)
    assert tidx.cfg.packed == (metric == "l2")
    for ef in (16, 64):
        _same(tidx.search(q, 10, ef_search=ef), jidx.search(q, 10, ef_search=ef))
    _same(tidx.search(q, 10, ef_search=24, max_iters=3),
          jidx.search(q, 10, ef_search=24, max_iters=3))
    ts, ti = tidx.search(q[0], 5)                       # one query, squeezed
    assert ts.shape == (5,) and ti.shape == (5,)
    _same((ts[None], ti[None]), tuple(np.asarray(a)[None] for a in jidx.search(q[0], 5)))
    np.testing.assert_array_equal(tidx.get([0, 1234, 2999]),
                                  np.asarray(jidx.get([0, 1234, 2999])))
    assert len(tidx) == len(jidx) == N


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_high_precision_share(corpus, metric):
    x, q = corpus
    j0 = jax_built(corpus, metric)
    jidx = _variant(j0, cfg=dataclasses.replace(j0.cfg, precision="high"))
    tidx = _port_of(jidx)
    ti = tidx.search(q, 10, ef_search=32)[1].numpy()
    ji = np.asarray(jidx.search(q, 10, ef_search=32)[1])
    assert (ti == ji).mean() >= 0.97, (ti == ji).mean()


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_descend_matches_jax(corpus, metric):
    x, q = corpus
    jidx = jax_built(corpus, metric)
    tidx = _port_of(jidx)
    qj = JD.preprocess_queries(jnp.asarray(q), metric)
    qt = TD.preprocess_queries(torch.from_numpy(q), metric)
    with jax.default_matmul_precision("float32"):
        jep, jes = JH.descend(jidx.state, qj, metric, jidx.levels_cap)
    tep, tes = TH.descend(tidx.state, qt, metric, tidx.levels_cap, precision="highest")
    np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
    np.testing.assert_allclose(tes.numpy(), np.asarray(jes), **TOL)
    if metric == "l2":   # the packed one-gather scorer the search uses for l2 + f32
        table = torch.cat([tidx.state.vectors, tidx.state.norms[:, None]], dim=1)
        scorer = TH.make_packed_scorer(table, qt, "highest")
        tep, _ = TH.descend(tidx.state, qt, metric, tidx.levels_cap, scorer=scorer)
        np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
    assert np.asarray(jep).min() >= 0


def test_tombstones_and_save_files_both_ways(corpus, tmp_path):
    x, q = corpus
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_built(corpus).save(jpath)
    jidx = ZJ.HNSW.load(jpath)
    tidx = ZT.HNSW.load(jpath, device=CPU)
    dead = np.arange(0, N, 7)
    assert jidx.remove(dead) == tidx.remove(dead) == dead.size
    assert tidx.remove(dead[:5]) == 0 and len(tidx) == len(jidx) == N - dead.size
    with pytest.raises(IndexError):
        tidx.remove([N])
    with pytest.raises(IndexError):
        tidx.get([7])
    t_res = tidx.search(q, 10, ef_search=48)
    _same(t_res, jidx.search(q, 10, ef_search=48))
    assert not np.isin(t_res[1].numpy(), dead).any()
    # the port's file (dead_ext) loads in JAX, and JAX's in the port
    tidx.save(tpath)
    jidx.save(jpath)
    j2 = ZJ.HNSW.load(tpath)
    t2 = ZT.HNSW.load(jpath, device=CPU)
    assert j2._dead == t2._dead == set(int(i) for i in dead)
    _same(t2.search(q, 10, ef_search=48), j2.search(q, 10, ef_search=48))
    assert torch.equal(t2.search(q, 10, ef_search=48)[1], t_res[1])
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for f in zj.files:
            if f != "meta":
                assert zt[f].dtype == zj[f].dtype and zt[f].shape == zj[f].shape, f


@pytest.mark.parametrize("mode", ["scan", "beam"])
def test_allowed_filter_modes(corpus, mode):
    x, q = corpus
    jidx = jax_built(corpus)
    tidx = _port_of(jidx)
    even = np.zeros(N, bool)
    even[::2] = True
    for allowed in (even, np.arange(0, N, 2)):
        ts, ti = tidx.search(q, 10, ef_search=64, allowed=allowed, filter_mode=mode)
        _same((ts, ti), jidx.search(q, 10, ef_search=64, allowed=allowed, filter_mode=mode))
        got = ti.numpy()
        assert (got[got >= 0] % 2 == 0).all()
    if mode == "scan":   # the exact masked scan: every slot filled, the true top-10
        from zvdb_tpu_torch.index.flat import exact_ground_truth
        _, gt = exact_ground_truth(x[::2], q, 10, device=CPU)
        np.testing.assert_array_equal(ti.numpy(), 2 * gt)
    # tombstones and the allowlist together
    tidx.remove([0, 2, 4])
    ti = tidx.search(q, 10, ef_search=64, allowed=even, filter_mode=mode)[1].numpy()
    assert not np.isin(ti, [0, 2, 4]).any() and (ti[ti >= 0] % 2 == 0).all()


def test_empty_index_and_k_above_n(corpus, tmp_path):
    x, q = corpus
    cfg = ZT.HNSWConfig(dim=DIM, m=8)
    for tidx in (ZT.HNSW(cfg, device=CPU), ZT.HNSW(cfg, capacity=100, device=CPU)):
        s, i = tidx.search(q[:3], 5)
        assert (i.numpy() == -1).all() and torch.isinf(s).all() and (s > 0).all()
        assert len(tidx) == 0
    s, i = ZT.HNSW(ZT.HNSWConfig(dim=DIM, metric="dot"), device=CPU).search(q[0], 4)
    assert s.shape == (4,) and (s == -float("inf")).all() and (i == -1).all()
    # an empty JAX save file loads
    path = str(tmp_path / "empty.npz")
    ZJ.HNSW(ZJ.HNSWConfig(dim=DIM, m=8)).save(path)
    assert ZT.HNSW.load(path, device=CPU).state is None
    # k > n: a 20-row JAX index
    jidx = ZJ.HNSW(ZJ.HNSWConfig(dim=DIM, m=8, precision="float32"), seed=1)
    jidx.build(x[:20])
    tidx = _port_of(jidx)
    t_res, j_res = tidx.search(q[:10], 30), jidx.search(q[:10], 30)
    _same(t_res, j_res)
    assert (t_res[1].numpy()[:, 20:] == -1).all() and (t_res[1].numpy()[:, :20] >= 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_storage_dtypes(corpus, dtype, tmp_path):
    x, q = corpus
    jidx = jax_built(corpus, "l2", dtype)
    tidx = _port_of(jidx)
    assert tidx.state.vectors.dtype == tidx.cfg.storage_dtype and not tidx.cfg.packed
    assert tidx.state.q_scale == float(np.asarray(jidx.state.q_scale))
    # bf16 / int8 rows dequantize in another order of operations than JAX's
    # promoted einsum, so ids may differ on near-ties: 0 of 2,000 differ
    # here; at most 4 may
    n_bad = _same(tidx.search(q, 10, ef_search=32), jidx.search(q, 10, ef_search=32))
    assert n_bad <= 4, n_bad
    np.testing.assert_array_equal(tidx.get([3, 2000]), np.asarray(jidx.get([3, 2000])))
    path = str(tmp_path / "t.npz")
    tidx.save(path)       # bf16 vectors round-trip through f32
    j2 = ZJ.HNSW.load(path)
    assert j2.state.vectors.dtype == jidx.state.vectors.dtype
    np.testing.assert_array_equal(np.asarray(j2.state.vectors, np.float32),
                                  np.asarray(jidx.state.vectors, np.float32))


def test_default_device_is_cuda(corpus, tmp_path):
    cfg = ZT.HNSWConfig(dim=DIM)
    path = str(tmp_path / "e.npz")
    ZT.HNSW(cfg, device=CPU).save(path)
    if torch.cuda.is_available():
        assert ZT.HNSW(cfg).device.type == "cuda"
        assert ZT.HNSW.load(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ZT.HNSW(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ZT.HNSW.load(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ZT.HNSW.from_numpy(dataclasses.asdict(cfg))


def test_surface_errors(corpus):
    x, q = corpus
    tidx = _port_of(jax_built(corpus))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tidx.search(q[:, :8], 5)
    with pytest.raises(ValueError, match="filter_mode"):
        tidx.search(q, 5, filter_mode="probe")
    with pytest.raises(IndexError):
        tidx.get([-1])
    assert tidx.get([]).shape == (0, DIM)
    for name in ("insert", "add", "flush", "resume_build"):
        assert callable(getattr(tidx, name))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tidx.insert(q[:2, :8])
    assert len(tidx) == N   # nothing buffered


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_index_stats_same_as_jax(corpus, metric):
    jidx = jax_built(corpus, metric)
    tidx = _port_of(jidx)
    jidx.remove([1, 2])
    try:
        tidx.remove([1, 2])
        want, got = j_index_stats(jidx), t_index_stats(tidx)
    finally:
        jidx._dead, jidx._dead_rows = set(), None
    assert got == want
    assert got["max_level"] == int(jidx.state.max_level) and sum(got["levels_hist"]) == N
