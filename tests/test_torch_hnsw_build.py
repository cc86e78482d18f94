"""zvdb_tpu_torch's HNSW one-shot build (index/build.py) on the CPU, against the JAX package.

The port's build draws its levels, graphs and anchors from a
torch.Generator, so one seed builds a different graph in each package. The
deterministic stages are held to JAX on equal inputs:
  * the diversity reorder of a carried pre-reorder state: nbr0 equal and
    dist0 within rtol 1e-6 at precision="float32" (l2 on JAX's build; dot
    on the same edges with their -dot distances);
  * the ingest (stored rows, norms, q_scale, ext ids, capacity): equal, and
    cosine rows within rtol 1e-6 (see the test). JAX's ingest runs with its
    graph builder stubbed out (`_no_graph`), which the ingest does not read;
  * compact's renumbering: the survivors' old ids and the rows JAX would
    rebuild from, in order.
The whole build is held to its contract against JAX's own build at the same
size (3000 x 32d clustered, m=8, build_batch=1024, precision="float32"):
recall@10 at ef=64 within 0.02 of JAX's, no isolated node, max_level and
the entry at the top level, the same capacity and hierarchy height. JAX
builds once per module: with diverse_rows=False, then its own
reorder_rows_diverse, which is what its build runs last with
diverse_rows=True. The level histogram must be geometric within 6 standard
deviations, and the same seed must build the same graph.

The gpu-marked test needs the card and skips without one; it imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hnsw_build.py
"""
import dataclasses
import math
from unittest import mock

import numpy as np
import pytest
import torch

import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.index import build as TB
from zvdb_tpu_torch.index import hnsw as TH
from zvdb_tpu_torch.ops import block_scan as BS

CPU = "cpu"
N, DIM = 3000, 32
SMALL = 1200   # rows of the port-only builds (a build's CPU time grows with them)


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


def cfg_of(**kw):
    return dict(dim=DIM, m=8, build_batch=1024, **kw)


def recall_at_k(ids, gt, k):
    return np.mean([len(set(ids[r, :k]) & set(gt[r, :k])) / k for r in range(ids.shape[0])])


@pytest.fixture(scope="module")
def gt(corpus):
    from zvdb_tpu_torch.index.flat import exact_ground_truth
    x, q = corpus
    return exact_ground_truth(x, q, 10, device=CPU)[1]


def port_built(corpus, seed=3, **kw):
    idx = ZT.HNSW(ZT.HNSWConfig(**cfg_of(**kw)), seed=seed, device=CPU)
    idx.build(corpus[0])
    return idx


# ---------------------------------------------------------------------------
# against the JAX package (imported inside: the gpu test runs without JAX)


_JAX: dict = {}


def jax_pre_reorder(corpus):
    """JAX's build at precision "float32" with diverse_rows=False, once per
    module: (the index, its state's arrays as numpy)."""
    if "pre" not in _JAX:
        import zvdb_tpu as ZJ
        from zvdb_tpu.index import hnsw as JH

        idx = ZJ.HNSW(ZJ.HNSWConfig(**cfg_of(precision="float32", diverse_rows=False)), seed=3)
        idx.build(corpus[0])
        _JAX["pre"] = idx, {f: np.asarray(getattr(idx.state, f)) for f in JH.HNSWState._fields}
    return _JAX["pre"]


def jax_built(corpus):
    """JAX's own float32 build: the pre-reorder build, then its reorder."""
    if "post" not in _JAX:
        from zvdb_tpu.index import build as JB

        pre, _ = jax_pre_reorder(corpus)
        cfg = dataclasses.replace(pre.cfg, diverse_rows=True)
        idx = _jax_index(cfg, JB.reorder_rows_diverse(pre.state, cfg), pre)
        _JAX["post"] = idx
    return _JAX["post"]


def _jax_index(cfg, state, like):
    import zvdb_tpu as ZJ

    idx = ZJ.HNSW(cfg)
    idx.state, idx.capacity, idx.levels_cap = state, like.capacity, like.levels_cap
    idx._n_inserted = idx._anchor_n = like._n_inserted
    return idx


def _no_graph(x, degree, key, **kw):
    """Stand-in for JAX's build_knn_graph: every edge empty."""
    import jax.numpy as jnp

    n = x.shape[0]
    return (jnp.full((n + 1, degree), -1, jnp.int32),
            jnp.full((n + 1, degree), jnp.inf, jnp.float32), None, None, None)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_reorder_rows_diverse_matches_jax(corpus, metric):
    from zvdb_tpu.index import build as JB

    pre, arrays = jax_pre_reorder(corpus)
    arrays = dict(arrays)
    if metric == "dot":   # the same edges, with their -dot distances
        x = arrays["vectors"]
        nb = arrays["nbr0"][:-1]
        d = -(x[:, None, :] * x[np.maximum(nb, 0)]).sum(-1)
        arrays["dist0"] = arrays["dist0"].copy()
        arrays["dist0"][:-1] = np.where(nb >= 0, d, np.inf).astype(np.float32)
        arrays["norms"] = np.zeros_like(arrays["norms"])
    cfg_j = dataclasses.replace(pre.cfg, diverse_rows=True, metric=metric)
    jst = pre.state._replace(dist0=arrays["dist0"], norms=arrays["norms"])
    jst = JB.reorder_rows_diverse(jst, cfg_j)
    tst = TH.state_from_numpy(ZT.HNSWConfig(**dataclasses.asdict(cfg_j)), arrays, CPU)
    tst = TB.reorder_rows_diverse(tst, ZT.HNSWConfig(**dataclasses.asdict(cfg_j)))
    np.testing.assert_array_equal(tst.nbr0.numpy(), np.asarray(jst.nbr0))
    np.testing.assert_allclose(tst.dist0.numpy(), np.asarray(jst.dist0), rtol=1e-6)
    # the reorder moved edges: rows are no longer all distance-sorted
    d = tst.dist0.numpy()[:N]
    assert (np.diff(np.where(np.isfinite(d), d, 1e30), axis=1) < 0).any()
    assert not np.array_equal(tst.nbr0.numpy(), arrays["nbr0"])


@pytest.mark.parametrize("metric,dtype", [("l2", "float32"), ("cosine", "float32"),
                                          ("l2", "int8"), ("dot", "bfloat16")])
def test_ingest_matches_jax(corpus, metric, dtype):
    """The stored rows, norms, q_scale, ext ids and capacity of a build (the
    graph aside: the ingest does not read it, so 1100 rows do)."""
    import zvdb_tpu as ZJ
    from zvdb_tpu.index import knn_graph as JKG

    x = corpus[0][:1100]
    jidx = ZJ.HNSW(ZJ.HNSWConfig(**cfg_of(metric=metric, dtype=dtype, diverse_rows=False)))
    with mock.patch.object(JKG, "build_knn_graph", _no_graph):
        jidx.build(x)
    tidx = port_built((x,), metric=metric, dtype=dtype, diverse_rows=False)
    st, js = tidx.state, jidx.state
    n = st.n
    assert n == int(js.n) and tidx.capacity == jidx.capacity == st.vectors.shape[0]
    assert tidx.levels_cap == jidx.levels_cap
    assert st.q_scale == float(np.asarray(js.q_scale))
    if metric == "cosine":
        # the second normalization (preprocess_corpus) sums the squares in
        # another order than XLA: an ulp apart on some rows
        np.testing.assert_allclose(st.vectors.numpy(), np.asarray(js.vectors),
                                   rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(st.vectors.float().numpy(),
                                      np.asarray(js.vectors, np.float32))
    np.testing.assert_allclose(st.norms.numpy(), np.asarray(js.norms), rtol=1e-6)
    np.testing.assert_array_equal(st.ext_ids.numpy()[:n], np.arange(n))
    assert (st.ext_ids.numpy()[n:] == -1).all() and (st.levels.numpy()[n:] == -1).all()


def test_build_contract_against_jax(corpus, gt):
    x, q = corpus
    jidx = jax_built(corpus)
    tidx = port_built(corpus, precision="float32")
    st = tidx.state
    assert tidx.capacity == jidx.capacity == 3072 and tidx.levels_cap == jidx.levels_cap
    lv = st.levels.numpy()[:N]
    assert st.max_level == int(lv.max()) and lv[st.entry] == st.max_level
    deg = (st.nbr0.numpy()[:N] >= 0).sum(1)
    assert deg.min() > 0, "isolated node"
    assert (st.nbr0.numpy()[N:] == -1).all()
    for ell in range(1, st.max_level + 1):   # every node of a layer has its edges there
        rows = np.nonzero(lv >= ell)[0]
        if rows.size >= 2:
            e = st.nbrU[ell - 1].numpy()[rows]
            assert (e >= 0).any(1).all() and np.isin(e[e >= 0], rows).all()
    r_t = recall_at_k(tidx.search(q, 10, ef_search=64)[1].numpy(), gt, 10)
    r_j = recall_at_k(np.asarray(jidx.search(q, 10, ef_search=64)[1]), gt, 10)
    assert r_t >= r_j - 0.02, (r_t, r_j)
    assert r_t >= 0.95
    ids = tidx.search(x[:300], 1, ef_search=32)[1].numpy()[:, 0]
    assert (ids == np.arange(300)).mean() >= 0.97


def test_compact_renumbering_matches_jax(corpus):
    x, q = corpus
    post = jax_built(corpus)
    jidx = _jax_index(post.cfg, post.state, post)
    arrays = {f: np.asarray(getattr(jidx.state, f)) for f in jidx.state._fields}
    tidx = ZT.HNSW.from_numpy(dataclasses.asdict(jidx.cfg), arrays, capacity=jidx.capacity,
                              levels_cap=jidx.levels_cap, n_inserted=jidx._n_inserted,
                              device=CPU)
    dead = np.random.default_rng(4).choice(N, 300, replace=False)
    jidx.remove(dead)
    tidx.remove(dead)
    rebuilt = []
    jidx.build = lambda v: rebuilt.append(np.asarray(v))   # JAX's rows, not its rebuild
    j_live, t_live = jidx.compact(), tidx.compact()
    np.testing.assert_array_equal(t_live, j_live)
    assert len(tidx) == N - 300 and not tidx._dead
    # new id == position in the survivors: the rows JAX would rebuild from
    np.testing.assert_array_equal(tidx.get(np.arange(N - 300)), rebuilt[0])
    np.testing.assert_array_equal(rebuilt[0], x[t_live])
    ids = tidx.search(x[t_live[:200]], 1, ef_search=32)[1].numpy()[:, 0]
    assert (ids == np.arange(200)).mean() >= 0.97
    assert tidx.compact().size == N - 300   # nothing to reclaim: no rebuild


# ---------------------------------------------------------------------------
# the port's build alone


@pytest.mark.parametrize("n,want", [(500, 500), (12_000, 1024), (100_000, 16384),
                                    (1_000_000, 32768)])
def test_attach_anchors_size_rule(n, want):
    cfg = ZT.HNSWConfig(dim=2, m=4)
    st = TH.init_state(n, cfg, 1, CPU)
    st.vectors[:] = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    st.norms[:] = (st.vectors ** 2).sum(1)
    TB._attach_anchors(st, n, torch.Generator().manual_seed(0))
    rows = st.a_rows.long()
    assert st.anchors.shape == (want, 2) and st.a_rows.dtype == torch.int32
    assert rows.unique().numel() == want and int(rows.max()) < n
    assert torch.equal(st.anchors, st.vectors[rows]) and torch.equal(st.a_norms, st.norms[rows])
    if n == 500:
        assert torch.equal(st.a_rows, torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("m,ml", [(16, None), (8, None), (4, 0.5)])
def test_sample_levels_geometric(m, ml):
    n, cap = 200_000, 6
    lv = TB.sample_levels(torch.Generator().manual_seed(m), n, m, cap, ml)
    assert lv.dtype == np.int32 and lv.shape == (n,) and lv.min() >= 0 and lv.max() <= cap
    mlv = ml if ml is not None else 1.0 / math.log(m)
    for ell in range(1, 4):
        p = math.exp(-ell / mlv)          # P(level >= ell) = e^(-ell / mL)
        want, sd = n * p, math.sqrt(n * p * (1 - p))
        got = int((lv >= ell).sum())
        assert abs(got - want) <= 6 * sd + 1, (ell, got, want)


def test_same_seed_same_graph(corpus):
    x = corpus[0][:SMALL]
    a, b = (port_built((x,), seed=11) for _ in range(2))
    for f in ("nbr0", "dist0", "nbrU", "distU", "levels", "a_rows", "anchors"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    # a tensor corpus builds what its numpy copy builds
    d = ZT.HNSW(ZT.HNSWConfig(**cfg_of()), seed=11, device=CPU)
    d.build(torch.from_numpy(x))
    assert torch.equal(d.state.nbr0, a.state.nbr0) and torch.equal(d.state.nbrU, a.state.nbrU)
    # a second build on one index draws new levels and anchors
    a.build(x)
    assert not torch.equal(a.state.levels, b.state.levels)
    assert not torch.equal(a.state.a_rows, b.state.a_rows)


@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"), ("l2", "int8"),
                                          ("l2", "bfloat16")])
def test_build_other_metrics_and_storage(corpus, metric, dtype):
    x = corpus[0][:SMALL]
    tidx = port_built((x,), metric=metric, dtype=dtype)
    assert tidx.state.vectors.dtype == tidx.cfg.storage_dtype
    ids = tidx.search(x[:300], 1, ef_search=32)[1].numpy()[:, 0]
    assert (ids == np.arange(300)).mean() >= 0.95


def test_block_topk_pallas_on_the_cpu(corpus):
    """block_topk="pallas": the base layer's block scoring through kernel
    D's wrapper, which runs its plain version on CPU tensors (no launch)."""
    x = corpus[0][:SMALL]
    before = BS.block_bins.launches
    tidx = port_built((x,), block_topk="pallas")
    assert BS.block_bins.launches == before
    st = tidx.build_stats
    assert st["kc"] == 16 and len(st["c_blocks"]) == 2 and st["bcap"] >= 4 * st["kc"]
    ids = tidx.search(x[:300], 1, ef_search=32)[1].numpy()[:, 0]
    assert (ids == np.arange(300)).mean() >= 0.97


def test_build_modes_and_empty(corpus, tmp_path):
    """build_mode picks the build: "batched" (or "auto" with a checkpoint)
    the frozen-prefix batches, which give every node a level-descending
    row order; "oneshot" (or "auto" without one) the one-shot build."""
    x, _ = corpus
    for cfg_kw, kw in ((dict(build_mode="batched"), {}),
                       ({}, dict(checkpoint_path=str(tmp_path / "c.npz")))):
        idx = ZT.HNSW(ZT.HNSWConfig(**cfg_of(**cfg_kw)), device=CPU)
        idx.build(x[:100], **kw)
        assert idx.build_stats["batches"] == 1 and idx.state.n == 100
        assert (np.diff(idx.state.levels.numpy()[:100]) <= 0).all()
    idx = port_built((x[:50],), build_mode="oneshot")
    assert "batches" not in idx.build_stats
    assert idx.state.n == 50 and len(idx) == 50
    idx.build(np.zeros((0, DIM), np.float32))
    assert idx.state is None and len(idx) == 0 and idx.capacity == 0
    assert (idx.search(x[:2], 3)[1].numpy() == -1).all()
    with pytest.raises(ValueError, match="dimension mismatch"):
        idx.build(x[:10, :8])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel D has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_build_on_the_card_runs_kernel_d(cuda_device):
    x = torch.from_numpy(clustered(20_000, 64, seed=1)).to(cuda_device)
    BS.block_bins.launches = BS.block_bins.launches_mma = 0
    idx = ZT.HNSW(ZT.HNSWConfig(dim=64, m=16, build_batch=8192, block_topk="pallas"))
    idx.build(x)
    torch.cuda.synchronize()
    st = idx.build_stats
    want = sum(-(-cb // st["cc"]) for cb in st["c_blocks"])
    assert BS.block_bins.launches == BS.block_bins.launches_mma == want > 0
    ids = idx.search(x[:500], 1, ef_search=32)[1].cpu().numpy()[:, 0]
    assert (ids == np.arange(500)).mean() >= 0.95
