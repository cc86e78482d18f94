"""zvdb_tpu_torch.CagraIndex's insert on a JAX-built index, against the JAX package.

One JAX build at 3000 x 16d (precision "highest", build_batch 256); the
bf16 and int8 indexes are JAX's own ingest under that graph (JAX's graph
build function stubbed to return it). Each index has ids removed, is carried into
the port by its save file, and then takes the same 600 inserted rows in
both packages: three extend steps of build_batch rows and a capacity growth
(3,000 -> 6,000), under the anchor reseed's threshold. The extend step is
index/cagra.py:_extend_batch_impl, the one every ShardedCagra shard runs.
  * f32 and bf16: the graph (nbrs below the scatters' trash row) equal;
    int8: equal up to code-space ties, on at most 1% of the rows;
  * the stored rows and norms equal, the edge distances within rtol 1e-5;
  * search with JAX's anchors (carried, not redrawn): scores within TOL,
    ids equal up to near-ties.
"""
import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index import cagra as JC

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM = 3000, 16
CFG = dict(dim=DIM, degree=16, precision="highest", build_batch=256, seed=3)


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
def graph_file(tmp_path_factory):
    """The one JAX build: its corpus, save file and graph."""
    x = clustered(N, DIM, seed=2)
    j = ZJ.CagraIndex(ZJ.CagraConfig(**CFG))
    j.build(x)
    path = str(tmp_path_factory.mktemp("g") / "f32.npz")
    j.save(path)
    return x, path, (j.state.nbrs, j.state.dists)


def jax_index(graph_file, dtype, monkeypatch):
    x, path, (nbrs, dists) = graph_file
    if dtype == "float32":
        return ZJ.CagraIndex.load(path)
    monkeypatch.setattr(JC, "build_knn_graph",
                        lambda *a, **k: (nbrs, dists, None, None, None))
    j = ZJ.CagraIndex(ZJ.CagraConfig(**{**CFG, "dtype": dtype}))
    j.build(x)
    return j


def _same(t, j):
    """Scores within TOL slot by slot; ids equal except at most 1% of
    slots, each at a near-tie of its row (or the k-th)."""
    (ts, ti), (js, ji) = (tuple(np.asarray(a) for a in r) for r in (t, j))
    np.testing.assert_allclose(ts, js, **TOL)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= 0.01 * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for row, col in bad:
        others = np.delete(js[row], col)
        assert col == js.shape[1] - 1 or np.abs(others - js[row, col]).min() <= tie, (row, col)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_insert_on_carried_index_leaves_jax_graph(tmp_path, graph_file, dtype, monkeypatch):
    x = graph_file[0]
    j = jax_index(graph_file, dtype, monkeypatch)
    gone = [5, 77, 1234, 2999]
    assert j.remove(gone) == 4
    path = str(tmp_path / "j.npz")
    j.save(path)
    t = ZT.CagraIndex.load(path, device="cpu")
    assert t._dead == set(gone) and t.capacity == j.capacity == N
    extra = clustered(600, DIM, seed=9)
    t.insert(extra)          # 600 pending >= build_batch: flushed in 3 steps
    j.insert(extra)
    assert t.capacity == j.capacity == 2 * N and len(t) == len(j) == N + 600 - 4
    assert t._anchor_n == j._anchor_n == N
    st, js = t.state, j.state
    assert st.n == int(js.n) == N + 600
    np.testing.assert_array_equal(st.vectors.float().numpy(),
                                  np.asarray(js.vectors).astype(np.float32))
    np.testing.assert_allclose(st.norms.numpy(), np.asarray(js.norms), rtol=1e-6, atol=1e-6)
    # row cap is the scatters' trash row, which JAX's dropped writes fill
    tn, jn = st.nbrs.numpy()[:-1], np.asarray(js.nbrs)[:-1]
    differ = (tn != jn).any(1)
    if dtype == "int8":
        assert differ.sum() <= 0.01 * (N + 600), int(differ.sum())
    else:
        assert not differ.any(), np.flatnonzero(differ)[:10]
    same = ~differ
    np.testing.assert_allclose(st.dists.numpy()[:-1][same], np.asarray(js.dists)[:-1][same],
                               rtol=1e-5, atol=1e-5)
    for f in ("anchors", "a_norms", "a_rows"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)))
    q = np.concatenate([extra[:100], x[:100]]) + np.float32(0.01)
    _same(t.search(q, 10), j.search(q, 10))
    ids = t.search(q, 10)[1].numpy()
    assert not np.isin(ids, gone).any()
    hit = t.search(extra[:64], 1)[1].numpy()[:, 0] == N + np.arange(64)
    assert hit.mean() >= 0.9
