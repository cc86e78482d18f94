"""zvdb_tpu_torch.index.knn_graph (the cluster-kNN graph build) against the
JAX package.

Each deterministic stage gets the same numpy inputs (seeded) in both packages
and must give the same ids: the assignment, both packs, the representatives
and chain, the block-kNN scatter for sel in {exact, binfold, pallas}, the
prune, the chain and long-range stamps (the long-range ids drawn once with
JAX's PRNG and handed to both), and the tiny-corpus graph. Products run at
precision="highest" against JAX's f32 CPU dots; sel="pallas" runs at "high"
in both (the JAX kernel in interpret mode, the port's plain version).
Distances agree within rtol 1e-5 (other summation orders).

The whole build draws from a torch.Generator, so it is held to its contract
instead: edge recall, connectivity, true edge distances, the device pack
equal to the host pack, and one seed one graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zvdb_tpu.index import knn_graph as JK
from zvdb_tpu_torch.bench.harness import ground_truth_host
from zvdb_tpu_torch.index import knn_graph as TK

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def clustered(n, d, seed, nc=50, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


def test_assign_spill():
    rng = np.random.default_rng(0)
    x = clustered(700, 16, seed=1)
    cent = x[rng.choice(700, 37, replace=False)] + 0.01
    xn, cn = (x * x).sum(1), (cent * cent).sum(1)
    ta, ts = TK._assign_spill(_t(x), _t(xn), _t(cent), _t(cn), 2, "l2", tile=256,
                              precision="highest")
    ja, js = JK._assign_spill(jnp.asarray(x), jnp.asarray(xn), jnp.asarray(cent),
                              jnp.asarray(cn), 2, "l2", tile=256)
    np.testing.assert_array_equal(_np(ta), _np(ja))
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    assert ta.dtype == torch.int32


def _padded_pack(bp, bo, nm, morder, bcap):
    """Append the presence-overflow blocks as _build_steps does."""
    bp, bo, nm, morder = map(_np, (bp, bo, nm, morder))
    if nm > 0:
        rows = -(-int(nm) // bcap)
        extra = np.full((rows, bcap), -1, np.int32)
        extra.reshape(-1)[:nm] = morder[:nm]
        bp = np.concatenate([bp, extra])
        bo = np.concatenate([bo, np.zeros((rows, bcap), np.int32)])
    return bp, bo


@pytest.mark.parametrize("seed,n,c,bcap", [(0, 5000, 37, 160), (3, 997, 11, 96)])
def test_pack_core_and_pack_blocks(seed, n, c, bcap):
    # the parameters of tests/test_device_pack.py: cluster 0 overflows, so
    # some points are missing from every block
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, c, (n, 2)).astype(np.int32)
    assign[: n // 3, 0] = 0
    t_core = TK._pack_core(_t(assign), c, bcap, 2)
    j_core = JK._pack_core(jnp.asarray(assign), c, bcap, 2)
    for a, b in zip(t_core, j_core):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert int(t_core[2]) > 0
    hp, ho, hd = TK._pack_blocks(assign, c, bcap)
    jp, jo, jd = JK._pack_blocks(assign, c, bcap)
    np.testing.assert_array_equal(hp, jp)
    np.testing.assert_array_equal(ho, jo)
    assert hd == jd
    dp, do = _padded_pack(*t_core, bcap)   # device pack == host pack
    np.testing.assert_array_equal(dp, hp)
    np.testing.assert_array_equal(do, ho)


def test_reps_chain_device():
    rng = np.random.default_rng(5)
    c, n = 40, 900
    assign0 = rng.integers(0, c - 3, n).astype(np.int32)   # the last 3 clusters empty
    assign0[17] = c - 5                                     # ...and singletons
    s0 = rng.integers(0, 30, n).astype(np.float32)          # coarse: ties in the order
    tr, tc = TK._reps_chain_device(_t(assign0), _t(s0), c, 4)
    jr, jc = JK._reps_chain_device(jnp.asarray(assign0), jnp.asarray(s0), c, 4)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_array_equal(_np(tc), _np(jc))
    hr, hc = TK._reps_chain_host(assign0, s0, c, 4)
    np.testing.assert_array_equal(hr, _np(jr))
    np.testing.assert_array_equal(hc, _np(jc))


def _blocks(rng, n, cc, bcap):
    """cc blocks of distinct points, -1 tails; block c writes lane c + 1."""
    bp = np.full((cc, bcap), -1, np.int32)
    for c in range(cc):
        m = bcap - 7 * c
        bp[c, :m] = rng.choice(n, m, replace=False)
    bo = np.broadcast_to(np.arange(cc, dtype=np.int32)[:, None], (cc, bcap)).copy()
    return bp, bo


@pytest.mark.parametrize("sel,metric", [("exact", "l2"), ("binfold", "l2"), ("pallas", "l2"),
                                        ("pallas", "dot"), ("exact", "dot")])
def test_block_knn_scatter(sel, metric):
    rng = np.random.default_rng(len(sel) + len(metric))
    n, d, cc, bcap, kc, lanes = 500, 16, 3, 160, 16, 4
    x = clustered(n, d, seed=7, nc=12, spread=0.4)
    xn = (x * x).sum(1) if metric == "l2" else np.zeros(n, np.float32)
    bp, bo = _blocks(rng, n, cc, bcap)
    cs = np.full((n + 1, lanes, kc), np.inf, np.float32)
    ci = np.full((n + 1, lanes, kc), -1, np.int32)
    ts, ti = TK._block_knn_scatter(_t(x), _t(xn), _t(bp), _t(bo), 1, _t(cs.copy()),
                                   _t(ci.copy()), kc, metric, sel=sel, precision="highest")
    js, ji = JK._block_knn_scatter(jnp.asarray(x), jnp.asarray(xn), jnp.asarray(bp),
                                   jnp.asarray(bo), jnp.asarray(1, jnp.int32), jnp.asarray(cs),
                                   jnp.asarray(ci), kc, metric, sel=sel)
    # row n is the trash row (invalid slots write there in any order)
    np.testing.assert_array_equal(_np(ti)[:n], _np(ji)[:n])
    np.testing.assert_allclose(_np(ts)[:n], _np(js)[:n], **TOL)
    assert (_np(ti)[:n, 1:] >= 0).sum() > 0 and (_np(ti)[:n, 0] == -1).all()


def test_prune_chunk():
    rng = np.random.default_rng(8)
    n, d = 600, 16
    x = clustered(n, d, seed=9, nc=10, spread=0.3)
    xn = (x * x).sum(1)
    rows = np.arange(100, 164)
    cand = rng.integers(0, n, (64, 48)).astype(np.int32)
    cand[:, 5] = cand[:, 3]                                 # duplicates to drop
    cand[rng.random(cand.shape) < 0.1] = -1
    dots = np.einsum("rd,rcd->rc", x[rows], x[np.maximum(cand, 0)])
    cs = np.where(cand >= 0, xn[np.maximum(cand, 0)] - 2 * dots, np.inf).astype(np.float32)
    for cap in (0, 32):
        ts, td = TK._prune_chunk(_t(x), _t(xn), _t(rows), _t(cs), _t(cand), 1.2, 16, "l2",
                                 prune_cap=cap, precision="highest")
        js, jd = JK._prune_chunk(jnp.asarray(x), jnp.asarray(xn), jnp.asarray(rows),
                                 jnp.asarray(cs), jnp.asarray(cand), jnp.float32(1.2), 16, "l2",
                                 prune_cap=cap)
        np.testing.assert_array_equal(_np(ts), _np(js))
        np.testing.assert_allclose(_np(td), _np(jd), **TOL)


def _tables(rng, n, deg):
    nbrs = rng.integers(0, n, (n + 1, deg)).astype(np.int32)
    nbrs[n] = -1
    dists = rng.random((n + 1, deg)).astype(np.float32)
    dists[n] = np.inf
    return nbrs, dists


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_stamp_chain_and_long_edges(metric):
    rng = np.random.default_rng(10)
    n, d, deg, n_long = 300, 16, 12, 4
    x = clustered(n, d, seed=11)
    xn = (x * x).sum(1) if metric == "l2" else np.zeros(n, np.float32)
    nbrs, dists = _tables(rng, n, deg)
    succ = rng.integers(0, n, n).astype(np.int32)
    succ[rng.random(n) < 0.2] = -1
    tn, td = TK._stamp_chain_edges(_t(x), _t(xn), _t(nbrs.copy()), _t(dists.copy()), _t(succ),
                                   metric, slot=deg - n_long - 1)
    jn, jd = JK._stamp_chain_edges(jnp.asarray(x), jnp.asarray(xn), jnp.asarray(nbrs),
                                   jnp.asarray(dists), jnp.asarray(succ), metric,
                                   slot=deg - n_long - 1)
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_allclose(_np(td), _np(jd), **TOL)

    key = jax.random.PRNGKey(3)
    ids = np.asarray(jax.random.randint(key, (n, n_long), 0, n, jnp.int32))
    tn, td = TK._stamp_long_edges(_t(x), _t(xn), _t(nbrs.copy()), _t(dists.copy()), _t(ids),
                                  metric, precision="highest")
    jn, jd = JK._stamp_long_edges(jnp.asarray(x), jnp.asarray(xn), jnp.asarray(nbrs),
                                  jnp.asarray(dists), key, n_long, metric)
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_allclose(_np(td), _np(jd), **TOL)
    assert (_np(tn)[:n, -n_long:] != np.arange(n)[:, None]).all()   # no self-edges


@pytest.mark.parametrize("n,degree,metric", [(25, 16, "l2"), (10, 16, "l2"), (20, 8, "dot")])
def test_tiny_graph(n, degree, metric):
    x = clustered(n, 8, seed=n)
    xn = (x * x).sum(1) if metric == "l2" else np.zeros(n, np.float32)
    out_t = TK._tiny_graph(_t(x), _t(xn), n, degree, metric, precision="highest")
    out_j = JK._tiny_graph(jnp.asarray(x), jnp.asarray(xn), n, degree, metric)
    np.testing.assert_array_equal(_np(out_t[0]), _np(out_j[0]))
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


# ---------------------------------------------------------------------------
# the whole build, by contract


@pytest.fixture(scope="module")
def corpus():
    return clustered(3000, 16, seed=1)


@pytest.mark.parametrize("block_topk", ["exact", "binfold", "pallas", "approx"])
def test_build_edge_recall_and_connectivity(corpus, block_topk):
    # test_cagra.py's contract, at 3000 x 16d
    x = corpus
    n = x.shape[0]
    nbrs, dists, cent, cn, c_rows = TK.build_knn_graph(
        x, 32, torch.Generator().manual_seed(0), block_topk=block_topk, kc_per_view=16,
        prune_cap=64, device="cpu")
    assert nbrs.shape == (n + 1, 32) and nbrs.dtype == torch.int32
    nb = nbrs.numpy()[:n]
    _, gt = ground_truth_host(x, x, 11)
    gt = gt[:, 1:]
    hit = np.mean([len(set(nb[i]) & set(gt[i])) / 10 for i in range(0, n, 10)])
    assert hit >= 0.90, f"edge 10-NN recall {hit:.3f}"
    assert ((nb >= 0).sum(1) > 0).all(), "no isolated nodes"
    assert (nb != np.arange(n)[:, None]).all(), "no self-edges"
    assert c_rows.dim() == 2 and int(c_rows.max()) < n
    # stored edge distances are true squared L2 of the endpoints
    for i in (5, 777, 2999):
        for s in (0, 20, 31):
            j = int(nb[i, s])
            want = float(((x[i] - x[j]) ** 2).sum())
            np.testing.assert_allclose(float(dists[i, s]), want, rtol=1e-3, atol=1e-4)
    assert (nbrs.numpy()[n] == -1).all()


def test_device_pack_graph_identical():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    g_dev = TK.build_knn_graph(x, 16, torch.Generator().manual_seed(7), block=256,
                               pack="device", device="cpu")
    g_host = TK.build_knn_graph(x, 16, torch.Generator().manual_seed(7), block=256,
                                pack="host", device="cpu")
    for a, b in zip(g_dev, g_host):
        assert torch.equal(a, b)
    # one seed, one graph
    again = TK.build_knn_graph(x, 16, torch.Generator().manual_seed(7), block=256, device="cpu")
    assert torch.equal(again[0], g_dev[0])


def test_segments_build(corpus):
    # the upload-overlap path: pass 0 clusters on the first segment
    x = corpus
    segs = [_t(x[i:i + 700]) for i in range(0, 3000, 700)]
    nbrs, *_ = TK.build_knn_graph(None, 16, torch.Generator().manual_seed(2), segments=segs)
    nb = nbrs.numpy()[:3000]
    _, gt = ground_truth_host(x, x, 6)
    hit = np.mean([len(set(nb[i]) & set(gt[i, 1:])) / 5 for i in range(0, 3000, 10)])
    assert hit >= 0.90, hit
    assert ((nb >= 0).sum(1) > 0).all()
    tiny = TK.build_knn_graph(None, 16, torch.Generator(), segments=[_t(x[:10]), _t(x[10:20])])
    assert tiny[0].shape == (21, 16) and bool((tiny[0][:20] >= 0).all())
