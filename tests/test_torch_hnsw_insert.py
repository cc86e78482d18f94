"""zvdb_tpu_torch's HNSW write path (insert, flush, the batched build) on the CPU, against the JAX package.

The batched step (index/build.py:build_batch_step) is fed what JAX's
build_batch_step is fed: the same carried state (JAX's, through
state_from_numpy), batch rows, levels, external ids and valid mask, at
precision="float32", batch after batch: the first (empty prefix), middle
ones and a padded last one, upper_beam True and False, l2 / cosine / dot
and f32 / bf16 / int8. nbr0, nbrU, levels and ext_ids must be equal
(the trash rows aside: JAX writes there in no set order); entry, max_level
and n too. Distances are held to rtol 1e-5 with atol 1e-4, the rounding of
||x||^2 - 2 q.x + ||q||^2 when both sides sum their products in another
order. int8 rows are multiples of one scale, so two candidates at exactly
the same distance in code space are common, and that rounding decides
between them (both packages' products sum in their own order); a tie
decided the other way changes that row's candidate pool and so, through
the diversity rule, other edges of the row. int8 edges are therefore
held to at most 1% differing (0.5% at most here), JAX's distances on the
rows whose ids agree, and (l2) the port's every edge real: its stored
distance equal to the one recomputed from the codes.

With both packages' sample_levels replaced by one numpy stream (test side
only), the port's insert path builds JAX's graph: a level-sorted batched
build, an insert that grows the capacity, and extend_graph from no state;
with JAX's anchors copied across, search returns JAX's ids. The rest mirrors
the JAX package's own tests of these paths (test_hnsw_contracts.py,
test_concurrent.py, test_anchor_refresh.py, test_delete.py,
test_persist.py, test_round2_fixes.py, test_reverse_hub.py,
test_diverse_rows.py) on the port, plus the repairs this path needed.

The gpu-marked test needs the card and skips without one; it imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hnsw_insert.py
"""
import dataclasses
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.index import build as TB
from zvdb_tpu_torch.index import hnsw as TH

CPU = "cpu"
N, DIM, B = 868, 16, 256      # 3 full batches and a padded one
TOL = dict(rtol=1e-5, atol=1e-4)
GRAPH_IDS = ("nbr0", "nbrU", "levels", "ext_ids")


def clustered(n, d, seed, nc=20, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


X = clustered(N, DIM, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_kw(**kw):
    return dict(dim=DIM, m=8, ef_construction=32, build_batch=B, precision="float32", **kw)


def port_index(seed=0, **kw):
    return ZT.HNSW(ZT.HNSWConfig(**{**dict(dim=DIM, m=8, ef_construction=32, build_batch=B),
                                    **kw}), seed=seed, device=CPU)


def self_hit(idx, q, want, ef=32):
    return float((idx.search(q, 1, ef_search=ef)[1].numpy()[:, 0] == want).mean())


def trimmed(f, a):
    """A state field without the adjacency tables' trash row."""
    if f in ("nbr0", "dist0"):
        return a[:-1]
    if f in ("nbrU", "distU"):
        return a[:, :-1]
    return a


def jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def edge_distances(codes, scale, nbr):
    """f64 squared l2 distance of every edge (row r -> nbr[r, j]) between
    the dequantized rows; nan for empty slots."""
    x = codes.astype(np.float64) * scale
    d = ((x[:nbr.shape[0], None, :] - x[np.maximum(nbr, 0)]) ** 2).sum(-1)
    return np.where(nbr >= 0, d, np.nan)


def assert_graph_equal(j, t, int8_metric=None):
    """j: JAX's state fields as numpy; t: the port's state. int8 states
    (int8_metric: their metric) are held up to exact code-space ties: at
    most 1% of edges differ, rows whose ids agree carry JAX's distances,
    and, for l2, every edge the port stores is real (its distance
    recomputed from the codes in f64). dot and cosine edges born of the
    intra-batch pool carry ||x||^2 beside -dot, as in JAX (its
    pairwise_scores takes the rows' squared norms as the bias there)."""
    same_rows = {}
    for f in GRAPH_IDS:
        a, b = trimmed(f, j[f]), trimmed(f, getattr(t, f).numpy())
        assert a.shape == b.shape, f
        diff = a != b
        if int8_metric is None or f in ("levels", "ext_ids"):
            assert not diff.any(), (f, np.argwhere(diff)[:5])
        else:
            assert diff.sum() <= 0.01 * ((a >= 0) | (b >= 0)).sum(), (f, diff.sum())
            same_rows[f] = ~diff.any(-1)
    for f, ids in (("dist0", "nbr0"), ("distU", "nbrU")):
        got, want = trimmed(f, getattr(t, f).numpy()), trimmed(f, j[f])
        keep = same_rows.get(ids, np.ones(got.shape[:-1], bool))
        np.testing.assert_allclose(got[keep], want[keep], **TOL, err_msg=f)
    if int8_metric == "l2":
        codes = t.vectors.numpy()
        for nbr, dist in ((t.nbr0.numpy()[:-1], t.dist0.numpy()[:-1]),
                          *zip(t.nbrU.numpy()[:, :-1], t.distU.numpy()[:, :-1])):
            d = edge_distances(codes, t.q_scale, nbr)
            ok = nbr >= 0
            np.testing.assert_allclose(dist[ok], d[ok], **TOL)
    for f in ("vectors", "norms"):
        np.testing.assert_allclose(getattr(t, f).float().numpy(), np.asarray(j[f], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    assert (t.entry, t.max_level, t.n) == (int(j["entry"]), int(j["max_level"]), int(j["n"]))
    assert t.q_scale == float(j["q_scale"])


# ---------------------------------------------------------------------------
# one batch step against JAX's, on JAX's carried state

STEP_CASES = [("l2", "float32", False), ("l2", "float32", True), ("cosine", "float32", False),
              ("dot", "float32", True), ("l2", "bfloat16", False), ("dot", "bfloat16", False),
              ("l2", "int8", False), ("cosine", "int8", True)]
LEVELS = np.minimum(np.floor(-np.log(np.random.default_rng(3).uniform(1e-9, 1, N))
                             / np.log(8)).astype(np.int32), 3)
_STEPS: dict = {}


def batch(t):
    """Batch t of X as the batched build pads it: (xb, lb, extb, valid)."""
    lo, hi = t * B, min((t + 1) * B, N)
    xb = np.zeros((B, DIM), np.float32)
    xb[:hi - lo] = X[lo:hi]
    lb = np.full(B, -1, np.int32)
    lb[:hi - lo] = LEVELS[lo:hi]
    eb = np.full(B, -1, np.int32)
    eb[:hi - lo] = np.arange(lo, hi)
    return xb, lb, eb, np.arange(B) < hi - lo


def jax_steps(metric, dtype, upper_beam):
    """JAX's states before and after each of the 4 batches (unsorted levels,
    so upper layers have work in every batch and the entry is promoted
    mid-way), once per case."""
    key = (metric, dtype, upper_beam)
    if key not in _STEPS:
        import jax.numpy as jnp

        import zvdb_tpu as ZJ
        from zvdb_tpu.index import build as JB
        from zvdb_tpu.index import hnsw as JH

        cfg = ZJ.HNSWConfig(**cfg_kw(metric=metric, dtype=dtype, upper_beam=upper_beam))
        st = JH.init_state(1024, cfg, 3)
        if dtype == "int8":   # bulk_build's scale, from the whole corpus
            xs = TB._prepared(X, metric)
            st = st._replace(q_scale=jnp.asarray(max(float(np.abs(xs).max()), 1e-12) / 127.0,
                                                 jnp.float32))
        states = [jax_arrays(st)]
        for t in range(4):
            st = JB.build_batch_step(st, *(jnp.asarray(a) for a in batch(t)), cfg, 3)
            states.append(jax_arrays(st))
        _STEPS[key] = states
    return _STEPS[key]


@pytest.mark.parametrize("t", [0, 1, 3], ids=["first", "middle", "padded_last"])
@pytest.mark.parametrize("metric,dtype,upper_beam", STEP_CASES)
def test_batch_step_matches_jax(metric, dtype, upper_beam, t):
    states = jax_steps(metric, dtype, upper_beam)
    cfg = ZT.HNSWConfig(**cfg_kw(metric=metric, dtype=dtype, upper_beam=upper_beam))
    st = TH.state_from_numpy(cfg, states[t], CPU)
    xb, lb, eb, vb = batch(t)
    assert (st.n == 0) == (t == 0)
    TB.build_batch_step(st, torch.from_numpy(xb), lb, eb, vb, cfg, 3)
    want = states[t + 1]
    assert_graph_equal(want, st, int8_metric=metric if dtype == "int8" else None)
    lo = t * B
    assert st.n == min(lo + B, N) and (want["levels"][lo:lo + B] >= 0).sum() == vb.sum()
    assert (st.nbr0.numpy()[lo:st.n] >= 0).any(1).all(), "a row of the batch has no edge"


# ---------------------------------------------------------------------------
# the insert path with injected levels, against JAX


def level_stream():
    """One numpy stream of levels standing in for both packages'
    sample_levels (their own draws differ by design)."""
    rng = np.random.default_rng(11)

    def sample_levels(key, n, m, levels_cap, ml):
        u = rng.uniform(1e-9, 1.0, n)
        return np.clip(np.floor(-np.log(u) / np.log(m)), 0, levels_cap).astype(np.int32)

    return sample_levels


_E2E: dict = {}


def insert_pair():
    """(JAX index, port index, [(stage, JAX state arrays, port state
    copy)]): a level-sorted batched build over X[:600], then one insert of
    the other 268 rows, which grows the capacity 768 -> 1536. Both with
    seed_anchors=0: the port's flush then seeds its beams from the descent
    alone, as JAX's does."""
    if "pair" not in _E2E:
        import zvdb_tpu as ZJ
        from zvdb_tpu.index import build as JB

        kw = cfg_kw(build_mode="batched")
        jidx = ZJ.HNSW(ZJ.HNSWConfig(**kw), ZJ.SearchConfig(seed_anchors=0), seed=1)
        tidx = ZT.HNSW(ZT.HNSWConfig(**kw), ZT.SearchConfig(seed_anchors=0), seed=1,
                       device=CPU)
        stages = []
        with mock.patch.object(JB, "sample_levels", level_stream()), \
                mock.patch.object(TB, "sample_levels", level_stream()):
            for step in ("build", "insert"):
                for idx in (jidx, tidx):
                    if step == "build":
                        idx.build(X[:600])
                    else:
                        idx.insert(X[600:])
                stages.append((step, jax_arrays(jidx.state), snapshot(tidx.state),
                               jidx.capacity, tidx.capacity))
        _E2E["pair"] = jidx, tidx, stages
    return _E2E["pair"]


def snapshot(state):
    """A copy of a port state (later flushes update tensors in place)."""
    return dataclasses.replace(state, **{
        f: getattr(state, f).clone() for f in TH.FIELDS if f not in TH._HOST_FIELDS})


def copy_anchors(jidx, tidx):
    """JAX's anchor table into the port's state (each package draws its own)."""
    for f in ("anchors", "a_norms", "a_rows"):
        setattr(tidx.state, f, torch.from_numpy(np.array(getattr(jidx.state, f))))


@pytest.mark.parametrize("step", ["build", "insert"])
def test_insert_path_matches_jax(step):
    jidx, tidx, stages = insert_pair()
    _, want, got, jcap, tcap = stages[("build", "insert").index(step)]
    assert tcap == jcap == (768 if step == "build" else 1536)
    for f in GRAPH_IDS:
        np.testing.assert_array_equal(trimmed(f, getattr(got, f).numpy()), trimmed(f, want[f]),
                                      err_msg=f)
    np.testing.assert_allclose(trimmed("dist0", got.dist0.numpy()), trimmed("dist0", want["dist0"]),
                               **TOL)
    assert (got.entry, got.max_level, got.n) == (int(want["entry"]), int(want["max_level"]),
                                                 int(want["n"]))
    if step == "build":   # rows in level-descending order; ext ids their positions in x
        lv = got.levels.numpy()[:600]
        assert (np.diff(lv) <= 0).all() and lv[0] == got.max_level and got.entry == 0
        assert sorted(got.ext_ids.numpy()[:600]) == list(range(600))


@pytest.mark.parametrize("seed_anchors", [0, 16])
def test_search_after_insert_matches_jax(seed_anchors):
    import zvdb_tpu as ZJ

    jidx, tidx, _ = insert_pair()
    assert len(tidx) == len(jidx) == N and tidx.levels_cap == jidx.levels_cap
    copy_anchors(jidx, tidx)
    jidx.search_cfg = ZJ.SearchConfig(seed_anchors=seed_anchors)
    tidx.search_cfg = ZT.SearchConfig(seed_anchors=seed_anchors)
    q = (X[::4] + 0.05 * np.random.default_rng(5).standard_normal((217, DIM))).astype(np.float32)
    for ef in (16, 48):
        got = tidx.search(q, 10, ef_search=ef)
        want = jidx.search(q, 10, ef_search=ef)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert self_hit(tidx, X[600:], np.arange(600, N)) >= 0.97


def test_flush_seeds_beams_with_anchors():
    """A flush into a built index seeds each base beam with the descent's
    row and the top SearchConfig.seed_anchors anchors, as search does (JAX:
    the descent alone, seed_anchors=0). Two far groups with every edge
    between them cut: the descent cannot leave the entry's group, so rows
    inserted near the other one get their edges in the wrong group, and
    nothing of their own group links to them; the anchors span both."""
    rng = np.random.default_rng(0)
    centers = np.zeros((2, DIM), np.float32)
    centers[1] = 10.0
    grp = np.repeat([0, 1, 0, 1], [800, 800, 100, 100])   # built rows, then the inserts
    x = (centers[grp] + rng.standard_normal((grp.size, DIM))).astype(np.float32)
    cfg = ZT.HNSWConfig(dim=DIM, m=8, ef_construction=32, build_batch=B)
    built = ZT.HNSW(cfg, seed=3, device=CPU)
    built.build(x[:1600])
    st = built.state
    for nbr, dist in ((st.nbr0, st.dist0), *zip(st.nbrU, st.distU)):
        nb = nbr[:1600].numpy()
        cross = (nb >= 0) & (grp[np.maximum(nb, 0)] != grp[:1600, None])
        nb[cross] = -1
        dist[:1600].numpy()[cross] = np.inf
    far = 1 - grp[st.entry]   # the group the descent cannot reach
    arrays = TH.state_to_numpy(st)
    for sa in (0, 16):   # the same graph, each flush from its own copy
        idx = ZT.HNSW.from_numpy(cfg, arrays, ZT.SearchConfig(seed_anchors=sa), device=CPU)
        idx.insert(x[1600:])
        idx.flush()
        idx.search_cfg = ZT.SearchConfig()
        rows = np.arange(1600, 1800)
        hit = idx.search(x[rows], 1, ef_search=32)[1].numpy()[:, 0] == rows
        fwd = idx.state.nbr0.numpy()[rows, :8]
        wrong = ((fwd >= 0) & (grp[np.maximum(fwd, 0)] != grp[rows, None])).sum(1)
        in_far = grp[rows] == far
        assert hit[~in_far].all() and not wrong[~in_far].any()
        if sa:
            assert hit.all() and not wrong.any()
        else:
            assert hit[in_far].mean() <= 0.8 and (wrong[in_far] > 0).mean() >= 0.5, (
                hit[in_far].mean(), (wrong[in_far] > 0).mean())


def test_extend_graph_from_none_matches_jax():
    """No state yet: a level-sorted bulk_build at capacity max(n, 1024),
    external ids shifted to ext_id_start."""
    import jax

    import zvdb_tpu as ZJ
    from zvdb_tpu.index import build as JB

    kw = cfg_kw()
    with mock.patch.object(JB, "sample_levels", level_stream()), \
            mock.patch.object(TB, "sample_levels", level_stream()):
        js, jcap = JB.extend_graph(None, 0, 4, X[:300], ZJ.HNSWConfig(**kw),
                                   jax.random.PRNGKey(0), ext_id_start=7)
        ts, tcap = TB.extend_graph(None, 0, 4, X[:300], ZT.HNSWConfig(**kw),
                                   torch.Generator().manual_seed(0), ext_id_start=7,
                                   device=CPU)
    assert tcap == jcap == 1024 and ts.nbrU.shape[0] == js.nbrU.shape[0]
    want = jax_arrays(js)
    for f in GRAPH_IDS:
        np.testing.assert_array_equal(trimmed(f, getattr(ts, f).numpy()), trimmed(f, want[f]),
                                      err_msg=f)
    assert sorted(ts.ext_ids.numpy()[:300]) == list(range(7, 307))
    assert (ts.entry, ts.max_level, ts.n) == (int(js.entry), int(js.max_level), 300)


# ---------------------------------------------------------------------------
# the reference's contracts (JAX test_hnsw_contracts.py), on the port


def test_basic_functionality():
    idx = port_index(dim=3)
    for p in ([1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]):
        idx.insert(p)
    assert len(idx) == 3 and idx.state is None   # buffered until a read
    s, i = idx.search(np.array([3.0, 4.0, 5.0], np.float32), 2)
    s, i = s.numpy(), i.numpy()
    assert (i >= 0).all() and s[0] <= s[1] and set(i.tolist()) == {0, 1}


def test_single_point_and_memory_model():
    idx = port_index(dim=4)
    p = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    idx.insert(p)
    p[:] = 99.0   # the caller's buffer changes after the insert
    s, i = idx.search(np.array([1.0, 2.0, 3.0, 4.0], np.float32), 1)
    assert int(i[0]) == 0 and float(s[0]) < 1e-6
    t = torch.ones(4)
    idx.insert(t)   # a tensor is copied too
    t[:] = 5.0
    assert float(idx.search(torch.ones(4), 1)[0][0]) < 1e-6
    with pytest.raises(ValueError, match="dimension mismatch"):
        idx.insert(np.ones(3, np.float32))


def test_duplicates_and_k_greater_than_n():
    idx = port_index(dim=2)
    for p in ([1.0, 1.0], [1.0, 1.0], [2.0, 2.0]):
        idx.insert(p)
    s, i = idx.search(np.array([1.0, 1.0], np.float32), 5)
    i = i.numpy()
    assert len(i[i >= 0]) == 3 and {0, 1} <= set(i[i >= 0].tolist()) and (i[3:] == -1).all()


def test_incremental_matches_batch_semantics():
    idx = port_index(dim=DIM)
    idx.insert(X[:100])
    for r in X[100:110]:
        idx.insert(r)
    idx.insert(X[110:600])
    assert len(idx) == 600
    assert int(idx.search(X[105], 1, ef_search=64)[1][0]) == 105
    assert self_hit(idx, X[:600], np.arange(600), ef=64) >= 0.97


def test_deterministic_batched_build_under_fixed_seed():
    x = X[:512]
    a, b = (port_index(seed=7, build_mode="batched") for _ in range(2))
    a.build(x)
    b.build(x)
    for f in ("nbr0", "dist0", "nbrU", "levels", "ext_ids", "a_rows"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    c = port_index(seed=8, build_mode="batched")
    c.build(x)
    assert not torch.equal(a.state.levels, c.state.levels)
    # a tensor corpus, padded on its device, builds what its numpy copy builds
    d = port_index(seed=7, build_mode="batched")
    d.build(torch.from_numpy(x))
    assert torch.equal(d.state.nbr0, a.state.nbr0) and torch.equal(d.state.nbrU, a.state.nbrU)
    assert self_hit(a, X[:300], np.arange(300)) >= 0.97


def test_concurrent_inserts():
    """8 threads x 250 single-row inserts: every row present once."""
    idx = port_index(dim=8)
    data = np.random.default_rng(0).standard_normal((8, 250, 8)).astype(np.float32)
    errs = []

    def worker(t):
        try:
            for row in data[t]:
                idx.insert(row)
        except Exception as e:  # noqa: BLE001 - the test reports it
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errs and not any(th.is_alive() for th in threads)
    assert len(idx) == 2000
    idx.flush()
    ext = idx.state.ext_ids.numpy()
    assert idx.state.n == 2000 and sorted(ext[ext >= 0]) == list(range(2000))
    assert (idx.search(data[0, 0], 5)[1].numpy() >= 0).all()


def test_search_during_insert():
    """2 writers add 64-row requests while 4 readers search and one thread
    removes 2 ids (JAX test_concurrent.py): no error, every answer valid,
    nothing lost afterwards."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1200, DIM)).astype(np.float32)
    idx = port_index()
    idx.build(x[:800])
    q = x[:8] + 0.01
    errs, seen, stop = [], [], threading.Event()

    def writer(part):
        try:
            for lo in range(0, part.shape[0], 64):
                idx.add(part[lo:lo + 64])
        except Exception as e:  # noqa: BLE001
            errs.append(("writer", e))

    def reader():
        try:
            while not stop.is_set():
                s, i = idx.search(q, 5)
                s, i = s.numpy(), i.numpy()
                assert s.shape == (8, 5) and (i >= -1).all() and np.isfinite(s[i >= 0]).all()
                seen.append(i)
        except Exception as e:  # noqa: BLE001
            errs.append(("reader", e))

    def remover():
        try:
            idx.remove([10, 11])
        except Exception as e:  # noqa: BLE001
            errs.append(("remover", e))

    ws = [threading.Thread(target=writer, args=(h,)) for h in np.array_split(x[800:], 2)]
    rs = [threading.Thread(target=reader) for _ in range(4)]
    rm = threading.Thread(target=remover)
    for th in rs + ws + [rm]:
        th.start()
    for th in ws + [rm]:
        th.join(timeout=300)
    stop.set()
    for th in rs:
        th.join(timeout=300)
    assert not errs, errs
    assert seen and not any(th.is_alive() for th in rs + ws + [rm])
    assert len(idx) == 1200 - 2
    s, _ = idx.search(x[-32:], 1, allowed=np.arange(1200))   # exact scan: nothing lost
    assert s.numpy().max() < 1e-3


def test_anchor_refresh_at_10x_growth():
    x = clustered(3300, DIM, seed=12, nc=30, spread=0.12)
    idx = port_index(build_batch=512)
    idx.build(x[:300])
    assert idx._anchor_n == 300
    idx.insert(x[300:])
    idx.flush()
    assert int(idx.state.a_rows.max()) >= 300 and idx._anchor_n == 3300
    tail = np.arange(3000, 3300)
    assert self_hit(idx, x[tail], tail, ef=48) >= 0.85


def test_insert_after_remove_and_compact():
    """At "float32", as JAX computes on the CPU: at "high" (bf16x3, ~16
    significant bits an operand) the 1.6e-5 between a row and its +0.001
    copy is below the scores' resolution at these norms (~1e-4)."""
    x = clustered(2000, DIM, seed=8)
    idx = port_index(m=16, ef_construction=64, precision="float32")
    idx.build(x)
    dead = list(range(0, 200, 2))
    assert idx.remove(dead) == 100 and len(idx) == 1900
    idx.insert(x[:2] + 0.001)   # ids continue past the high-water mark
    assert set(idx.search(x[:2] + 0.001, 1, ef_search=32)[1].numpy()[:, 0]) == {2000, 2001}
    ids = idx.search(x[:200], 5, ef_search=32)[1].numpy()
    assert not np.isin(ids, dead).any()
    old = idx.compact()
    assert old.size == 1902 and len(idx) == 1902
    idx.insert(x[:4] + 0.002)   # after compact: from the new count
    assert len(idx) == 1906
    got = idx.search(x[:4] + 0.002, 1, ef_search=32)[1].numpy()[:, 0]
    assert set(got) == {1902, 1903, 1904, 1905}


def test_remove_all_then_compact_then_insert():
    x = np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32)
    idx = port_index(dim=8, ef_construction=16)
    idx.build(x)
    idx.remove(list(range(200)))
    assert len(idx) == 0 and (idx.search(x[:4], 3)[1].numpy() == -1).all()
    assert idx.compact().size == 0 and (idx.search(x[:4], 3)[1].numpy() == -1).all()
    idx.insert(x[:5])
    assert (idx.search(x[:5], 1)[1].numpy()[:, 0] == np.arange(5)).all()


def test_insert_after_load(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    idx = ZT.HNSW(ZT.HNSWConfig(dim=24, m=8, ef_construction=48, build_batch=512), device=CPU)
    idx.build(x)
    idx.insert(x[:3] + 0.01)   # saved after a flush
    path = str(tmp_path / "index.npz")
    idx.save(path)
    loaded = ZT.HNSW.load(path, device=CPU)
    assert len(loaded) == 1503 and loaded._anchor_n == 1503
    q = rng.standard_normal((16, 24)).astype(np.float32)
    assert torch.equal(loaded.search(q, 5)[1], idx.search(q, 5)[1])
    loaded.insert(rng.standard_normal(24).astype(np.float32))
    assert len(loaded) == 1504
    assert int(loaded.search(x[1] + 0.01, 1)[1][0]) == 1501


def test_int8_insert_self_hit():
    x = clustered(2000, DIM, seed=71)
    idx = port_index(dtype="int8", build_batch=512)
    idx.build(x)
    scale = idx.state.q_scale
    extra = clustered(100, DIM, seed=72)
    idx.insert(extra)
    idx.flush()
    assert idx.state.q_scale == scale   # later batches clip to the build's scale
    assert self_hit(idx, extra[:32], 2000 + np.arange(32), ef=48) >= 0.85
    np.testing.assert_allclose(idx.get([2000]), [np.clip(extra[0] / scale, -127, 127).round()
                                                 * scale], rtol=1e-6)


def test_hub_insert_bounded():
    """One hub every row picks (JAX test_reverse_hub.py): the reverse-edge
    window drops excess reverse edges per batch; search stays right."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1500, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= (1.0 + 0.01 * rng.standard_normal((1500, 1))).astype(np.float32)
    x[0] = 0.0
    idx = port_index(dim=96, ef_construction=48)
    idx.build(x[:500])
    idx.insert(x[500:])
    assert int(idx.search(x[:1], 1)[1][0, 0]) == 0
    assert self_hit(idx, x[600:700], np.arange(600, 700), ef=48) >= 0.9
    assert (idx.state.nbr0.numpy()[0] >= 0).sum() >= 12


def test_batched_diverse_rows_help_truncation():
    """JAX test_diverse_rows.py at 2000 x 32d (20 clusters; JAX's: 10000,
    100): with descent-only seeding, a truncated-degree search needs the
    diversity-first rows of the batched build; full rows do not care;
    anchors rescue the plain rows."""
    x = clustered(2000, 32, seed=1, nc=20, spread=0.15)
    rng = np.random.default_rng(0)
    q = (x[rng.integers(0, 2000, 200)] + 0.05 * rng.standard_normal((200, 32))).astype(np.float32)
    from zvdb_tpu_torch.index.flat import exact_ground_truth

    gt = exact_ground_truth(x, q, 10, device=CPU)[1]

    def recall(idx, sd, anchors=0):
        idx.search_cfg = ZT.SearchConfig(search_degree=sd, seed_anchors=anchors)
        ids = idx.search(q, 10, ef_search=64)[1].numpy()
        return np.mean([len(set(ids[r]) & set(gt[r])) / 10 for r in range(200)])

    kw = dict(dim=32, m=8, ef_construction=64, build_batch=512, build_mode="batched")
    plain = ZT.HNSW(ZT.HNSWConfig(**kw, diverse_rows=False), device=CPU)
    plain.build(x)
    # what the build runs last with diverse_rows=True, on a copy: one build, not two
    div = ZT.HNSW.from_numpy(ZT.HNSWConfig(**kw, diverse_rows=True),
                             TH.state_to_numpy(plain.state), device=CPU)
    TB.reorder_rows_diverse(div.state, div.cfg)
    assert abs(recall(plain, None) - recall(div, None)) < 0.05
    r_plain, r_div = recall(plain, 8), recall(div, 8)
    assert r_div > r_plain + 0.05, (r_div, r_plain)
    assert recall(plain, 8, anchors=16) >= r_div - 0.05


# ---------------------------------------------------------------------------
# repairs of the engine's derived state


def test_flush_rebuilds_the_packed_table_and_keeps_tombstones():
    idx = port_index()
    idx.build(X[:600])
    idx.search(X[:4], 1)
    assert idx._packed_table is not None
    assert idx.remove([3, 5]) == 2
    idx.insert(X[600:])   # grows the capacity: 768 -> 1536
    assert idx.capacity == 1536 and idx._packed_table is None and idx._dead == {3, 5}
    assert idx._dead_rows.shape[0] == 1537 and idx._dead_rows[[3, 5]].all()
    assert int(idx._dead_rows.sum()) == 2
    assert self_hit(idx, X[600:], np.arange(600, N)) >= 0.97
    assert idx._packed_table.shape == (1536, DIM + 1)
    for mode in ("beam", "scan"):
        ids = idx.search(X[:8], 3, allowed=np.arange(N), filter_mode=mode)[1].numpy()
        assert not np.isin(ids, [3, 5]).any()
    assert len(idx) == N - 2


def test_len_counts_pending_rows():
    idx = port_index()
    idx.build(X[:300])
    idx.insert(X[300:400])
    assert idx.state.n == 300 and len(idx) == 400
    idx.remove([0])   # flushes first
    assert idx.state.n == 400 and len(idx) == 399
    idx.insert(X[400:410])
    assert len(idx) == 409
    np.testing.assert_array_equal(idx.get([405])[0], X[405])   # get flushes
    assert idx.state.n == 410


def test_greedy_and_beam_wrappers_match_jax():
    """_greedy_layer and beam_layer (the batched build's state scorers)
    on JAX's built state: the frozen-prefix beam ignores rows >= limit_n."""
    import jax.numpy as jnp

    from zvdb_tpu.index import hnsw as JH

    states = jax_steps("l2", "float32", False)
    arr = states[3]
    cfg = ZT.HNSWConfig(**cfg_kw())
    st = TH.state_from_numpy(cfg, arr, CPU)
    jst = JH.HNSWState(**{f: jnp.asarray(v) for f, v in arr.items()})
    q = X[:64] + 0.02
    ep = np.full(64, int(arr["entry"]), np.int32)
    ep_s = TH._scores_to(st, torch.from_numpy(q), torch.from_numpy(ep)[:, None], "l2",
                         "highest")[:, 0]
    for ell in (2, 1):
        want = JH._greedy_layer(jst, jnp.asarray(q), jnp.asarray(ep), jnp.asarray(ep_s.numpy()),
                                jst.nbrU[ell - 1], "l2", 32)
        got = TH._greedy_layer(st, torch.from_numpy(q), torch.from_numpy(ep), ep_s,
                               st.nbrU[ell - 1], "l2", 32, "highest")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        ep, ep_s = got[0].numpy(), got[1]
    for limit in (None, 300):
        want = JH.beam_layer(jst, jnp.asarray(q), jnp.asarray(ep)[:, None],
                             jnp.asarray(ep_s.numpy())[:, None], jst.nbr0, 24, "l2", expand=4,
                             limit_n=limit)
        got = TH.beam_layer(st, torch.from_numpy(q), torch.from_numpy(ep)[:, None],
                            ep_s[:, None], st.nbr0, 24, "l2", expand=4, limit_n=limit,
                            precision="highest")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        if limit:   # the seeds aside, no row past the prefix
            rows = got[1].numpy()
            assert ((rows < limit) | (rows == ep[:, None])).all()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_flush_on_the_card_launches_no_kernel(cuda_device):
    from zvdb_tpu_torch.ops import block_scan as BS
    from zvdb_tpu_torch.ops import flat_scan as FS
    from zvdb_tpu_torch.ops import pq_scan as PS
    from zvdb_tpu_torch.ops import scan_topk as ST

    def counts():
        return (FS.flat_scan_bins.launches, PS.pq_scan_bins.launches,
                PS.pq_grouped_scan_bins.launches, PS.pq_grouped_scan_pairs.launches,
                BS.block_bins.launches,
                ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches)

    x = clustered(20_000, 64, seed=1, nc=200, spread=0.15)
    idx = ZT.HNSW(ZT.HNSWConfig(dim=64, m=16, build_batch=4096))
    idx.build(x[:16_000])
    before = counts()
    idx.insert(x[16_000:])
    idx.flush()   # one batch of 4000 rows
    torch.cuda.synchronize()
    assert idx.state.n == 20_000 and counts() == before
    ids = idx.search(x[16_000:16_500], 1, ef_search=32)[1].cpu().numpy()[:, 0]
    assert (ids == np.arange(16_000, 16_500)).mean() >= 0.95
