"""zvdb_tpu_torch's ShardedHNSW on the CPU, against the JAX package.

parallel/sharded.py and parallel/scan_filter.py.

JAX builds one ShardedHNSW (2000 x 16d clustered rows, m=8, build_batch=256,
precision="float32", 4 shards on 4 of tests/conftest.py's virtual CPU
devices) and saves it; the port loads the file onto make_mesh(n_shards=4,
devices=["cpu"]), so both search the same per-shard graphs, anchors and
entry points. At "float32" both compute f32 products summed in other
orders, so ids must be equal up to near-ties (`same`: a differing id ties
another of its row within 1e-5 of the score scale, at most 1% of ids) and
scores within rtol 1e-5 / atol 1e-4: unfiltered, after remove, and with
allowed= in "scan" (the sharded masked scan) and "beam" modes. An insert
of 300 rows across a capacity growth, with both packages' sample_levels
replaced by one numpy stream and the port's flush seeded from the descent
alone (seed_anchors=0, JAX's path), leaves JAX's per-shard graphs (f32,
and int8 built by JAX at its sharded build's q_scale of 1.0). The port's
own sharded build is held to the port's single-chip HNSW at a saturating
ef (tests/test_sharded_equivalence.py's rule) and to recall@10 >= 0.9 on a
(data=2, shard=4) mesh (tests/test_sharded_round2.py's).
"""
import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.parallel import sharded as JS
from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh
from zvdb_tpu_torch.bench.harness import recall_at_k
from zvdb_tpu_torch.index.flat import exact_ground_truth
from zvdb_tpu_torch.parallel import sharded as TS
from zvdb_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, K = 2000, 16, 10
GRAPH_IDS = ("nbr0", "nbrU", "levels", "ext_ids")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


X = clustered(N + 300, DIM, seed=1)
_rng = np.random.default_rng(2)
Q = (X[_rng.integers(0, N, 64)] + 0.05 * _rng.standard_normal((64, DIM))).astype(np.float32)


def cfg_kw(**kw):
    return dict(dim=DIM, m=8, ef_construction=32, build_batch=256, precision="float32", **kw)


def port_mesh(n_data=1):
    return make_mesh(n_shards=4, n_data=n_data, devices=["cpu"])


_SAVED: dict = {}


def jax_saved(tmp_path_factory, dtype="float32"):
    """The path of JAX's saved ShardedHNSW over X[:N] (built once per dtype)."""
    if dtype not in _SAVED:
        j = JS.ShardedHNSW(ZJ.HNSWConfig(**cfg_kw(dtype=dtype)), mesh=jax_mesh(n_shards=4))
        j.build(X[:N])
        path = str(tmp_path_factory.mktemp("jax") / f"sharded_{dtype}.npz")
        j.save(path)
        _SAVED[dtype] = path
    return _SAVED[dtype]


def loaded(path):
    """(JAX index, port index), both fresh from one save file."""
    return (JS.ShardedHNSW.load(path, mesh=jax_mesh(n_shards=4)),
            ZT.ShardedHNSW.load(path, mesh=port_mesh()))


def same(t, j, max_share=0.01):
    """Scores equal within TOL slot by slot; ids equal except where a result
    ties another of its row (or is the k-th) within 1e-5 of the score scale,
    at most max_share of the ids."""
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


def test_carried_search_equals_jax(tmp_path_factory):
    j, t = loaded(jax_saved(tmp_path_factory))
    assert (t.levels_cap, t.shard_cap, t._n, t.n_shards) == (j.levels_cap, j.shard_cap, N, 4)
    assert [st.entry for st in t.state] == list(np.asarray(j.state.entry))
    assert t.state[0].anchors.shape == (512, DIM)   # min(2^10, the shard capacity)
    for ef in (16, 64):
        same(t.search(Q, K, ef_search=ef), j.search(Q, K, ef_search=ef))
    # one query as a vector: a [1, k] result, as JAX's atleast_2d gives
    same(t.search(Q[0], 5), j.search(Q[0], 5))


def test_carried_search_after_remove_and_allowed(tmp_path_factory):
    j, t = loaded(jax_saved(tmp_path_factory))
    dead = np.unique(np.argmin(((Q[:8, None] - X[None, :N]) ** 2).sum(-1), axis=1))
    assert t.remove(dead) == j.remove(dead) == dead.size
    assert t.remove(dead[:2]) == 0 and len(t) == len(j) == N - dead.size
    got = t.search(Q, K, ef_search=32)
    same(got, j.search(Q, K, ef_search=32))
    assert not np.isin(got[1].numpy(), dead).any()
    mask = np.zeros(N, bool)
    mask[::3] = True
    id_list = np.flatnonzero(np.arange(N) % 5 == 1)
    for allowed in (mask, id_list):
        for mode in ("scan", "beam", "auto"):
            got = t.search(Q, K, ef_search=48, allowed=allowed, filter_mode=mode)
            same(got, j.search(Q, K, ef_search=48, allowed=allowed, filter_mode=mode))
            ids = got[1].numpy()
            assert np.isin(ids[ids >= 0], np.flatnonzero(mask) if allowed is mask
                           else id_list).all() and not np.isin(ids, dead).any()
    with pytest.raises(ValueError, match="filter_mode"):
        t.search(Q, K, allowed=mask, filter_mode="probe")
    with pytest.raises(IndexError):
        t.remove([N])


def level_stream():
    """One numpy stream of levels standing in for both packages'
    sample_levels (their own draws differ by design)."""
    rng = np.random.default_rng(11)

    def sample_levels(key, n, m, levels_cap, ml):
        u = rng.uniform(1e-9, 1.0, n)
        return np.clip(np.floor(-np.log(u) / np.log(m)), 0, levels_cap).astype(np.int32)

    return sample_levels


def trimmed(f, a):
    """A field without the adjacency tables' trash row."""
    return a[:-1] if f == "nbr0" or f == "dist0" else a[:, :-1] if f in ("nbrU", "distU") else a


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_carried_insert_equals_jax(tmp_path_factory, dtype):
    j, t = loaded(jax_saved(tmp_path_factory, dtype))
    t.search_cfg = ZT.SearchConfig(seed_anchors=0)
    with mock.patch.object(JS, "sample_levels", level_stream()), \
            mock.patch.object(TS, "sample_levels", level_stream()):
        for idx in (j, t):
            idx.insert(X[N:N + 120])
            idx.add(X[N + 120:])
            idx.flush()
    assert t.shard_cap == j.shard_cap == 1024 and len(t) == N + 300   # grown from 512
    for si, st in enumerate(t.state):
        want = {f: np.asarray(getattr(j.state, f))[si] for f in ("dist0",) + GRAPH_IDS}
        for f in GRAPH_IDS:
            a, b = trimmed(f, want[f]), trimmed(f, getattr(st, f).numpy())
            diff = (a != b).sum()
            if dtype == "int8" and f in ("nbr0", "nbrU"):
                assert diff <= 0.01 * ((a >= 0) | (b >= 0)).sum(), (si, f, diff)
            else:
                assert diff == 0, (si, f)
        if dtype == "float32":
            np.testing.assert_allclose(trimmed("dist0", st.dist0.numpy()),
                                       trimmed("dist0", want["dist0"]), **TOL)
        assert (st.entry, st.max_level, st.n, st.q_scale) == (
            int(np.asarray(j.state.entry)[si]), int(np.asarray(j.state.max_level)[si]),
            int(np.asarray(j.state.n)[si]), float(np.asarray(j.state.q_scale)[si]))
    assert t.state[0].q_scale == 1.0   # JAX's sharded int8 build never sets a scale
    # ids 2000.. went to the shards contiguously, 75 each
    np.testing.assert_array_equal(t.state[1].ext_ids.numpy()[500:575], np.arange(2075, 2150))
    if dtype == "float32":
        same(t.search(Q, K, ef_search=32), j.search(Q, K, ef_search=32))


def test_data_axis(tmp_path_factory):
    path = jax_saved(tmp_path_factory)
    t1 = ZT.ShardedHNSW.load(path, mesh=port_mesh())
    t2 = ZT.ShardedHNSW.load(path, mesh=port_mesh(n_data=2))
    assert t2.n_data == 2
    assert torch.equal(t2.search(Q, K, ef_search=32)[1], t1.search(Q, K, ef_search=32)[1])
    mask = np.arange(N) % 2 == 0
    for mode in ("scan", "beam"):
        assert torch.equal(t2.search(Q, K, allowed=mask, filter_mode=mode)[1],
                           t1.search(Q, K, allowed=mask, filter_mode=mode)[1])
    # a batch that does not divide over the data rows raises in both packages
    j2 = JS.ShardedHNSW.load(path, mesh=jax_mesh(n_shards=4, n_data=2))
    for idx in (t2, j2):
        with pytest.raises(ValueError, match="divisible"):
            idx.search(Q[:3], K)
        with pytest.raises(ValueError, match="divisible"):
            idx.search(Q[:3], K, allowed=mask, filter_mode="scan")


def test_port_save_loads_in_jax(tmp_path_factory, tmp_path):
    _, t = loaded(jax_saved(tmp_path_factory))
    t.remove([3, 70, 1999])
    path = str(tmp_path / "port.npz")
    t.save(path)
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        assert z["nbr0"].shape[0] == 4 and z["entry"].shape == (4,)
        np.testing.assert_array_equal(z["dead_ext"], [3, 70, 1999])
    assert meta["n_shards"] == 4 and meta["shard_cap"] == t.shard_cap
    j = JS.ShardedHNSW.load(path, mesh=jax_mesh(n_shards=4))
    assert j._dead == {3, 70, 1999}
    same(t.search(Q, K, ef_search=32), j.search(Q, K, ef_search=32))
    with np.load(path) as z:   # from_numpy carries the arrays without a file
        t2 = ZT.ShardedHNSW.from_numpy({f: z[f] for f in z.files if f != "meta"}, meta,
                                       mesh=port_mesh())
    assert torch.equal(t2.search(Q, K)[1], t.search(Q, K)[1])
    with pytest.raises(ValueError, match="shards"):
        ZT.ShardedHNSW.load(path, mesh=make_mesh(n_shards=2, devices=["cpu"]))


def assert_same(sa, ia, sb, ib, atol=1e-3):
    """tests/test_sharded_equivalence.py's rule: scores equal slot by slot,
    and an id may differ only where both sides score the slot equal."""
    sa, ia, sb, ib = (a.numpy() for a in (sa, ia, sb, ib))
    fin = np.isfinite(sa) | np.isfinite(sb)
    np.testing.assert_allclose(np.where(fin, sa, 0.0), np.where(fin, sb, 0.0), rtol=1e-3,
                               atol=atol)
    neq = (ia != ib) & fin
    assert np.allclose(sa[neq], sb[neq], rtol=1e-3, atol=atol)


def test_port_build_equals_the_single_chip_engine():
    rng = np.random.default_rng(42)
    n, d = 2000, 24
    cents = rng.standard_normal((24, d)).astype(np.float32) * 4
    x = (cents[rng.integers(0, 24, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, 48)] + 0.05 * rng.standard_normal((48, d))).astype(np.float32)
    # "float32": JAX's CPU products are f32 at every precision; the port's
    # default "high" rounds to bf16x3, whose l2 scores near 0 miss the atol
    cfg = ZT.HNSWConfig(dim=d, m=12, ef_construction=96, build_batch=512, precision="float32")
    single = ZT.HNSW(cfg, device="cpu")
    single.build(x)
    sh = ZT.ShardedHNSW(cfg, mesh=port_mesh())
    sh.build(x)
    assert [st.n for st in sh.state] == [500] * 4 and sh.shard_cap == 500
    oracle = ZT.FlatIndex(ZT.FlatConfig(dim=d, precision="highest"), capacity=n, device="cpu")
    oracle.add(x)
    assert_same(*oracle.search(q, K), *single.search(q, K, ef_search=256))
    assert_same(*single.search(q, K, ef_search=256), *sh.search(q, K, ef_search=256))
    dead = np.unique(np.argmin(((q[:4, None] - x[None]) ** 2).sum(-1), axis=1))
    assert single.remove(dead) == sh.remove(dead) == dead.size
    assert_same(*single.search(q, K, ef_search=256), *sh.search(q, K, ef_search=256))
    allowed = np.arange(0, n, 3)
    assert_same(*single.search(q, K, allowed=allowed), *sh.search(q, K, allowed=allowed))
    live = sh.compact()
    np.testing.assert_array_equal(live, np.setdiff1d(np.arange(n), dead))
    assert len(sh) == n - dead.size and not sh._dead
    _, ids = sh.search(x[live[:50]], 1, ef_search=64)
    assert (ids.numpy()[:, 0] == np.arange(50)).mean() >= 0.96


def test_recall_on_a_data_parallel_mesh():
    n, d, k = 4000, 16, 5
    x = clustered(n, d, seed=12)
    idx = ZT.ShardedHNSW(ZT.HNSWConfig(dim=d, m=8, ef_construction=32, build_batch=256),
                         mesh=port_mesh(n_data=2), seed=3)
    idx.build(x)
    rng = np.random.default_rng(0)
    q = (x[rng.integers(0, n, 64)] + 0.05 * rng.standard_normal((64, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, k, device="cpu")
    _, ids = idx.search(q, k, ef_search=48)        # B=64 split over the data axis
    assert recall_at_k(ids.numpy(), gt, k) >= 0.9
    _, i1 = idx.search(x[:2], 1, ef_search=32)
    assert (i1.numpy()[:, 0] == np.arange(2)).all()


def test_anchor_reseed_and_empty_index():
    mesh = port_mesh()
    idx = ZT.ShardedHNSW(ZT.HNSWConfig(**cfg_kw()), mesh=mesh)
    s, ids = idx.search(Q[:2], 3)
    assert (ids.numpy() == -1).all() and torch.isinf(s).all() and len(idx) == 0
    idx.insert(X[:203])
    assert len(idx) == 203 and idx.state is None
    idx.flush()                         # a flush from no state builds
    assert len(idx) == 203 and idx.shard_cap == 51 and idx._anchor_n == 51
    states = [dataclasses.replace(st) for st in idx.state]
    TS.make_anchor_reseed(mesh, 40)(states, seed=7)
    rows = [st.a_rows.numpy() for st in states]
    assert all(r.shape == (40,) and r.min() >= 0 and r.max() < st.n
               for r, st in zip(rows, states))
    assert not np.array_equal(rows[0], rows[1])       # each shard draws its own rows
    np.testing.assert_array_equal(states[2].anchors.numpy(),
                                  states[2].vectors[states[2].a_rows.long()].numpy())
    again = [dataclasses.replace(st) for st in idx.state]
    TS.make_anchor_reseed(mesh, 40)(again, seed=7)
    assert all(np.array_equal(a.a_rows.numpy(), r) for a, r in zip(again, rows))
    with pytest.raises(ValueError, match="dimension mismatch"):
        idx.insert(np.zeros((1, DIM + 1), np.float32))
