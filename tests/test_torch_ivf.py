"""zvdb_tpu_torch.IVFIndex on the CPU, against its contract and the JAX package.

The engine tests mirror the JAX package's IVF tests (tests/test_ivf.py,
test_checkpoint.py, the IVF cases of test_delete.py, test_filtered.py,
test_round2_fixes.py and test_device_build.py) on indexes the port builds
itself (device="cpu"), with the same shapes, seeds and floors.

The k-means draws from each package's own random numbers, so for id
comparisons the JAX package builds the index and `from_numpy` or `load`
carries its state across: both then search the same centroids and blocks,
and the ids must be equal (`search`, filtered search in both modes,
`search_range`); scores agree within rtol 1e-5 / atol 1e-4 (f32 sums in
another order). The write path's comparisons are in test_torch_ivf_write.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index import ivf as JI
from zvdb_tpu.utils import stats as JS
from zvdb_tpu_torch.index import ivf as TI
from zvdb_tpu_torch.ops import distance as D
from zvdb_tpu_torch.ops import topk as T
from zvdb_tpu_torch.utils import stats as TS

CPU = "cpu"
STOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def IVF(**kw):
    return ZT.IVFIndex(ZT.IVFConfig(**kw), device=CPU)


def recall_at_k(ids, gt_ids, k):
    return np.mean(
        [len(set(ids[r, :k]) & set(gt_ids[r, :k])) / k for r in range(ids.shape[0])])


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


def gt(x, q, k, metric="l2"):
    return ZT.exact_ground_truth(x, q, k, metric=metric, device=CPU)[1]


def _no_dead_in_results(ids, dead):
    flat = np.asarray(ids).ravel()
    return not np.isin(flat[flat >= 0], list(dead)).any()


def _gt_filtered(x, q, allow_ids, k):
    d2 = ((q[:, None, :] - x[None, allow_ids, :]) ** 2).sum(-1)
    return np.asarray(allow_ids)[np.argsort(d2, axis=1)[:, :k]]


# ---------------------------------------------------------------------------
# the engine contract (tests/test_ivf.py)


def test_ivf_recall_l2(rng):
    n, d, k = 20000, 32, 10
    x = clustered(n, d, seed=1)
    q = (x[rng.integers(0, n, 200)]
         + 0.05 * rng.standard_normal((200, d)).astype(np.float32)).astype(np.float32)
    want = gt(x, q, k)
    idx = IVF(dim=d, n_clusters=64, nprobe=8)
    idx.build(x)
    s, ids = idx.search(q, k)
    assert ids.dtype == torch.int32 and ids.device.type == "cpu"
    assert recall_at_k(ids.numpy(), want, k) >= 0.92
    _, ids_full = idx.search(q, k, nprobe=64)
    assert recall_at_k(ids_full.numpy(), want, k) >= 0.999


def test_ivf_recall_improves_with_nprobe():
    n, d, k = 10000, 16, 10
    x = clustered(n, d, seed=2)
    q = clustered(300, d, seed=3)
    want = gt(x, q, k)
    idx = IVF(dim=d, n_clusters=64)
    idx.build(x)
    rs = [recall_at_k(idx.search(q, k, nprobe=npb)[1].numpy(), want, k)
          for npb in (1, 4, 16, 64)]
    assert rs == sorted(rs) or rs[-1] > 0.99
    assert rs[-1] >= 0.999


def test_ivf_cosine_and_dot():
    n, d, k = 5000, 24, 5
    x = clustered(n, d, seed=4)
    q = clustered(100, d, seed=5)
    for metric in ("cosine", "dot"):
        want = gt(x, q, k, metric)
        idx = IVF(dim=d, n_clusters=32, nprobe=16, metric=metric)
        idx.build(x)
        s, ids = idx.search(q, k)
        assert recall_at_k(ids.numpy(), want, k) >= 0.9, metric
        assert (np.diff(s.numpy(), axis=1) <= 1e-5).all()   # similarity descending


def test_ivf_block_balance():
    x = clustered(8000, 16, seed=6)
    idx = IVF(dim=16, n_clusters=32, max_cluster_factor=1.5)
    idx.build(x)
    counts = idx.state.counts.numpy()
    cap = idx.state.blocks.shape[1]
    assert counts.sum() == 8000
    assert (counts <= cap).all()
    ids = idx.state.b_ids.numpy()
    live = ids[ids >= 0]
    assert len(live) == 8000 and len(set(live.tolist())) == 8000


def test_ivf_incremental_add():
    x = clustered(4000, 16, seed=7)
    idx = IVF(dim=16, n_clusters=32, nprobe=8)
    idx.build(x[:3000])
    idx.add(x[3000:])
    assert len(idx) == 4000
    s, ids = idx.search(x[3500], 1, nprobe=32)
    assert float(s[0]) < 1e-6


def test_ivf_int8_blocks():
    n, d, k = 8000, 32, 10
    x = clustered(n, d, seed=11)
    q = clustered(200, d, seed=12)
    want = gt(x, q, k)
    idx = IVF(dim=d, n_clusters=32, nprobe=8, dtype="int8")
    idx.build(x)
    assert idx.state.blocks.dtype == torch.int8
    r = recall_at_k(idx.search(q, k)[1].numpy(), want, k)
    assert r >= 0.9
    idx2 = IVF(dim=d, n_clusters=32, nprobe=8, dtype="int8", rerank=4)
    idx2.build(x)
    r2 = recall_at_k(idx2.search(q, k)[1].numpy(), want, k)
    assert r2 >= r - 1e-6 and r2 >= 0.95


def test_ivf_save_load(tmp_path):
    x = clustered(3000, 16, seed=8)
    idx = IVF(dim=16, n_clusters=32)
    idx.build(x)
    q = clustered(20, 16, seed=9)
    _, i0 = idx.search(q, 5)
    p = str(tmp_path / "ivf.npz")
    idx.save(p)
    _, i1 = ZT.IVFIndex.load(p, device=CPU).search(q, 5)
    assert torch.equal(i0, i1)


def test_ivf_empty_and_k_gt_n():
    idx = IVF(dim=8, n_clusters=8)
    _, ids = idx.search(np.zeros((2, 8), np.float32), 3)
    assert (ids == -1).all()
    idx.build(clustered(5, 8, seed=10))
    _, ids = idx.search(np.zeros((1, 8), np.float32), 10, nprobe=8)
    assert int((ids >= 0).sum()) == 5


def _scan_inputs(idx, q, p, metric="l2"):
    st = idx.state
    qp = D.preprocess_queries(torch.from_numpy(q), metric)
    cs = D.pairwise_scores(qp, st.centroids, st.c_norms, metric)
    _, probes = T.smallest_k_dense(cs, p)
    return st, qp, cs, probes


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pair_scan_matches_grouped_scan(dtype):
    """The two scans (one block gather per pair; the per-cluster grouping)
    give the same candidates with the same scores on the same probes (the
    port's own pair, as tests/test_ivf.py checks JAX's), f32 blocks and
    int8 residual codes."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4000, 24)).astype(np.float32)
    idx = IVF(dim=24, n_clusters=64, nprobe=6, dtype=dtype)
    idx.build(x)
    st, qp, cs, probes = _scan_inputs(idx, x[:32] + 0.01, 6)
    resid = dtype == "int8"
    ps, pi = TI._pair_scan(st, qp, cs, probes, 10, "l2", resid)
    gs, gi = TI._grouped_scan(st, qp, cs, probes, 10, "l2", resid, 4.0)
    for r in range(32):
        pd = {int(i): float(s) for s, i in zip(ps[r], pi[r]) if i >= 0}
        gd = {int(i): float(s) for s, i in zip(gs[r], gi[r]) if i >= 0}
        assert set(pd) == set(gd)
        for i in pd:
            assert abs(pd[i] - gd[i]) < 1e-4


def test_pair_scan_int8_residual_rerank_small_batch():
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((40, 16)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 4000)]
         + 0.1 * rng.standard_normal((4000, 16))).astype(np.float32)
    idx = IVF(dim=16, n_clusters=64, nprobe=8, dtype="int8", rerank=4)
    idx.build(x)
    _, ids = idx.search(x[:8], 1)     # b=8, p=8 -> c*8=512 > 64 -> pair mode
    assert (ids[:, 0].numpy() == np.arange(8)).mean() >= 0.99


def test_ivf_search_range_matches_oracle():
    rng = np.random.default_rng(5)
    n, d = 3000, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:32] + 0.01
    idx = IVF(dim=d, n_clusters=16, nprobe=2)
    idx.build(x)
    r = 2.0
    s, i, c = (v.numpy() for v in idx.search_range(q, r, max_results=64))
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(c, (d2 <= r).sum(1))
    for b in range(32):
        inr = np.nonzero(d2[b] <= r)[0]
        assert set(i[b][i[b] >= 0]) == set(inr[np.argsort(d2[b][inr])][:64])
    assert (s[i >= 0] <= r).all()
    idx.remove([0, 1])
    s2, i2, c2 = (v.numpy() for v in idx.search_range(q, r, max_results=64))
    d2m = d2.copy()
    d2m[:, [0, 1]] = np.inf
    np.testing.assert_array_equal(c2, (d2m <= r).sum(1))
    assert not np.isin(i2.ravel(), [0, 1]).any()
    _, it, ct = idx.search_range(q, r, max_results=4)
    np.testing.assert_array_equal(ct.numpy(), c2)
    assert ((it.numpy() >= 0).sum(1) <= 4).all()
    idxd = IVF(dim=d, metric="dot", n_clusters=16)
    idxd.build(x)
    _, _, cd = idxd.search_range(q, 5.0, max_results=64)
    np.testing.assert_array_equal(cd.numpy(), (q @ x.T >= 5.0).sum(1))
    idx8 = IVF(dim=d, n_clusters=16, dtype="int8", rerank=4)
    idx8.build(x)
    idx8.remove([0, 1])
    _, i8, c8 = (v.numpy() for v in idx8.search_range(q, r, max_results=64))
    np.testing.assert_array_equal(c8, c2)
    for b in range(32):
        assert set(i8[b][i8[b] >= 0]) == set(i2[b][i2[b] >= 0])
    # a large radius: shadow rows past n (zeros) never scan as live rows
    rbig = float((q ** 2).sum(1).max()) + 10.0
    _, ib, cb = (v.numpy() for v in idx8.search_range(q, rbig, max_results=64))
    np.testing.assert_array_equal(cb, (d2m <= rbig).sum(1))
    assert ib.max() < n
    iflt = idx8.search(q[:8], 5, allowed=np.arange(n))[1].numpy()
    assert iflt.max() < n and (iflt >= 0).all()
    idx8n = IVF(dim=d, n_clusters=16, dtype="int8", rerank=0)
    idx8n.build(x)
    with pytest.raises(ValueError):
        idx8n.search_range(q, r)
    se, ie, ce = IVF(dim=d).search_range(q, r)
    assert (ie == -1).all() and (ce == 0).all()
    _, i1, c1 = idx.search_range(q[0], r)          # one query row: squeezed
    assert i1.shape == (128,) and c1.shape == ()


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, tests/test_device_build.py


def test_ivf_plan_checkpoint_resume_identical(tmp_path, rng):
    nc = 30
    centers = rng.standard_normal((nc, 24)).astype(np.float32)
    x = (centers[rng.integers(0, nc, 4000)]
         + 0.1 * rng.standard_normal((4000, 24))).astype(np.float32)
    cfg = ZT.IVFConfig(dim=24, n_clusters=64, nprobe=4, dtype="int8", rerank=4)
    ckpt = str(tmp_path / "ivf.ckpt.npz")
    direct = ZT.IVFIndex(cfg, device=CPU)
    direct.build(x, checkpoint_path=ckpt)
    resumed = ZT.IVFIndex.resume_build(ckpt, device=CPU)
    assert len(resumed) == 4000
    for f in TI._STATE_FIELDS:
        a, b = getattr(direct.state, f), getattr(resumed.state, f)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f
    _, i = resumed.search(x[:64], 1)
    assert (i[:, 0].numpy() == np.arange(64)).mean() >= 0.9


def test_ivf_device_build_matches_host():
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((40, 24)).astype(np.float32) * 5
    x = (cents[rng.integers(0, 40, 4000)]
         + rng.standard_normal((4000, 24)).astype(np.float32))
    cfg = ZT.IVFConfig(dim=24, n_clusters=64, nprobe=8)

    def self_hit(idx):
        return (idx.search(x[:200], 1)[1][:, 0].numpy() == np.arange(200)).mean()

    host = ZT.IVFIndex(cfg, device=CPU)
    host.build(x)
    dev = ZT.IVFIndex(cfg, device=CPU)
    dev.build(torch.from_numpy(x))      # a tensor takes the device split
    assert self_hit(dev) >= self_hit(host) - 0.01
    assert self_hit(dev) > 0.97


# ---------------------------------------------------------------------------
# deletes (tests/test_delete.py)


def test_ivf_remove_filters_results_and_survivors_stay_reachable():
    n, d = 4000, 16
    x = clustered(n, d, seed=12)
    idx = IVF(dim=d, n_clusters=32)
    idx.build(x)
    dead = set(range(0, 400, 2))
    assert idx.remove(sorted(dead)) == len(dead)
    assert len(idx) == n - len(dead)
    assert _no_dead_in_results(idx.search(x[:400], 5, nprobe=8)[1], dead)
    alive = np.asarray([r for r in range(400) if r not in dead])
    ii = idx.search(x[alive], 1, nprobe=8)[1].numpy()
    assert (ii[:, 0] == alive).mean() >= 0.95
    with pytest.raises(IndexError):
        idx.get([0])
    idx.add(x[:2] + 0.001)
    i2 = idx.search(x[:2] + 0.001, 1, nprobe=8)[1].numpy()
    assert set(i2[:, 0]) == {n, n + 1}
    assert _no_dead_in_results(idx.search(x[:400], 5, nprobe=8)[1], dead)


def test_ivf_delete_survives_repack_and_save(tmp_path):
    n, d = 1000, 16
    x = clustered(n, d, seed=13)
    idx = IVF(dim=d, n_clusters=16)
    idx.build(x)
    idx.remove(list(range(0, 50)))
    idx.add(clustered(3000, d, seed=14))      # forces the overflow repack
    idx.flush()
    assert _no_dead_in_results(idx.search(x[:100], 5, nprobe=8)[1], set(range(50)))
    assert len(idx) == n + 3000 - 50
    p = str(tmp_path / "ivf.npz")
    idx.save(p)
    back = ZT.IVFIndex.load(p, device=CPU)
    assert back._dead == set(range(50))
    assert _no_dead_in_results(back.search(x[:100], 5, nprobe=8)[1], set(range(50)))
    old_ids = back.compact()
    assert len(back) == n + 3000 - 50
    assert not np.isin(old_ids, np.arange(50)).any()


def test_ivf_remove_int8_rerank_path():
    n, d = 2000, 16
    x = clustered(n, d, seed=15)
    idx = IVF(dim=d, n_clusters=16, dtype="int8", rerank=4)
    idx.build(x)
    dead = list(range(0, 100))
    idx.remove(dead)
    assert _no_dead_in_results(idx.search(x[:200], 5, nprobe=8)[1], set(dead))


# ---------------------------------------------------------------------------
# filtered search (tests/test_filtered.py)


def test_ivf_filtered():
    n, d, k = 4000, 16, 5
    x = clustered(n, d, seed=34)
    q = x[:128] + 0.01
    allow = np.arange(0, n, 2)
    want = _gt_filtered(x, q, allow, k)
    idx = IVF(dim=d, n_clusters=32)
    idx.build(x)
    i = idx.search(q, k, nprobe=8, allowed=allow)[1].numpy()
    assert set(i[i >= 0]) <= set(allow)
    assert np.mean([len(set(i[r]) & set(want[r])) / k for r in range(128)]) >= 0.9


def test_filter_mode_scan_exact_at_low_selectivity():
    n, d, k = 4000, 16, 5
    x = clustered(n, d, seed=35)
    q = x[:64] + 0.01
    allow = np.sort(np.random.default_rng(35).choice(n, n // 100, replace=False))   # 1%
    want = _gt_filtered(x, q, allow, k)
    engines = [IVF(dim=d, n_clusters=32), IVF(dim=d, n_clusters=32, dtype="int8", rerank=4)]
    for idx in engines:
        idx.build(x)
        i = idx.search(q, k, allowed=allow)[1].numpy()
        assert set(i[i >= 0]) <= set(allow)
        assert np.mean([len(set(i[r]) & set(want[r])) / k for r in range(64)]) >= 0.99
        idx.remove(allow[:2])
        i2 = idx.search(q, k, allowed=allow)[1].numpy()
        assert not np.isin(i2.ravel(), allow[:2]).any()
    ip = engines[0].search(q, k, allowed=allow, nprobe=16, filter_mode="probe")[1].numpy()
    assert set(ip[ip >= 0]) <= set(allow)
    with pytest.raises(ValueError):
        engines[0].search(q, k, allowed=allow, filter_mode="bogus")
    v8 = IVF(dim=d, n_clusters=32, dtype="int8", rerank=0)   # no shadow store: probe
    v8.build(x)
    i8 = v8.search(q, k, allowed=allow, nprobe=32)[1].numpy()
    assert set(i8[i8 >= 0]) <= set(allow)


# ---------------------------------------------------------------------------
# tests/test_round2_fixes.py


def test_ivf_int8_rerank_save_load_roundtrip(tmp_path, rng):
    n, d, k = 8000, 32, 10
    x = clustered(n, d, seed=11)
    q = (x[rng.integers(0, n, 100)]
         + 0.05 * rng.standard_normal((100, d)).astype(np.float32)).astype(np.float32)
    idx = IVF(dim=d, n_clusters=32, nprobe=8, dtype="int8", rerank=4)
    idx.build(x)
    s0, i0 = idx.search(q, k)
    path = str(tmp_path / "ivf_int8.npz")
    idx.save(path)
    loaded = ZT.IVFIndex.load(path, device=CPU)
    assert loaded.state.rerank_vecs.dtype == torch.float32   # by rerank_dtype, never int8
    s1, i1 = loaded.search(q, k)
    assert torch.equal(i0, i1)
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,rerank", [("float32", 0), ("int8", 4)])
def test_ivf_add_preserves_ids_and_recall(dtype, rerank):
    n, d = 6000, 32
    x = clustered(n, d, seed=21)
    idx = IVF(dim=d, n_clusters=32, nprobe=32, dtype=dtype, rerank=rerank)
    idx.build(x)
    probe = x[:256]
    assert (idx.search(probe, 1)[1][:, 0].numpy() == np.arange(256)).mean() >= 0.99
    extra = clustered(500, d, seed=22)
    idx.add(extra)
    assert len(idx) == n + 500
    assert (idx.search(probe, 1)[1][:, 0].numpy() == np.arange(256)).mean() >= 0.99
    assert (idx.search(extra[:64], 1)[1][:, 0].numpy() == n + np.arange(64)).mean() >= 0.95
    assert float(idx.search(probe, 1)[0][:, 0].mean()) < 0.1


def test_ivf_add_appends_in_place_without_repack():
    n, d = 4000, 16
    x = clustered(n, d, seed=31)
    idx = IVF(dim=d, n_clusters=16, nprobe=16)
    idx.build(x)
    shape = idx.state.blocks.shape
    total = int(idx.state.counts.sum())
    idx.add(clustered(64, d, seed=32))
    idx.flush()
    assert idx.state.blocks.shape == shape
    assert int(idx.state.counts.sum()) == total + 64
    assert idx.state.n == n + 64


def test_ivf_add_overflow_repacks_correctly(rng):
    n, d = 2000, 16
    x = clustered(n, d, seed=41, nc=8)
    idx = IVF(dim=d, n_clusters=8, nprobe=8, block_headroom=1.05)
    idx.build(x)
    hot = (x[0] + 0.01 * rng.standard_normal((600, d))).astype(np.float32)
    idx.add(hot)
    assert len(idx) == n + 600
    assert (idx.search(x[:128], 1)[1][:, 0].numpy() == np.arange(128)).mean() >= 0.99
    assert (idx.search(hot[:64], 1)[1][:, 0].numpy() >= n).mean() >= 0.9


def test_ivf_get_returns_stored_vectors():
    x = clustered(2000, 16, seed=51)
    idx = IVF(dim=16, n_clusters=16)
    idx.build(x)
    ids = np.array([0, 1234, 1999])
    np.testing.assert_allclose(idx.get(ids), x[ids], rtol=1e-5, atol=1e-6)
    idx8 = IVF(dim=16, n_clusters=16, dtype="int8")
    idx8.build(x)
    assert np.abs(idx8.get(ids) - x[ids]).max() < 0.05
    with pytest.raises(IndexError):
        idx.get([2000])


# ---------------------------------------------------------------------------
# port-only checks


def test_live_scatter_targets_are_unique():
    """Both scans' scatters send every dropped pair to a trash row; on the
    card a duplicated target has no defined writer, so every live
    (cluster, slot) and (query, probe) target must be distinct. Skewed
    probes at a small q_cap make many pairs drop."""
    rng = np.random.default_rng(2)
    b, p, c = 300, 6, 20
    hot = np.r_[[0.5], [0.5 / (c - 1)] * (c - 1)]    # cluster 0 in half the probe lists
    probes = torch.from_numpy(np.stack([rng.choice(c, size=p, replace=False, p=hot)
                                        for _ in range(b)]))
    q_cap = TI.group_q_cap(b, p, c, 0.5)
    qslot, pslot = TI._slot_pairs(probes, b, p, c, q_cap)
    assert qslot.shape == (c, q_cap)                 # the trash row is cut off
    live = (qslot >= 0).numpy()
    qs, ps = qslot.numpy()[live], pslot.numpy()[live]
    assert len(set(zip(qs.tolist(), ps.tolist()))) == live.sum()   # (query, probe) distinct
    assert 0 < live.sum() < b * p                    # some pairs were dropped
    # each live (cluster, slot) holds a pair that probed that cluster
    np.testing.assert_array_equal(probes.numpy()[qs, ps], np.nonzero(live)[0])


def test_scan_selection_rule():
    """The pair scan when C * 8 > B * P, else the grouped one; the slot cap
    is max(8, slack * B * P / C), at most B * P."""
    assert TI.use_pair_scan(64, 8, 8) and not TI.use_pair_scan(64, 64, 8)
    assert TI.group_q_cap(2048, 8, 1100, 4.0) == int(4.0 * 2048 * 8 / 1100)
    assert TI.group_q_cap(4, 2, 1000, 4.0) == 8 and TI.group_q_cap(2, 1, 1000, 4.0) == 2


def test_no_device_raises_without_cuda():
    cfg = ZT.IVFConfig(dim=8)
    if torch.cuda.is_available():
        assert ZT.IVFIndex(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            ZT.IVFIndex(cfg)
        with pytest.raises(RuntimeError):
            ZT.IVFIndex.from_numpy(cfg)


def test_config_and_surface_equal_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(ZT.IVFConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(ZJ.IVFConfig)])
    with pytest.raises(ValueError):
        ZT.IVFConfig(dim=8, metric="hamming")

    def public(cls):
        return {m for m in dir(cls) if not m.startswith("_")}

    assert public(ZJ.IVFIndex) <= public(ZT.IVFIndex)
    assert public(ZT.IVFIndex) - public(ZJ.IVFIndex) == {"from_numpy"}
    assert list(TI._STATE_FIELDS) == list(JI.IVFState._fields)


# ---------------------------------------------------------------------------
# against the JAX package on a carried index


def test_split_oversized_equals_jax():
    x = clustered(3000, 16, seed=3, nc=6)
    cent = x[:12].copy()
    assign = np.argmin(((x[:, None] - cent[None]) ** 2).sum(-1), 1)
    jc, ja = JI.split_oversized(x, cent, assign, 200, np.random.default_rng(4))
    tc, ta = TI.split_oversized(x, cent, assign, 200, np.random.default_rng(4))
    assert len(jc) > 12
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ta, ja)


@pytest.fixture(scope="module")
def jax_built():
    """JAX-built indexes over one corpus with 120 rows removed: f32 l2 and
    int8 + rerank cosine, each carried by a save file and by from_numpy."""
    x = clustered(3000, 16, seed=60)
    out = {}
    for name, cfg in (("f32_l2", dict(n_clusters=32, nprobe=6)),
                      ("int8_cos", dict(n_clusters=32, nprobe=6, metric="cosine",
                                        dtype="int8", rerank=4))):
        j = ZJ.IVFIndex(ZJ.IVFConfig(dim=16, **cfg))
        j.build(x)
        j.remove(np.arange(0, 240, 2))
        out[name] = j
    return x, out


@pytest.mark.parametrize("name", ["f32_l2", "int8_cos"])
@pytest.mark.parametrize("carry", ["load", "from_numpy"])
def test_carried_index_returns_jax_ids(jax_built, name, carry, tmp_path):
    x, built = jax_built
    j = built[name]
    if carry == "load":
        p = str(tmp_path / "j.npz")
        j.save(p)
        t = ZT.IVFIndex.load(p, device=CPU)
    else:
        arrays = {f: np.asarray(getattr(j.state, f)) for f in JI.IVFState._fields}
        t = ZT.IVFIndex.from_numpy(dataclasses.asdict(j.cfg), arrays,
                                   n_inserted=j._n_inserted, device=CPU)
    assert t._dead == j._dead and len(t) == len(j)
    c = t.state.centroids.shape[0]
    q = x[::17][:160] + 0.02
    allow = np.arange(1, 3000, 3)
    for qq in (q[:4], q):                            # pair scan, grouped scan
        assert TI.use_pair_scan(c, len(qq), 6) == (len(qq) == 4)
        js, ji = j.search(qq, 10)
        ts, ti = t.search(qq, 10)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STOL)
        for mode in ("scan", "probe"):
            np.testing.assert_array_equal(
                t.search(qq, 10, allowed=allow, filter_mode=mode)[1].numpy(),
                np.asarray(j.search(qq, 10, allowed=allow, filter_mode=mode)[1]), err_msg=mode)
    radius = 0.5 if name == "f32_l2" else 0.9
    js, ji, jc = j.search_range(q[:32], radius, max_results=32)
    ts, ti, tc = t.search_range(q[:32], radius, max_results=32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tc.sum()) > 0


def test_index_stats_equal_jax(jax_built):
    _, built = jax_built
    for j in built.values():
        arrays = {f: np.asarray(getattr(j.state, f)) for f in JI.IVFState._fields}
        t = ZT.IVFIndex.from_numpy(dataclasses.asdict(j.cfg), arrays,
                                   n_inserted=j._n_inserted, device=CPU)
        assert TS.index_stats(t) == JS.index_stats(j)
