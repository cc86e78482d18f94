"""zvdb_tpu_torch.CagraIndex on the CPU, against its contract and the JAX package.

The engine tests mirror tests/test_cagra.py, test_fat_rows.py,
test_reverse_hub.py, the CAGRA case of test_anchor_refresh.py and
test_pallas_topk.py's block_topk="pallas" build on indexes the port builds
itself (device="cpu"), at 3000 x 16d where the JAX tests go larger.

The build draws from a torch.Generator, so for id comparisons the JAX package
builds the index and `CagraIndex.from_numpy` (or a save file) carries its
state across: both then search the same graph and anchors. At
precision="highest" both compute f32 products and the ids must be equal up
to near-ties (see `_same`) for l2, dot, cosine, int8, filtered and
tombstoned searches; at "high" the port rounds to bf16x3 as the TPU does
while JAX's CPU dots stay f32, and the share of equal ids is held to
>= 0.97. Scores agree within rtol 1e-5 / atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index.cagra import CagraState as JCagraState
import zvdb_tpu_torch.index.cagra as cagra_mod

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)


def clustered(n, d, seed, nc=50, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


def recall_at_k(ids, gt, k):
    return np.mean([len(set(ids[r, :k]) & set(gt[r, :k])) / k for r in range(ids.shape[0])])


def self_hit(idx, x, rows, **kw):
    ids = np.asarray(idx.search(x[rows], 1, **kw)[1])
    return (ids[:, 0] == rows).mean()


@pytest.fixture(scope="module")
def corpus():
    x = clustered(3000, 16, seed=2)
    rng = np.random.default_rng(0)
    q = (x[rng.integers(0, 3000, 200)] + 0.05 * rng.standard_normal((200, 16))).astype(np.float32)
    return x, q


# ---------------------------------------------------------------------------
# the JAX package's state carried across


_JAX_BUILT: dict = {}


def jax_built(corpus, metric="l2", dtype="float32"):
    """A JAX-built index (precision "highest"), one per (metric, dtype) per module."""
    key = (metric, dtype)
    if key not in _JAX_BUILT:
        idx = ZJ.CagraIndex(ZJ.CagraConfig(dim=16, degree=16, metric=metric, dtype=dtype,
                                           precision="highest", seed=3))
        idx.build(corpus[0])
        _JAX_BUILT[key] = idx
    return _JAX_BUILT[key]


def _arrays(jidx):
    return {f: np.asarray(getattr(jidx.state, f)) for f in JCagraState._fields}


def _port_of(jidx, **cfg_changes):
    cfg = dataclasses.replace(jidx.cfg, **cfg_changes)
    return ZT.CagraIndex.from_numpy(dataclasses.asdict(cfg), _arrays(jidx),
                                    capacity=jidx.capacity, n_inserted=jidx._n_inserted,
                                    device=CPU)


def _same(t, j):
    """Scores equal within TOL slot by slot; ids equal except where a
    result ties another of its row (or the k-th) within 1e-5 of the score
    scale: l2 surrogates cancel terms ~30x the distance at this width, so
    the last ulps of two summation orders can swap a near-tie."""
    (ts, ti), (js, ji) = t, j
    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, **TOL)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= 0.01 * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for pos in bad:
        row, col = js[tuple(pos[:-1])], pos[-1]
        others = np.delete(row, col)
        assert col == row.shape[0] - 1 or np.abs(others - row[col]).min() <= tie, pos


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_from_numpy_same_ids(corpus, metric):
    x, q = corpus
    jidx = jax_built(corpus, metric)
    tidx = _port_of(jidx)
    assert tidx.state.n == 3000 and tidx.state.nbrs.dtype == torch.int32
    for kw in (dict(), dict(ef_search=24), dict(ef_search=48, search_degree=8, max_iters=3)):
        _same(tidx.search(q, 10, **kw), jidx.search(q, 10, **kw))
    _same(tidx.search(q[0], 5), jidx.search(q[0], 5))     # one query, squeezed
    np.testing.assert_allclose(tidx.get([0, 1234]), np.asarray(jidx.get([0, 1234])), rtol=1e-6)


def test_from_numpy_filtered_and_tombstoned(corpus, tmp_path):
    x, q = corpus
    path = str(tmp_path / "j.npz")
    jax_built(corpus).save(path)
    jidx = ZJ.CagraIndex.load(path)
    jidx.remove(np.arange(0, 3000, 5))
    jidx.save(path)
    tidx = ZT.CagraIndex.load(path, device=CPU)
    assert len(tidx) == len(jidx) == 2400
    _same(tidx.search(q, 10), jidx.search(q, 10))
    allowed = np.zeros(3000, bool)
    allowed[1::2] = True
    for mode in ("beam", "scan", "auto"):
        _same(tidx.search(q, 10, allowed=allowed, filter_mode=mode),
              jidx.search(q, 10, allowed=allowed, filter_mode=mode))
    ids = np.arange(100, 2000, 3)
    _same(tidx.search(q, 5, allowed=ids, filter_mode="beam"),
          jidx.search(q, 5, allowed=ids, filter_mode="beam"))


def test_high_precision_share(corpus):
    """At "high" the port rounds to bf16x3 (the TPU's arithmetic); JAX's
    CPU dots stay f32, so a few near-ties may resolve differently."""
    x, q = corpus
    jidx = jax_built(corpus)
    jhigh = ZJ.CagraIndex(dataclasses.replace(jidx.cfg, precision="high"))
    jhigh.state, jhigh.capacity, jhigh._n_inserted = jidx.state, jidx.capacity, 3000
    jhigh._anchor_n = 3000
    tidx = _port_of(jidx, precision="high")
    ti = tidx.search(q, 10, ef_search=24)[1].numpy()
    ji = np.asarray(jhigh.search(q, 10, ef_search=24)[1])
    share = (ti == ji).mean()
    assert share >= 0.97, share
    assert recall_at_k(ti, ji, 10) >= 0.99


def test_save_load_both_ways_int8(corpus, tmp_path):
    x, q = corpus
    jidx = jax_built(corpus, dtype="int8")
    path = str(tmp_path / "jax_int8.npz")
    jidx.save(path)
    tidx = ZT.CagraIndex.load(path, device=CPU)
    assert tidx.state.vectors.dtype == torch.int8
    assert tidx.state.q_scale == float(np.float32(jidx.state.q_scale))
    _same(tidx.search(q, 10), jidx.search(q, 10))

    # the port's own int8 build, read by JAX
    own = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, dtype="int8", precision="highest"),
                        device=CPU)
    own.build(x)
    path2 = str(tmp_path / "port_int8.npz")
    own.save(path2)
    back = ZJ.CagraIndex.load(path2)
    assert str(back.state.vectors.dtype) == "int8"
    _same(own.search(q, 10), back.search(q, 10))


@pytest.mark.parametrize("metric,dtype", [("l2", "float32"), ("cosine", "bfloat16")])
def test_port_save_file_loads_in_jax(corpus, tmp_path, metric, dtype):
    x, q = corpus
    own = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, metric=metric, dtype=dtype,
                                       precision="highest"), device=CPU)
    own.build(x)
    own.remove([3, 4, 5])
    path = str(tmp_path / "port.npz")
    own.save(path)
    back = ZJ.CagraIndex.load(path)
    assert len(back) == len(own) == 2997
    _same(own.search(q, 10), back.search(q, 10))
    again = ZT.CagraIndex.load(path, device=CPU)
    _same(again.search(q, 10), own.search(q, 10))
    assert again.state.vectors.dtype == own.state.vectors.dtype


# ---------------------------------------------------------------------------
# engine contracts (tests/test_cagra.py)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_cagra_recall(corpus, metric):
    x, q = corpus
    _, gt = ZT.exact_ground_truth(x, q, 10, metric=metric, device=CPU)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=32, metric=metric), device=CPU)
    idx.build(x)
    s, ids = idx.search(q, 10, ef_search=48)
    assert ids.dtype == torch.int32 and ids.device.type == "cpu"
    r = recall_at_k(ids.numpy(), gt, 10)
    assert r >= 0.93, f"{metric} recall {r:.3f}"
    if metric == "l2":   # user-facing squared distances, ascending
        true = ((q[:5, None, :] - x[ids.numpy()[:5]]) ** 2).sum(-1)
        np.testing.assert_allclose(s.numpy()[:5], true, rtol=1e-3, atol=1e-3)


def test_cagra_insert_and_self_hit():
    x = clustered(3000, 16, seed=3)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=24), device=CPU)
    idx.build(x)
    assert self_hit(idx, x, np.arange(200)) >= 0.95
    extra = clustered(500, 16, seed=4)
    idx.insert(extra)
    assert len(idx) == 3500
    ids = np.asarray(idx.search(extra[:100], 1, ef_search=48)[1])
    assert (ids[:, 0] == 3000 + np.arange(100)).mean() >= 0.9
    assert self_hit(idx, x, np.arange(100)) >= 0.95       # old points still findable
    idx.add(torch.from_numpy(extra[:3] + 0.01))
    assert len(idx) == 3503


def test_cagra_empty_and_k_gt_n():
    rng = np.random.default_rng(0)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=8, degree=8), device=CPU)
    s, i = idx.search(np.zeros(8, np.float32), 3)
    assert (i == -1).all()
    x = rng.standard_normal((5, 8)).astype(np.float32)
    idx.insert(x)
    _, i = idx.search(x[0], 10)
    assert (i >= 0).sum() == 5 and int(i[0]) == 0
    with pytest.raises(ValueError):
        idx.search(np.zeros(9, np.float32), 2)
    with pytest.raises(ValueError):
        idx.search(x, 2, filter_mode="fast")


def test_cagra_deterministic_search_and_build():
    x = clustered(3000, 16, seed=5)
    cfg = ZT.CagraConfig(dim=16, degree=16, seed=7)
    idx = ZT.CagraIndex(cfg, device=CPU)
    idx.build(x)
    runs = [idx.search(x[:32], 5)[1] for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(runs[0], r)
    other = ZT.CagraIndex(cfg, device=CPU)      # one seed, one index
    other.build(x)
    assert torch.equal(other.state.nbrs, idx.state.nbrs)
    assert torch.equal(other.state.a_rows, idx.state.a_rows)


def test_cagra_save_load_get(corpus, tmp_path):
    x, _ = corpus
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16), device=CPU)
    idx.build(x)
    s0, i0 = idx.search(x[:16], 5)
    path = str(tmp_path / "cagra.npz")
    idx.save(path)
    loaded = ZT.CagraIndex.load(path, device=CPU)
    s1, i1 = loaded.search(x[:16], 5)
    assert torch.equal(i0, i1)
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(loaded.get([0, 100]), x[[0, 100]], rtol=1e-6)
    loaded.insert(x[:10] + 0.5)
    assert len(loaded) == 3010
    with pytest.raises(IndexError):
        loaded.get([5000])


def test_cagra_int8(corpus):
    x, q = corpus
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=24, dtype="int8"), device=CPU)
    idx.build(x)
    assert idx.state.vectors.dtype == torch.int8
    _, ids = idx.search(q, 10, ef_search=48)
    # judged against exact kNN over the dequantized stored data
    _, gt = ZT.exact_ground_truth(idx.get(np.arange(3000)), q, 10, device=CPU)
    assert recall_at_k(ids.numpy(), gt, 10) >= 0.90


def test_remove_compact(corpus):
    x, q = corpus
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16), device=CPU)
    idx.build(x)
    dead = np.arange(0, 3000, 3)
    assert idx.remove(dead) == 1000 and idx.remove(dead[:5]) == 0
    assert len(idx) == 2000
    _, ids = idx.search(x[:300], 5)
    assert not np.isin(ids.numpy(), dead).any()
    with pytest.raises(IndexError):
        idx.get([0])
    live = idx.compact()
    assert len(idx) == 2000 and live.size == 2000
    ids = np.asarray(idx.search(x[live[:200]], 1)[1])
    assert (ids[:, 0] == np.arange(200)).mean() >= 0.95


def test_filtered_search_is_exact_in_scan_mode(corpus):
    x, q = corpus
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16), device=CPU)
    idx.build(x)
    allowed = np.arange(0, 3000, 7)
    _, ids = idx.search(q, 10, allowed=allowed, filter_mode="scan")
    _, gt = ZT.exact_ground_truth(x[allowed], q, 10, device=CPU)
    np.testing.assert_array_equal(ids.numpy(), allowed[gt])


def test_segmented_upload_overlap_build(monkeypatch):
    monkeypatch.setattr(cagra_mod, "_OVERLAP_MIN_N", 1000)
    x = clustered(3000, 16, seed=6, nc=50, spread=0.12)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, upload_segments=8), device=CPU)
    idx.build(x[:2997])   # odd n exercises the tail segment
    assert self_hit(idx, x, np.arange(512), ef_search=24) >= 0.9


def test_search_knob_overrides_match_config():
    x = clustered(3000, 16, seed=21)
    base = ZT.CagraConfig(dim=16, degree=16, search_degree=24, max_iters=8, seed=5)
    idx = ZT.CagraIndex(base, device=CPU)
    idx.build(x)
    s_o, i_o = idx.search(x[:128], 5, ef_search=16, search_degree=8, max_iters=3)
    other = ZT.CagraIndex(dataclasses.replace(base, search_degree=8, max_iters=3), device=CPU)
    other.state = idx.state
    s_c, i_c = other.search(x[:128], 5, ef_search=16)
    assert torch.equal(i_o, i_c)
    np.testing.assert_allclose(s_o.numpy(), s_c.numpy(), rtol=1e-6)
    other2 = ZT.CagraIndex(base, device=CPU)
    other2.state = idx.state
    assert torch.equal(idx.search(x[:128], 5, ef_search=16)[1],
                       other2.search(x[:128], 5, ef_search=16)[1])


def test_block_topk_pallas_build():
    # tests/test_pallas_topk.py: the block scorer's build is of the same class
    x = clustered(3000, 16, seed=12, nc=40, spread=0.12)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, block_topk="pallas"), device=CPU)
    idx.build(x)
    assert self_hit(idx, x, np.arange(512), ef_search=24) >= 0.95


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert ZT.CagraIndex(ZT.CagraConfig(dim=4)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            ZT.CagraIndex(ZT.CagraConfig(dim=4))


def test_config_validation():
    with pytest.raises(ValueError):
        ZT.CagraConfig(dim=8, metric="hamming")
    with pytest.raises(ValueError):
        ZT.CagraConfig(dim=0)
    assert ZT.CagraConfig(dim=8).packed and not ZT.CagraConfig(dim=8, dtype="int8").packed
    assert ZT.CagraConfig(dim=8, dtype="bfloat16").storage_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# fat rows (tests/test_fat_rows.py)


@pytest.fixture(scope="module")
def fat_pair():
    x = clustered(3000, 24, seed=7)
    out = {}
    for metric in ("l2", "cosine"):
        pair = []
        for fat in ("off", "on"):
            idx = ZT.CagraIndex(ZT.CagraConfig(dim=24, degree=16, metric=metric, fat_rows=fat,
                                               precision="highest", seed=1), device=CPU)
            idx.build(x)
            pair.append(idx)
        out[metric] = pair
    return x, out


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_fat_matches_thin(fat_pair, metric):
    x, pairs = fat_pair
    thin, fat = pairs[metric]
    assert fat._fat_enabled() and not thin._fat_enabled()
    # at "highest": the packed thin layout carries ||x||^2 inside the
    # product, the fat one adds it after, so at "high" their roundings differ
    q = x[:100] + 0.01
    _same(thin.search(q, 10), fat.search(q, 10))


def test_fat_pack_invalidated_on_insert():
    x = clustered(1500, 24, seed=7)
    fat = ZT.CagraIndex(ZT.CagraConfig(dim=24, degree=16, fat_rows="on"), device=CPU)
    fat.build(x)
    fat.search(x[:4], 3)
    assert fat._fat_pack is not None
    extra = clustered(64, 24, seed=9)
    fat.insert(extra)
    _, ids = fat.search(extra, 1)
    assert (ids[:, 0].numpy() == 1500 + np.arange(64)).mean() >= 0.9


def test_fat_auto_respects_budget():
    x = clustered(500, 24, seed=3)
    small = ZT.CagraIndex(ZT.CagraConfig(dim=24, degree=8, fat_rows="auto",
                                         fat_budget_bytes=100), device=CPU)
    small.build(x)
    assert not small._fat_enabled()
    big = ZT.CagraIndex(ZT.CagraConfig(dim=24, degree=8, fat_rows="auto"), device=CPU)
    big.build(x)
    assert big._fat_enabled()
    off = ZT.CagraIndex(ZT.CagraConfig(dim=24, degree=8), device=CPU)
    off.build(x)
    assert not off._fat_enabled()


# ---------------------------------------------------------------------------
# a hub every point picks (tests/test_reverse_hub.py), anchor refresh
# (tests/test_anchor_refresh.py)


def test_hub_row_keeps_nearest_and_stays_searchable():
    n, d = 2000, 128
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= (1.0 + 0.01 * rng.standard_normal((n, 1))).astype(np.float32)
    x[0] = 0.0
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=d, degree=16), device=CPU)
    idx.build(x)
    nbrs, dists = idx.state.nbrs[0].numpy(), idx.state.dists[0].numpy()
    assert (nbrs >= 0).sum() >= 12
    finite = np.isfinite(dists)
    assert finite.sum() >= 12 and dists[finite].max() < 2.0
    assert int(idx.search(x[:1], 1)[1][0, 0]) == 0
    assert self_hit(idx, x, np.arange(100, 200)) >= 0.9
    ids2 = idx.search(x[100:164], 2)[1].numpy()
    assert (ids2 == 0).any(axis=1).mean() >= 0.9


def test_anchor_refresh_10x_growth():
    d, n0, n_total = 16, 300, 3000
    x = clustered(n_total, d, seed=11, nc=60, spread=0.12)
    cfg = ZT.CagraConfig(dim=d, degree=16, build_batch=512)
    idx = ZT.CagraIndex(cfg, device=CPU)
    idx.build(x[:n0])
    assert idx._anchor_n == n0
    idx.insert(x[n0:])
    idx.flush()
    assert int(idx.state.a_rows.max()) >= n0
    assert idx._anchor_n >= 2 * n0
    fresh = ZT.CagraIndex(cfg, device=CPU)
    fresh.build(x)
    tail = np.arange(n_total - 300, n_total)
    grown_hit = self_hit(idx, x, tail, ef_search=48)
    fresh_hit = self_hit(fresh, x, tail, ef_search=48)
    assert grown_hit >= fresh_hit - 0.05, (grown_hit, fresh_hit)
    assert grown_hit >= 0.85, grown_hit
