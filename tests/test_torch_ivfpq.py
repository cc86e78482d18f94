"""zvdb_tpu_torch.IVFPQIndex on the CPU, against its contract and the JAX package.

The engine tests mirror tests/test_ivfpq.py on indexes the port trains
itself (device="cpu"): recall against exact_ground_truth, self-hits,
user-facing scores, adds with stable ids, spill vs repack, deletes, exact
filtered search, search_range, save/load, cosine, chunked builds.

Training draws from each package's own random numbers, so for id
comparisons the JAX package builds the index and `IVFPQIndex.from_numpy`
carries its state across: both then search the same centroids, codebooks
and blocks and must return the same ids. The JAX side runs its Pallas
grouped kernel in interpret mode, the port the kernel's plain version.
Scores agree within 1e-5 of the terms an l2 distance cancels from (see
`_same`), the tolerance of test_torch_pqflat.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
import zvdb_tpu_torch.index.ivfpq as ivfpq_mod

CPU = "cpu"
BASE = dict(n_sub=16, nprobe=8, rerank=12)


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(7)
    d = 64
    cents = r.normal(size=(512, d)).astype(np.float32)
    x = (cents[r.integers(0, 512, 8000)] + 0.25 * r.normal(size=(8000, d))).astype(np.float32)
    q = (cents[r.integers(0, 512, 100)] + 0.25 * r.normal(size=(100, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def built(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE), device=CPU)
    idx.build(x)
    return idx


def _self_hits(idx, x, lo, hi):
    _, ids = idx.search(x[lo:hi], 1)
    return float((ids[:, 0].numpy() == np.arange(lo, hi)).mean())


def test_build_recall(corpus, built):
    x, q = corpus
    _, gt = ZT.exact_ground_truth(x, q, 10, device=CPU)
    _, got = built.search(q, 10)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    got = got.numpy()
    rec = np.mean([len(set(gt[i]) & set(got[i])) / 10 for i in range(len(q))])
    assert rec >= 0.95, rec
    assert _self_hits(built, x, 0, 100) >= 0.97


def test_scores_are_user_facing(corpus, built):
    """l2 scores are squared distances to the refine-store rows."""
    x, q = corpus
    s, ids = (a.numpy() for a in built.search(q[:10], 5))
    for b in range(10):
        assert np.all(np.diff(s[b]) >= -1e-3)
        for j in range(5):
            true = ((q[b] - x[ids[b, j]]) ** 2).sum()
            assert abs(s[b, j] - true) < 1e-2 * max(true, 1.0)


def test_add_then_search_id_stability(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE), device=CPU)
    idx.build(x[:6000])
    idx.add(x[6000:7000])
    idx.add(torch.from_numpy(x[7000:8000]))
    assert len(idx) == 8000
    assert _self_hits(idx, x, 5950, 6050) >= 0.95        # ids continue across build/add
    assert np.allclose(idx.get([6001, 7500]), x[[6001, 7500]], atol=0.05)


def test_add_overflow_repacks(corpus):
    """Appends past block capacity trigger the repack; ids stay valid."""
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, block_headroom=1.05), device=CPU)
    idx.build(x[:2000])
    cap0 = idx.state.codes_blocks.shape[2]
    idx.add(x[2000:8000])
    idx.flush()
    assert len(idx) == 8000 and idx.state.codes_blocks.shape[2] > cap0
    assert _self_hits(idx, x, 0, 50) >= 0.95
    assert _self_hits(idx, x, 5000, 5050) >= 0.95


def test_empty_and_k_gt_n():
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, n_sub=16), device=CPU)
    s, i = idx.search(np.zeros((3, 64), np.float32), 4)
    assert (i == -1).all() and torch.isinf(s).all()
    idx.build(np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32))
    _, i = idx.search(np.zeros((2, 64), np.float32), 8)
    i = i.numpy()
    assert (i >= 0).sum(axis=1).min() == 5               # k > n: trailing -1
    assert np.all(i[:, 5:] == -1)


def test_dim_mismatch_raises(built):
    with pytest.raises(ValueError):
        built.search(np.zeros((2, 65), np.float32), 3)
    with pytest.raises(ValueError):
        built.add(np.zeros((2, 65), np.float32))
    with pytest.raises(ValueError):
        built.search_range(np.zeros((2, 65), np.float32), 1.0)


def test_remove_compact(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE), device=CPU)
    idx.build(x[:2000])
    assert idx.remove([0, 5, 7]) == 3
    assert idx.remove([5]) == 0                          # already dead
    assert len(idx) == 1997
    with pytest.raises(IndexError):
        idx.remove([2000])
    _, ids = idx.search(x[:1], 3)
    assert 0 not in ids.numpy().ravel().tolist()
    with pytest.raises(IndexError):
        idx.get([5])
    old = idx.compact()
    assert len(old) == 1997 and 0 not in old and 5 not in old
    pos = int(np.flatnonzero(old == 10)[0])              # survivor new id = position in old
    _, ids = idx.search(x[10:11], 1)
    assert int(ids[0, 0]) == pos


def test_filtered_search_exact(corpus, built):
    """filter_mode="auto" below the crossover is the exact masked scan."""
    x, q = corpus
    allowed = np.zeros(8000, bool)
    allowed[::7] = True
    _, ids = built.search(q[:20], 5, allowed=allowed)
    ids = ids.numpy()
    assert np.all((ids % 7 == 0) | (ids == -1))
    sub = np.flatnonzero(allowed)
    d2 = ((q[:20, None, :] - x[None, sub, :]) ** 2).sum(-1)
    gt = sub[np.argsort(d2, axis=1)[:, :5]]
    agree = np.mean([len(set(gt[i]) & set(ids[i])) / 5 for i in range(20)])
    assert agree >= 0.95, agree
    _, ids = built.search(q[:20], 5, allowed=np.arange(0, 8000, 7), filter_mode="probe")
    ids = ids.numpy()
    assert np.all((ids % 7 == 0) | (ids == -1))
    with pytest.raises(ValueError):
        built.search(q[:2], 5, filter_mode="beam")


def test_search_range(corpus, built):
    x, q = corpus
    d2 = ((q[:10, None, :] - x[None, :, :]) ** 2).sum(-1)
    radius = float(np.quantile(d2[:, :500], 0.01))
    s, i, c = (a.numpy() for a in built.search_range(q[:10], radius=radius))
    assert np.all((i >= 0) | np.isinf(s))
    assert np.all(s[i >= 0] <= radius)
    # the refine store is int16: counts match the exact count up to rows
    # within 1e-3 of the boundary
    lo = (d2 <= radius - 1e-3).sum(1)
    hi = (d2 <= radius + 1e-3).sum(1)
    assert np.all((c >= lo) & (c <= hi))
    s1, _, _ = built.search_range(q[0], radius=radius, max_results=4)
    assert s1.shape == (4,)
    # a deleted row no longer counts (on an index of its own: `built` is shared)
    own = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE), device=CPU)
    own.build(x)
    _, i0, c0 = own.search_range(q[:1], radius=radius)
    own.remove([int(i0[0, 0])])
    _, i2, c2 = own.search_range(q[:1], radius=radius)
    assert int(c2[0]) == int(c0[0]) - 1 and int(i0[0, 0]) not in i2[0].tolist()
    with pytest.raises(ValueError):
        ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, refine="none"), device=CPU).search_range(q[0], 1.0)


def test_save_load_roundtrip(tmp_path, corpus, built):
    _, q = corpus
    p = str(tmp_path / "ivfpq.npz")
    built.save(p)
    idx2 = ZT.IVFPQIndex.load(p, device=CPU)
    s1, i1 = built.search(q[:20], 5)
    s2, i2 = idx2.search(q[:20], 5)
    assert torch.equal(i1, i2) and torch.allclose(s1, s2, rtol=1e-5)
    empty = str(tmp_path / "empty.npz")
    ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64), device=CPU).save(empty)
    e = ZT.IVFPQIndex.load(empty, device=CPU)
    assert e.state is None and len(e) == 0


def test_cosine_metric(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, metric="cosine"), device=CPU)
    idx.build(x[:2000])
    s, _ = idx.search(x[:50], 1)
    assert _self_hits(idx, x, 0, 50) >= 0.95
    assert (s[:, 0] > 0.99).all()                        # self-similarity ~1


def test_expected_rows_chunked_build(corpus):
    """expected_rows pre-sizes blocks and the refine store: chunked adds
    append O(batch) with no overflow repack."""
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, expected_rows=8000, n_clusters=64),
                        device=CPU)
    idx.build(x[:2000])
    cap0, rcap0 = idx.state.codes_blocks.shape[2], idx.state.refine.shape[0]
    assert rcap0 >= 8000
    for lo in range(2000, 8000, 2000):
        idx.add(x[lo:lo + 2000])
        idx.flush()
    assert idx.state.codes_blocks.shape[2] == cap0 and idx.state.refine.shape[0] == rcap0
    assert idx.state.n == 8000 and isinstance(idx.state.n, int)
    assert _self_hits(idx, x, 6950, 7050) >= 0.95


def test_config_validation_and_properties():
    for bad in (dict(dim=60), dict(dim=64, n_sub=4), dict(dim=64, l_bins=100),
                dict(dim=64, metric="cityblock"), dict(dim=64, chunk=300),
                dict(dim=64, per_bin=3), dict(dim=64, refine="fp8"),
                dict(dim=64, scan_precision="highest"), dict(dim=0, n_sub=8)):
        with pytest.raises(ValueError):
            ZT.IVFPQConfig(**bad)
    for refine in ("none", "int8", "int16", "float32", "bfloat16"):
        t, j = ZT.IVFPQConfig(dim=64, refine=refine), ZJ.IVFPQConfig(dim=64, refine=refine)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.dsub, t.nb, t.bytes_per_vector) == (j.dsub, j.nb, j.bytes_per_vector)
        assert str(t.refine_dtype).split(".")[-1] == str(np.dtype(j.refine_dtype))


def test_small_overflow_spills_not_repacks(corpus):
    """A batch that overfills one cluster a little is absorbed by spilling
    to the next-nearest centroid with spare capacity: no repack, and every
    row stays findable (non-residual scores do not depend on the cluster)."""
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, n_clusters=64, expected_rows=8000),
                        device=CPU)
    idx.build(x[:6000])
    cap0, c0 = idx.state.codes_blocks.shape[2], idx.state.centroids.shape[0]
    counts = idx.state.counts.numpy()
    hot = int(np.argmax(counts))
    spare = cap0 - int(counts[hot])
    burst = (idx.state.centroids[hot].numpy()[None]
             + 0.001 * np.random.default_rng(0).normal(size=(spare + 16, 64))).astype(np.float32)
    idx.add(burst)
    idx.flush()
    st = idx.state
    assert st.codes_blocks.shape[2] == cap0 and st.centroids.shape[0] == c0
    assert st.n == 6000 + spare + 16
    _, ids = idx.search(burst[:32], spare + 16)
    missing = set(range(6000, 6000 + spare + 16)) - set(ids.numpy().ravel().tolist())
    assert not missing, sorted(missing)[:5]


def test_refine_growth_without_repack(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, n_clusters=64, block_headroom=4.0),
                        device=CPU)
    idx.build(x[:1000])
    cap0, rcap0 = idx.state.codes_blocks.shape[2], idx.state.refine.shape[0]
    idx.add(x[1000:4000])                 # the blocks have 4x headroom; the store does not
    idx.flush()
    st = idx.state
    assert st.refine.shape[0] > rcap0 and st.codes_blocks.shape[2] == cap0
    assert st.n == 4000
    assert _self_hits(idx, x, 3950, 4000) >= 0.95
    assert np.allclose(idx.get([1001, 3500]), x[[1001, 3500]], atol=0.05)


def test_repack_streams_host_segments(corpus, monkeypatch):
    """The host-streamed repack (past _REPACK_SPLIT_MAX_ROWS), forced at CPU
    scale through the module threshold; tombstones survive it."""
    monkeypatch.setattr(ivfpq_mod, "_REPACK_SPLIT_MAX_ROWS", 100)
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, block_headroom=1.05, n_clusters=32),
                        device=CPU)
    idx.build(x[:2000])
    c0, cap0 = idx.state.centroids.shape[0], idx.state.codes_blocks.shape[2]
    idx.remove([3])
    idx.add(x[2000:8000])
    idx.flush()
    assert len(idx) == 7999 and idx.state.codes_blocks.shape[2] > cap0   # repacked
    assert idx.state.centroids.shape[0] == c0                            # without a split
    assert _self_hits(idx, x, 7000, 7050) >= 0.95
    _, ids = idx.search(x[:50], 1)
    hit = ids[:, 0].numpy() == np.arange(50)
    assert hit.mean() >= 0.95 and not hit[3]
    assert 3 not in idx.search(x[3], 5)[1].tolist()


def test_final_chunk_pow2_padding_does_not_grow_refine(corpus):
    x, _ = corpus
    idx = ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64, **BASE, n_clusters=64, expected_rows=8000),
                        device=CPU)
    idx.build(x[:3000])
    rcap0 = idx.state.refine.shape[0]
    assert 3000 + (1 << 13) > rcap0                    # pow2 padding (8192) would overshoot
    idx.add(x[3000:8000])
    idx.flush()                                        # 1024-multiple padding fits
    assert idx.state.refine.shape[0] == rcap0 and idx.state.n == 8000
    assert _self_hits(idx, x, 7900, 8000) >= 0.95


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ZT.IVFPQIndex(ZT.IVFPQConfig(dim=64))


# ---------------------------------------------------------------------------
# the same state in both packages


JBASE = dict(dim=32, n_sub=8, nprobe=8, rerank=12, l_bins=128, chunk=128, train_sample=2048)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    cents = rng.normal(size=(128, 32)).astype(np.float32)
    x = (cents[rng.integers(0, 128, 4000)] + 0.25 * rng.normal(size=(4000, 32))).astype(np.float32)
    q = (x[rng.integers(0, 4000, 80)] + 0.05 * rng.normal(size=(80, 32))).astype(np.float32)
    return x, q


_BUILT = {}


def _jax_index(small, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _BUILT:
        j = ZJ.IVFPQIndex(ZJ.IVFPQConfig(**{**JBASE, **kw}))
        j.build(small[0])
        _BUILT[key] = j
    return _BUILT[key]


def _arrays(j):
    return {f: np.asarray(getattr(j.state, f)) for f in j.state._fields}


def _with_precision(j, precision):
    """The JAX index j under another scan precision (a copy of its state:
    the JAX append donates its buffers), and the port's index over the same
    state."""
    import jax.numpy as jnp

    cfg = dataclasses.replace(j.cfg, scan_precision=precision)
    j2 = ZJ.IVFPQIndex(cfg)
    j2.state = type(j.state)(*(jnp.array(a, copy=True) for a in j.state))
    j2._n_inserted, j2._trained, j2._dead = j._n_inserted, True, set(j._dead)
    return j2, ZT.IVFPQIndex.from_numpy(dataclasses.asdict(cfg), _arrays(j), device=CPU)


def _same(out_j, out_t, q):
    """Ids equal; scores within 1e-5 of the terms they cancel from (an l2
    distance is ||x||^2 - 2 q.x + ||q||^2)."""
    sj, ij = (np.array(a) for a in out_j)
    st, it = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(it, ij)
    assert it.dtype == np.int32 and st.dtype == np.float32
    scale = 4.0 * float((np.atleast_2d(q) ** 2).sum(1).max())
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("refine", ["int16", "int8", "float32", "bfloat16", "none"])
def test_search_same_ids_as_jax(small, refine):
    _, q = small
    j = _jax_index(small, refine=refine)
    for precision in ("int8", "default", "high"):
        jj, t = _with_precision(j, precision)
        assert t.state.refine.dtype == t.cfg.refine_dtype and t.state.n == 4000
        _same(jj.search(q, 10), t.search(q, 10), q)
    _same(jj.search(q[3], 5), t.search(q[3], 5), q[3])        # single-query squeeze


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_metrics_same_ids_as_jax(small, metric):
    _, q = small
    j = _jax_index(small, metric=metric)
    jj, t = _with_precision(j, "int8")
    _same(jj.search(q[:40], 10), t.search(q[:40], 10), q[:40])


def test_overrides_filters_and_removes_same_ids_as_jax(small):
    x, q = small
    j = _jax_index(small, refine="int16")
    jj, t = _with_precision(j, "int8")
    _same(jj.search(q, 10, nprobe=3, rerank=4), t.search(q, 10, nprobe=3, rerank=4), q)
    # k * rerank = 12 <= 64: the pool cut takes the position-ordered route
    _same(jj.search(q, 6, rerank=2), t.search(q, 6, rerank=2), q)
    allowed = np.arange(0, 4000, 3)
    _same(jj.search(q[:30], 10, allowed=allowed, filter_mode="probe"),
          t.search(q[:30], 10, allowed=allowed, filter_mode="probe"), q[:30])
    gone = np.unique(np.array(jj.search(q[:30], 3)[1]).ravel())
    assert jj.remove(gone) == t.remove(gone) == gone.size
    _same(jj.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    assert len(t) == len(jj) == 4000 - gone.size
    np.testing.assert_allclose(t.get([0, 7, 3999]), jj.get([0, 7, 3999]), rtol=1e-6, atol=1e-6)
    # appends into spare capacity (no repack at this size) keep both in step
    extra = x[:300] + 0.01
    jj.add(extra)
    t.add(extra)
    _same(jj.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    for f in ("codes_blocks", "b_ids", "counts"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                      np.asarray(getattr(jj.state, f)))
    # decoded norms are sums over subspaces in another order: an ulp apart
    np.testing.assert_allclose(t.state.norms_blocks.numpy(), np.asarray(jj.state.norms_blocks),
                               rtol=1e-6)


@pytest.mark.parametrize("refine", ["int16", "bfloat16"])
def test_save_files_load_in_both_packages(small, refine, tmp_path):
    _, q = small
    j = _jax_index(small, refine=refine)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j.save(pj)
    t = ZT.IVFPQIndex.load(pj, device=CPU)
    assert t.state.refine.dtype == t.cfg.refine_dtype
    _same(j.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    t.remove([5, 6])
    t.save(pt)
    j2 = ZJ.IVFPQIndex.load(pt)
    assert np.asarray(j2.state.refine).dtype == np.asarray(j.state.refine).dtype
    assert len(j2) == len(t) == 3998 and j2._dead == {5, 6}
    _same(j2.search(q[:30], 10), t.search(q[:30], 10), q[:30])


def test_chunked_build_with_spill_matches_jax(monkeypatch):
    """bench_cuda.py's scale-row protocol at a cut size: JAX builds chunk 0
    with expected_rows, the port carries it by from_numpy, then both add +
    flush three more chunks, each with a burst that overfills one cluster so
    the spill-to-neighbour path runs (no repack). The states must agree:
    codes, ids, counts, centroids, the int16 refine rows and their scales
    exactly; decoded norms to 1e-6 relative (a sum over subspaces in another
    order); and the search ids at nprobe=16, rerank=32, up to near-ties (below)."""
    rng = np.random.default_rng(90)
    d, n_chunk, n_cent = 96, 1500, 48
    cents = rng.standard_normal((n_cent, d)).astype(np.float32) * 2.0

    def chunk(i):
        r = np.random.default_rng(9000 + i)
        return (cents[r.integers(0, n_cent, n_chunk)]
                + 0.25 * r.standard_normal((n_chunk, d))).astype(np.float32)

    chunks = [chunk(i) for i in range(4)]
    for i in (1, 2, 3):   # 200 rows around one chunk-0 row: past its cluster's cap
        chunks[i][:200] = chunks[0][17 * i] + 0.02 * rng.standard_normal((200, d))
    cfg = dict(dim=d, n_sub=48, refine="int16", l_bins=256, chunk=512, expected_rows=6000)
    j = ZJ.IVFPQIndex(ZJ.IVFPQConfig(**cfg))
    j.build(chunks[0])
    t = ZT.IVFPQIndex.from_numpy(dataclasses.asdict(j.cfg), _arrays(j), device=CPU)
    cap0 = t.state.codes_blocks.shape[2]

    moved = []
    spill = ZT.IVFPQIndex._assign_with_spill

    def spy(self, new, assign, counts, cap, t=8):
        out = spill(self, new, assign, counts, cap, t)
        moved.append(-1 if out is None else int((out != assign).sum()))
        return out

    monkeypatch.setattr(ZT.IVFPQIndex, "_assign_with_spill", spy)
    for x in chunks[1:]:
        for idx in (j, t):
            idx.add(x)
            idx.flush()
    assert len(moved) == 3 and min(moved) > 0, moved         # every chunk spilled
    assert t.state.codes_blocks.shape[2] == cap0 and t.state.n == len(j) == 6000
    for f in ("codes_blocks", "b_ids", "counts", "centroids"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(), np.asarray(getattr(j.state, f)))
    np.testing.assert_allclose(t.state.norms_blocks.numpy(), np.asarray(j.state.norms_blocks),
                               rtol=1e-6)
    for f in ("refine", "r_scales"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(), np.asarray(getattr(j.state, f)))
    # the same ids up to f32 near-ties of the rerank: at 96d a distance of
    # ~0.35 cancels from norms of ~400, and the packages sum the refine dot
    # products in other orders. Scores agree within _same's tolerance; where
    # an id differs, both ids' f64 distances to the query over the (equal)
    # refine rows agree within it too
    q = (chunks[3][rng.integers(0, n_chunk, 24)]
         + 0.05 * rng.standard_normal((24, d))).astype(np.float32)
    sj, ij = (np.array(a) for a in j.search(q, 10, nprobe=16, rerank=32))
    st, it = (a.numpy() for a in t.search(q, 10, nprobe=16, rerank=32))
    tol = 1e-5 * 4.0 * float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(st, sj, rtol=0, atol=tol)
    flip = it != ij
    assert flip.mean() < 0.02, flip.sum()
    rows = t.state.refine.numpy().astype(np.float64) * t.state.r_scales.numpy()[:, None]

    def d64(ids):
        return ((q[:, None, :].astype(np.float64) - rows[ids]) ** 2).sum(-1)

    np.testing.assert_allclose(d64(it)[flip], d64(ij)[flip], rtol=0, atol=tol)
