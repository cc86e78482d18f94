"""zvdb_tpu_torch.FlatIndex against zvdb_tpu.FlatIndex on one corpus.

Both packages index the same seeded numpy data (the port on device="cpu")
and must return the same ids; scores agree within rtol 1e-5 (other
summation orders). Mirrors tests/test_flat.py and the engine cases of
tests/test_pallas_topk.py.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.index.flat import state_from_numpy

CPU = "cpu"
STOL = dict(rtol=1e-5, atol=1e-5)


def _pair(x, capacity=0, **cfg):
    j = ZJ.FlatIndex(ZJ.FlatConfig(**cfg), capacity=capacity)
    t = ZT.FlatIndex(ZT.FlatConfig(**cfg), capacity=capacity, device=CPU)
    if x is not None:
        j.add(x)
        t.add(x)
    return j, t


def _same(out_j, out_t, stol=STOL):
    sj, ij = (np.array(a) for a in out_j)
    st, it = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(it, ij)
    assert it.dtype == np.int32 and st.dtype == np.float32
    np.testing.assert_allclose(st, sj, **stol)


def _clustered(seed, n, d, nq, nc=32, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    x = (centers[rng.integers(0, nc, n)] + spread * rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_exact_search_matches_jax(rng, metric):
    x = rng.standard_normal((700, 16)).astype(np.float32)
    q = rng.standard_normal((13, 16)).astype(np.float32)
    j, t = _pair(x, dim=16, metric=metric, tile_n=256)
    _same(j.search(q, 10), t.search(q, 10))
    _same(j.search(q[0], 4), t.search(q[0], 4))   # single-query squeeze


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_storage_dtypes_match_jax(rng, dtype):
    x = rng.standard_normal((900, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    j, t = _pair(x, dim=24, dtype=dtype)
    assert t.state.vectors.dtype == t.cfg.storage_dtype
    _same(j.search(q, 8), t.search(q, 8))
    np.testing.assert_allclose(t.get([0, 5, 899]), np.array(j.get([0, 5, 899])), **STOL)


def test_tiled_matches_untiled(rng):
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    _, a = _pair(x, dim=16, tile_n=128)
    j, b = _pair(x, dim=16, tile_n=100000)
    ta, tb = a.search(q, 7), b.search(q, 7)
    assert torch.equal(ta[1], tb[1])
    _same(j.search(q, 7), ta)


def test_empty_and_k_above_n(rng):
    j, t = _pair(None, dim=8)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    s, i = t.search(q, 5)
    assert (i.numpy() == -1).all() and np.isinf(s.numpy()).all() and len(t) == 0
    x = rng.standard_normal((2, 8)).astype(np.float32)
    j.add(x)
    t.add(x)
    _same(j.search(q[:1], 5), t.search(q[:1], 5))
    assert (t.search(q[:1], 5)[1].numpy()[0, 2:] == -1).all()


def test_incremental_adds_and_growth(rng):
    j, t = _pair(None, capacity=4, dim=8)
    xs = rng.standard_normal((40, 8)).astype(np.float32)
    for row in xs:
        j.insert(row)
        t.insert(row)
    assert len(t) == len(j) == 40 and t.capacity == 64
    q = rng.standard_normal((6, 8)).astype(np.float32)
    _same(j.search(q, 5), t.search(q, 5))
    s, i = t.search(xs[13], 1)
    assert int(i[0]) == 13 and float(s[0]) < 1e-5


def test_remove_compact_get(rng):
    x = rng.standard_normal((500, 12)).astype(np.float32)
    q = x[:20] + 0.01
    j, t = _pair(x, dim=12, dtype="int8")
    dead = [0, 3, 3, 17, 499]
    assert t.remove(dead) == j.remove(dead) == 4
    assert t.remove([3]) == 0 and len(t) == len(j) == 496
    _same(j.search(q, 6), t.search(q, 6))
    with pytest.raises(IndexError):
        t.get([3])
    with pytest.raises(IndexError):
        t.remove([500])
    np.testing.assert_array_equal(t.compact(), j.compact())
    assert len(t) == 496 and t.capacity == 496
    _same(j.search(q, 6), t.search(q, 6))
    np.testing.assert_allclose(t.get([0, 100]), np.array(j.get([0, 100])), **STOL)
    t.remove(list(range(496)))
    t.compact()
    assert t.state is None and (t.search(q, 3)[1].numpy() == -1).all()


@pytest.mark.parametrize("form", ["mask", "ids"])
@pytest.mark.parametrize("approx", [False, True])
def test_allowed_filter(rng, form, approx):
    x = rng.standard_normal((600, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    keep = rng.random(600) < 0.1
    allowed = keep if form == "mask" else np.flatnonzero(keep)
    j, t = _pair(x, dim=16, scan="pallas", l_bins=64, pallas_chunk=128, rerank=2)
    ot = t.search(q, 10, approx=approx, allowed=allowed)
    _same(j.search(q, 10, approx=approx, allowed=allowed), ot)
    assert np.isin(ot[1].numpy(), np.flatnonzero(keep)).all()
    with pytest.raises(IndexError):
        t.search(q, 3, allowed=[600])


def test_search_range_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = x[:32] + 0.01
    for metric, radius in (("l2", 2.0), ("dot", 5.0)):
        j, t = _pair(x, dim=16, metric=metric, tile_n=1024)
        oj, ot = j.search_range(q, radius, max_results=64), t.search_range(q, radius, max_results=64)
        _same(oj[:2], ot[:2], stol=dict(rtol=1e-5, atol=1e-4))
        np.testing.assert_array_equal(ot[2].numpy(), np.array(oj[2]))
    j.remove([0, 1])
    t.remove([0, 1])
    np.testing.assert_array_equal(t.search_range(q, 5.0)[2].numpy(),
                                  np.array(j.search_range(q, 5.0)[2]))
    s1, i1, c1 = t.search_range(q[0], 5.0, max_results=8)
    assert s1.shape == (8,) and c1.ndim == 0
    assert t.search_range(q, 5.0)[2].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_two_pass_rerank(dtype):
    # the port's first pass rounds to bf16 ("default"), JAX's CPU pass is f32;
    # the exact rescore of 4k candidates makes the final ids agree
    x, q = _clustered(1, 2000, 24, 40)
    j, t = _pair(x, dim=24, dtype=dtype, rerank=4, recall_target=0.97)
    _same(j.search(q, 10, approx=True), t.search(q, 10, approx=True),
          stol=dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pca_path(metric):
    # the projected first pass is bf16 on the port (as on the TPU) and f32 in
    # JAX on the CPU; with rerank=16 both candidate pools hold the true top-10
    # (at rerank=8 both reach 0.95 recall, with 5% of ids differing)
    x, q = _clustered(2, 3000, 64, 60, nc=24, spread=0.2)
    j, t = _pair(x, dim=64, metric=metric, pca_dim=16, rerank=16)
    _same(j.search(q, 10, approx=True), t.search(q, 10, approx=True),
          stol=dict(rtol=1e-5, atol=1e-4))
    t.remove(list(range(50)))   # deletes invalidate and re-derive the projection
    ids = t.search(x[:50], 5, approx=True)[1].numpy()
    assert not np.isin(ids, np.arange(50)).any()


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_scan_path(rerank, dtype):
    x, q = _clustered(3, 1500, 13, 19)
    j, t = _pair(x, dim=13, dtype=dtype, scan="pallas", rerank=rerank, l_bins=128,
                 pallas_chunk=256, pallas_bq=8)
    _same(j.search(q, 10, approx=True), t.search(q, 10, approx=True),
          stol=dict(rtol=1e-5, atol=1e-4))


def test_pallas_scan_exact_when_bins_cover_corpus():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((500, 13)).astype(np.float32)
    q = rng.standard_normal((16, 13)).astype(np.float32)
    exact = ZT.FlatIndex(ZT.FlatConfig(dim=13), capacity=512, device=CPU)
    exact.add(x)
    pal = ZT.FlatIndex(ZT.FlatConfig(dim=13, scan="pallas", l_bins=512, pallas_chunk=512),
                       capacity=512, device=CPU)
    pal.add(x)
    es, ei = exact.search(q, 10)
    ps, pi = pal.search(q, 10, approx=True)
    assert torch.equal(pi, ei)
    np.testing.assert_allclose(ps.numpy(), es.numpy(), rtol=1e-4, atol=1e-4)


def test_dimension_mismatch_raises():
    t = ZT.FlatIndex(ZT.FlatConfig(dim=8), capacity=10, device=CPU)
    with pytest.raises(ValueError):
        t.add(np.zeros((2, 9), np.float32))
    t.add(np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError):
        t.search(np.zeros((1, 4), np.float32), 1)
    with pytest.raises(ValueError):
        t.search_range(np.zeros((1, 4), np.float32), 1.0)


@pytest.mark.parametrize("precision", ["float32", "high"])
def test_masked_exact_search(rng, precision):
    from zvdb_tpu.index.flat import masked_exact_search as mj
    from zvdb_tpu_torch.index.flat import masked_exact_search as mt

    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    bias = (x * x).sum(1)
    bias[rng.random(500) < 0.5] = np.inf          # blocked rows
    scales = np.ones(500, np.float32)
    ot = mt(torch.from_numpy(x), torch.from_numpy(bias), torch.from_numpy(scales),
            torch.from_numpy(q), 8, "l2", tile_n=128, precision=precision)
    oj = mj(x, bias, scales, q, 8, "l2", tile_n=128, precision=precision)
    if precision == "float32":
        _same(oj, ot)
    assert np.isfinite(bias[ot[1].numpy()]).all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_ground_truth(rng, metric):
    x = rng.standard_normal((400, 12)).astype(np.float32)
    q = rng.standard_normal((9, 12)).astype(np.float32)
    sj, ij = ZJ.exact_ground_truth(x, q, 5, metric=metric, tile_n=128)
    st, it = ZT.exact_ground_truth(x, q, 5, metric=metric, tile_n=128, device=CPU)
    assert isinstance(it, np.ndarray)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, **STOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_state_from_numpy(rng, dtype):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    j = ZJ.FlatIndex(ZJ.FlatConfig(dim=16, dtype=dtype))
    j.add(x)
    j.remove([7])
    arrays = {f: np.asarray(getattr(j.state, f)) for f in ("vectors", "norms", "scales", "n")}
    st = state_from_numpy(arrays["vectors"], arrays["norms"], arrays["scales"], arrays["n"], CPU)
    assert st.n == 300 and st.vectors.dtype == ZT.FlatConfig(dim=16, dtype=dtype).storage_dtype
    np.testing.assert_array_equal(st.vectors.float().numpy(),
                                  np.array(j.state.vectors.astype(np.float32)))
    t = ZT.FlatIndex.from_numpy(dataclasses.asdict(j.cfg), arrays, device=CPU)
    assert len(t) == len(j) == 299
    _same(j.search(q, 6), t.search(q, 6))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_save_load_both_directions(tmp_path, rng, dtype):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    j, t = _pair(x, dim=16, dtype=dtype, metric="cosine", scan="pallas", l_bins=64)
    j.remove([4, 9])
    t.remove([4, 9])
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "torch.npz"))
    t_from_j = ZT.FlatIndex.load(str(tmp_path / "jax.npz"), device=CPU)
    j_from_t = ZJ.FlatIndex.load(str(tmp_path / "torch.npz"))
    assert t_from_j.cfg == t.cfg and j_from_t.cfg == j.cfg
    assert t_from_j.capacity == j_from_t.capacity == 1024
    assert len(t_from_j) == len(j_from_t) == 298
    for a, b in ((j, t_from_j), (j_from_t, t)):
        _same(a.search(q, 7), b.search(q, 7))
    with np.load(str(tmp_path / "torch.npz")) as z:
        assert json.loads(str(z["cfg"])) == dataclasses.asdict(j.cfg)


def test_load_reads_jax_bf16_file(tmp_path, rng):
    x = rng.standard_normal((100, 8)).astype(np.float32)
    j, t = _pair(x, dim=8, dtype="bfloat16")
    j.save(str(tmp_path / "jax.npz"))
    loaded = ZT.FlatIndex.load(str(tmp_path / "jax.npz"), device=CPU)
    assert torch.equal(loaded.state.vectors, t.state.vectors)
    t.save(str(tmp_path / "torch.npz"))   # the same bytes layout JAX writes
    with np.load(str(tmp_path / "torch.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert a["vectors"].dtype == b["vectors"].dtype
        assert a["vectors"].tobytes() == b["vectors"].tobytes()


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ZT.FlatIndex(ZT.FlatConfig(dim=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ZT.exact_ground_truth(np.zeros((3, 4), np.float32), np.zeros((1, 4), np.float32), 1)


def test_config_validation_and_dtype():
    with pytest.raises(ValueError):
        ZT.FlatConfig(dim=4, metric="hamming")
    with pytest.raises(ValueError):
        ZT.FlatConfig(dim=4, scan="triton")
    assert [f.name for f in dataclasses.fields(ZT.FlatConfig)] == \
        [f.name for f in dataclasses.fields(ZJ.FlatConfig)]
    assert dataclasses.asdict(ZT.FlatConfig(dim=4)) == dataclasses.asdict(ZJ.FlatConfig(dim=4))
    assert ZT.FlatConfig(dim=4, dtype="bfloat16").storage_dtype == torch.bfloat16
