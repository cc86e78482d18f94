"""zvdb_tpu_torch.PQFlatIndex against zvdb_tpu.PQFlatIndex.

Training draws from each package's own PRNG, so the JAX package builds the
index and `PQFlatIndex.from_numpy` carries its state into the port (on
device="cpu"): both then search the same codebooks and codes and must return
the same ids. Scores agree within 1e-5 of the terms an l2 distance cancels
from (other summation orders; see `_same`). The
JAX side runs its Pallas ADC kernel in interpret mode; the port runs the
kernel's plain version. The exact decode scan is compared at
precision="highest": JAX's XLA dots compute f32 on the CPU for every
precision, the port rounds as the card does. Mirrors tests/test_pq.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT

CPU = "cpu"
STOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(dim=32, n_sub=8, train_sample=4096, rerank=16, l_bins=512, pallas_chunk=1024)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 5000, 32
    cents = rng.standard_normal((32, d)).astype(np.float32) * 3
    x = (cents[rng.integers(0, 32, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, 120)] + 0.05 * rng.standard_normal((120, d))).astype(np.float32)
    return x, q


def _arrays(j):
    st = j.state
    return dict(codes=np.asarray(st.codes), norms=np.asarray(st.norms),
                codebooks=np.asarray(st.codebooks), rot=np.asarray(st.rot),
                refine=np.asarray(st.refine), r_scales=np.asarray(st.r_scales),
                n=np.asarray(st.n))


def _port_of(j):
    return ZT.PQFlatIndex.from_numpy(dataclasses.asdict(j.cfg), device=CPU, **_arrays(j))


_BUILT = {}


def _jax_index(data, **kw):
    """A JAX-built index per configuration, shared across this module."""
    key = tuple(sorted(kw.items()))
    if key not in _BUILT:
        j = ZJ.PQFlatIndex(ZJ.PQConfig(**{**BASE, **kw}))
        j.build(data[0])
        _BUILT[key] = j
    return _BUILT[key]


def _same(out_j, out_t, q):
    """Ids equal; scores within 1e-5 of the terms they cancel from: an l2
    distance is ||x||^2 - 2 q.x + ||q||^2, and near a query those terms are
    ~300 on this data while the distance is ~0.1."""
    sj, ij = (np.array(a) for a in out_j)
    st, it = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(it, ij)
    assert it.dtype == np.int32 and st.dtype == np.float32
    scale = 4.0 * float((np.atleast_2d(q) ** 2).sum(1).max())
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("refine", ["int16", "float32", "int8", "none"])
def test_pallas_search_same_ids_as_jax(data, refine):
    _, q = data
    j = _jax_index(data, refine=refine, scan="pallas")
    t = _port_of(j)
    assert t.cfg.scan == "pallas" and t.cfg.scan_precision == "int8"
    assert t.state.codes.shape == (4, j.capacity) and t.state.codes.dtype == torch.uint8
    _same(j.search(q, 10), t.search(q, 10), q)
    _same(j.search(q[3], 5), t.search(q[3], 5), q[3])    # single-query squeeze


def test_rerank_override_same_ids_as_jax(data):
    _, q = data
    j = _jax_index(data, refine="int16", scan="pallas")
    _same(j.search(q[:40], 10, rerank=7), _port_of(j).search(q[:40], 10, rerank=7), q[:40])


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_metrics_same_ids_as_jax(data, metric):
    _, q = data
    j = _jax_index(data, metric=metric, scan="pallas")
    _same(j.search(q[:40], 10), _port_of(j).search(q[:40], 10), q[:40])


@pytest.mark.parametrize("refine,n_codes", [("int16", 16), ("none", 16), ("int8", 256)])
def test_exact_scan_same_ids_as_jax(data, refine, n_codes):
    # n_codes=256: one-byte codes, stored unpacked [cap, S]
    _, q = data
    j = _jax_index(data, refine=refine, n_codes=n_codes, precision="highest", tile_n=2048)
    t = _port_of(j)
    assert t.cfg.scan == "xla" and t.cfg.packed == (n_codes == 16)
    _same(j.search(q, 10, approx=False), t.search(q, 10, approx=False), q)
    np.testing.assert_allclose(t.get([0, 7, 4999]), np.asarray(j.get([0, 7, 4999])), **STOL)


def test_allowed_remove_compact_same_ids_as_jax(data):
    x, q = data
    j = ZJ.PQFlatIndex(ZJ.PQConfig(**BASE, scan="pallas"))
    j.build(x)
    t = _port_of(j)
    allowed = np.arange(0, 5000, 3)
    _same(j.search(q[:30], 10, allowed=allowed), t.search(q[:30], 10, allowed=allowed), q[:30])
    mask = np.zeros(5000, bool)
    mask[:800] = True
    _same(j.search(q[:30], 10, allowed=mask), t.search(q[:30], 10, allowed=mask), q[:30])
    gone = np.unique(np.array(j.search(q[:30], 3)[1]).ravel())
    assert j.remove(gone) == t.remove(gone) == gone.size
    _same(j.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    assert len(t) == len(j) == 5000 - gone.size
    np.testing.assert_array_equal(t.compact(), j.compact())
    _same(j.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    assert t.capacity == j.capacity and t.state.n == int(j.state.n)


def test_add_on_a_jax_built_index_matches_jax(data):
    """Rows added to a JAX-built index and to its port: the same codes,
    refine and r_scales bit for bit, norms within an ulp (decoded norms sum
    the subspaces in another order), and the same ids through the kernel
    path. Mirrors the IVF-PQ append check in test_torch_ivfpq.py."""
    x, q = data
    j = ZJ.PQFlatIndex(ZJ.PQConfig(**BASE, refine="int16", scan="pallas"))
    j.build(x[:4000])
    t = _port_of(j)
    extra = x[4000:4600] + 0.01
    j.add(extra)
    t.add(extra)
    assert len(t) == len(j) == 4600 and t.capacity == j.capacity
    for f in ("codes", "refine", "r_scales"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(), np.asarray(getattr(j.state, f)))
    np.testing.assert_allclose(t.state.norms.numpy(), np.asarray(j.state.norms), rtol=1e-6)
    _same(j.search(q, 10), t.search(q, 10), q)


@pytest.mark.parametrize("refine", ["int16", "bfloat16"])
def test_save_files_load_in_both_packages(data, refine, tmp_path):
    x, q = data
    j = _jax_index(data, refine=refine, scan="pallas")
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j.save(pj)
    t = ZT.PQFlatIndex.load(pj, device=CPU)
    assert t.state.refine.dtype == t.cfg.refine_dtype
    _same(j.search(q[:30], 10), t.search(q[:30], 10), q[:30])
    np.testing.assert_allclose(t.get([0, 9, 4999]), np.asarray(j.get([0, 9, 4999])), **STOL)
    t.remove([5, 6])
    t.save(pt)
    j2 = ZJ.PQFlatIndex.load(pt)
    assert np.asarray(j2.state.refine).dtype == np.asarray(j.state.refine).dtype
    assert len(j2) == len(t) == 4998
    _same(j2.search(q[:30], 10), t.search(q[:30], 10), q[:30])


def test_port_built_index_surface(data, tmp_path):
    """The port's own training, end to end: recall through the refine
    rerank, self-hits, get, incremental add with stable ids, OPQ, and a save
    that loads back to the same ids."""
    x, q = data
    _, gt = ZT.exact_ground_truth(x, q, 10, device=CPU)
    idx = ZT.PQFlatIndex(ZT.PQConfig(**BASE, scan="pallas"), device=CPU)
    idx.build(x[:4000])
    idx.add(x[4000:])
    assert len(idx) == 5000 and idx.capacity == 8000
    ids = idx.search(q, 10)[1].numpy()
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids.tolist(), gt.tolist())])
    assert rec > 0.9
    assert int(idx.search(x[4500], 1)[1][0]) == 4500
    g = idx.get([0, 1, 4999])
    assert np.abs(g - x[[0, 1, 4999]]).max() / np.abs(x).max() < 1e-4   # int16 refine
    p = str(tmp_path / "own.npz")
    idx.save(p)
    assert torch.equal(ZT.PQFlatIndex.load(p, device=CPU).search(q[:20], 10)[1],
                       idx.search(q[:20], 10)[1])
    opq = ZT.PQFlatIndex(ZT.PQConfig(**BASE, opq=True, refine="none", opq_iters=3), device=CPU)
    opq.build(x)
    rot = opq.state.rot
    assert float((rot @ rot.T - torch.eye(32)).abs().max()) < 1e-4
    rel = np.linalg.norm(opq.get(np.arange(50)) - x[:50], axis=1) / np.linalg.norm(x[:50], axis=1)
    assert rel.mean() < 0.45   # 4-bit codes are the storage: coarse by design


def test_port_built_unpacked_codes(data):
    """One-byte codes (n_codes=256) take the unpacked [cap, S] store through
    ingest, growth, remove, compact and the decode scan."""
    x, q = data
    idx = ZT.PQFlatIndex(ZT.PQConfig(dim=32, n_sub=8, n_codes=256, train_sample=4096,
                                     kmeans_iters=4), device=CPU)
    idx.build(x[:3000])
    idx.add(x[3000:])
    assert idx.state.codes.shape == (6000, 8) and len(idx) == 5000
    assert idx.search(x[:50], 1)[1][:, 0].eq(torch.arange(50)).float().mean() > 0.95
    idx.remove([3])
    assert 3 not in idx.search(x[3], 5)[1].tolist()
    old = idx.compact()
    assert old.size == 4999 and idx.state.codes.shape == (4999, 8)
    assert int(idx.search(x[4500], 1)[1][0]) == 4499


def test_get_without_refine_matches_jax(data):
    j = _jax_index(data, refine="none", scan="pallas")
    np.testing.assert_allclose(_port_of(j).get(np.arange(40)), np.asarray(j.get(np.arange(40))),
                               **STOL)


def test_edge_contracts(data):
    x, q = data
    cfg = ZT.PQConfig(dim=32, n_sub=8)
    e = ZT.PQFlatIndex(cfg, device=CPU)
    s, i = e.search(q[:3], 5)
    assert (i == -1).all() and torch.isinf(s).all()
    t = ZT.PQFlatIndex(ZT.PQConfig(dim=32, n_sub=8, train_sample=64), device=CPU)
    t.add(x[:3])
    _, it = t.search(q[:2], 8)
    assert (it == -1).sum() == 10
    with pytest.raises(ValueError):
        t.search(np.zeros((2, 33), np.float32), 3)
    with pytest.raises(ValueError):
        t.add(np.zeros((2, 33), np.float32))
    with pytest.raises(IndexError):
        t.remove([3])
    t.remove([1])
    with pytest.raises(IndexError):
        t.get([1])
    assert t.compact().tolist() == [0, 2]
    assert t.compact().tolist() == [0, 1]
    t.remove([0, 1])
    assert t.compact().size == 0 and len(t) == 0
    t.add(x[:2])   # trained codebooks survive an emptying compact
    assert t.search(x[1], 1)[1].item() == 1
    with pytest.raises(ValueError):
        e.save("unused.npz")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ZT.PQFlatIndex(ZT.PQConfig(dim=32, n_sub=8))
