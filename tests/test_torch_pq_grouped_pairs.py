"""zvdb_tpu_torch.ops.pq_scan.pq_grouped_scan_pairs against what the JAX
package computes in its place: the Pallas grouped kernel
(zvdb_tpu/ops/pallas_pq.py:pq_grouped_scan_bins, in interpret mode)
followed by its search's scatter of the slot output to (query, probe) pools
(zvdb_tpu/index/ivfpq.py:336-349, written out here in numpy).

On the CPU the wrapper runs its plain PyTorch version. Both sides get the
same numpy table, codes and norms, and the slot tables of JAX's own
`_slot_pairs`. Tolerance: positions exactly equal in "int8", and "int8"
scores bit for bit (integer sums, the same float steps); "default"/"high"
scores rtol 1e-5 (other summation orders), where a position may differ only
on a tie within that tolerance, as in tests/test_torch_pq_grouped_scan.py.

The `gpu`-marked test needs the card and skips without one; the JAX side is
imported inside the tests that use it, so that it runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_pq_grouped_pairs.py
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.index.ivf import _slot_pairs
from zvdb_tpu_torch.ops import pq_scan as PS

STOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, c, cap, n_sub, p, seed, metric="l2", hot=0, empty=False, tombstones=True):
    """A table of ADC scale, random nibble codes per cluster, 'decoded norms'
    (+inf on every 7th row when tombstones), and p distinct random probes a
    query; hot > 0 sends that many queries' rank-0 probe to cluster 0, and
    empty=True makes cluster 1 hold no valid row."""
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (c, n_sub // 2, cap), dtype=np.uint8)
    norms = ((rng.random((c, cap)) * n_sub).astype(np.float32) if metric == "l2"
             else np.zeros((c, cap), np.float32))
    if tombstones:
        norms.reshape(-1)[::7] = np.inf
    if empty:
        norms[1] = np.inf
    probes = np.argsort(rng.random((b, c)), axis=1)[:, :p]
    for r in range(min(hot, b)):
        probes[r] = np.concatenate([[0], 1 + np.argsort(rng.random(c - 1))[:p - 1]])
    return lut, codes, norms, probes.astype(np.int32)


def _jax_slots(probes, b, p, c, q_cap):
    import jax.numpy as jnp
    from zvdb_tpu.index.ivfpq import _slot_pairs as jax_slot_pairs

    return [np.array(a) for a in jax_slot_pairs(jnp.asarray(probes), b, p, c, q_cap)]


def _jax_pools(lut, qslot, pslot, codes, norms, p, l_bins, chunk, **kw):
    """JAX's kernel in interpret mode, then its search's scatter in numpy."""
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_pq

    bin_s, bin_pos = (np.array(a) for a in pallas_pq.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(codes), jnp.asarray(norms),
        l_bins=l_bins, chunk=chunk, interpret=True, **kw))
    b = lut.shape[0]
    c, _, cap = codes.shape
    lw = bin_s.shape[-1]
    _, capp = pallas_pq.grouped_geometry(cap, l_bins, chunk)
    flatpos = np.arange(c, dtype=np.int32)[:, None, None] * capp + bin_pos
    flatpos = np.where(bin_pos >= 0, flatpos, -1).astype(np.int32)
    out_s = np.full((b + 1, p, lw), np.inf, np.float32)
    out_i = np.full((b + 1, p, lw), -1, np.int32)
    wq = np.where(qslot >= 0, qslot, b)
    wp = np.maximum(pslot, 0)
    live = qslot >= 0            # the trash row b takes the empty slots
    out_s[wq[live], wp[live]] = bin_s[live]
    out_i[wq[live], wp[live]] = flatpos[live]
    return out_s[:b].reshape(b, p * lw), out_i[:b].reshape(b, p * lw)


def _port_pools(lut, qslot, pslot, codes, norms, p, **kw):
    out = PS.pq_grouped_scan_pairs(
        *(torch.from_numpy(a) for a in (lut, qslot, pslot, codes, norms)), p, **kw)
    return [a.numpy() for a in out]


def _agree(port, ref, precision):
    (ts, ti), (js, ji) = port, ref
    assert ts.shape == js.shape and ti.dtype == np.int32 and ts.dtype == np.float32
    if precision == "int8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        return
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    fin = ji >= 0
    np.testing.assert_allclose(ts[fin], js[fin], **STOL)
    assert np.isinf(ts[~fin]).all()
    flip = ti != ji
    assert np.allclose(ts[flip], js[flip], **STOL)   # a position differs only on a tie
    assert flip.mean() < 0.01


def _case(b, c, cap, n_sub, p, q_cap, l_bins, chunk, metric, precision, per_bin, seed, **inp):
    lut, codes, norms, probes = _inputs(b, c, cap, n_sub, p, seed, metric=metric, **inp)
    qslot, pslot = _jax_slots(probes, b, p, c, q_cap)
    kw = dict(l_bins=l_bins, chunk=chunk, metric=metric, precision=precision, per_bin=per_bin)
    port = _port_pools(lut, qslot, pslot, codes, norms, p, **kw)
    ref = _jax_pools(lut, qslot, pslot, codes, norms, p, **kw)
    _agree(port, ref, precision)
    return port, (lut, qslot, pslot, codes, norms, probes)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_pools_match_pallas_and_scatter(precision, per_bin, metric):
    # cap 300: no multiple of L=128 (capp 512 at chunk 256); q_cap + 4
    # queries send their first probe to cluster 0, past its q_cap; cluster 1
    # holds no valid row; every 7th row is tombstoned
    q_cap = 32 if precision == "int8" else 8
    (ps, pi), (_, qslot, pslot, _, norms, probes) = _case(
        40, 6, 300, 16, 3, q_cap, 128, 256, metric, precision, per_bin,
        seed=per_bin + 7 * len(precision) + len(metric), hot=q_cap + 4, empty=True)
    pools_s, pools_i = ps.reshape(40, 3, -1), pi.reshape(40, 3, -1)
    covered = np.zeros((40, 3), bool)
    covered[qslot[qslot >= 0], pslot[qslot >= 0]] = True
    assert (~covered).any()                                # q_cap dropped pairs
    assert (pools_i[~covered] == -1).all() and np.isinf(pools_s[~covered]).all()
    assert (pools_i[probes == 1] == -1).all()              # the empty cluster
    flat = pi[pi >= 0]
    assert PS.grouped_geometry(300, 128, 256) == (256, 512)
    assert (flat % 512 < 300).all()                        # never a padding position
    assert np.isfinite(norms[flat // 512, flat % 512]).all()   # never a tombstone


def test_single_query_and_many_probes():
    # B=1: the query probes every cluster; int8 and "high" windows of slots
    for precision in ("int8", "high"):
        _case(1, 10, 200, 8, 10, 32, 128, 128, "l2", precision, 2, seed=3)


def test_rank_order_of_a_hot_cluster():
    """q_cap drops a hot cluster's highest-rank probes first (JAX's rule):
    every query that probes cluster 0 at rank 0 keeps that pool while slots
    remain, and the pools that go are its later ranks."""
    lut, codes, norms, probes = _inputs(50, 5, 256, 8, 2, seed=5, tombstones=False)
    probes[:, 0] = 0
    probes[:, 1] = 1 + np.arange(50) % 4
    qslot, pslot = _jax_slots(probes, 50, 2, 5, 32)
    kw = dict(l_bins=128, chunk=256, metric="l2", precision="int8", per_bin=2)
    ps, pi = _port_pools(lut, qslot, pslot, codes, norms, 2, **kw)
    _agree((ps, pi), _jax_pools(lut, qslot, pslot, codes, norms, 2, **kw), "int8")
    kept = (pi.reshape(50, 2, 256) >= 0).any(-1)
    assert kept[:32, 0].all() and not kept[32:, 0].any() and kept[:, 1].all()


def test_argument_checks_and_empty_batch():
    lut, codes, norms, probes = _inputs(3, 4, 100, 8, 2, seed=1)
    qslot, pslot = (torch.from_numpy(a) for a in _jax_slots(probes, 3, 2, 4, 32))
    lut, codes, norms = (torch.from_numpy(a) for a in (lut, codes, norms))
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_pairs(lut, qslot, pslot[:, :8], codes, norms, 2)   # pslot shape
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_pairs(lut, qslot, pslot, codes, norms, 0)          # n_probe
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_pairs(lut, qslot, pslot, codes, norms, 2, l_bins=100, chunk=200)
    before = PS.pq_grouped_scan_pairs.launches
    s, i = PS.pq_grouped_scan_pairs(lut, qslot, pslot, codes, norms, 2, precision="int8")
    assert PS.pq_grouped_scan_pairs.launches == before   # the CPU counts nothing
    assert s.shape == i.shape == (3, 2 * 256)
    s, i = PS.pq_grouped_scan_pairs(lut[:0], torch.full_like(qslot, -1),
                                    torch.full_like(pslot, -1), codes, norms, 2)
    assert s.shape == i.shape == (0, 512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision, per_bin):
    # the engine's slot tables (a hot cluster past q_cap, an empty cluster,
    # tombstones, cap no multiple of L), then a cluster too large to stage
    for metric, b, c, cap, p, q_cap, hot in (("l2", 70, 30, 700, 5, 32, 40),
                                             ("dot", 1, 9, 300, 9, 32, 0),
                                             ("l2", 20, 4, 4200, 2, 32, 0)):
        lut, codes, norms, probes = _inputs(b, c, cap, 16, p, seed=9 + per_bin, metric=metric,
                                            hot=hot, empty=True)
        probes_t = torch.from_numpy(probes.astype(np.int64)).to(cuda_device)
        qslot, pslot = _slot_pairs(probes_t, b, p, c, q_cap)
        lut, codes, norms = (torch.from_numpy(a).to(cuda_device) for a in (lut, codes, norms))
        kw = dict(l_bins=256, chunk=512, metric=metric, precision=precision, per_bin=per_bin)
        before = PS.pq_grouped_scan_pairs.launches
        ks, ki = PS.pq_grouped_scan_pairs(lut, qslot, pslot, codes, norms, p, **kw)
        ps, pi = PS._pq_grouped_scan_pairs_plain(lut, qslot, pslot, codes, norms, p, 256, 512,
                                                 metric, precision, per_bin)
        torch.cuda.synchronize()
        assert PS.pq_grouped_scan_pairs.launches == before + 1
        _agree((ks.cpu().numpy(), ki.cpu().numpy()), (ps.cpu().numpy(), pi.cpu().numpy()),
               precision)
