"""zvdb_tpu_torch.ops.pq_scan.pq_grouped_scan_bins against the Pallas kernel it
replaces (zvdb_tpu/ops/pallas_pq.py:pq_grouped_scan_bins).

On the CPU the wrapper runs its plain PyTorch version; the JAX side runs the
Pallas kernel in interpret mode. Both get the same numpy table, slots, codes
and norms. Tolerance: "int8" scores and positions exactly equal (integer
sums, the same float steps); "default"/"high" scores rtol 1e-5 (other
summation orders), and a position may differ only where the two scores tie
within that tolerance. Mirrors tests/test_ivfpq.py's kernel tests.

The `gpu`-marked test needs the card and skips without one; the JAX side is
imported inside the tests that use it, so that it runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_pq_grouped_scan.py
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import pq as PQ
from zvdb_tpu_torch.ops import pq_scan as PS

STOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, c, cap, n_sub, qcap, seed, metric="l2", live=6, dup=0):
    """A table of ADC scale, random nibble codes per cluster, 'decoded norms'
    with one tombstone (+inf), and up to `live` slots per cluster filled with
    random queries (the rest empty, so whole 16-slot tiles are empty too).
    dup > 0 repeats each cluster's first dup rows through the block."""
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (c, n_sub // 2, cap), dtype=np.uint8)
    norms = ((rng.random((c, cap)) * n_sub).astype(np.float32) if metric == "l2"
             else np.zeros((c, cap), np.float32))
    if dup:
        codes = np.tile(codes[:, :, :dup], (1, 1, -(-cap // dup)))[:, :, :cap].copy()
        norms = np.tile(norms[:, :dup], (1, -(-cap // dup)))[:, :cap].copy()
    norms[0, 3] = np.inf
    qslot = np.full((c, qcap), -1, np.int32)
    for ci in range(c):
        k = int(rng.integers(0, live + 1)) if ci else live
        qslot[ci, :k] = rng.integers(0, b, k)
    return lut, qslot, codes, norms


def _jax_bins(lut, qslot, codes, norms, **kw):
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_pq

    out = pallas_pq.pq_grouped_scan_bins(jnp.asarray(lut), jnp.asarray(qslot),
                                         jnp.asarray(codes), jnp.asarray(norms),
                                         interpret=True, **kw)
    return [np.array(a) for a in out]


def _port_bins(lut, qslot, codes, norms, **kw):
    out = PS.pq_grouped_scan_bins(*(torch.from_numpy(a) for a in (lut, qslot, codes, norms)),
                                  **kw)
    return [a.numpy() for a in out]


def _agree(port, ref, precision):
    (ts, ti), (js, ji) = port, ref
    assert ts.shape == js.shape and ti.dtype == np.int32
    if precision == "int8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        return
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    fin = ji >= 0
    np.testing.assert_allclose(ts[fin], js[fin], **STOL)
    flip = ti != ji
    assert np.allclose(ts[flip], js[flip], **STOL)   # a position differs only on a tie
    assert flip.mean() < 0.01


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_bins_match_pallas(precision, per_bin, metric):
    # cap=300: no multiple of L=128 (JAX pads the block to capp=384); qcap 32
    lut, qslot, codes, norms = _inputs(9, 5, 300, 16, 32, seed=per_bin + 7 * len(precision),
                                       metric=metric)
    kw = dict(l_bins=128, chunk=256, metric=metric, precision=precision, per_bin=per_bin)
    port, ref = _port_bins(lut, qslot, codes, norms, **kw), _jax_bins(lut, qslot, codes, norms, **kw)
    assert port[0].shape == (5, 32, per_bin * 128)
    _agree(port, ref, precision)
    empty = qslot < 0
    assert (port[1][empty] == -1).all() and np.isinf(port[0][empty]).all()
    assert not (port[1][0] == 3).any()                 # the tombstoned row never wins
    assert (port[1] < 300).all()                       # never a padding position


@pytest.mark.parametrize("precision", ["int8", "high"])
def test_qcap_64_and_single_query(precision):
    # B=1: every live slot holds query 0; qcap 64 gives four 16-slot tiles
    lut, qslot, codes, norms = _inputs(1, 4, 200, 8, 64, seed=3, live=40)
    kw = dict(l_bins=128, chunk=128, metric="l2", precision=precision, per_bin=2)
    _agree(_port_bins(lut, qslot, codes, norms, **kw), _jax_bins(lut, qslot, codes, norms, **kw),
           precision)


@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_ties_from_duplicated_codes(precision):
    # each cluster repeats its first 128 rows: every bin holds a row and its
    # copy at position + 128; the lower copy wins slot 1, the next slot 2
    lut, qslot, codes, norms = _inputs(5, 3, 256, 8, 32, seed=11, dup=128)
    norms[0, 3] = norms[0, 131] = 1.0    # keep the tombstone out of this one
    kw = dict(l_bins=128, chunk=128, metric="l2", precision=precision, per_bin=2)
    port = _port_bins(lut, qslot, codes, norms, **kw)
    np.testing.assert_array_equal(port[1], _jax_bins(lut, qslot, codes, norms, **kw)[1])
    live = qslot >= 0
    ti = port[1][live]
    np.testing.assert_array_equal(ti[:, :128], np.arange(128)[None].repeat(len(ti), 0))
    np.testing.assert_array_equal(ti[:, 128:], ti[:, :128] + 128)


def test_grouped_scan_matches_oracle():
    """Mirror of tests/test_ivfpq.py's oracle test on the port: each live
    (cluster, slot) pool's best row is the brute-force best surrogate of
    that query within that cluster; empty slots are all -1 / +inf; the
    tombstoned row is never selected."""
    rng = np.random.default_rng(0)
    d, s, c, cap, b = 32, 8, 4, 40, 16
    x = torch.from_numpy(rng.normal(size=(c * cap, d)).astype(np.float32))
    cb = PQ.train_codebooks(x, torch.Generator().manual_seed(0), s, 16, 4)
    codes = PQ.encode(x, cb)
    norms = PQ.decoded_sq_norms(codes, cb)
    codes_blocks = PQ.pack_nibbles(codes).reshape(c, cap, s // 2).transpose(1, 2).contiguous()
    norms_blocks = norms.reshape(c, cap).clone()
    norms_blocks[0, 3] = float("inf")
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    lut = PQ.adc_lut(q, cb)
    qcap = 32
    qslot = torch.full((c, qcap), -1, dtype=torch.int32)
    fill = [0] * c
    for bi in range(b):
        for cc in (bi % c, (bi + 1) % c):
            qslot[cc, fill[cc]] = bi
            fill[cc] += 1
    bs, bi_ = PS.pq_grouped_scan_bins(lut, qslot, codes_blocks, norms_blocks, l_bins=128,
                                      chunk=128, precision="high", per_bin=2)
    assert bs.shape == (c, qcap, 256)
    sur = (norms[None, :] - 2.0 * q @ PQ.decode(codes, cb).T).numpy()
    sur[:, 3] = np.inf
    bs, bi_ = bs.numpy(), bi_.numpy()
    for cc in range(c):
        for sl in range(qcap):
            qi = int(qslot[cc, sl])
            if qi < 0:
                assert (bi_[cc, sl] == -1).all() and np.isinf(bs[cc, sl]).all()
                continue
            seg = sur[qi, cc * cap:(cc + 1) * cap]
            pos = bi_[cc, sl][bs[cc, sl].argmin()]
            assert 0 <= pos < cap and abs(seg[pos] - seg.min()) < 1e-3
            live = bi_[cc, sl][bi_[cc, sl] >= 0]
            assert (live < cap).all()
            assert cc != 0 or 3 not in live.tolist()


@pytest.mark.parametrize("cap,l_bins,chunk,want", [
    (40, 128, 512, (128, 128)), (1000, 128, 512, (512, 1024)), (624, 256, 512, (512, 1024)),
    (256, 256, 512, (256, 256))])
def test_grouped_geometry_padding(cap, l_bins, chunk, want):
    """cap not a multiple of l_bins pads; positions index the padded cap."""
    from zvdb_tpu.ops.pallas_pq import grouped_geometry

    assert PS.grouped_geometry(cap, l_bins, chunk) == want == grouped_geometry(cap, l_bins, chunk)


def test_argument_checks():
    lut, qslot, codes, norms = (torch.from_numpy(a) for a in _inputs(2, 3, 64, 8, 32, seed=0))
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot, codes, norms, l_bins=100, chunk=200)  # L % 128
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot, codes, norms, l_bins=128, chunk=192)  # chunk % L
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot[:, :24], codes, norms, precision="int8")  # qcap % 32
    PS.pq_grouped_scan_bins(lut, qslot[:, :24], codes, norms, precision="high")   # % 8 is enough
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot[:2], codes, norms)                    # C differs
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot, codes, norms, per_bin=3)
    with pytest.raises(ValueError):
        PS.pq_grouped_scan_bins(lut, qslot, codes[:, :3], norms)                 # codes width


def test_cpu_tensors_take_the_plain_version_and_empty_batches():
    lut, qslot, codes, norms = (torch.from_numpy(a) for a in _inputs(3, 4, 100, 8, 32, seed=1))
    before = PS.pq_grouped_scan_bins.launches
    a = PS.pq_grouped_scan_bins(lut, qslot, codes, norms, precision="int8")
    b = PS._pq_grouped_scan_bins_plain(lut, qslot, codes, norms, 128, 512, "l2", "int8", 2)
    assert PS.pq_grouped_scan_bins.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    s, i = PS.pq_grouped_scan_bins(lut[:0], torch.full_like(qslot, -1), codes, norms)
    assert s.shape == (4, 32, 256) and (i == -1).all() and torch.isinf(s).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision, per_bin):
    for metric, b, c, cap, qcap in (("l2", 37, 50, 700, 64), ("dot", 1, 9, 300, 32)):
        arrays = _inputs(b, c, cap, 16, qcap, seed=9 + per_bin, metric=metric, live=20)
        lut, qslot, codes, norms = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        kw = dict(l_bins=256, chunk=512, metric=metric, precision=precision, per_bin=per_bin)
        before = PS.pq_grouped_scan_bins.launches
        ks, ki = PS.pq_grouped_scan_bins(lut, qslot, codes, norms, **kw)
        ps, pi = PS._pq_grouped_scan_bins_plain(lut, qslot, codes, norms, 256, 512, metric,
                                                precision, per_bin)
        torch.cuda.synchronize()
        assert PS.pq_grouped_scan_bins.launches == before + 1
        _agree((ks.cpu().numpy(), ki.cpu().numpy()), (ps.cpu().numpy(), pi.cpu().numpy()),
               precision)
    # duplicated codes tie in every bin: the lower position wins
    lut, qslot, codes, norms = (torch.from_numpy(a).to(cuda_device) for a in _inputs(
        5, 3, 512, 16, 32, seed=3, dup=256))
    norms[0, 3] = norms[0, 259] = 1.0
    _, di = PS.pq_grouped_scan_bins(lut, qslot, codes, norms, l_bins=256, chunk=256,
                                    precision=precision, per_bin=2)
    live = qslot >= 0
    di = di[live]
    assert torch.equal(di[:, :256], torch.arange(256, device=cuda_device).int().expand(len(di), -1))
    assert torch.equal(di[:, 256:], di[:, :256] + 256)
