"""zvdb_tpu_torch.ops.pq_scan against the Pallas PQ kernel it replaces.

On the CPU `pq_scan_bins` runs its plain PyTorch version; the JAX side runs
zvdb_tpu.ops.pallas_pq in interpret mode, which rounds as the TPU does. Both
get the same numpy table (a LUT computed by each package could differ in an
ulp and flip an int8 rounding). Tolerance: "int8" ids and scores exactly
equal (integer sums, the same float steps); "default"/"high" scores rtol
1e-5 (other summation orders), and an id may differ only where the two
scores tie within that tolerance.

The `gpu`-marked tests need the card and skip without one. The JAX side is
imported inside the tests that use it, so that they also run where JAX is
absent:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_pq_scan.py
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import pq_scan as PS

STOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, n, n_sub, seed, metric="l2", invalid_every=0, dup_rows=0):
    """A table of plausible ADC scale, random nibble codes, their 'decoded
    norms'. dup_rows > 0 repeats the first dup_rows codes (and norms) through
    the whole corpus, so many rows tie exactly."""
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 256, (n_sub // 2, n), dtype=np.uint8)
    norms = (rng.random(n) * n_sub).astype(np.float32) if metric == "l2" \
        else np.zeros(n, np.float32)
    if dup_rows:
        codes = np.tile(codes[:, :dup_rows], (1, -(-n // dup_rows)))[:, :n].copy()
        norms = np.tile(norms[:dup_rows], -(-n // dup_rows))[:n].copy()
    if invalid_every:
        norms[::invalid_every] = np.inf
    return lut, codes, norms


def _jax_bins(lut, codes, norms, **kw):
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_pq

    out = pallas_pq.pq_scan_bins(jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(norms),
                                 interpret=True, **kw)
    return [np.array(a) for a in out]


def _port_bins(lut, codes, norms, **kw):
    out = PS.pq_scan_bins(torch.from_numpy(lut), torch.from_numpy(codes),
                          torch.from_numpy(norms), **kw)
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
    assert np.allclose(ts[flip], js[flip], **STOL)   # an id differs only on a tie
    assert flip.mean() < 0.01


@pytest.mark.parametrize("seg_rows", [0, 1024])
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_bins_match_pallas(precision, per_bin, seg_rows):
    # N=2900: no multiple of chunk=512, three 1024-row segments; B=11
    lut, codes, norms = _inputs(11, 2900, 8, seed=per_bin + 3 * len(precision),
                                invalid_every=7)
    kw = dict(l_bins=128, chunk=512, metric="l2", precision=precision, per_bin=per_bin,
              seg_rows=seg_rows)
    port, ref = _port_bins(lut, codes, norms, **kw), _jax_bins(lut, codes, norms, **kw)
    n_seg = 3 if seg_rows else 1
    assert port[0].shape == (11, n_seg * per_bin * 128)
    _agree(port, ref, precision)
    assert not np.isin(port[1], np.arange(0, 2900, 7)).any()   # invalid rows never win


@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_bins_dot_metric_single_query(precision):
    lut, codes, norms = _inputs(1, 700, 16, seed=5, metric="dot", invalid_every=3)
    kw = dict(l_bins=64, chunk=128, metric="dot", precision=precision, per_bin=2)
    _agree(_port_bins(lut, codes, norms, **kw), _jax_bins(lut, codes, norms, **kw), precision)


@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_ties_from_duplicated_codes(precision):
    # 96 distinct rows repeated: each bin holds three distinct rows and their
    # copies. The lower copy of the best row wins slot 1, and its next copy,
    # an equal score, lands in slot 2, as in the Pallas fold
    lut, codes, norms = _inputs(6, 1000, 8, seed=11, dup_rows=96)
    kw = dict(l_bins=32, chunk=64, metric="l2", precision=precision, per_bin=2)
    port = _port_bins(lut, codes, norms, **kw)
    np.testing.assert_array_equal(port[1], _jax_bins(lut, codes, norms, **kw)[1])
    ti = port[1]
    assert (ti[:, :32] < 96).all()
    np.testing.assert_array_equal(ti[:, 32:], ti[:, :32] + 96)


def test_empty_bins_when_n_below_l():
    lut, codes, norms = _inputs(3, 40, 8, seed=2)
    kw = dict(l_bins=64, chunk=64, precision="int8", per_bin=2)
    port = _port_bins(lut, codes, norms, **kw)
    _agree(port, _jax_bins(lut, codes, norms, **kw), "int8")
    assert (port[1][:, 40:64] == -1).all() and np.isinf(port[0][:, 40:64]).all()


def test_prep_lut_matches_jax():
    # against the compiled JAX function, as pq_scan_bins runs it: XLA turns
    # the division by 127 into a product with f32(1/127) (seed 14 row 6
    # differs in the last bit from a true division)
    import functools

    import jax
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_pq

    lut = np.concatenate([_inputs(11, 8, 8, seed=14)[0], _inputs(9, 8, 8, seed=4)[0]])
    lut[3] = 0.0                                  # all-zero row: the 1e-30 scale floor
    lut[5, 2, 7] = 0.5 * np.abs(lut[5]).max()     # lands near a .5 rounding point
    tk, tsc = PS._prep_lut(torch.from_numpy(lut), "int8")
    jk, jsc = jax.jit(functools.partial(pallas_pq._prep_lut, n_sub=8, precision="int8"))(
        jnp.asarray(lut))
    perm = np.array(pallas_pq.permute_lut(jnp.asarray(tk.numpy().astype(np.float32)), 8))
    np.testing.assert_array_equal(perm.astype(np.int8), np.array(jk))
    np.testing.assert_array_equal(tsc.numpy(), np.array(jsc)[:, 0])


@pytest.mark.parametrize("k", [20, 100])
@pytest.mark.parametrize("precision", ["int8", "high"])
def test_topk_matches_pallas(k, precision):
    # k=20 takes the position-ordered route, k=100 > 64 the (score, id) sort
    import jax.numpy as jnp
    from zvdb_tpu.ops import pallas_pq

    lut, codes, norms = _inputs(7, 3000, 8, seed=k, invalid_every=5, dup_rows=700)
    kw = dict(l_bins=128, chunk=256, precision=precision, per_bin=2, seg_rows=1024)
    ts, ti = (a.numpy() for a in PS.pq_scan_topk(
        torch.from_numpy(lut), torch.from_numpy(codes), torch.from_numpy(norms), k, **kw))
    js, ji = (np.array(a) for a in pallas_pq.pq_scan_topk(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(norms), k, interpret=True, **kw))
    assert ts.shape == (7, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **STOL)


def test_topk_pads_when_k_exceeds_the_pool():
    lut, codes, norms = _inputs(2, 50, 8, seed=1)
    s, i = PS.pq_scan_topk(torch.from_numpy(lut), torch.from_numpy(codes),
                           torch.from_numpy(norms), 80, l_bins=32, chunk=32, per_bin=2)
    assert s.shape == (2, 80)
    assert (i[:, 64:] == -1).all() and torch.isinf(s[:, 64:]).all()


def test_segments_follow_padded_rows():
    assert PS.segments(1_000_000, 1024, 1_048_576) == (1, 1_048_576)
    assert PS.segments(2900, 512, 1024) == (3, 1024)
    assert PS.segments(2900, 512, 0) == (1, 3072)
    assert PS.segments(0, 512, 0) == (1, 512)


def test_argument_checks():
    lut, codes, norms = (torch.from_numpy(a) for a in _inputs(2, 64, 8, seed=0))
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut, codes, norms, l_bins=32, chunk=48)       # chunk % l_bins
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut, codes, norms, l_bins=32, chunk=64, seg_rows=96)
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut, codes, norms, per_bin=3)
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut, codes, norms, precision="highest")
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut[:, :6], codes[:3], norms)                 # n_sub % 8
    with pytest.raises(ValueError):
        PS.pq_scan_bins(lut, codes[:3], norms)                        # codes width


def test_cpu_tensors_take_the_plain_version():
    lut, codes, norms = (torch.from_numpy(a) for a in _inputs(3, 300, 8, seed=1))
    before = PS.pq_scan_bins.launches
    a = PS.pq_scan_bins(lut, codes, norms, l_bins=16, chunk=32, precision="int8")
    b = PS._pq_scan_bins_plain(lut, codes, norms, 16, 32, "l2", "int8", 1, 0)
    assert PS.pq_scan_bins.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("precision", ["int8", "default", "high"])
def test_kernel_matches_plain_on_gpu(cuda_device, precision, per_bin):
    lut, codes, norms = (torch.from_numpy(a).to(cuda_device) for a in _inputs(
        37, 5000, 16, seed=9, invalid_every=7))
    kw = dict(l_bins=128, chunk=512, metric="l2", precision=precision, per_bin=per_bin,
              seg_rows=2048)
    before = PS.pq_scan_bins.launches
    ks, ki = PS.pq_scan_bins(lut, codes, norms, **kw)
    ps, pi = PS._pq_scan_bins_plain(lut, codes, norms, 128, 512, "l2", precision, per_bin, 2048)
    torch.cuda.synchronize()
    assert PS.pq_scan_bins.launches == before + 1
    _agree((ks.cpu().numpy(), ki.cpu().numpy()), (ps.cpu().numpy(), pi.cpu().numpy()),
           precision)
    # duplicated codes tie in every bin: the lower row wins
    lut, codes, norms = (torch.from_numpy(a).to(cuda_device) for a in _inputs(
        5, 512, 16, seed=3, dup_rows=128))
    _, di = PS.pq_scan_bins(lut, codes, norms, l_bins=128, chunk=128, precision=precision,
                            per_bin=2)
    assert torch.equal(di[:, :128], torch.arange(128, device=cuda_device).int().expand(5, -1))
    assert torch.equal(di[:, 128:], di[:, :128] + 128)
