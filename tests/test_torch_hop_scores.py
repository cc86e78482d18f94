"""zvdb_tpu_torch.ops.hop_scores against the Pallas hop scorer it replaces
(examples/exp_r3_hopkernel.py:fused_hop_scores, kernel G) and against the
example's gather + einsum (`xla_hop_scores`).

On the CPU `fused_hop_scores` runs `_hop_scores_plain`; the JAX side runs the
example kernel in interpret mode, loaded by path. Tolerance: atol 1e-5, the
f32 dot summing in another order (the scores are O(1)-O(10)).

The `gpu`-marked tests need the card and skip without one; they force a
route by swapping out `choose_route`:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hop_scores.py
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import hop_scores as HS

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example():
    spec = importlib.util.spec_from_file_location(
        "exp_r3_hopkernel", os.path.join(_EX, "exp_r3_hopkernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(b, k, n, d, seed, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    if dup:   # a graph hop's candidate lists repeat ids
        idx[:, 1::2] = idx[:, ::2]
    return idx, q, x


def test_plain_matches_pallas_and_xla():
    import jax.numpy as jnp

    ex = _example()
    idx, q, x = _inputs(16, 256, 500, 32, seed=0, dup=True)
    want = np.asarray(ex.fused_hop_scores(jnp.asarray(idx), jnp.asarray(q), jnp.asarray(x),
                                          interpret=True))
    xla = np.asarray(ex.xla_hop_scores(jnp.asarray(idx), jnp.asarray(q), jnp.asarray(x)))
    got = HS.fused_hop_scores(torch.from_numpy(idx), torch.from_numpy(q), torch.from_numpy(x))
    assert got.shape == (16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=1e-5)
    exact = np.einsum("bd,bkd->bk", q.astype(np.float64), x.astype(np.float64)[idx])
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,k", [(12, 128), (8, 100), (0, 128)])
def test_shape_checks_as_the_tpu_asserts(b, k):
    idx, q, x = (torch.from_numpy(a) for a in _inputs(max(b, 1), k, 50, 8, seed=1))
    if b == 0:   # B = 0 and K = 128 pass the checks: an empty result
        out = HS.fused_hop_scores(idx[:0], q[:0], x)
        assert out.shape == (0, 128)
        return
    with pytest.raises(ValueError):
        HS.fused_hop_scores(idx, q, x)


def test_cpu_tensors_take_the_plain_version():
    idx, q, x = (torch.from_numpy(a) for a in _inputs(8, 128, 300, 20, seed=2))
    before = HS.fused_hop_scores.launches
    a = HS.fused_hop_scores(idx, q, x)
    assert HS.fused_hop_scores.launches == before
    assert torch.equal(a, HS._hop_scores_plain(idx, q, x))
    with pytest.raises(ValueError):
        HS.fused_hop_scores(idx, q[:, :10], x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,d", [(8, 128, 32), (64, 256, 128), (8, 128, 100), (8, 128, 13)])
def test_kernel_matches_plain_on_gpu(cuda_device, b, k, d):
    idx, q, x = (torch.from_numpy(a).to(cuda_device)
                 for a in _inputs(b, k, 5000, d, seed=d, dup=True))
    before = HS.fused_hop_scores.launches
    got = HS.fused_hop_scores(idx, q, x)
    want = HS._hop_scores_plain(idx, q, x)
    torch.cuda.synchronize()
    assert HS.fused_hop_scores.launches == before + 1
    scale = q.norm(dim=1)[:, None] * x.norm(dim=1)[idx.long()]
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    bad = idx.clone()
    bad[0, 0], bad[-1, -1] = -1, 5000   # outside [0, N): NaN, nothing read
    out = HS.fused_hop_scores(bad, q, x)
    assert bool(torch.isnan(out[0, 0])) and bool(torch.isnan(out[-1, -1]))
    assert torch.equal(out[0, 1:], got[0, 1:])


def _window_cases():
    # (B, K, N, shift, out-of-range ids): windows of one row, ragged last
    # windows, a corpus far smaller than the list, and ids outside [0, N)
    return [(8, 128, 5000, 4, False), (16, 256, 5000, 9, True), (8, 128, 7, 0, True),
            (24, 128, 100_000, 14, True), (8, 128, 1, 0, False)]


@pytest.mark.parametrize("b,k,n,shift,bad", _window_cases())
def test_window_order_plain_against_numpy(b, k, n, shift, bad):
    rng = np.random.default_rng(b + k + n + shift)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[:, 1::3] = idx[:, ::3][:, :idx[:, 1::3].shape[1]]   # repeated ids
    if bad:
        idx[0, 0], idx[-1, 5], idx[3, -1] = -1, n, -(2**31)
    pos, ids, counts = HS._window_order_plain(torch.from_numpy(idx), n, shift)
    pos, ids, counts = pos.numpy(), ids.numpy(), counts.numpy()
    flat = idx.reshape(-1)
    windows = (n + (1 << shift) - 1) >> shift
    w = np.where((flat >= 0) & (flat < n), flat.astype(np.int64) >> shift, windows)
    assert pos.dtype == np.int32 and ids.dtype == np.int32
    assert np.array_equal(np.sort(pos), np.arange(b * k))             # every position once
    assert np.array_equal(ids, flat[pos])
    assert np.all(np.diff(w[pos]) >= 0)                                # windows in order
    same = np.diff(w[pos]) == 0
    assert np.all(np.diff(pos)[same] > 0)                              # (b, j) order within one
    assert np.array_equal(counts, np.bincount(w, minlength=windows + 1))


@pytest.mark.parametrize("b,k,n,want", [(4992, 256, 1_000_000, "grouped"),
                                        (2048, 128, 1_000_000, "direct"),
                                        (64, 256, 5000, "grouped"), (8, 128, 5000, "direct"),
                                        (8, 128, 0, "direct")])
def test_route_depends_only_on_b_k_n(b, k, n, want):
    assert HS.choose_route(b, k, n) == want
    share = HS.repeat_share(b, k, n)
    assert 0.0 <= share < 1.0
    if n:   # the share is the expected one of b * k uniform draws from n rows
        draws = np.random.default_rng(0).integers(0, n, b * k)
        assert abs(share - (1 - np.unique(draws).size / draws.size)) < 0.01
    # nothing but the three ints: the same answer for any ids, widths or devices
    idx, q, x = (torch.from_numpy(a) for a in _inputs(8, 128, 300, 20, seed=3))
    before = (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped)
    HS.fused_hop_scores(idx, q, x)
    assert HS.choose_route(b, k, n) == want
    assert (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped) == before


def _scratch_ints_model(cap):
    """The kernel's zvdb_hop_scratch_ints as far as window_shift reads it:
    -1 past `cap` windows or outside shift [0, 30], else >= 0."""
    def scratch_ints(p, n, shift):
        ok = 0 <= shift <= 30 and (n + (1 << shift) - 1) >> shift <= cap
        return 2 * p + 1 if ok else -1
    return scratch_ints


@pytest.mark.parametrize("n,d", [(1_000_000, 128), (5000, 13), (10**9, 128), (1, 1),
                                 (2**31 - 1, 4)])
def test_window_shift_fits_the_counting_pass(n, d):
    for cap in (511, 40, 2):   # the kernel's cap, whatever it is, sets the shift
        shift = HS.window_shift(n, d, _scratch_ints_model(cap))
        windows = (n + (1 << shift) - 1) >> shift
        assert 0 <= shift <= 30 and windows <= cap
        # the window stays within WINDOW_BYTES unless the window count forces it up,
        # and then it is the smallest the count allows
        if (1 << shift) * d * 4 > HS.WINDOW_BYTES:
            assert (n + (1 << (shift - 1)) - 1) >> (shift - 1) > cap
    with pytest.raises(ValueError):
        HS.window_shift(n, d, lambda p, n, shift: -1)


@pytest.mark.parametrize("route", ["direct", "grouped"])
def test_cpu_is_plain_whatever_the_route(monkeypatch, route):
    idx, q, x = (torch.from_numpy(a) for a in _inputs(8, 128, 300, 20, seed=4, dup=True))
    want = HS._hop_scores_plain(idx, q, x)
    monkeypatch.setattr(HS, "choose_route", lambda b, k, n: route)
    before = (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped)
    assert torch.equal(HS.fused_hop_scores(idx, q, x), want)
    assert (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped) == before
    pos, ids, counts = HS.window_order(idx, 300, 5)   # the plain pass on CPU tensors
    assert int(counts.sum()) == idx.numel() and torch.equal(ids, idx.reshape(-1)[pos.long()])


def _gpu_inputs(dev, b, k, n, d, seed):
    idx, q, x = (torch.from_numpy(a).to(dev) for a in _inputs(b, k, n, d, seed=seed, dup=True))
    idx[0, 0], idx[-1, -1] = -1, n   # outside [0, N): NaN, nothing read
    return idx, q, x


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["direct", "grouped"])
@pytest.mark.parametrize("n", [5000, 7])   # 7 rows: every id repeats many times
@pytest.mark.parametrize("b,k,d", [(8, 128, 32), (64, 256, 128), (8, 128, 100), (8, 128, 13)])
def test_each_route_matches_plain_on_gpu(monkeypatch, cuda_device, route, n, b, k, d):
    idx, q, x = _gpu_inputs(cuda_device, b, k, n, d, seed=d + n)
    monkeypatch.setattr(HS, "choose_route", lambda b, k, n: route)
    before = (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped)
    got = HS.fused_hop_scores(idx, q, x)
    torch.cuda.synchronize()
    assert (HS.fused_hop_scores.launches, HS.fused_hop_scores.launches_grouped) == (
        before[0] + 1, before[1] + (route == "grouped"))
    assert bool(torch.isnan(got[0, 0])) and bool(torch.isnan(got[-1, -1]))
    ok = idx.clamp(0, n - 1)
    want = HS._hop_scores_plain(ok, q, x)
    got[0, 0], got[-1, -1] = want[0, 0], want[-1, -1]
    scale = q.norm(dim=1)[:, None] * x.norm(dim=1)[ok.long()]
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,n,shift,bad", _window_cases())
def test_window_order_kernel_matches_plain_on_gpu(cuda_device, b, k, n, shift, bad):
    idx, _, _ = _gpu_inputs(cuda_device, b, k, n, 4, seed=shift)
    if not bad:
        idx = idx.clamp(0, n - 1)
    before = HS.window_order.launches
    got = HS.window_order(idx, n, shift)
    want = HS._window_order_plain(idx, n, shift)
    assert HS.window_order.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the wrapper's window size is one the kernel takes, at most 511 windows
    scratch_ints = HS.build_grouped().scratch_ints
    shift = HS.window_shift(n, 4, scratch_ints)
    assert scratch_ints(b * k, n, shift) >= 0 and (n + (1 << shift) - 1) >> shift <= 511
