"""zvdb_tpu_torch.ops.hop_scores against the Pallas hop scorer it replaces
(examples/exp_r3_hopkernel.py:fused_hop_scores, kernel G) and against the
example's gather + einsum (`xla_hop_scores`).

On the CPU `fused_hop_scores` runs `_hop_scores_plain`; the JAX side runs the
example kernel in interpret mode, loaded by path. Tolerance: atol 1e-5, the
f32 dot summing in another order (the scores are O(1)-O(10)).

The `gpu`-marked test needs the card and skips without one:
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
