"""zvdb_tpu_torch.ops.distance against zvdb_tpu.ops.distance on the CPU.

The same seeded numpy inputs go through both packages. JAX's XLA dots on
the CPU compute f32 whatever their Precision, so the port's bf16 modes are
held against JAX fed the operands those modes round to.
Tolerance: rtol 1e-6, atol 1e-5 (the two sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zvdb_tpu.ops import distance as DJ
from zvdb_tpu_torch.ops import distance as DT

METRICS = ["l2", "dot", "cosine"]
TOL = dict(rtol=1e-6, atol=1e-5)
HIGHEST = jax.lax.Precision.HIGHEST


def _data(seed=0, n=300, b=11, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.array(jnp.asarray(a, jnp.float32))


def test_sq_norms_and_normalize():
    x, _ = _data()
    np.testing.assert_allclose(DT.sq_norms(torch.from_numpy(x)).numpy(),
                               np.array(DJ.sq_norms(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(DT.normalize(torch.from_numpy(x)).numpy(),
                               np.array(DJ.normalize(jnp.asarray(x))), **TOL)
    z = np.zeros((2, 5), np.float32)   # eps guard: zero rows stay zero
    np.testing.assert_array_equal(DT.normalize(torch.from_numpy(z)).numpy(), z)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_corpus_and_queries(metric, dtype):
    x, q = _data(1)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ts, tn = DT.preprocess_corpus(torch.from_numpy(x), metric, tdt)
    js, jn = DJ.preprocess_corpus(jnp.asarray(x), metric, jdt)
    assert ts.dtype == tdt
    np.testing.assert_allclose(_np(ts), _jnp(js), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.array(jn), **TOL)
    np.testing.assert_allclose(DT.preprocess_queries(torch.from_numpy(q), metric).numpy(),
                               np.array(DJ.preprocess_queries(jnp.asarray(q), metric)), **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_corpus(metric, bits):
    x, _ = _data(2)
    tc, tsc, tn = DT.quantize_corpus(torch.from_numpy(x), metric, bits=bits)
    jc, jsc, jn = DJ.quantize_corpus(jnp.asarray(x), metric, bits=bits)
    assert tc.dtype == {8: torch.int8, 16: torch.int16}[bits]
    if metric == "cosine":
        # the normalized inputs differ in the last ulp (other summation
        # order), which can move a value across a rounding midpoint
        diff = np.abs(tc.numpy().astype(np.int32) - np.array(jc).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    else:
        np.testing.assert_array_equal(tc.numpy(), np.array(jc))
    np.testing.assert_allclose(tsc.numpy(), np.array(jsc), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.array(jn), **TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_quantize_corpus_global(metric):
    x, _ = _data(3)
    tc, tn = DT.quantize_corpus_global(torch.from_numpy(x), metric, 0.02)
    jc, jn = DJ.quantize_corpus_global(jnp.asarray(x), metric, jnp.float32(0.02))
    np.testing.assert_array_equal(tc.numpy(), np.array(jc))
    np.testing.assert_allclose(tn.numpy(), np.array(jn), rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_scores_with_scales_and_invalid_rows(metric):
    x, q = _data(4)
    norms = (x * x).sum(1) if metric == "l2" else np.zeros(x.shape[0], np.float32)
    norms[::9] = np.inf
    codes, scales, _ = DT.quantize_corpus(torch.from_numpy(x), metric)
    for xs, sc in ((x, None), (codes.numpy(), scales.numpy())):
        t = DT.pairwise_scores(torch.from_numpy(q), torch.from_numpy(xs), torch.from_numpy(norms),
                               metric, precision="highest",
                               x_scales=None if sc is None else torch.from_numpy(sc))
        j = DJ.pairwise_scores(jnp.asarray(q), jnp.asarray(xs), jnp.asarray(norms), metric,
                               precision=HIGHEST,
                               x_scales=None if sc is None else jnp.asarray(sc))
        np.testing.assert_allclose(t.numpy(), np.array(j), **TOL)
        assert np.isinf(t.numpy()[:, ::9]).all()


def _split(a):
    hi = jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    lo = (jnp.asarray(a) - hi).astype(jnp.bfloat16).astype(jnp.float32)
    return hi, lo


@pytest.mark.parametrize("precision", ["default", "high"])
def test_pairwise_scores_bf16_modes(precision):
    x, q = _data(5)
    norms = (x * x).sum(1)
    t = DT.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
                           "l2", precision=precision).numpy()
    (qh, ql), (xh, xl) = _split(q), _split(x)
    if precision == "default":
        dots = np.array(jnp.dot(qh, xh.T, precision=HIGHEST))
    else:   # the TPU kernel's bf16x3: hi*hi + hi*lo + lo*hi
        dots = np.array(jnp.dot(qh, xh.T, precision=HIGHEST) + jnp.dot(qh, xl.T, precision=HIGHEST)
                        + jnp.dot(ql, xh.T, precision=HIGHEST))
    np.testing.assert_allclose(t, norms[None, :] - 2.0 * dots, **TOL)
    exact = DT.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
                               "l2", precision="highest").numpy()
    err = np.abs(t - exact).max()
    assert err > 0 and err < (0.1 if precision == "default" else 1e-3), err


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("use_scale", [False, True])
def test_gathered_scores(metric, use_scale):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    cand = rng.standard_normal((5, 7, 16)).astype(np.float32)
    cn = (cand * cand).sum(-1)
    scale = 0.5 if use_scale else None
    t = DT.gathered_scores(torch.from_numpy(q), torch.from_numpy(cand), torch.from_numpy(cn),
                           metric, precision="highest", scale=scale)
    j = DJ.gathered_scores(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(cn), metric,
                           precision=HIGHEST, scale=scale)
    np.testing.assert_allclose(t.numpy(), np.array(j), **TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_finalize_and_brute_force_scores(metric):
    x, q = _data(7)
    s = np.random.default_rng(7).standard_normal((q.shape[0], 9)).astype(np.float32)
    np.testing.assert_allclose(
        DT.finalize_scores(torch.from_numpy(s), torch.from_numpy(q), metric).numpy(),
        np.array(DJ.finalize_scores(jnp.asarray(s), jnp.asarray(q), metric)), **TOL)
    np.testing.assert_allclose(
        DT.brute_force_scores(torch.from_numpy(q), torch.from_numpy(x), metric).numpy(),
        np.array(DJ.brute_force_scores(jnp.asarray(q), jnp.asarray(x), metric)),
        rtol=1e-6, atol=1e-4)


def test_unknown_precision_raises():
    x, q = _data(8)
    with pytest.raises(ValueError):
        DT.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x),
                           torch.zeros(x.shape[0]), "dot", precision="fast")
