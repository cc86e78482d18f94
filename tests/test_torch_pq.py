"""zvdb_tpu_torch.ops.pq, ops.topk.sort_smallest_k and PQConfig against the
JAX package on the CPU.

With the same codebooks the deterministic ops agree: decode / adc_lut /
decoded_sq_norms within rtol 1e-5 (other summation orders), pack / unpack
exactly, encode on >= 99.9% of codes (an argmin may flip where two centroids
tie within an ulp). Training draws from torch's generator, which cannot
reproduce JAX's PRNG, so it is held to its contract: a quantization error
within 1.1x of JAX's on the same sample, an orthogonal OPQ rotation, and the
same codes from the same seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.ops import pq as PJ
from zvdb_tpu.ops import topk as TJ
from zvdb_tpu_torch.ops import pq as PT
from zvdb_tpu_torch.ops import topk as TT

STOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sample():
    """An anisotropic, cluster-structured sample mixed by a rotation, so
    subspaces and OPQ both have structure to find."""
    rng = np.random.default_rng(7)
    n, d = 4096, 32
    cents = rng.standard_normal((24, d)) * 2.0
    z = cents[rng.integers(0, 24, n)] + rng.standard_normal((n, d))
    z *= np.exp(-np.arange(d) / 12.0)
    mix = np.linalg.qr(rng.standard_normal((d, d)))[0]
    return (z @ mix).astype(np.float32)


@pytest.fixture(scope="module")
def jax_codebooks(sample):
    return np.array(PJ.train_codebooks(jnp.asarray(sample), jax.random.PRNGKey(0), 8, 16, 8))


def _mse_port(x, cb, rot=None):
    xr = x if rot is None else x @ rot
    return float(((PT.decode(PT.encode(xr, cb), cb) - xr) ** 2).mean())


def _mse_jax(x, cb, rot=None):
    xr = x if rot is None else x @ rot
    return float(jnp.mean((PJ.decode(PJ.encode(xr, cb), cb) - xr) ** 2))


@pytest.mark.parametrize("n_codes", [16, 256])
def test_encode_decode_match_jax(sample, n_codes):
    cb = np.array(PJ.train_codebooks(jnp.asarray(sample), jax.random.PRNGKey(1), 8, n_codes, 4))
    x = sample[:3000]
    cj = np.array(PJ.encode(jnp.asarray(x), jnp.asarray(cb), chunk=1024))
    ct = PT.encode(torch.from_numpy(x), torch.from_numpy(cb), chunk=1024).numpy()
    assert ct.dtype == np.uint8 and ct.shape == (3000, 8)
    assert (ct == cj).mean() >= 0.999
    np.testing.assert_allclose(PT.decode(torch.from_numpy(cj), torch.from_numpy(cb)).numpy(),
                               np.array(PJ.decode(jnp.asarray(cj), jnp.asarray(cb))), **STOL)
    np.testing.assert_allclose(
        PT.decoded_sq_norms(torch.from_numpy(cj), torch.from_numpy(cb)).numpy(),
        np.array(PJ.decoded_sq_norms(jnp.asarray(cj), jnp.asarray(cb))), **STOL)


def test_adc_lut_matches_jax(sample, jax_codebooks):
    q = sample[::97]
    np.testing.assert_allclose(
        PT.adc_lut(torch.from_numpy(q), torch.from_numpy(jax_codebooks)).numpy(),
        np.array(PJ.adc_lut(jnp.asarray(q), jnp.asarray(jax_codebooks))), **STOL)


def test_pack_unpack_match_jax():
    codes = np.random.default_rng(0).integers(0, 16, (37, 8)).astype(np.uint8)
    pt = PT.pack_nibbles(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(pt, np.array(PJ.pack_nibbles(jnp.asarray(codes))))
    assert pt.shape == (37, 4)
    np.testing.assert_array_equal(PT.unpack_nibbles(torch.from_numpy(pt), 8).numpy(), codes)
    # the transposed [S/2, N] store unpacks through .T, as the engines read it
    np.testing.assert_array_equal(
        PT.unpack_nibbles(torch.from_numpy(np.ascontiguousarray(pt.T)).T, 8).numpy(), codes)


def test_apply_rotation_identity_sentinel():
    x = torch.randn(5, 8)
    assert PT.apply_rotation(x, torch.zeros((0, 0))) is x
    rot = torch.linalg.qr(torch.randn(8, 8)).Q
    torch.testing.assert_close(PT.apply_rotation(x, rot), x @ rot)


@pytest.mark.parametrize("n_codes", [16, 256])
def test_training_contract(sample, n_codes):
    xs = torch.from_numpy(sample)
    cb_t = PT.train_codebooks(xs, torch.Generator().manual_seed(0), 8, n_codes, 8)
    cb_j = np.array(PJ.train_codebooks(jnp.asarray(sample), jax.random.PRNGKey(0), 8, n_codes, 8))
    assert cb_t.shape == (8, n_codes, 4) and cb_t.dtype == torch.float32
    assert _mse_port(xs, cb_t) <= 1.1 * _mse_jax(jnp.asarray(sample), jnp.asarray(cb_j))
    again = PT.train_codebooks(xs, torch.Generator().manual_seed(0), 8, n_codes, 8)
    assert torch.equal(PT.encode(xs, again), PT.encode(xs, cb_t))


def test_training_with_fewer_rows_than_codes():
    xs = torch.randn(5, 8, generator=torch.Generator().manual_seed(3))
    cb = PT.train_codebooks(xs, torch.Generator().manual_seed(0), 2, 16, 3)
    assert cb.shape == (2, 16, 4) and torch.isfinite(cb).all()


def test_opq_contract(sample):
    xs = torch.from_numpy(sample)
    rot, cb = PT.train_opq(xs, torch.Generator().manual_seed(0), 8, 16, 8, 4)
    assert rot.shape == (32, 32)
    assert float((rot @ rot.T - torch.eye(32)).abs().max()) < 1e-4
    rot_j, cb_j = PJ.train_opq(jnp.asarray(sample), jax.random.PRNGKey(0), 8, 16, 8, 4)
    assert _mse_port(xs, cb, rot) <= 1.1 * _mse_jax(jnp.asarray(sample), cb_j, rot_j)
    # the rotation's job: less error than plain PQ at the same code budget
    plain = PT.train_codebooks(xs, torch.Generator().manual_seed(0), 8, 16, 8)
    assert _mse_port(xs, cb, rot) < _mse_port(xs, plain)
    rot2, cb2 = PT.train_opq(xs, torch.Generator().manual_seed(0), 8, 16, 8, 4)
    assert torch.equal(PT.encode(xs @ rot2, cb2), PT.encode(xs @ rot, cb))


def _scores_ids(seed, rows=30, width=40, ties=False, dup_ids=False):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((rows, width)).astype(np.float32)
    if ties:   # few distinct values: ties at every rank
        s = (np.round(s * 2) / 2 + 0.25).astype(np.float32)
    s[rng.random((rows, width)) < 0.2] = np.inf
    if dup_ids:   # ids repeat within a row, sometimes with different scores
        ids = rng.integers(0, width // 3, (rows, width)).astype(np.int32)
    else:
        ids = rng.permutation(rows * width).reshape(rows, width).astype(np.int32)
    return s, np.where(np.isinf(s), -1, ids).astype(np.int32)


@pytest.mark.parametrize("dedupe", [False, True])
@pytest.mark.parametrize("ties,dup_ids", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_sort_smallest_k_matches_jax(k, ties, dup_ids, dedupe):
    s, ids = _scores_ids(k + 2 * ties + dup_ids, ties=ties, dup_ids=dup_ids)
    ts, ti = TT.sort_smallest_k(torch.from_numpy(s), torch.from_numpy(ids), k, dedupe=dedupe)
    js, ji = TJ.sort_smallest_k(jnp.asarray(s), jnp.asarray(ids), k, dedupe=dedupe)
    np.testing.assert_array_equal(ti.numpy(), np.array(ji))
    np.testing.assert_array_equal(ts.numpy(), np.array(js))
    if dedupe:
        for row in ti.numpy():
            live = row[row >= 0]
            assert live.size == np.unique(live).size


def test_sort_smallest_k_breaks_ties_by_id_not_position():
    s = torch.tensor([[1.0, 0.5, 0.5, 0.5]])
    ids = torch.tensor([[9, 7, 3, 5]], dtype=torch.int32)
    _, ti = TT.sort_smallest_k(s, ids, 3)
    assert ti.tolist() == [[3, 5, 7]]
    _, pos = TT.smallest_k_dense(s, 3)   # the position route
    assert pos.tolist() == [[1, 2, 3]]


def test_config_matches_jax():
    fj = {f.name: f.default for f in dataclasses.fields(ZJ.PQConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(ZT.PQConfig)}
    assert fj == ft
    for kw in [dict(dim=128), dict(dim=32, n_sub=8, refine="none"),
               dict(dim=32, n_sub=8, n_codes=256, refine="bfloat16"),
               dict(dim=64, n_sub=16, refine="int8", scan="pallas")]:
        cj, ct = ZJ.PQConfig(**kw), ZT.PQConfig(**kw)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)   # scan resolves alike off the card
        for prop in ("packed", "codes_width", "dsub", "bytes_per_vector"):
            assert getattr(cj, prop) == getattr(ct, prop)
    assert ZT.PQConfig(dim=128).bytes_per_vector == 8 + 4 + 256 + 4
    assert ZT.PQConfig(dim=128, refine="bfloat16").refine_dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(dim=30, n_sub=8), dict(dim=32, n_sub=8, refine="int4"), dict(dim=0),
    dict(dim=32, n_sub=8, n_codes=300), dict(dim=32, n_sub=8, scan="triton"),
    dict(dim=32, n_sub=8, metric="hamming"),
    dict(dim=32, n_sub=8, n_codes=256, scan="pallas"),
    dict(dim=48, n_sub=12, scan="pallas"),
    dict(dim=32, n_sub=8, scan="pallas", pallas_chunk=300),
    dict(dim=32, n_sub=8, scan="pallas", per_bin=3),
    dict(dim=32, n_sub=8, scan="pallas", pallas_chunk=1024, seg_rows=1500),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        ZJ.PQConfig(**kw)
    with pytest.raises(ValueError):
        ZT.PQConfig(**kw)
