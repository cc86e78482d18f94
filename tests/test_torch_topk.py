"""zvdb_tpu_torch.ops.topk against zvdb_tpu.ops.topk on the CPU: ids exact,
ties taken in position order as lax.top_k takes them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zvdb_tpu.ops import topk as TJ
from zvdb_tpu_torch.ops import topk as TT


def _scores_ids(seed, rows=40, width=24, p_inf=0.2, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((rows, width)).astype(np.float32)
    if ties:   # few distinct values (no signed zeros): ties, also at the k-th score
        s = (np.round(s) + 0.5).astype(np.float32)
    s[rng.random((rows, width)) < p_inf] = np.inf
    ids = rng.permutation(rows * width).reshape(rows, width).astype(np.int32)
    ids = np.where(np.isinf(s), -1, ids).astype(np.int32)
    return s, ids


def _both(fn_t, fn_j, *arrays, k):
    t = fn_t(*(torch.from_numpy(a) for a in arrays), k)
    j = fn_j(*(jnp.asarray(a) for a in arrays), k)
    return [x.numpy() for x in t], [np.array(x) for x in j]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 24])
def test_smallest_k_matches_jax(ties, k):
    s, ids = _scores_ids(k, ties=ties)
    (ts, ti), (js, ji) = _both(TT.smallest_k, TJ.smallest_k, s, ids, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert ti.dtype == np.int32
    assert (ti[np.isinf(ts)] == -1).all()


@pytest.mark.parametrize("ties", [False, True])
def test_smallest_k_dense_matches_jax(ties):
    s, _ = _scores_ids(3, p_inf=0.0, ties=ties)
    (ts, tp), (js, jp) = _both(TT.smallest_k_dense, TJ.smallest_k_dense, s, k=7)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)


def test_k_greater_than_width_raises_in_both():
    s, ids = _scores_ids(4, width=6)
    with pytest.raises(ValueError):
        TT.smallest_k(torch.from_numpy(s), torch.from_numpy(ids), 7)
    with pytest.raises(ValueError):
        TJ.smallest_k(jnp.asarray(s), jnp.asarray(ids), 7)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_merge_topk_matches_jax(k):
    # k above each list's width (4 and 3), with +inf / -1 slots in both lists
    sa, ia = _scores_ids(5, width=4, p_inf=0.3)
    sb, ib = _scores_ids(6, width=3, p_inf=0.3)
    (ts, ti), (js, ji) = _both(TT.merge_topk, TJ.merge_topk, sa, ia, sb, ib, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert (ts[:, :-1] <= ts[:, 1:]).all()   # ascending


def test_all_invalid_row():
    s = np.full((2, 5), np.inf, np.float32)
    ids = np.full((2, 5), -1, np.int32)
    ts, ti = TT.smallest_k(torch.from_numpy(s), torch.from_numpy(ids), 3)
    assert np.isinf(ts.numpy()).all() and (ti.numpy() == -1).all()
