"""The graph engines' shared pieces in zvdb_tpu_torch against the JAX package:
ops/topk.py (mask_duplicate_ids, mask_ids_in, bitonic_smallest_k),
index/build.py (select_neighbors, _reverse_pass, _reverse_pass_bulk) and
index/hnsw.py (beam_layer_fn).

The same numpy inputs (seeded) go through both packages. Ids and rows must be
equal. Products are compared at precision="highest" (JAX's CPU dots are f32
at every precision); beam tests score rows by lookup in one f32 table, so
both sides see identical scores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zvdb_tpu.index import build as JB
from zvdb_tpu.index import hnsw as JH
from zvdb_tpu.index.knn_graph import VecStore as JVecStore
from zvdb_tpu.ops import topk as JT
from zvdb_tpu_torch.index import build as TB
from zvdb_tpu_torch.index import hnsw as TH
from zvdb_tpu_torch.index.knn_graph import VecStore as TVecStore
from zvdb_tpu_torch.ops import topk as TT


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids_with_dups(rng, shape, hi, invalid=0.1):
    ids = rng.integers(0, hi, shape).astype(np.int32)
    ids[rng.random(shape) < invalid] = -1
    return ids


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_duplicate_ids(seed):
    rng = np.random.default_rng(seed)
    ids = _ids_with_dups(rng, (7, 5, 24), 12)          # many repeats, a batch axis
    s = rng.standard_normal(ids.shape).astype(np.float32)
    ts, ti = TT.mask_duplicate_ids(_t(s), _t(ids))
    js, ji = JT.mask_duplicate_ids(jnp.asarray(s), jnp.asarray(ids))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ti.dtype == torch.int32


def test_mask_ids_in():
    rng = np.random.default_rng(2)
    ids = _ids_with_dups(rng, (9, 30), 40)
    banned = _ids_with_dups(rng, (9, 7), 40, invalid=0.3)
    s = rng.standard_normal(ids.shape).astype(np.float32)
    ts, ti = TT.mask_ids_in(_t(s), _t(ids), _t(banned))
    js, ji = JT.mask_ids_in(jnp.asarray(s), jnp.asarray(ids), jnp.asarray(banned))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("c,k", [(48, 16), (37, 37), (5, 8)])
def test_bitonic_smallest_k(c, k):
    rng = np.random.default_rng(c)
    # scores on a coarse grid: many ties, which go to the smaller id
    s = rng.integers(0, 6, (11, c)).astype(np.float32)
    ids = rng.permutation(11 * c).reshape(11, c).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    s[ids < 0] = np.inf
    ts, ti = TT.bitonic_smallest_k(_t(s), _t(ids), k)
    js, ji = JT.bitonic_smallest_k(jnp.asarray(s), jnp.asarray(ids), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and it agrees with the (score, id) sort
    _, si = TT.sort_smallest_k(_t(s), _t(ids), k)
    np.testing.assert_array_equal(ti.numpy()[:, :min(c, k)], si.numpy())


def _candidates(rng, x, xn, rows, c, metric, invalid=0.1):
    """Per base row: c distinct candidate rows (some -1) and their surrogate
    scores in f32."""
    n = x.shape[0]
    cand = np.stack([rng.choice(n, c, replace=False) for _ in rows]).astype(np.int32)
    cand[rng.random(cand.shape) < invalid] = -1
    dots = np.einsum("rd,rcd->rc", x[rows], x[np.maximum(cand, 0)])
    s = (xn[np.maximum(cand, 0)] - 2 * dots) if metric == "l2" else -dots
    s = np.where(cand >= 0, s, np.inf).astype(np.float32)
    return cand, s


@pytest.mark.parametrize("metric,max_candidates,c", [
    ("l2", 0, 40), ("dot", 0, 40), ("l2", 24, 40), ("l2", 0, 10)])
def test_select_neighbors(metric, max_candidates, c):
    rng = np.random.default_rng(len(metric) + c + max_candidates)
    cents = rng.standard_normal((8, 16)).astype(np.float32)
    x = (cents[rng.integers(0, 8, 400)] + 0.3 * rng.standard_normal((400, 16))).astype(np.float32)
    xn = (x * x).sum(1) if metric == "l2" else np.zeros(400, np.float32)
    rows = np.arange(64)
    cand, s = _candidates(rng, x, xn, rows, c, metric)
    # c=10 < m_out=16: the tiny-pool padding path
    ti, td = TB.select_neighbors(TVecStore(_t(x), _t(xn), 1.0), _t(x[rows]), _t(xn[rows]),
                                 _t(cand), _t(s), 16, 1.2, metric,
                                 max_candidates=max_candidates, precision="highest")
    ji, jd = JB.select_neighbors(JVecStore(jnp.asarray(x), jnp.asarray(xn), jnp.float32(1.0)),
                                 jnp.asarray(x[rows]), jnp.asarray(xn[rows]), jnp.asarray(cand),
                                 jnp.asarray(s), 16, 1.2, metric, max_candidates=max_candidates)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (ti >= 0).sum() > 0


def test_select_neighbors_int8_store():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    xq = codes.astype(np.float32) * scale
    xn = (xq * xq).sum(1).astype(np.float32)
    rows = np.arange(40)
    cand, s = _candidates(rng, xq, xn, rows, 32, "l2")
    ti, _ = TB.select_neighbors(TVecStore(_t(codes), _t(xn), float(scale)), _t(xq[rows]),
                                _t(xn[rows]), _t(cand), _t(s), 12, 1.2, "l2",
                                precision="highest")
    ji, _ = JB.select_neighbors(JVecStore(jnp.asarray(codes), jnp.asarray(xn), jnp.float32(scale)),
                                jnp.asarray(xq[rows]), jnp.asarray(xn[rows]), jnp.asarray(cand),
                                jnp.asarray(s), 12, 1.2, "l2")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _graph(rng, cap, deg, fill=0.7):
    """A [cap+1, deg] table of distance-sorted edges (-1 / +inf padded; the
    trash row cap empty)."""
    nbrs = np.full((cap + 1, deg), -1, np.int32)
    dists = np.full((cap + 1, deg), np.inf, np.float32)
    for r in range(cap):
        m = int(rng.integers(0, deg + 1) * fill + 0.5)
        nb = rng.choice(cap, m, replace=False)
        nbrs[r, :m] = nb
        dists[r, :m] = np.sort(rng.random(m).astype(np.float32) * 4)
    return nbrs, dists


def test_reverse_pass():
    rng = np.random.default_rng(3)
    cap, deg, b, m = 300, 8, 64, 8
    nbrs, dists = _graph(rng, cap, deg)
    src = np.arange(200, 200 + b, dtype=np.int32)
    fwd = rng.integers(0, 200, (b, m)).astype(np.int32)
    fwd[:, 0] = 5                                       # a hub: more sources than the window
    fwd[rng.random(fwd.shape) < 0.15] = -1
    fwd_d = np.where(fwd >= 0, rng.random((b, m)) * 4, np.inf).astype(np.float32)
    tn, td = TB._reverse_pass(_t(nbrs.copy()), _t(dists.copy()), _t(src), _t(fwd), _t(fwd_d), deg)
    jn, jd = JB._reverse_pass(jnp.asarray(nbrs), jnp.asarray(dists), jnp.asarray(src),
                              jnp.asarray(fwd), jnp.asarray(fwd_d), deg)
    # row cap is the trash row: JAX writes every non-first edge's merge there
    np.testing.assert_array_equal(tn.numpy()[:cap], np.asarray(jn)[:cap])
    np.testing.assert_array_equal(td.numpy()[:cap], np.asarray(jd)[:cap])
    assert (tn.numpy()[cap] == -1).all()
    assert not np.array_equal(tn.numpy(), nbrs)


@pytest.mark.parametrize("rev_window", [0, 4])
def test_reverse_pass_bulk(rev_window):
    rng = np.random.default_rng(4 + rev_window)
    n, deg = 400, 12
    nbrs, dists = _graph(rng, n, deg)
    nbrs[:, 0] = np.where(nbrs[:, 0] >= 0, 7, -1)      # a hub in every row
    nbrs[7, 0] = 8
    tn, td = TB._reverse_pass_bulk(_t(nbrs), _t(dists), n, deg, rev_window=rev_window)
    jn, jd = JB._reverse_pass_bulk(jnp.asarray(nbrs), jnp.asarray(dists), n, deg,
                                   rev_window=rev_window)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# beam_layer_fn: rows scored by lookup in one table S [B, N]


def _beam_inputs(seed, b=24, n=500, deg=12, s_width=6):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, (n + 1, deg)).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.1] = -1
    nbrs[n] = -1
    table = rng.random((b, n)).astype(np.float32)
    seeds = rng.integers(0, n, (b, s_width)).astype(np.int32)
    seeds[:, 1] = seeds[:, 0]                           # a duplicated seed
    seeds[:, 2] = -1
    seed_s = np.where(seeds >= 0, np.take_along_axis(table, np.maximum(seeds, 0), 1), np.inf)
    return nbrs, table, seeds, seed_s.astype(np.float32)


def _scorers(table):
    tt, jt = _t(table), jnp.asarray(table)

    def t_score(rows):
        return torch.where(rows >= 0, torch.gather(tt, 1, rows.clamp(min=0).long()), float("inf"))

    def j_score(rows):
        return jnp.where(rows >= 0, jnp.take_along_axis(jt, jnp.maximum(rows, 0), 1), jnp.inf)

    return t_score, j_score


@pytest.mark.parametrize("kw", [
    dict(ef=16, expand=4),
    dict(ef=16, expand=2, max_iters=3),
    dict(ef=12, expand=4, limit_n=300),
    dict(ef=16, expand=4, use_degree=8),
    dict(ef=4, expand=2),                                # ef < seeds: seeds cut to ef
    dict(ef=16, expand=4, dedupe_candidates=False),
], ids=["plain", "max_iters", "limit_n", "use_degree", "ef_lt_seeds", "no_dedupe"])
def test_beam_layer_fn(kw):
    nbrs, table, seeds, seed_s = _beam_inputs(sum(map(len, kw)))
    t_score, j_score = _scorers(table)
    ts, tr = TH.beam_layer_fn(t_score, _t(seeds), _t(seed_s), _t(nbrs), **kw)
    js, jr = JH.beam_layer_fn(j_score, jnp.asarray(seeds), jnp.asarray(seed_s),
                              jnp.asarray(nbrs), **kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_beam_layer_fn_expand_fn():
    nbrs, table, seeds, seed_s = _beam_inputs(9)
    t_score, j_score = _scorers(table)
    tn, jn = _t(nbrs), jnp.asarray(nbrs)

    def t_expand(sel_r):
        cand = torch.where((sel_r >= 0)[:, :, None], tn[sel_r.clamp(min=0).long()], -1)
        cand = cand.reshape(sel_r.shape[0], -1)
        return cand, t_score(cand)

    def j_expand(sel_r):
        cand = jnp.where((sel_r >= 0)[:, :, None], jnp.take(jn, jnp.maximum(sel_r, 0), 0), -1)
        cand = cand.reshape(sel_r.shape[0], -1)
        return cand, j_score(cand)

    ts, tr = TH.beam_layer_fn(None, _t(seeds), _t(seed_s), tn, 16, expand=4, expand_fn=t_expand)
    js, jr = JH.beam_layer_fn(None, jnp.asarray(seeds), jnp.asarray(seed_s), jn, 16, expand=4,
                              expand_fn=j_expand)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
