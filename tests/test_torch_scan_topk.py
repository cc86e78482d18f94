"""zvdb_tpu_torch.ops.scan_topk against the two Pallas exact scans it replaces
(examples/pallas_scan_v1.py:flat_topk_pallas, kernel E, and
examples/pallas_scan_v2.py:flat_topk_pallas2, kernel F).

On the CPU both entry points run `_flat_topk_plain`; the JAX side runs the
example kernels in interpret mode (f32 dots), loaded by path as
tests/test_pallas_scan.py loads them. Ids must be equal id for id, in slot
order. Scores within rtol 1e-5, atol 1e-4: the f32 dot sums in another order.

On the CPU `filter_margin` is also held against an emulated bf16x3 split,
and F's in-chunk filter rule (keep a column while s~ - margin <= the k-th
smallest s~ + margin) against the exact stable top-k of adversarial chunks.
The `gpu`-marked tests need the card and skip without one; they hold the
tensor-core E and F and the CUDA-core E and F equal bit for bit:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_scan_topk.py
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import scan_topk as ST

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load(name, fname):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_EX, fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_both(q, x, k, **kw):
    """JAX's E and F in interpret mode; asserts they agree (one contract)."""
    import jax.numpy as jnp

    e = _load("pallas_scan_v1", "pallas_scan_v1.py").flat_topk_pallas
    f = _load("pallas_scan_v2", "pallas_scan_v2.py").flat_topk_pallas2
    es, ei = (np.asarray(a) for a in e(jnp.asarray(q), jnp.asarray(x), k, interpret=True, **kw))
    fs, fi = (np.asarray(a) for a in f(jnp.asarray(q), jnp.asarray(x), k, interpret=True, **kw))
    np.testing.assert_array_equal(ei, fi)
    np.testing.assert_array_equal(es, fs)
    return es, ei


def _inputs(n, d, b, seed, dup=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dup:   # rows 300 .. 300+dup-2 repeat row 0, and query 0 is row 0
        x[300:300 + dup - 1] = x[0]
        q[0] = x[0]
    return q, x


def _assert_same(ts, ti, js, ji):
    assert ts.shape == js.shape and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-4)


CASES = [
    # (n, d, b, k, metric, chunk)
    (3000, 32, 64, 10, "l2", 512),
    (3000, 32, 64, 10, "l2", 256),
    (3000, 32, 64, 10, "dot", 512),
    (3000, 32, 64, 10, "dot", 256),
    (2777, 32, 61, 10, "l2", 256),     # ragged N and ragged B
    (3000, 32, 64, 1, "l2", 512),      # k = 1
    (7, 32, 64, 10, "l2", 256),        # N < k: slots past N stay +inf / -1
    (40, 32, 16, 10, "dot", 8),        # k > chunk: the extra rounds take nothing
]


@pytest.mark.parametrize("n,d,b,k,metric,chunk", CASES)
def test_plain_matches_pallas(n, d, b, k, metric, chunk):
    q, x = _inputs(n, d, b, seed=n + b + k + chunk)
    js, ji = _jax_both(q, x, k, metric=metric, q_tile=32, chunk=chunk)
    for fn in (ST.flat_topk_pallas, ST.flat_topk_pallas2):
        ts, ti = fn(torch.from_numpy(q), torch.from_numpy(x), k, metric=metric, q_tile=32,
                    chunk=chunk)
        _assert_same(ts, ti, js, ji)
    if n < k:
        assert (ji[:, n:] == -1).all() and np.isinf(js[:, n:]).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ties_match_pallas(metric):
    # 40 equal rows (row 0 and rows 300..338): the first argmin takes the
    # lower row, the first argmax slot is replaced, and an equal score is
    # never taken, so query 0 (= row 0) ends with [0, 308, 307, ..., 300]
    q, x = _inputs(1000, 16, 32, seed=11, dup=40)
    js, ji = _jax_both(q, x, 10, metric=metric, q_tile=32, chunk=256)
    ts, ti = ST.flat_topk_pallas(torch.from_numpy(q), torch.from_numpy(x), 10, metric=metric,
                                 q_tile=32, chunk=256)
    _assert_same(ts, ti, js, ji)
    if metric == "l2":
        assert ti[0].tolist() == [0, 308, 307, 306, 305, 304, 303, 302, 301, 300]


def test_q_tile_changes_nothing_and_chunk_only_the_order():
    q, x = _inputs(1500, 8, 20, seed=3)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    s1, i1 = ST.flat_topk_pallas(qt, xt, 10, q_tile=8, chunk=128)
    s2, i2 = ST.flat_topk_pallas(qt, xt, 10, q_tile=256, chunk=128)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    _, i3 = ST.flat_topk_pallas(qt, xt, 10, chunk=1024)
    assert torch.equal(torch.sort(i1, 1).values, torch.sort(i3, 1).values)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.sort(np.argsort(d2, axis=1, kind="stable")[:, :10], 1)
    np.testing.assert_array_equal(torch.sort(i1, 1).values.numpy(), gt)


def _fma_dot(q, x):
    """acc = fmaf(q_d, x_d, acc) over d in order, for every (query, row):
    the exact product in f64, one rounding to f32 per step."""
    q64, x64 = q.double(), x.double()
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    for d in range(q.shape[1]):
        acc = (q64[:, None, d] * x64[None, :, d] + acc.double()).float()
    return acc


def _split(v):
    hi = v.to(torch.bfloat16)
    return hi.float(), (v - hi.float()).to(torch.bfloat16).float()


@pytest.mark.parametrize("d", [16, 33, 128, 1024])
def test_filter_margin_bounds_the_split(d):
    # the tensor-core filter's score (three bf16 products summed in f32)
    # against the exact score (the f32 fmaf chain) and an f64 dot: within
    # half the margin (the margin keeps >= 2x headroom on its proven bound)
    rng = np.random.default_rng(d)
    nq, nx = 12, 160
    q = rng.standard_normal((nq, d))
    x = rng.standard_normal((nx, d))
    q *= 10.0 ** rng.uniform(-3, 4, (nq, 1))             # norms from ~1e-3 to ~1e4 and beyond
    x *= 10.0 ** rng.uniform(-3, 4, (nx, 1))
    x[:8] = x[8:16] + 1e-6 * rng.standard_normal((8, d))  # near-duplicates, mixed signs
    x[16:24] = rng.standard_normal((8, d)) * 2e-38        # at bf16's underflow
    q[0] = rng.standard_normal(d) * 3e-38
    q, x = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(x.astype(np.float32))
    qh, ql = _split(q)
    xh, xl = _split(x)
    approx = qh @ xh.T + qh @ xl.T + ql @ xh.T
    exact = _fma_dot(q, x)
    nrm = _fma_dot(x, x).diagonal()
    dot64 = q.double() @ x.double().T
    qn = torch.linalg.vector_norm(q.double(), dim=1)[:, None]
    xn = torch.linalg.vector_norm(x.double(), dim=1)[None, :]
    half = ST.filter_margin(qn, xn, d) / 2
    s_approx = nrm[None, :] - 2.0 * approx
    s_exact = nrm[None, :] - 2.0 * exact
    assert bool(((s_approx.double() - s_exact.double()).abs() <= half).all())
    assert bool(((s_approx.double() - (nrm.double()[None, :] - 2.0 * dot64)).abs() <= half).all())
    assert bool(((approx.double() - exact.double()).abs() <= half).all())
    assert bool(((approx.double() - dot64).abs() <= half).all())


def test_filter_margin_formula():
    u = 2.0 ** -24
    assert ST.filter_margin(1.0, 1.0, 128) == pytest.approx(
        u * (4096 + 18 * 128 + 5) + 2.0 ** -100 * 128 * 3)
    # DP is D rounded up to 16
    assert ST.filter_margin(2.0, 3.0, 33) == ST.filter_margin(2.0, 3.0, 48)


def _chunk_rule(q, x, k, metric, chunk):
    """F's in-chunk filter on the CPU: s~ from the emulated bf16x3 split, the
    exact score from the fmaf chain, L/U = s~ -/+ filter_margin, T the k-th
    smallest U of each (query, chunk). Checks that the chunk's exact stable
    top-k lies within {L <= T} and that the survivors' stable top-k is it."""
    qh, ql = _split(q)
    xh, xl = _split(x)
    approx = (qh @ xh.T + qh @ xl.T + ql @ xh.T).double()
    exact = _fma_dot(q, x)
    nrm = _fma_dot(x, x).diagonal()
    if metric == "l2":
        s_approx = nrm.double()[None, :] - 2.0 * approx
        s_exact = nrm[None, :] - 2.0 * exact
    else:
        s_approx, s_exact = -approx, -exact
    qn = torch.linalg.vector_norm(q.double(), dim=1)[:, None]
    xn = torch.linalg.vector_norm(x.double(), dim=1)[None, :]
    margin = ST.filter_margin(qn, xn, q.shape[1])
    lo, hi = s_approx - margin, s_approx + margin
    kept = 0
    for c0 in range(0, x.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        kk = min(k, lo[:, sl].shape[1])
        t = torch.kthvalue(hi[:, sl], kk, dim=1).values[:, None]
        keep = lo[:, sl] <= t
        want = torch.sort(s_exact[:, sl], dim=1, stable=True).indices[:, :kk]
        assert bool(torch.gather(keep, 1, want).all())
        masked = torch.where(keep, s_exact[:, sl], torch.full_like(s_exact[:, sl], _INF))
        got = torch.sort(masked, dim=1, stable=True).indices[:, :kk]
        assert torch.equal(got, want)
        kept += int(keep.sum())
    return kept


_INF = float("inf")


def _adversarial(k):
    """Near-duplicate and equal rows around query 0, rows of norm ~1e3 around
    a query near the origin (query 1), rows and a query at bf16's underflow."""
    rng = np.random.default_rng(7 + k)
    d, nq = 64, 10
    x = rng.standard_normal((600, d))
    q = rng.standard_normal((nq, d))
    x[40:80] = x[0] + 1e-6 * rng.standard_normal((40, d))     # near-duplicates of row 0
    x[80:84] = x[0]                                           # exact duplicates: ties
    q[0] = x[0]
    far = rng.standard_normal((200, d))                        # norm ~1e3 around a query at ~0
    x[200:400] = far / np.linalg.norm(far, axis=1, keepdims=True) * (1e3 + rng.standard_normal((200, 1)))
    q[1] = 1e-3 * rng.standard_normal(d)
    x[400:440] = rng.standard_normal((40, d)) * 2e-38          # at bf16's underflow
    q[2] = rng.standard_normal(d) * 3e-38
    return torch.from_numpy(q.astype(np.float32)), torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("k", [1, 10])
def test_chunk_filter_rule_keeps_the_exact_top_k(metric, k):
    q, x = _adversarial(k)
    kept = _chunk_rule(q, x, k, metric, chunk=128)
    assert kept >= k * q.shape[0] * 5   # every chunk keeps at least its k


def _lane_minima_rule(q, x, k, metric, chunk):
    """The tensor-core F's bound for k <= 32, step by step as the kernel takes
    it: column c of a 128-column step is seen by lane (c % 128 // 16) * 4 +
    c % 8 // 2 of 32; after the chunk's first step each lane keeps the least
    U of its columns and T = the k-th smallest of the 32 minima; a column goes
    to the list while L <= T; after that a lane's minimum takes only the
    columns taken; T = min(T, the new bound) after steps 1, 3, 7, ... and at
    the chunk's end. Checks that the survivors (L <= T at the end) hold the
    chunk's exact stable top-k and that their stable top-k is it."""
    qh, ql = _split(q)
    xh, xl = _split(x)
    approx = (qh @ xh.T + qh @ xl.T + ql @ xh.T).double()
    exact = _fma_dot(q, x)
    nrm = _fma_dot(x, x).diagonal()
    s_approx = nrm.double()[None, :] - 2.0 * approx if metric == "l2" else -approx
    s_exact = nrm[None, :] - 2.0 * exact if metric == "l2" else -exact
    qn = torch.linalg.vector_norm(q.double(), dim=1)[:, None]
    xn = torch.linalg.vector_norm(x.double(), dim=1)[None, :]
    margin = ST.filter_margin(qn, xn, q.shape[1])
    lo, hi = s_approx - margin, s_approx + margin
    nq, n = s_exact.shape
    lane = (torch.arange(128) % 128 // 16) * 4 + torch.arange(128) % 8 // 2
    for c0 in range(0, n, chunk):
        w = min(chunk, n - c0)
        steps = -(-w // 128)
        mins = torch.full((nq, 32), _INF, dtype=torch.float64)
        t_b = torch.full((nq,), _INF, dtype=torch.float64)
        taken = torch.zeros((nq, w), dtype=torch.bool)

        def bound():
            kth = torch.kthvalue(mins, k, dim=1).values
            return torch.minimum(t_b, kth)

        for t in range(steps):
            cols = torch.arange(t * 128, min(w, t * 128 + 128))
            u, l_ = hi[:, c0 + cols], lo[:, c0 + cols]
            sl = lane[:len(cols)]
            if t == 0:
                for j, ln in enumerate(sl.tolist()):
                    mins[:, ln] = torch.minimum(mins[:, ln], u[:, j])
                t_b = bound()
            take = ~(l_ > t_b[:, None])
            taken[:, cols] = take
            for j, ln in enumerate(sl.tolist()):
                mins[:, ln] = torch.where(take[:, j], torch.minimum(mins[:, ln], u[:, j]),
                                          mins[:, ln])
            if t + 1 == steps or (t > 0 and ((t + 1) & t) == 0):
                t_b = bound()
        keep = taken & (lo[:, c0:c0 + w] <= t_b[:, None])
        kk = min(k, w)
        want = torch.sort(s_exact[:, c0:c0 + w], dim=1, stable=True).indices[:, :kk]
        assert bool(torch.gather(keep, 1, want).all())
        masked = torch.where(keep, s_exact[:, c0:c0 + w], torch.full((nq, w), _INF))
        assert torch.equal(torch.sort(masked, dim=1, stable=True).indices[:, :kk], want)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_lane_minima_bound_keeps_the_exact_top_k(metric, k):
    # chunk 512: bounds after steps 0, 1 and at the end (3); 88 rows left over
    q, x = _adversarial(k)
    _lane_minima_rule(q, x, k, metric, chunk=512)


def test_cpu_tensors_count_nothing():
    q, x = (torch.from_numpy(a) for a in _inputs(300, 8, 5, seed=1))
    before = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma,
              ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma)
    ST.flat_topk_pallas(q, x, 4, chunk=64)
    ST.flat_topk_pallas2(q, x, 4, chunk=64)
    assert (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma,
            ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma) == before


def test_cuda_tensor_picks_the_mma_entry_point(monkeypatch):
    # a device other than the CPU takes the tensor-core entry point, counted
    # by both counters (the checks and the launch itself stubbed out)
    q, x = torch.empty((3, 8), device="meta"), torch.empty((50, 8), device="meta")
    monkeypatch.setattr(ST, "_launch", lambda name, q, v, k, chunk: (q, v, None, None, 3, 50, 8))
    monkeypatch.setattr(ST, "build_v1_mma", lambda: "tensor cores")
    monkeypatch.setattr(ST, "build_v1", lambda: "cuda cores")
    seen = []
    monkeypatch.setattr(ST, "launch", lambda kernel, *a, **kw: seen.append(kernel) or ("s", "i"))
    before = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma)
    assert ST.flat_topk_pallas(q, x, 5) == ("s", "i")
    assert seen == ["tensor cores"]
    assert (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma) == \
        (before[0] + 1, before[1] + 1)


def test_cuda_tensor_picks_the_mma_entry_point_for_f(monkeypatch):
    # F on a device other than the CPU takes its tensor-core entry point,
    # counted by both of F's counters (the checks and the launch stubbed out)
    q, x = torch.empty((3, 8), device="meta"), torch.empty((50, 8), device="meta")
    monkeypatch.setattr(ST, "_launch", lambda name, q, v, k, chunk: (q, v, None, None, 3, 50, 8))
    monkeypatch.setattr(ST, "build_v2_mma", lambda: "tensor cores")
    monkeypatch.setattr(ST, "build_v2_passes", lambda: "cuda cores")
    seen = []
    monkeypatch.setattr(ST, "launch_f_passes",
                        lambda kernel, *a, **kw: seen.append((kernel, kw)) or ("s", "i", 0, 0))
    before = (ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma)
    assert ST.flat_topk_pallas2(q, x, 5) == ("s", "i")
    assert seen == [("tensor cores", {})]   # every part: pre-pass, pairs and fold
    assert (ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma) == \
        (before[0] + 1, before[1] + 1)


def test_argument_checks_and_cpu_path():
    q, x = (torch.from_numpy(a) for a in _inputs(50, 4, 3, seed=0))
    with pytest.raises(ValueError):
        ST.flat_topk_pallas(q, x, 0)
    with pytest.raises(ValueError):
        ST.flat_topk_pallas2(q, x, 5, chunk=0)
    before = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches)
    a = ST.flat_topk_pallas(q, x, 5, chunk=16)
    b = ST._flat_topk_plain(q, x, 5, chunk=16)
    assert (ST.flat_topk_pallas.launches, ST.flat_topk_pallas2.launches) == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tie_aware(q, x, metric, ks, ki, ps, pi):
    """Kernel against plain: equal where both are empty; elsewhere scores
    within 1e-5 of the score scale and every differing id a near-tie in f64."""
    assert torch.equal(ki < 0, pi < 0)
    fin = pi >= 0
    scale = float(ps[fin].abs().max()) if bool(fin.any()) else 1.0
    tol = 1e-5 * scale + 1e-5
    assert float((ks - ps).abs()[fin].max()) <= tol if bool(fin.any()) else True
    bad = fin & (ki != pi)
    if bool(bad.any()):
        xd, qd = x.double(), q.double()
        f = 2.0 if metric == "l2" else 1.0
        nrm = (xd * xd).sum(1) if metric == "l2" else torch.zeros_like(xd[:, 0])
        r, c = torch.nonzero(bad, as_tuple=True)
        sk = nrm[ki[r, c].long()] - f * (qd[r] * xd[ki[r, c].long()]).sum(1)
        sp = nrm[pi[r, c].long()] - f * (qd[r] * xd[pi[r, c].long()]).sum(1)
        assert float((sk - sp).abs().max()) <= tol


def _four_ways(q, x, k, metric, chunk):
    """The tensor-core E and F, and the CUDA-core E and F (uncounted): equal
    bit for bit."""
    es, ei = ST.flat_topk_pallas(q, x, k, metric, chunk=chunk)
    fs, fi = ST.flat_topk_pallas2(q, x, k, metric, chunk=chunk)
    os_, oi = ST.launch(ST.build_v1(), q, x, k, metric, chunk)
    gs, gi, _, _ = ST.launch_f_passes(ST.build_v2_passes(), q, x, k, metric, chunk)
    torch.cuda.synchronize()
    assert torch.equal(ei, fi) and torch.equal(es, fs)
    assert torch.equal(ei, oi) and torch.equal(es, os_)
    assert torch.equal(ei, gi) and torch.equal(es, gs)
    return es, ei


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,k,metric,chunk", [
    (5000, 128, 37, 10, "l2", 2048), (5003, 40, 70, 100, "dot", 256),
    (3000, 33, 1, 1, "l2", 256), (5, 16, 9, 10, "l2", 256),
    (9001, 64, 17, 256, "l2", 4096), (4097, 1024, 20, 10, "dot", 2048),
    (777, 20, 33, 100, "l2", 4096), (6000, 96, 300, 10, "dot", 256),
    (3000, 1024, 5, 256, "l2", 4096),    # the tightest plan: two stages, D chunks of 64
    (50_000, 64, 5, 10, "l2", 256)])     # many chunks, a small batch
def test_kernels_match_plain_on_gpu(cuda_device, n, d, b, k, metric, chunk):
    # E and F on the tensor cores == the CUDA-core E and F bit for bit;
    # tie-aware against the plain version (other summation order)
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _inputs(n, d, b, seed=n + k))
    ps, pi = ST._flat_topk_plain(q, x, k, metric, chunk=chunk)
    counters = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma,
                ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma)
    before = counters
    es, ei = _four_ways(q, x, k, metric, chunk)
    counters = (ST.flat_topk_pallas.launches, ST.flat_topk_pallas.launches_mma,
                ST.flat_topk_pallas2.launches, ST.flat_topk_pallas2.launches_mma)
    assert counters == tuple(c + 1 for c in before)
    _tie_aware(q, x, metric, es, ei, ps, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_kernel_ties_on_gpu(cuda_device, metric):
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _inputs(1000, 16, 32, seed=11, dup=40))
    _, pi = ST._flat_topk_plain(q, x, 10, metric, chunk=256)
    _, ki = _four_ways(q, x, 10, metric, 256)
    assert torch.equal(ki[0], pi[0])
    if metric == "l2":
        assert ki[0].tolist() == [0, 308, 307, 306, 305, 304, 303, 302, 301, 300]


def _overflow_inputs(seed):
    """Query 0's nearest row repeated 600 times in a later chunk, and 100
    rows 1 ulp from it in one coordinate: at k=100 its list overflows."""
    q, x = _inputs(20_000, 64, 24, seed=seed)
    near = int(np.argmin(((x - q[0]) ** 2).sum(1)))
    x[5000:5600] = x[near]
    x[5600:5700] = x[near]
    x[5600:5700, 0] = np.nextafter(x[near, 0], np.float32(np.inf))
    return q, x


@pytest.mark.gpu
def test_mma_route_overflow_on_gpu(cuda_device):
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _overflow_inputs(seed=4))
    _four_ways(q, x, 100, "l2", 2048)
    st = torch.zeros(5, dtype=torch.int64, device=cuda_device)
    ST.launch(ST.build_v1_mma(), q, x, 100, "l2", 2048, stats=st)
    assert dict(zip(ST._STATS, st.tolist()))["overflowed"] >= 1
    st.zero_()
    ST.launch_f_passes(ST.build_v2_mma(), q, x, 100, "l2", 2048, stats=st)
    assert dict(zip(ST._STATS_F, st.tolist()))["overflowed"] >= 1


@pytest.mark.gpu
def test_mma_route_misaligned_rows_on_gpu(cuda_device):
    q, x = (torch.from_numpy(a).to(cuda_device) for a in _inputs(3000, 33, 19, seed=2))
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 4
    es, ei = _four_ways(q, xm, 10, "l2", 256)
    assert torch.equal(ei, ST.flat_topk_pallas(q, x, 10, chunk=256)[1])
