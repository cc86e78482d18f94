"""zvdb_tpu_torch.ops.approx_topk against jax.lax.approx_min_k.

* `reduction_output_size` (the bin count L) equals the L that JAX reports
  for approx_min_k(..., aggregate_to_topk=False), read by jax.eval_shape
  (shapes only, no compute), over a grid of N, k, recall_target and rank.
* `_approx_min_k_plain` equals a bin fold written here in numpy, bit for bit
  in values and positions (ties across and within bins, +-0.0, rows of only
  +inf, N no multiple of L, N < L, k = L, rank 3); with L >= N it equals
  lax.top_k; its mean selection recall on iid rows matches L/k(1-(1-1/L)^k).
* The kernel's own algorithm (splits of windows folded apart into 64-bit
  (ordered value, column) keys, merged by a min, sorted) written in numpy
  equals the plain version, so the split rule and the key order are tested
  here although the kernel runs only on the card.
* On the CPU, `approx_min_k` returns what JAX's approx_min_k returns there
  (the exact top-k) at each call site's row width: values equal, ids equal
  outside ties.
* One engine test per site family (flat two-pass, CAGRA seeds and build,
  IVF probes) swaps the sites' CPU selection for the binned plain version at
  a size where L < N, and holds recall@10 against exact_ground_truth to the
  0.95 bar the bench rows meet.

The gpu-marked test needs the card and skips without one:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_approx_topk.py
There the kernel is held to the plain version with torch.equal (values
compared as bits) over the same grid, plus few long rows that split.
"""
import numpy as np
import pytest
import torch

from zvdb_tpu_torch.ops import approx_topk as AK
from zvdb_tpu_torch.ops import topk as T

GRID_N = (1, 7, 100, 128, 129, 300, 1000, 2456, 4096, 100000, 131072, 250000, 500000, 2**20)
GRID_K = (1, 2, 10, 16, 40, 100, 256)
GRID_R = (0.5, 0.9, 0.95, 0.97, 0.99, 1.0)


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("n", GRID_N)
def test_reduction_output_size_matches_jax(n, rank):
    import jax
    import jax.numpy as jnp

    shape = (2,) * (rank - 1) + (n,)
    for k in GRID_K:
        if k > n:
            continue
        for r in GRID_R:
            out = jax.eval_shape(
                lambda x: jax.lax.approx_min_k(x, k, recall_target=r, aggregate_to_topk=False),
                jax.ShapeDtypeStruct(shape, jnp.float32))[0]
            assert AK.reduction_output_size(n, rank, k, r) == out.shape[-1], (n, k, r, rank)


def test_reduction_output_size_at_the_sites():
    # the table of the sites' widths (rank 2 unless named)
    assert AK.reduction_output_size(250_000, 2, 10, 0.95) == 256
    assert AK.reduction_output_size(250_000, 1, 10, 0.95) == 2048
    assert AK.reduction_output_size(100_000, 2, 10, 0.97) == 512
    assert AK.reduction_output_size(500_000, 2, 40, 0.97) == 2048
    assert AK.reduction_output_size(250_000, 2, 16, 0.95) == 512
    assert AK.reduction_output_size(2_456, 3, 40, 0.95) == 1280
    assert AK.reduction_output_size(300, 2, 10, 0.95) == 300
    assert AK.reduction_output_size(100_000, 2, 10, 1.0) == 100_000
    with pytest.raises(ValueError):
        AK.reduction_output_size(1000, 2, 10, 0.0)


def _numpy_binfold(s, k, l_bins):
    """The contract in numpy: pad to a multiple of L with +inf, bin c % L
    keeps its first minimum (numpy's argmin), then the k smallest (value,
    column) pairs with -0.0 ordered as +0.0."""
    n = s.shape[-1]
    lead = s.shape[:-1]
    flat = s.reshape(-1, n)
    g = -(-n // l_bins)
    pad = np.full((flat.shape[0], g * l_bins - n), np.inf, np.float32)
    view = np.concatenate([flat, pad], axis=1).reshape(flat.shape[0], g, l_bins)
    arg = view.argmin(axis=1)
    vals = np.take_along_axis(view, arg[:, None, :], axis=1)[:, 0, :]
    cols = arg * l_bins + np.arange(l_bins)
    out_v = np.empty((flat.shape[0], k), np.float32)
    out_c = np.empty((flat.shape[0], k), np.int64)
    for r in range(flat.shape[0]):
        order = np.lexsort((cols[r], vals[r] + np.float32(0.0)))[:k]
        out_v[r], out_c[r] = vals[r][order], cols[r][order]
    return out_v.reshape(*lead, k), out_c.reshape(*lead, k)


def _kernel_emulation(s, k, l_bins):
    """csrc/approx_topk.cu's algorithm in numpy: each split of windows folds
    its bins with a strict < into 64-bit keys (ordered bits of the value,
    -0.0 read as +0.0, << 32 | column), the splits merge by a min, the keys
    sort, and each value is read back from s at its column."""
    n = s.shape[-1]
    flat = s.reshape(-1, n)
    rows = flat.shape[0]
    windows = -(-n // l_bins)
    splits, per = AK.fold_splits(rows, windows)
    assert (splits - 1) * per < windows <= splits * per
    keys = np.full((rows, splits, l_bins), np.iinfo(np.uint64).max, np.uint64)
    for sp in range(splits):
        cend = min((sp + 1) * per * l_bins, n)
        for b in range(l_bins):
            c0 = sp * per * l_bins + b
            best = np.full(rows, np.inf, np.float32)
            col = np.full(rows, c0, np.int64)
            for c in range(c0, cend, l_bins):
                take = flat[:, c] < best
                best = np.where(take, flat[:, c], best)
                col = np.where(take, c, col)
            bits = np.where(best == 0, np.float32(0.0), best).view(np.uint32)
            bits = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint64)
            keys[:, sp, b] = (bits << np.uint64(32)) | col.astype(np.uint64)
    merged = np.sort(keys.min(axis=1), axis=1)[:, :k]
    pos = (merged & np.uint64(0xFFFFFFFF)).astype(np.int64)
    vals = np.take_along_axis(flat, pos, axis=1)
    return vals.reshape(*s.shape[:-1], k), pos.reshape(*s.shape[:-1], k)


def _tie_rows(shape, seed, zeros=True, inf_rows=True):
    """Scores on a coarse grid (many ties within and across bins), with
    -0.0 and +0.0 mixed in and rows of only +inf."""
    rng = np.random.default_rng(seed)
    s = (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)
    flat = s.reshape(-1, shape[-1])
    if zeros:
        z = rng.random(flat.shape) < 0.2
        flat[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    flat[rng.random(flat.shape) < 0.1] = np.inf
    if inf_rows and flat.shape[0] > 2:
        flat[1] = np.inf
    return s


PLAIN_CASES = [
    # (shape, k, L): ties across and within bins, N % L != 0, N < L, k == L, rank 3
    ((6, 1000), 10, 128),
    ((6, 1000), 128, 128),          # k == L
    ((5, 1027), 7, 256),            # the last window partial
    ((4, 100), 10, 128),            # N < L: bins past N hold only padding
    ((4, 100), 128, 128),           # ... and k == L reaches into them
    ((3, 5, 700), 16, 128),         # rank 3
    ((7, 300), 300, 300),           # L == N
    ((2, 4096), 1, 128),
]


@pytest.mark.parametrize("shape,k,l_bins", PLAIN_CASES)
def test_plain_matches_numpy_binfold(shape, k, l_bins):
    s = _tie_rows(shape, seed=k + l_bins)
    got_v, got_p = AK._approx_min_k_plain(torch.from_numpy(s), k, l_bins)
    want_v, want_p = _numpy_binfold(s, k, l_bins)
    assert got_v.dtype == torch.float32 and got_p.dtype == torch.int64
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32), want_v.view(np.uint32))


def test_plain_keeps_the_sign_of_a_winning_zero():
    # bin 0 sees -0.0 at column 0 and +0.0 at column 4: they tie, column 0
    # wins and its -0.0 comes out; bin 1 the other way round
    s = torch.tensor([[-0.0, 0.0, 5.0, 5.0, 0.0, -0.0, 5.0, 5.0]])
    v, p = AK._approx_min_k_plain(s, 2, 4)
    assert p.tolist() == [[0, 1]]
    assert [np.signbit(x) for x in v[0].numpy()] == [True, False]


@pytest.mark.parametrize("shape,k,l_bins", [((3, 1000), 10, 128), ((2, 3, 600), 16, 128),
                                            ((2, 5000), 40, 256), ((4, 100), 10, 100)])
def test_kernel_algorithm_matches_plain(shape, k, l_bins):
    s = _tie_rows(shape, seed=l_bins)
    want_v, want_p = AK._approx_min_k_plain(torch.from_numpy(s), k, l_bins)
    got_v, got_p = _kernel_emulation(s, k, l_bins)
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32), want_v.numpy().view(np.uint32))


def test_fold_splits_fill_the_card_for_few_rows():
    assert AK.fold_splits(10_000, 196) == (1, 196)
    splits, per = AK.fold_splits(16, 7813)
    assert splits * 16 >= 2000 and (splits - 1) * per < 7813 <= splits * per
    assert AK.fold_splits(1, 3) == (3, 1)


@pytest.mark.parametrize("n,k", [(50, 10), (128, 128), (300, 7), (1000, 40)])
def test_plain_with_l_at_least_n_is_lax_top_k(n, k):
    import jax

    rng = np.random.default_rng(n)
    s = rng.integers(1, 6, (8, n)).astype(np.float32)       # many ties, no zeros
    s[rng.random(s.shape) < 0.05] = np.inf
    v, p = AK._approx_min_k_plain(torch.from_numpy(s), k, n)
    jv, jp = jax.lax.top_k(-s, k)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), -np.asarray(jv))


def test_plain_selection_recall_matches_the_bound():
    l_bins, k, rows = 256, 10, 2000
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((rows, 40 * l_bins)).astype(np.float32))
    _, p = AK._approx_min_k_plain(s, k, l_bins)
    _, e = T.smallest_k_dense(s, k)
    per_row = np.array([len(set(a) & set(b)) / k for a, b in zip(p.tolist(), e.tolist())])
    bound = l_bins / k * (1 - (1 - 1 / l_bins) ** k)
    assert abs(per_row.mean() - bound) <= 4 * per_row.std() / np.sqrt(rows) + 1e-9
    assert per_row.mean() >= 0.95


SITE_SHAPES = [
    # (operand shape with the batch cut, k, recall_target): the row widths of the sites
    ((32, 100_000), 10, 0.97),      # flat: the bench flat row's one tile
    ((8, 500_000), 40, 0.97),       # flat_1m's first pass (rerank 4), one tile
    ((16, 250_000), 10, 0.95),      # sharded flat: one shard of 1M
    ((32, 16_384), 120, 0.95),      # the PQ decode scan's tile (rerank 12)
    ((64, 4_096), 8, 0.95),         # IVF probes at C = 4096
    ((64, 2_048), 40, 0.95),        # the IVF pair scan's cut
    ((2, 64, 1_640), 16, 0.95),     # a knn_graph block chunk [cc, B, bcap]
    ((32, 250_000), 16, 0.95),      # CAGRA's seed anchors
]


@pytest.mark.parametrize("shape,k,r", SITE_SHAPES)
def test_cpu_matches_jax_approx_min_k_on_the_cpu(shape, k, r):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    s = rng.standard_normal(shape).astype(np.float32)
    s.reshape(-1, shape[-1])[:, ::13] = np.inf
    jv, jp = jax.lax.approx_min_k(jnp.asarray(s), k, recall_target=r)
    v, p = AK.approx_min_k(torch.from_numpy(s), k, recall_target=r)
    assert p.dtype == torch.int64 and v.shape == jv.shape
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    diff = p.numpy() != np.asarray(jp)
    if diff.any():     # ids may differ only between equal scores
        np.testing.assert_array_equal(np.take_along_axis(s, p.numpy(), -1)[diff],
                                      np.take_along_axis(s, np.asarray(jp), -1)[diff])
    ev, ep = T.smallest_k_dense(torch.from_numpy(s), k)
    assert torch.equal(v, ev) and torch.equal(p, ep)


def _binned_plain(calls):
    """approx_min_k with the CPU branch swapped for the binned plain version."""
    def select(s, k, recall_target=0.95):
        l_bins = AK.reduction_output_size(s.shape[-1], s.dim(), k, recall_target)
        calls.append((tuple(s.shape), k, l_bins))
        return AK._approx_min_k_plain(s, k, l_bins)
    return select


def _recall(ids, gt):
    return np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)])


def _clustered(n, d, seed):
    from zvdb_tpu_torch.io.datasets import synthetic_clustered

    x = synthetic_clustered(n, d, n_clusters=max(n // 20, 10), seed=seed)
    rng = np.random.default_rng(seed + 1)
    q = (x[rng.integers(0, n, 200)] + 0.05 * rng.standard_normal((200, d))).astype(np.float32)
    return x, q


def test_flat_two_pass_with_binned_selection(monkeypatch):
    import zvdb_tpu_torch as ZT

    calls = []
    monkeypatch.setattr(AK, "approx_min_k", _binned_plain(calls))
    x, q = _clustered(20_000, 32, seed=5)
    _, gt = ZT.exact_ground_truth(x, q, 10, device="cpu")
    idx = ZT.FlatIndex(ZT.FlatConfig(dim=32, rerank=4, recall_target=0.97, tile_n=8192),
                       capacity=20_000, device="cpu")
    idx.add(x)
    _, ids = idx.search(q, 10, approx=True)
    ids = ids.numpy()
    # three tiles of 8192 (the last padded to the tile's width), L < N on each
    assert [c[0] for c in calls] == [(200, 8192)] * 3
    assert all(c[1] == 40 and c[2] < 8192 for c in calls)
    assert ((ids >= 0) & (ids < 20_000)).all()
    assert _recall(ids, gt) >= 0.95
    calls.clear()
    idx.search(q, 10, approx=False)
    assert not calls


def test_cagra_seeds_and_build_with_binned_selection(monkeypatch):
    import zvdb_tpu_torch as ZT

    calls = []
    monkeypatch.setattr(AK, "approx_min_k", _binned_plain(calls))
    x, q = _clustered(6_000, 16, seed=9)
    _, gt = ZT.exact_ground_truth(x, q, 10, device="cpu")
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, n_anchors=1024), device="cpu")
    idx.build(x)
    blocks, seeds = list(calls), calls       # the build's: knn_graph's [cc, B, bcap] blocks
    seeds.clear()
    assert blocks and all(len(c[0]) == 3 and c[2] < c[0][-1] for c in blocks)
    _, ids = idx.search(q, 10, ef_search=64)
    ids = ids.numpy()
    assert seeds == [((200, 1024), 16, 512)]
    assert ((ids >= 0) & (ids < 6_000)).all()
    assert _recall(ids, gt) >= 0.95
    seeds.clear()
    off = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, n_anchors=1024, seed_approx=False),
                        device="cpu")
    off.build(x)
    seeds.clear()
    off.search(q, 10, ef_search=64)
    assert not seeds


def test_ivf_probes_with_binned_selection(monkeypatch):
    import zvdb_tpu_torch as ZT

    calls = []
    monkeypatch.setattr(AK, "approx_min_k", _binned_plain(calls))
    x, q = _clustered(40_000, 16, seed=11)
    _, gt = ZT.exact_ground_truth(x, q, 10, device="cpu")
    idx = ZT.IVFIndex(ZT.IVFConfig(dim=16, n_clusters=4096, kmeans_iters=2,
                                   kmeans_sample=40_000), device="cpu")
    idx.build(x)
    _, ids = idx.search(q, 10, nprobe=64)
    ids = ids.numpy()
    c = idx.state.centroids.shape[0]                            # >= 4096 after the split
    probe = [call for call in calls if call[0] == (200, c)]
    assert c >= 4096 and probe == [((200, c), 64, AK.reduction_output_size(c, 2, 64, 0.95))]
    assert probe[0][2] < c
    assert ((ids >= 0) & (ids < 40_000)).all()
    assert _recall(ids, gt) >= 0.95
    calls.clear()
    idx.search(q, 10, nprobe=c // 4 + 1)                        # 4 * P > C: exact probes
    assert not [call for call in calls if call[0] == (200, c)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [(s, k, r) for s, k, r in SITE_SHAPES] + [
    ((6, 1000), 10, 0.95), ((5, 1027), 7, 0.9), ((3, 5, 700), 16, 0.95), ((7, 300), 300, 0.95),
    ((2, 4096), 1, 0.95), ((6, 1000), 128, 0.5), ((16, 1 << 20), 10, 0.95),
    ((1, 3_000_000), 100, 0.99), ((300, 2456), 40, 0.95), ((4, 250_000), 256, 0.95)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,r", GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda_device, shape, k, r):
    s = torch.from_numpy(_tie_rows(shape, seed=k)).to(cuda_device)
    l_bins = AK.reduction_output_size(shape[-1], len(shape), k, r)
    before = AK.approx_min_k.launches
    v, p = AK.approx_min_k(s, k, recall_target=r)
    torch.cuda.synchronize()
    assert AK.approx_min_k.launches == before + 1
    pv, pp = AK._approx_min_k_plain(s, k, l_bins)
    assert torch.equal(p, pp)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))


@pytest.mark.gpu
def test_kernel_limits_on_gpu(cuda_device):
    s = torch.zeros((2, 20_000), device=cuda_device)
    with pytest.raises(ValueError):
        AK.approx_min_k(s, 10, recall_target=1.0)      # L = N > MAX_BINS
    with pytest.raises(TypeError):
        AK.approx_min_k(s.double(), 10)
