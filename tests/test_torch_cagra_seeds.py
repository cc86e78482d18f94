"""CAGRA's seed anchors over kernel A's bins (index/cagra.py:_binned_seeds,
the "bins" route of `seed_route`), against approx_min_k over the [B, A]
anchor scores.

On the CPU, kernel A's plain version folds the anchors into approx_min_k's L
bins and the exact top-k selects over them: the seeds must equal
`_approx_min_k_plain` of the [B, A] scores (ragged A, bins with no finite
row, l2 and dot, n_seeds 1 and 16). The gpu-marked cases hold the route on
the card against the [B, A] product and approx_min_k's kernel at
cagra_1m.batch's shape (B = 2048, A = 250,000) and count one search's
launches and host waits. No JAX here, so the card can run this file:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cagra_seeds.py
"""
import numpy as np
import pytest
import torch

import zvdb_tpu_torch as ZT
import zvdb_tpu_torch.index.cagra as cagra_mod
from zvdb_tpu_torch.ops import approx_topk as AK
from zvdb_tpu_torch.ops import distance as D
from zvdb_tpu_torch.ops import flat_scan as FS

CPU = "cpu"



def _seed_operands(b, a, d, metric, seed, integer=False, device=CPU):
    """Preprocessed queries [b, d], anchors [a, d] and their norms."""
    g = torch.Generator().manual_seed(seed)
    if integer:   # exact in bf16, their sums exact in f32
        q = torch.randint(-20, 21, (b, d), generator=g).float()
        x = torch.randint(-20, 21, (a, d), generator=g).float()
    else:
        q, x = torch.randn(b, d, generator=g), torch.randn(a, d, generator=g)
    x, norms = D.preprocess_corpus(x.to(device), metric)
    return D.preprocess_queries(q.to(device), metric), x, norms


def _check_seeds(got, want, scores):
    """Scores equal; columns equal where the score is finite and held by no
    other anchor of the row's [A] `scores` (ties across bins come in bin
    order on the "bins" route, in anchor order over the [B, A] scores); a
    +inf seed has column -1 on the "bins" route. Returns the share of the
    finite seeds whose columns were compared."""
    (gs, gc), (ws, wc) = got, want
    assert torch.equal(gs, ws)
    finite = torch.isfinite(ws)
    assert torch.equal(gc[~finite], torch.full_like(gc[~finite], -1))
    alone = torch.stack([(scores == ws[:, j:j + 1]).sum(1) == 1 for j in range(ws.shape[1])], 1)
    sure = finite & alone
    assert torch.equal(gc[sure].long(), wc[sure].long())
    return (sure.sum() / finite.sum()).item()


@pytest.mark.parametrize("metric,a,s,precision,live_bins", [
    ("l2", 3000, 16, "high", None),      # L = 384: a ragged last window
    ("dot", 3000, 16, "high", None),
    ("l2", 1337, 16, "default", None),
    ("l2", 1337, 1, "high", None),       # L = 128
    ("dot", 2000, 1, "high", None),
    ("l2", 3000, 16, "high", 5),         # 5 bins hold finite rows: 11 seeds -1 / +inf
    ("dot", 1337, 16, "default", 3),
])
def test_binned_seeds_equal_approx_min_k_plain(metric, a, s, precision, live_bins):
    b, d = 40, 16
    qp, x, norms = _seed_operands(b, a, d, metric, seed=a + s)
    l_bins = AK.reduction_output_size(a, 2, s, 0.95)
    # the select over the bins never folds again
    assert AK.reduction_output_size(l_bins, 2, s, 1.0) == l_bins
    if live_bins is not None:
        norms = torch.where(torch.arange(a) % l_bins < live_bins, norms, float("inf"))
    launches = FS.flat_scan_bins.launches, AK.approx_min_k.launches
    got = cagra_mod._binned_seeds(qp, x, norms, s, metric, precision)
    cs = D.pairwise_scores(qp, x, norms, metric, precision=precision)
    assert got[1].dtype == torch.int32 and got[0].shape == got[1].shape == (b, s)
    assert _check_seeds(got, AK._approx_min_k_plain(cs, s, l_bins), cs) > 0.99
    if live_bins is not None:
        assert bool(torch.isinf(got[0][:, live_bins:]).all())
    assert (FS.flat_scan_bins.launches, AK.approx_min_k.launches) == launches   # CPU: none


@pytest.mark.parametrize("b,a,seed_approx,precision,cuda,want", [
    (2048, 250_000, True, "high", True, "bins"),
    (2048, 250_000, True, "default", True, "bins"),
    (2048, 250_000, True, "highest", True, "approx"),
    (2048, 250_000, True, "high", False, "approx"),
    (256, 32_768, True, "high", True, "bins"),
    (255, 250_000, True, "high", True, "approx"),
    (512, 250_000, True, "default", True, "bins"),
    (511, 250_000, True, "default", True, "approx"),
    (2048, 250_000, False, "high", True, "exact"),
    (2048, 64, True, "high", True, "exact"),
    (2048, 65, True, "high", True, "bins"),
])
def test_seed_route(b, a, seed_approx, precision, cuda, want):
    assert cagra_mod.seed_route(b, a, 16, seed_approx, precision, cuda) == want


def test_cpu_search_takes_no_bins():
    """A CPU search never takes the "bins" route: kernel A's plain version
    never runs under it, whatever the batch."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(40, 16, generator=g)[torch.randint(0, 40, (3000,), generator=g)]
         + 0.15 * torch.randn(3000, 16, generator=g)).numpy()
    q = x[:200] + 0.05 * np.random.default_rng(0).standard_normal((200, 16)).astype(np.float32)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, n_anchors=512, n_seeds=4),
                        device=CPU)
    idx.build(x)
    calls = []
    real = FS._flat_scan_bins_plain
    FS._flat_scan_bins_plain = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        qq = np.concatenate([q] * (-(-max(cagra_mod.SEED_BINS_MIN_QUERIES.values()) // q.shape[0])))
        ids = idx.search(qq, 5)[1]
    finally:
        FS._flat_scan_bins_plain = real
    assert not calls and ids.shape == (qq.shape[0], 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels A and H have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_binned_seeds_equal_dense_seeds_on_gpu(cuda_device, metric, precision):
    """Integer-valued queries and anchors: both routes' scores are exact, so
    they are equal, and the columns too but among exact ties."""
    b, a, s = 2048, 250_000, 16
    qp, x, norms = _seed_operands(b, a, 128, metric, seed=7, integer=True, device=cuda_device)
    before = FS.flat_scan_bins.launches_mma, AK.approx_min_k.launches
    got = cagra_mod._binned_seeds(qp, x, norms, s, metric, precision)
    torch.cuda.synchronize()
    assert (FS.flat_scan_bins.launches_mma, AK.approx_min_k.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    cs = D.pairwise_scores(qp, x, norms, metric, precision=precision)
    assert _check_seeds(got, AK.approx_min_k(cs, s), cs) > 0.1


@pytest.mark.gpu
def test_binned_seeds_close_to_dense_seeds_on_gpu(cuda_device):
    """Random data: the routes sum each bf16x3 product in another order, so
    the seed scores agree within 1e-5 |q| |x| and nearly all columns match."""
    b, a, s = 2048, 250_000, 16
    qp, x, norms = _seed_operands(b, a, 128, "l2", seed=8, device=cuda_device)
    gs, gc = cagra_mod._binned_seeds(qp, x, norms, s, "l2", "high")
    ws, wc = AK.approx_min_k(D.pairwise_scores(qp, x, norms, "l2", precision="high"), s)
    scale = qp.norm(dim=1, keepdim=True) * x.norm(dim=1).max()
    assert bool(((gs - ws).abs() <= 1e-5 * scale).all())
    assert (gc.long() == wc).float().mean().item() >= 0.99


@pytest.mark.gpu
def test_search_seed_route_launches_on_gpu(cuda_device):
    """cagra_1m.batch's search shape at 250,000 rows, all of them anchors:
    a batch of 2048 makes one kernel A launch on the tensor cores and one
    kernel H launch; a batch below SEED_BINS_MIN_QUERIES["high"] makes no
    kernel A launch. Both wait for the device 11 times."""
    from zvdb_tpu_torch.utils import profiling as P

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(250_000, 128, device=cuda_device, generator=g)
    idx = ZT.CagraIndex(ZT.CagraConfig(dim=128, degree=32, n_anchors=250_000, search_degree=24,
                                       max_iters=4, ef_search=12), device=cuda_device)
    idx.build(x)
    q = x[:2048] + 0.05 * torch.randn(2048, 128, device=cuda_device, generator=g)
    assert idx.state.anchors.shape[0] == 250_000
    for b, bins in ((2048, 1), (cagra_mod.SEED_BINS_MIN_QUERIES["high"] // 2, 0)):
        idx.search(q[:b], 10)   # first use of every op
        torch.cuda.synchronize()
        waits = lambda: sum(v for (c, _), v in P.host_waits.items() if c == "cagra.search")
        before = (FS.flat_scan_bins.launches_mma, AK.approx_min_k.launches, waits(),
                  P.entry_calls["cagra.search"])
        ids = idx.search(q[:b], 10)[1]
        torch.cuda.synchronize()
        after = (FS.flat_scan_bins.launches_mma, AK.approx_min_k.launches, waits(),
                 P.entry_calls["cagra.search"])
        assert tuple(v - w for v, w in zip(after, before)) == (bins, 1, 11, 1), (b, before, after)
        assert (ids[:, 0].cpu() == torch.arange(b)).float().mean().item() >= 0.95
