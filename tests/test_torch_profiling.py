"""zvdb_tpu_torch.utils.profiling, case for case with tests/test_profiling.py.

`live_buffer_bytes` counts CUDA tensors (torch.cuda.memory_allocated) where
JAX sums its live arrays on any backend; without a card it raises, and its
growth test is `gpu`-marked. Then the package's own spans and host-wait
counters: spans record nothing without a profiler, the engines' spans come
in order, `host_waits` counts by site, and (`gpu`-marked) equals the syncs
the CUDA runtime reports, with or without a profiler recording:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""
import json
import os
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zvdb_tpu_torch import CagraConfig, CagraIndex, IVFConfig, IVFIndex
from zvdb_tpu_torch.utils import profiling as P
from zvdb_tpu_torch.utils.profiling import Phase, PhaseRecorder, live_buffer_bytes, trace


def test_phase_timer():
    with Phase("x") as p:
        _ = sum(range(1000))
    assert p.elapsed_s is not None and p.elapsed_s >= 0


def test_phase_recorder():
    rec = PhaseRecorder()
    for _ in range(3):
        with rec.phase("work", sync=False):
            pass
    rep = rec.report()
    assert rep["work"]["count"] == 3
    assert rep["work"]["total_s"] >= 0
    assert rep["work"]["min_s"] <= rep["work"]["mean_s"] <= rep["work"]["max_s"]


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "tr")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1
    with open(tmp_path / "tr" / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_live_buffer_bytes_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: see the gpu-marked test")
    with pytest.raises(RuntimeError):
        live_buffer_bytes()


@pytest.mark.gpu
def test_live_buffer_bytes_grows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (PyTorch counts no CPU buffers)")
    before = live_buffer_bytes()
    x = torch.ones((1024, 1024), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    after = live_buffer_bytes()
    assert after >= before + 4 * 1024 * 1024
    del x


# ---------------------------------------------------------------------------
# spans and host-wait counters

# CAGRA at a small size: 4 hops, 16 seeds over an ef of 12, 48 anchors (so
# the seed selection is the exact top-k, 48 <= 4 * 16, on every device)
_CAGRA = dict(degree=16, n_anchors=48, n_seeds=16, ef_search=12, max_iters=4, block=256)
_BUILD_SPANS = (["cagra.build"]
                + ["build.kmeans", "build.assign", "build.pack", "build.block_knn"] * 2
                + ["build.reps", "build.prune", "build.reverse", "build.chain",
                   "build.long_edges", "cagra.anchors"])


def _corpus(n=3000, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g)


def _spans(prof, waits=False):
    """The "zvdb " ranges of a profile, outer first where two start together,
    without the "zvdb " prefix; the waits only if asked."""
    ev = sorted((e.time_range.start, -e.time_range.end, e.name[5:]) for e in prof.events()
                if e.name.startswith("zvdb ") and (waits or not e.name.startswith("zvdb wait.")))
    return [name for _, _, name in ev]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def cagra():
    """(a built small CAGRA index, its corpus)."""
    x = _corpus()
    idx = CagraIndex(CagraConfig(dim=16, **_CAGRA), device="cpu")
    idx.build(x)
    return idx, x


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(P, "_range", entered.append)
    assert not torch.autograd.profiler._is_profiler_enabled
    with P.span("x"), P.wait("w"), P.entry("e"):
        mark = P.Stages("cpu", "s.")
        mark("a")
        mark.end()
    assert entered == []
    assert P.span("x") is P.span("y")   # one shared no-op context


def test_span_enters_a_range_under_a_profiler():
    with _cpu_profile() as prof:
        with P.span("outer"):
            with P.wait("site"):
                pass
            mark = P.Stages("cpu", "st.")
            mark("one")
            mark("two")
            mark.end()
    assert _spans(prof, waits=True) == ["outer", "wait.site", "st.one", "st.two"]


def _by_site(call=...):
    """host_waits summed by site: of every call, or of one (None: outside any)."""
    out = {}
    for (c, site), n in P.host_waits.items():
        if call is ... or c == call:
            out[site] = out.get(site, 0) + n
    return out


def _grown(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_wait_counts_by_site_and_by_entry():
    before, calls = _by_site().get("t_site", 0), P.entry_calls["t.call"]
    inside = _by_site("t.call").get("t_site", 0)
    with P.entry("t.call"):
        for _ in range(3):
            with P.wait("t_site"):
                pass
        with P.entry("t.inner"):   # a nested call keeps its own waits
            with P.wait("t_site"):
                pass
    with P.wait("t_site"):   # outside any call
        pass
    assert _by_site()["t_site"] - before == 5
    assert P.entry_calls["t.call"] - calls == 1
    assert _by_site("t.call")["t_site"] - inside == 3


def test_stages_time_under_the_build_trace_variable(monkeypatch):
    monkeypatch.setenv("ZVDB_BUILD_TRACE", "1")
    seconds = {}
    mark = P.Stages("cpu", "st.", seconds)
    for _ in range(2):   # a stage marked twice sums
        mark("a")
        mark("b")
    mark.end()
    assert sorted(seconds) == ["a", "b"] and all(v >= 0 for v in seconds.values())
    assert mark.report("lbl").startswith("[lbl] total=")
    monkeypatch.setenv("ZVDB_BUILD_TRACE", "0")
    quiet = {}
    mark = P.Stages("cpu", "st.", quiet)
    mark("a")
    mark.end()
    assert quiet == {} and not mark.timed


def test_phase_span_records_a_phase():
    rec = PhaseRecorder()
    with P.span("shard 0", rec):
        pass
    assert rec.report()["shard 0"]["count"] == 1


def test_cagra_search_spans_in_order(cagra):
    idx, x = cagra
    with _cpu_profile() as prof:
        idx.search(x[:40], 10)
    assert _spans(prof) == (["cagra.search", "cagra.seeds", "beam.init"] + ["beam.hop"] * 4
                            + ["cagra.final"])


def test_cagra_build_spans_in_order():
    with _cpu_profile() as prof:
        CagraIndex(CagraConfig(dim=16, **_CAGRA), device="cpu").build(_corpus())
    assert _spans(prof) == _BUILD_SPANS


def test_ivf_search_spans_in_order():
    x = _corpus()
    idx = IVFIndex(IVFConfig(dim=16, n_clusters=16, kmeans_iters=2), device="cpu")
    idx.build(x)
    with _cpu_profile() as prof:
        idx.search(x[:64], 10, nprobe=4)
    assert _spans(prof) == ["ivf.search", "ivf.probes", "ivf.scan", "ivf.final"]


def test_cagra_search_waits_by_site(cagra):
    """From the code: the seeds' exact top-k (1), the seeds cut to the ef
    (16 > 12: 1), the beam's first top-k (1), two top-k a hop (4 hops: 8)
    and the final top-k (1), each one tie repair's nonzero (topk_ties)."""
    idx, x = cagra
    before = dict(P.host_waits)
    idx.search(x[:40], 10)
    assert _grown(before, P.host_waits) == {("cagra.search", "topk_ties"): 12}


def test_ivf_grouped_scan_waits_by_site():
    """From the code: the probes' top-k (16 clusters < 4096: exact, 1), the
    grouped scan's cut (1) and the final top-k (1)."""
    x = _corpus()
    idx = IVFIndex(IVFConfig(dim=16, n_clusters=16, kmeans_iters=2), device="cpu")
    idx.build(x)
    from zvdb_tpu_torch.index.ivf import use_pair_scan

    assert not use_pair_scan(idx.state.centroids.shape[0], 64, 4)   # the grouped scan
    before = dict(P.host_waits)
    idx.search(x[:64], 10, nprobe=4)
    assert _grown(before, P.host_waits) == {("ivf.search", "topk_ties"): 3}


# ---------------------------------------------------------------------------
# on the card: host_waits against the CUDA runtime's own count of syncs


def _syncs(fn):
    """(syncs the CUDA runtime reported while fn ran, host_waits' growth)."""
    before = sum(P.host_waits.values())
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in got if "called a synchronizing CUDA operation" in str(w.message)]
    return syncs, sum(P.host_waits.values()) - before


@pytest.mark.gpu
def test_host_waits_equal_the_runtimes_syncs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(20000, 64, device="cuda", generator=g)
    q = x[:512] + 0.01 * torch.randn(512, 64, device="cuda", generator=g)
    cagra = CagraIndex(CagraConfig(dim=64, degree=32, n_anchors=4096, n_seeds=16,
                                   ef_search=12, max_iters=4, block_topk="approx"))
    ivf = IVFIndex(IVFConfig(dim=64, n_clusters=64, kmeans_iters=2))
    ivf.build(x)
    cagra.build(x)   # builds and loads the kernels first
    cagra.search(q, 10)
    ivf.search(q, 10, nprobe=8)
    calls = {"cagra.search": lambda: cagra.search(q, 10),
             "ivf.search": lambda: ivf.search(q, 10, nprobe=8),
             "cagra.build": lambda: CagraIndex(cagra.cfg).build(x)}
    for recording in (False, True):
        for name, fn in calls.items():
            if recording:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                    syncs, waits = _syncs(fn)
            else:
                syncs, waits = _syncs(fn)
            where = sorted({f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs})
            assert len(syncs) == waits, (name, recording, len(syncs), waits, where)
            assert waits > 0, name
