"""spans.py on hand-made records (the idle gap a wait caused, a kernel put
down to its spans by correlation, nothing to read) and the host-wait
readers on the program's counters."""
import collections
import sys
import types

import pytest

from zvbench import harness as H
from zvbench import spans as S

MS = 1_000_000   # ns


def _record():
    """One search from 0 to 100 ms: seeds 0-10, one hop 10-60 holding a
    wait 40-50; kernels launched at 5 (seeds), 20 (the hop), 45 (the wait)
    and 80 (the search alone, running past its end) and one with no launch
    in any span."""
    spans = [("zvdb cagra.search", 0, 100 * MS), ("zvdb cagra.seeds", 0, 10 * MS),
             ("zvdb beam.hop", 10 * MS, 60 * MS), ("zvdb wait.topk_ties", 40 * MS, 50 * MS)]
    launches = {1: 5 * MS, 2: 20 * MS, 3: 45 * MS, 4: 80 * MS, 5: 150 * MS}
    kernels = [("k1", 6 * MS, 8 * MS, 1), ("k2", 21 * MS, 41 * MS, 2),
               ("k3", 52 * MS, 55 * MS, 3), ("k4", 81 * MS, 101 * MS, 4),
               ("k5", 151 * MS, 152 * MS, 5)]
    return dict(spans=spans, launches=launches, kernels=kernels)


def test_a_gap_that_begins_inside_a_wait_is_a_syncs():
    rec = _record()
    # gaps: 8-21 (no wait), 41-52 (begins inside the wait 40-50), 55-81, 101-151
    assert S.sync_gaps_ns(rec["spans"], rec["kernels"]) == 11 * MS
    got = S.split(rec, window_s=0.2)
    assert got["sync_idle_pct"] == pytest.approx(100.0 * 0.011 / 0.2)


def test_a_kernel_goes_to_its_spans_by_correlation():
    at = S.enclosing(_record()["spans"], [5 * MS, 45 * MS, 80 * MS, 150 * MS])
    assert at[45 * MS] == ["zvdb cagra.search", "zvdb beam.hop", "zvdb wait.topk_ties"]
    assert at[5 * MS] == ["zvdb cagra.search", "zvdb cagra.seeds"]
    assert at[80 * MS] == ["zvdb cagra.search"] and at[150 * MS] == []
    got = S.split(_record(), window_s=0.2)
    assert got["calls"] == {"zvdb cagra.search": 1}
    assert got["ms_under"]["zvdb cagra.seeds"] == pytest.approx(2.0)
    assert got["ms_under"]["zvdb beam.hop"] == pytest.approx(23.0)   # k2 and k3
    assert got["ms_under"]["zvdb wait.topk_ties"] == pytest.approx(3.0)
    assert got["ms_under"]["zvdb cagra.search"] == pytest.approx(45.0)
    assert got["unattributed_pct"] == pytest.approx(100.0 * 1 / 46)


def test_an_idle_gap_goes_to_the_spans_open_when_it_begins():
    got = S.split(_record(), window_s=0.2)
    # 8-21 begins in the seeds, 41-52 in the hop's wait, 55-81 in the hop,
    # 101-151 after the search
    assert got["idle_ms_under"]["zvdb cagra.seeds"] == pytest.approx(13.0)
    assert got["idle_ms_under"]["zvdb beam.hop"] == pytest.approx(37.0)
    assert got["idle_ms_under"]["zvdb wait.topk_ties"] == pytest.approx(11.0)
    assert got["idle_ms_under"]["zvdb cagra.search"] == pytest.approx(50.0)
    assert got["idle_outside_pct"] == pytest.approx(100.0 * 0.050 / 0.2)


def test_nothing_to_read_is_none():
    assert S.split(dict(spans=[], launches={}, kernels=[]), 1.0) is None
    rec = _record()
    rec["kernels"] = []
    assert S.split(rec, 1.0) is None


READERS = H.readers("metrics")


def _rec(loop, busy_s=0.5):
    return dict(loop=loop, profile=dict(busy_s=busy_s, window_s=1.0))


@pytest.fixture
def program(monkeypatch):
    mod = types.SimpleNamespace(entry_calls=collections.Counter(),
                                host_waits=collections.Counter())
    monkeypatch.setitem(sys.modules, "zvdb_tpu_torch.utils.profiling", mod)
    return mod


def test_host_waits_readers_divide_waits_by_calls(program):
    program.entry_calls.update({"cagra.search": 4, "cagra.build": 2})
    program.host_waits.update({("cagra.search", "topk_ties"): 40, ("cagra.search", "b"): 4,
                               ("cagra.build", "build_pull"): 780, (None, "topk_ties"): 9})
    assert READERS["host_waits.batch"].read(_rec("closed")) == 11
    assert READERS["host_waits.build"].read(_rec("build")) == 390
    assert READERS["host_waits.batch"].read(_rec("build")) is None
    assert READERS["host_waits.build"].read(_rec("closed")) is None


def test_host_waits_readers_find_nothing(program, monkeypatch):
    assert READERS["host_waits.batch"].read(_rec("closed")) is None   # no calls yet
    program.entry_calls["cagra.search"] = 1
    assert READERS["host_waits.batch"].read(_rec("closed", busy_s=0.0)) is None   # no device
    monkeypatch.setitem(sys.modules, "zvdb_tpu_torch.utils.profiling", types.SimpleNamespace())
    assert READERS["host_waits.batch"].read(_rec("closed")) is None   # a program without them
