"""The loops and the result line, at a tiny size on the CPU: the line has
the contract's keys with `checks` last, a stall moves the rate as it should
(all the work over all the time), and a cell made of new files alone runs."""
import json
import time

import pytest
import torch

from zvbench import harness as H
from zvbench.reference import knn as REF

from tiny import tiny_cell, write_cell


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contracts_keys(trace):
    line = H.run_cell(tiny_cell("cagra_1m.batch"), 2**31 + 11, 0.4, bool(trace), device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) - set(keys) - {"checks"} == ({"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) == {"search_ms.batch"}   # no device events on the CPU
    else:
        assert set(line["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))
    assert line["correct"] is True


class StallingIndex:
    """The exact reference as the engine, with one search that stalls."""

    def __init__(self, stall_at: int, stall_s: float):
        self.inner = REF.ExactIndex("float32", "cpu")
        self.calls, self.stall_at, self.stall_s = 0, stall_at, stall_s

    def build(self, x):
        self.inner.build(x)

    def search(self, q, k, **kw):
        self.calls += 1
        if self.calls == self.stall_at:
            time.sleep(self.stall_s)
        return self.inner.search(q, k)


def _run_with(monkeypatch, cell_name, stall_s):
    monkeypatch.setattr(H.Run, "make_engine",
                        lambda self: StallingIndex(stall_at=6, stall_s=stall_s))
    window = H.Run.window

    def counted_from_the_window(self, *a):
        self.engine.calls = 0   # set-up's warm-up searches do not count
        return window(self, *a)

    monkeypatch.setattr(H.Run, "window", counted_from_the_window)
    return H.run_cell(tiny_cell(cell_name), 3, 1.0, False, device="cpu")


def test_a_stall_lowers_qps(monkeypatch):
    base = _run_with(monkeypatch, "cagra_1m.batch", 0.0)
    stalled = _run_with(monkeypatch, "cagra_1m.batch", 0.5)
    assert base["correct"] and stalled["correct"]
    assert stalled["metrics"]["qps"]["value"] < 0.75 * base["metrics"]["qps"]["value"]


def test_a_cell_made_of_new_files_alone_runs(tmp_path):
    cell = tiny_cell("ivf_1m.batch")
    cell["workload"] = dict(cell["workload"], config="tmp_ivf", traffic="tmp_mix")
    cell["traffic"]["batch"] = 32
    write_cell(tmp_path, "tmp_ivf.small", cell)
    got = H.load_cell("tmp_ivf.small", root=tmp_path)
    line = H.run_cell(got, 77, 0.3, False, device="cpu")
    assert line["correct"] and line["attempted"] % 32 == 0
    assert set(line["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert torch.tensor(line["metrics"]["recall_at_10"]["value"]) > 0
