"""`correct` at a tiny size on the CPU, with the chip's look skipped: every
shipped cell's sound run passes; the plain reference in the program's place
at its configuration's control precision fails; and so does each fault the
cell can have, planted in the program underneath a run: half of a batch's
answers left out (the other half's given in their place), an answer altered
where it is produced, answers out of order, a selection that keeps the far
end (kernel H's largest bins, IVF's farthest lists), and a build that leaves
its state unchanged."""
import pytest
import torch

import zvdb_tpu_torch as Z
from zvbench import calibrate
from zvbench import harness as H

from tiny import tiny_cell

CELLS = ["cagra_1m.batch", "ivf_1m.batch", "cagra_1m.build"]
SEARCH_CELLS = {"cagra_1m.batch": Z.CagraIndex, "ivf_1m.batch": Z.IVFIndex,
                "cagra_1m.build": Z.CagraIndex}


def run(cell_name, control=None, before_window=None):
    cell = tiny_cell(cell_name)
    if control:
        control = cell["config"]["control"]
    return H.run_cell(cell, 2**31 + 5, 0.4, False, device="cpu", control=control,
                      before_window=before_window)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = run(cell, control=True)
    assert not line["correct"], line["checks"]
    assert line["checks"]["dist_err"]["value"] > line["checks"]["dist_err"]["limit"]


def _half(orig):
    def search(self, q, k, **kw):
        s, i = orig(self, q, k, **kw)
        h = s.shape[0] // 2
        s, i = s.clone(), i.clone()
        s[s.shape[0] - h:], i[i.shape[0] - h:] = s[:h].clone(), i[:h].clone()
        return s, i
    return search


def _altered(orig):
    def search(self, q, k, **kw):
        s, i = orig(self, q, k, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % 3000
        return s, i
    return search


def _reversed(orig):
    def search(self, q, k, **kw):
        s, i = orig(self, q, k, **kw)
        return s.flip(-1), i.flip(-1)
    return search


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half", "altered", "reversed"])
def test_search_fault_is_not_correct(cell, fault, monkeypatch):
    cls = SEARCH_CELLS[cell]
    monkeypatch.setattr(cls, "search", {"half": _half, "altered": _altered,
                                        "reversed": _reversed}[fault](cls.search))
    line = run(cell)
    assert not line["correct"], line["checks"]
    if fault == "reversed":
        assert line["checks"]["unsorted"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [("cagra_1m.batch", "far_bins"),
                                        ("cagra_1m.build", "far_bins"),
                                        ("ivf_1m.batch", "far_probes")])
def test_selection_fault_is_not_correct(cell, fault):
    """Valid, distinct rows at exact distances, nearest first, but not the
    near neighbours: only recall_miss catches it."""
    undo = []
    try:
        line = run(cell, before_window=calibrate.plant(fault, undo))
    finally:
        for u in undo:
            u()
    assert not line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["recall_miss"]["value"] > checks["recall_miss"]["limit"]
    assert checks["bad_ids"]["value"] == 0 and checks["unsorted"]["value"] == 0


def test_build_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(Z.CagraIndex, "build", lambda self, x: None)
    line = run("cagra_1m.build")
    assert not line["correct"]
    assert line["checks"]["bad_ids"]["value"] > 0


def test_build_with_edges_altered_is_not_correct(monkeypatch):
    orig = Z.CagraIndex.build

    def build(self, x):
        orig(self, x)
        col = self.state.nbrs[:-1, 0]
        col.copy_(torch.where(col >= 0, (col + 1) % x.shape[0], col))

    monkeypatch.setattr(Z.CagraIndex, "build", build)
    line = run("cagra_1m.build")
    assert not line["correct"]
    assert line["checks"]["edge_err"]["value"] > line["checks"]["edge_err"]["limit"]

