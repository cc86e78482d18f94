"""The benchmark's files agree with BENCHMARK.json and with each other:
every cell resolves to a configuration, a mix and its metrics' readers, and
every name, unit and file name keeps to the contract's characters."""
import json
import re
from pathlib import Path

import pytest

from zvbench import harness as H

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["zvbench"] and SPEC["command"] == ["python3", "zvbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    got = H.load_cell(cell)
    assert got["workload"]["config"] == entry["config"]
    assert got["workload"]["traffic"] == entry["traffic"]
    assert got["workload"]["chips"] == entry["chips"] == 1
    assert got["workload"]["why"] == entry["why"] and len(entry["why"]) <= 200
    conf = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert (BENCH.parent / conf["file"]).exists()
    assert got["config"]["reduced"] == conf["reduced"]
    assert set(got["config"]["limits"]) >= {"bad_ids", "unsorted", "dist_err", "recall_miss"}
    assert got["config"]["control"] in ("tf32", "bf16")
    # the cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", CELLS) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    kind = "end_to_end" if metric in SPEC["end_to_end"] else "metrics"
    mods = H.readers(kind)
    assert metric["name"] in mods
    assert mods[metric["name"]].UNIT == metric["unit"]
    assert set(metric.get("workloads", [])) <= set(CELLS)
    if kind == "metrics":
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))


def test_names_units_and_files_keep_to_the_characters():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(BENCH.parent))), path


def test_every_reader_has_a_unit_and_a_read():
    for kind in ("end_to_end", "metrics"):
        for name, mod in H.readers(kind).items():
            assert UNIT.match(mod.UNIT) and callable(mod.read), name
