"""The port's sweep CLI (zvdb_tpu_torch/bench/sweep.py) on the CPU.

Mirrors tests/test_sweep_cli.py with `--device cpu`: every engine builds,
searches and reports a parseable JSON object as the last line of stdout,
with the JAX package's row keys and recall floors; OPQ / nsub reach the PQ
engine; `--out` collects every row. `--devices 2` builds a 2-shard
ShardedHNSW for --engine hnsw (on the one CPU: its rows say one device and
carry JAX's keys) and raises for every other engine. Tiny shapes: this pins
the wiring.
"""
import dataclasses
import json

import pytest
import torch

from zvdb_tpu.bench.harness import BenchmarkResult as JaxRow
from zvdb_tpu_torch.bench import sweep


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(capsys, argv):
    sweep.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["operation"] == "search"
    return rec


BASE = ["--points", "600", "--queries", "60", "--dims", "16", "--ks", "5", "--recall",
        "--device", "cpu"]


@pytest.mark.parametrize("engine", ["hnsw", "flat", "ivf", "cagra", "pq"])
def test_every_engine_reports_json(capsys, engine):
    rec = _run(capsys, BASE + ["--engine", engine])
    assert rec["num_points"] == 600 and rec["k"] == 5 and rec["num_devices"] == 1
    floor = 0.9 if engine in ("flat", "hnsw", "cagra") else 0.5
    assert rec["recall"] >= floor, (engine, rec)


def test_pq_opq_and_nsub(capsys):
    rec = _run(capsys, BASE + ["--engine", "pq", "--pq-nsub", "8", "--opq"])
    assert rec["recall"] >= 0.5


def test_out_file_collects_all_rows(capsys, tmp_path):
    out = tmp_path / "rows.jsonl"
    _run(capsys, BASE + ["--engine", "flat", "--ks", "3,5", "--out", str(out)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["operation"] for r in rows] == ["insertion", "search", "search"]
    assert {r.get("k") for r in rows if r["operation"] == "search"} == {3, 5}


@pytest.mark.parametrize("engine", ["flat", "ivf"])
def test_several_devices_raise(capsys, engine):
    with pytest.raises(NotImplementedError, match="only --engine hnsw"):
        sweep.main(BASE + ["--engine", engine, "--devices", "2"])
    assert capsys.readouterr().out == ""


def test_sharded_hnsw_rows(capsys):
    sweep.main(BASE + ["--engine", "hnsw", "--devices", "2", "--ks", "3,5"])
    out = capsys.readouterr()
    rows = [json.loads(line) for line in out.out.strip().splitlines()]
    assert len(rows) == 1 and "2 shards over 1 device(s)" in out.err
    rec = rows[0]
    assert set(rec) == {f.name for f in dataclasses.fields(JaxRow)}
    assert (rec["operation"], rec["num_points"], rec["k"], rec["num_devices"]) == (
        "search", 600, 5, 1)
    assert rec["recall"] >= 0.9
    assert out.err.count("insertion:") == 1 and out.err.count("search:") == 2
