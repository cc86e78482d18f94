"""Every shipped cell, briefly, on a CUDA card: the command as the benchmark
runs it, whose last line must say `correct`. Skips without a card (decided
inside the test, never at import)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "zvbench/run.py", "--workload", cell, "--seed", "9",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
