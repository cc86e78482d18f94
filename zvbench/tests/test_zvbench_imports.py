"""Nothing the benchmark runs imports JAX or the JAX package: every module
under zvbench/ by its import statements (top-level names compared whole, so
zvdb_tpu_torch is not zvdb_tpu), the reference imports nothing of the
program, no module imports the repository's older scripts, and a tiny run's
sys.modules holds none of them."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "zvdb_tpu"}
OLD_SCRIPTS = {"bench", "bench_cuda", "chip_smoke", "approx_topk_sweep", "flat_tile_sweep",
               "hop_route_sweep", "topk_tile_sweep"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_old_scripts(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert not names & OLD_SCRIPTS, names & OLD_SCRIPTS


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "zvdb_tpu_torch" not in top_level_imports(path)


def test_a_run_loads_no_jax():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
        "from tiny import tiny_cell\n"
        "from zvbench import harness as H\n"
        "line = H.run_cell(tiny_cell('ivf_1m.batch'), 5, 0.3, False, device='cpu')\n"
        "print(json.dumps(dict(correct=line['correct'], bad=H.forbidden_modules(),\n"
        "      tops=sorted({m.split('.')[0] for m in sys.modules}))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["bad"] == []
    assert not set(got["tops"]) & FORBIDDEN
    assert "zvdb_tpu_torch" in got["tops"]
