"""The port stands alone: importing zvdb_tpu_torch or bench_cuda.py loads no
JAX, nothing of zvdb_tpu and not bench.py. Checked in a fresh interpreter,
since this test process has already imported jax (tests/conftest.py)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "zvdb_tpu", "bench")

_PROBE = """
import sys
import zvdb_tpu_torch
import zvdb_tpu_torch.bench.harness, zvdb_tpu_torch.io.datasets, zvdb_tpu_torch.ops.flat_scan
import zvdb_tpu_torch.index.flat, zvdb_tpu_torch.serve, zvdb_tpu_torch.utils.masks
import zvdb_tpu_torch.ops.pq, zvdb_tpu_torch.ops.pq_scan, zvdb_tpu_torch.ops.cuda_build
import zvdb_tpu_torch.index.pqflat, zvdb_tpu_torch.index.ivfpq, zvdb_tpu_torch.index.ivf
import zvdb_tpu_torch.index.knn_graph, zvdb_tpu_torch.utils.filter_policy
import zvdb_tpu_torch.ops.block_scan, zvdb_tpu_torch.index.build, zvdb_tpu_torch.index.hnsw
import zvdb_tpu_torch.index.cagra
import zvdb_tpu_torch.ops.scan_topk, zvdb_tpu_torch.ops.hop_scores, zvdb_tpu_torch.io.native_loader
import zvdb_tpu_torch.utils.router, zvdb_tpu_torch.utils.stats, zvdb_tpu_torch.utils.profiling
import zvdb_tpu_torch.parallel.mesh, zvdb_tpu_torch.parallel.sharded
import zvdb_tpu_torch.parallel.sharded_flat, zvdb_tpu_torch.parallel.scan_filter
import zvdb_tpu_torch.parallel.sharded_pq, zvdb_tpu_torch.parallel.sharded_ivfpq
import zvdb_tpu_torch.parallel.sharded_ivf, zvdb_tpu_torch.parallel.sharded_cagra
import bench_cuda
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax_and_no_reference_package():
    files = sorted((REPO / "zvdb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                               REPO / "bench_cuda.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)
