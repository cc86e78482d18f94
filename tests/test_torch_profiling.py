"""zvdb_tpu_torch.utils.profiling, case for case with tests/test_profiling.py.

`live_buffer_bytes` counts CUDA tensors (torch.cuda.memory_allocated) where
JAX sums its live arrays on any backend; without a card it raises, and its
growth test is `gpu`-marked:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""
import json
import os

import pytest
import torch

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
