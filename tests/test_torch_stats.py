"""zvdb_tpu_torch.utils.stats against zvdb_tpu/utils/stats.py (the flat case
of tests/test_stats.py, plus CAGRA and IVF-PQ; the HNSW and IVF cases wait for
those engines). The same state in both packages gives equal `n`,
`total_bytes`, `component_bytes`, `degree` and `overhead_vs_raw`: the port's
host scalars count 4 bytes each, as JAX's device scalars do. On a built
IVF-PQ index both packages raise AttributeError: JAX's `index_stats` reads
`state.blocks`, which IVFPQState does not have (a fault of the reference)."""
import dataclasses

import numpy as np
import pytest

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index.cagra import CagraState as JCagraState
from zvdb_tpu.utils.stats import index_stats as jax_stats
from zvdb_tpu_torch.utils.stats import index_stats

KEYS = ("n", "total_bytes", "component_bytes", "degree", "overhead_vs_raw")


def _assert_equal_stats(t, j):
    for key in KEYS:
        assert (key in t) == (key in j), key
        if key in j:
            assert t[key] == j[key], (key, t[key], j[key])


def test_flat_stats(rng):
    x = rng.standard_normal((50, 8)).astype(np.float32)
    idx = ZT.FlatIndex(ZT.FlatConfig(dim=8), capacity=100, device="cpu")
    idx.add(x)
    s = index_stats(idx)
    assert s["n"] == 50 and s["total_bytes"] > 0
    assert s["component_bytes"] == {"vectors": 3200, "norms": 400, "scales": 400, "n": 4}
    jidx = ZJ.FlatIndex(ZJ.FlatConfig(dim=8), capacity=100)
    jidx.add(x)
    _assert_equal_stats(s, jax_stats(jidx))
    assert index_stats(ZT.FlatIndex(ZT.FlatConfig(dim=8), device="cpu")) == \
        {"n": 0, "total_bytes": 0}


def test_cagra_stats_equal_on_one_graph(rng, tmp_path):
    # one graph in both packages: the port builds it, JAX loads its save
    # file (a JAX build would compile for ~15 s), and
    # CagraIndex.from_numpy carries JAX's state back into the port
    x = rng.standard_normal((600, 16)).astype(np.float32)
    own = ZT.CagraIndex(ZT.CagraConfig(dim=16, degree=16, precision="highest"), device="cpu")
    own.build(x)
    own.save(str(tmp_path / "g"))
    jidx = ZJ.CagraIndex.load(str(tmp_path / "g.npz"))
    arrays = {f: np.asarray(getattr(jidx.state, f)) for f in JCagraState._fields}
    tidx = ZT.CagraIndex.from_numpy(dataclasses.asdict(jidx.cfg), arrays,
                                    capacity=jidx.capacity, n_inserted=jidx._n_inserted,
                                    device="cpu")
    s, j = index_stats(tidx), jax_stats(jidx)
    _assert_equal_stats(s, j)
    _assert_equal_stats(index_stats(own), j)
    assert s["degree"]["isolated"] == 0 and s["degree"]["max"] <= 16
    assert s["overhead_vs_raw"] > 0   # graph tables cost something


def test_ivfpq_stats_raise_in_both_packages(rng):
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    kw = dict(dim=16, n_sub=8, n_clusters=8, train_sample=2000, kmeans_sample=2000)
    jidx = ZJ.IVFPQIndex(ZJ.IVFPQConfig(**kw))
    jidx.build(x)
    tidx = ZT.IVFPQIndex(ZT.IVFPQConfig(**kw), device="cpu")
    tidx.build(x)
    for fn, idx in ((jax_stats, jidx), (index_stats, tidx)):
        with pytest.raises(AttributeError, match="blocks"):
            fn(idx)
