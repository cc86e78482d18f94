"""zvdb_tpu_torch.utils.stats against zvdb_tpu/utils/stats.py (the flat case
of tests/test_stats.py, plus CAGRA, IVF-PQ and the sharded engines). The same
state in both packages gives equal `n`, `total_bytes`, `component_bytes`,
`degree` and `overhead_vs_raw`: the port's host scalars count 4 bytes each,
as JAX's device scalars do, and a sharded state's bytes sum over the shards.
On a built IVF-PQ index, sharded or not, both packages raise AttributeError:
JAX's `index_stats` reads `state.blocks`, which IVFPQState does not have;
on a ShardedHNSW or ShardedCagra both raise TypeError (JAX's int() of the
stacked [S] `n`); on a ShardedIVF both give JAX's `clusters` entry over the
stacked [S, C_loc] counts (`count` is S). All faults of the reference, kept."""
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


def _jax_mesh4():
    from zvdb_tpu.parallel.mesh import make_mesh as jax_mesh

    return jax_mesh(n_shards=4)


def _port_mesh4():
    return ZT.make_mesh(n_shards=4, devices=["cpu"])


def test_sharded_flat_stats_equal_jax(rng, tmp_path):
    """A ShardedFlat (a list of per-shard dicts in the port, a dict of
    stacked arrays in JAX) carried by a JAX save file."""
    from zvdb_tpu.parallel.sharded_flat import ShardedFlat as JShardedFlat

    x = rng.standard_normal((500, 16)).astype(np.float32)
    j = JShardedFlat(ZJ.FlatConfig(dim=16), mesh=_jax_mesh4())
    j.build(x)
    j.save(str(tmp_path / "f.npz"))
    t = ZT.ShardedFlat.load(str(tmp_path / "f.npz"), mesh=_port_mesh4())
    want = {"n": 500, "total_bytes": 36000,
            "component_bytes": {"vectors": 32000, "norms": 2000, "ids": 2000},
            "overhead_vs_raw": 0.125}
    assert jax_stats(j) == want and index_stats(t) == want


@pytest.mark.parametrize("n_codes", [256, 16])
def test_sharded_pq_stats_equal_jax(rng, tmp_path, n_codes):
    """JAX's dict on a carried ShardedPQFlat. Unpacked codes (n_codes=256)
    take JAX's bytes; packed ones (n_codes=16) hold the nibble layout kernel
    B reads, half of JAX's [S, per, n_sub] code bytes, every other key equal."""
    from zvdb_tpu.parallel.sharded_pq import ShardedPQFlat as JShardedPQFlat

    x = rng.standard_normal((500, 16)).astype(np.float32)
    cfg = dict(dim=16, n_sub=4, n_codes=n_codes, refine="int8", train_sample=256,
               kmeans_iters=2)
    j = JShardedPQFlat(ZJ.PQConfig(**cfg), mesh=_jax_mesh4())
    j.build(x)
    j.save(str(tmp_path / "p.npz"))
    t = ZT.ShardedPQFlat.load(str(tmp_path / "p.npz"), mesh=_port_mesh4())
    s, want = index_stats(t), jax_stats(j)
    if n_codes == 256:
        assert s == want
        assert want["component_bytes"] == {"codes": 2000, "norms": 2000, "refine": 8000,
                                           "r_scales": 2000, "ids": 2000}
    else:
        codes_t, codes_j = s["component_bytes"].pop("codes"), want["component_bytes"].pop("codes")
        assert 2 * codes_t == codes_j == 2000
        assert s["component_bytes"] == want["component_bytes"] and s["n"] == want["n"] == 500
        assert want["total_bytes"] - s["total_bytes"] == codes_t
    assert "overhead_vs_raw" not in s and "overhead_vs_raw" not in want


def test_sharded_hnsw_and_ivfpq_stats_raise_in_both_packages(rng, tmp_path):
    """Reference faults kept: JAX's index_stats takes int(st.n) of a stacked
    HNSW state (an [S] array: TypeError) and reads `blocks` of an IVF-PQ
    state (AttributeError); the port raises the same on its per-shard lists."""
    from zvdb_tpu.parallel.sharded import ShardedHNSW as JShardedHNSW
    from zvdb_tpu.parallel.sharded_ivfpq import ShardedIVFPQ as JShardedIVFPQ

    x = rng.standard_normal((400, 16)).astype(np.float32)
    jh = JShardedHNSW(ZJ.HNSWConfig(dim=16, m=4, ef_construction=16, build_batch=64),
                      mesh=_jax_mesh4())
    jh.build(x)
    jh.save(str(tmp_path / "h.npz"))
    th = ZT.ShardedHNSW.load(str(tmp_path / "h.npz"), mesh=_port_mesh4())
    for fn, idx in ((jax_stats, jh), (index_stats, th)):
        with pytest.raises(TypeError):
            fn(idx)
    cfg = dict(dim=16, n_sub=8, n_clusters=8, train_sample=400, kmeans_sample=400)
    ji = JShardedIVFPQ(ZJ.IVFPQConfig(**cfg), mesh=_jax_mesh4())
    ji.build(x)
    ji.save(str(tmp_path / "i.npz"))
    ti = ZT.ShardedIVFPQ.load(str(tmp_path / "i.npz"), mesh=_port_mesh4())
    for fn, idx in ((jax_stats, ji), (index_stats, ti)):
        with pytest.raises(AttributeError, match="blocks"):
            fn(idx)


def test_sharded_ivf_stats_equal_jax(tmp_path):
    """JAX's dict, key for key, on a carried ShardedIVF (rerank: the shadow
    stores count too). Its `clusters` entry reads the stacked [S, C_loc]
    counts as if they were [C]: count == S, pad_waste over S x cap slots."""
    from zvdb_tpu.parallel.sharded_ivf import ShardedIVF as JShardedIVF

    rng = np.random.default_rng(3)
    x = rng.standard_normal((800, 16)).astype(np.float32)
    j = JShardedIVF(ZJ.IVFConfig(dim=16, n_clusters=16, rerank=2), mesh=_jax_mesh4())
    j.build(x)
    j.save(str(tmp_path / "v.npz"))
    t = ZT.ShardedIVF.load(str(tmp_path / "v.npz"), mesh=_port_mesh4())
    s, want = index_stats(t), jax_stats(j)
    assert s == want and s["clusters"]["count"] == 4
    assert set(want) == {"n", "total_bytes", "component_bytes", "overhead_vs_raw", "clusters"}


def test_sharded_cagra_stats_raise_in_both_packages(tmp_path):
    from zvdb_tpu.parallel.sharded_cagra import ShardedCagra as JShardedCagra

    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    t = ZT.ShardedCagra(ZT.CagraConfig(dim=8, degree=8), mesh=_port_mesh4())
    t.build(x)
    t.save(str(tmp_path / "c.npz"))
    j = JShardedCagra.load(str(tmp_path / "c.npz"), mesh=_jax_mesh4())
    for fn, idx in ((jax_stats, j), (index_stats, t)):
        with pytest.raises(TypeError):
            fn(idx)
