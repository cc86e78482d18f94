"""zvdb_tpu_torch's HNSW build checkpoints on the CPU, and their crossing to and from the JAX package.

The checkpoint files are the JAX package's npz format. In the port a
resumed build equals the direct one: the batched build's nbr0 when it
snapshots every 2 batches and resumes from the file (JAX
test_checkpoint.py:8), the one-shot build's nbr0, nbrU, entry, max_level,
a_rows and levels (test_checkpoint.py:40; its epilogue replays a key drawn
at the start). Across the packages, at precision="float32": a JAX-written
batched checkpoint resumes in the port to JAX's own resumed graph; a
JAX-written one-shot checkpoint resumes in the port with JAX's base layer
and levels (after the deterministic diversity reorder: JAX's resumed nbr0),
upper layers and anchors from the port's stream; and JAX resumes a
port-written batched checkpoint to the port's direct graph. nbr0 is
compared without its trash row, where JAX writes in no set order.
"""
import json

import numpy as np
import pytest
import torch

import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.index.build import resume_build_oneshot

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)


def clustered(n, d, seed, nc=20, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


X = clustered(1200, 16, seed=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
BATCHED = dict(dim=16, m=8, ef_construction=32, build_batch=256, build_mode="batched",
               precision="float32")
ONESHOT = dict(dim=16, m=8, ef_construction=32, build_batch=512, build_mode="oneshot",
               precision="float32")


def self_hit(idx, n=64):
    ids = np.asarray(idx.search(X[:n], 1, ef_search=48)[1])
    return float((ids[:, 0] == np.arange(n)).mean())


def meta(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"])), sorted(z.files)


def test_batched_resume_equals_direct(tmp_path):
    cfg = ZT.HNSWConfig(**BATCHED)
    ckpt = str(tmp_path / "build.ckpt.npz")
    direct = ZT.HNSW(cfg, seed=5, device=CPU)
    direct.build(X)
    partial = ZT.HNSW(cfg, seed=5, device=CPU)
    partial.build(X, checkpoint_path=ckpt, checkpoint_every=2)
    m, files = meta(ckpt)
    assert m["next_batch"] == 4 and m["capacity"] == 1280 and m["cfg"]["build_mode"] == "batched"
    assert {"corpus", "lv", "ext", "nbr0", "entry", "q_scale"} <= set(files)
    with pytest.raises(ValueError, match="not a oneshot"):
        resume_build_oneshot(ckpt)
    resumed = ZT.HNSW.resume_build(ckpt, device=CPU)
    assert len(resumed) == 1200 and resumed.capacity == 1280
    assert resumed.levels_cap == direct.levels_cap and resumed.cfg == cfg
    for f in ("nbr0", "dist0", "nbrU", "levels", "ext_ids"):
        assert torch.equal(getattr(direct.state, f), getattr(partial.state, f)), f
        assert torch.equal(getattr(partial.state, f), getattr(resumed.state, f)), f
    assert (direct.state.entry, direct.state.max_level) == (resumed.state.entry,
                                                           resumed.state.max_level)
    assert self_hit(resumed) >= 0.95
    # "auto" with a checkpoint takes the batched build
    auto = ZT.HNSW(ZT.HNSWConfig(**{**BATCHED, "build_mode": "auto"}), seed=5, device=CPU)
    auto.build(X, checkpoint_path=str(tmp_path / "auto.npz"), checkpoint_every=2)
    assert torch.equal(auto.state.nbr0, direct.state.nbr0)


def test_oneshot_resume_equals_direct(tmp_path):
    cfg = ZT.HNSWConfig(**ONESHOT)
    ckpt = str(tmp_path / "oneshot.ckpt.npz")
    direct = ZT.HNSW(cfg, seed=7, device=CPU)
    direct.build(X)
    ck = ZT.HNSW(cfg, seed=7, device=CPU)
    ck.build(X, checkpoint_path=ckpt)
    m, files = meta(ckpt)
    assert m["kind"] == "hnsw_oneshot" and m["capacity"] == 1536
    assert set(files) == {"meta", "corpus", "lv", "key", "nbrs", "dists"}
    resumed = ZT.HNSW.resume_build(ckpt, device=CPU)
    assert len(resumed) == 1200
    for f in ("nbr0", "nbrU", "a_rows", "levels"):
        assert torch.equal(getattr(direct.state, f), getattr(resumed.state, f)), f
        assert torch.equal(getattr(direct.state, f), getattr(ck.state, f)), f
    assert (direct.state.entry, direct.state.max_level) == (resumed.state.entry,
                                                           resumed.state.max_level)
    assert self_hit(resumed) >= 0.95


# ---------------------------------------------------------------------------
# across the packages


def jax_index(kw, seed):
    import zvdb_tpu as ZJ

    return ZJ.HNSW(ZJ.HNSWConfig(**kw), seed=seed)


def test_jax_batched_checkpoint_resumes_in_the_port(tmp_path):
    import zvdb_tpu as ZJ

    ckpt = str(tmp_path / "jax.ckpt.npz")
    jax_index(BATCHED, 5).build(X, checkpoint_path=ckpt, checkpoint_every=2)
    jres = ZJ.HNSW.resume_build(ckpt)
    tres = ZT.HNSW.resume_build(ckpt, device=CPU)
    assert tres.capacity == jres.capacity and tres.levels_cap == jres.levels_cap
    np.testing.assert_array_equal(tres.state.nbr0.numpy()[:-1], np.asarray(jres.state.nbr0)[:-1])
    np.testing.assert_array_equal(tres.state.nbrU.numpy()[:, :-1],
                                  np.asarray(jres.state.nbrU)[:, :-1])
    np.testing.assert_allclose(tres.state.dist0.numpy()[:-1], np.asarray(jres.state.dist0)[:-1],
                               **TOL)
    for f in ("levels", "ext_ids"):
        np.testing.assert_array_equal(getattr(tres.state, f).numpy(),
                                      np.asarray(getattr(jres.state, f)))
    assert (tres.state.entry, tres.state.max_level, tres.state.n) == (
        int(jres.state.entry), int(jres.state.max_level), 1200)
    assert self_hit(tres) >= 0.95


def test_jax_oneshot_checkpoint_resumes_in_the_port(tmp_path):
    import zvdb_tpu as ZJ

    ckpt = str(tmp_path / "jax_oneshot.ckpt.npz")
    jax_index(ONESHOT, 7).build(X, checkpoint_path=ckpt)
    jres = ZJ.HNSW.resume_build(ckpt)
    tres = ZT.HNSW.resume_build(ckpt, device=CPU)
    st = tres.state
    # JAX's levels and base layer (reordered diversity-first, deterministically)
    np.testing.assert_array_equal(st.levels.numpy(), np.asarray(jres.state.levels))
    np.testing.assert_array_equal(st.nbr0.numpy()[:-1], np.asarray(jres.state.nbr0)[:-1])
    np.testing.assert_allclose(st.dist0.numpy()[:-1], np.asarray(jres.state.dist0)[:-1], **TOL)
    assert (st.entry, st.max_level) == (int(jres.state.entry), int(jres.state.max_level))
    # the upper layers come from the port's stream: every node of a layer has edges there
    lv = st.levels.numpy()[:1200]
    for ell in range(1, st.max_level + 1):
        rows = np.nonzero(lv >= ell)[0]
        if rows.size >= 2:
            e = st.nbrU[ell - 1].numpy()[rows]
            assert (e >= 0).any(1).all() and np.isin(e[e >= 0], rows).all()
    assert self_hit(tres) >= 0.95


def test_port_batched_checkpoint_resumes_in_jax(tmp_path):
    import zvdb_tpu as ZJ

    ckpt = str(tmp_path / "port.ckpt.npz")
    cfg = ZT.HNSWConfig(**BATCHED)
    direct = ZT.HNSW(cfg, seed=9, device=CPU)
    direct.build(X, checkpoint_path=ckpt, checkpoint_every=3)
    jres = ZJ.HNSW.resume_build(ckpt)
    assert jres.capacity == direct.capacity and jres.levels_cap == direct.levels_cap
    np.testing.assert_array_equal(np.asarray(jres.state.nbr0)[:-1], direct.state.nbr0.numpy()[:-1])
    np.testing.assert_array_equal(np.asarray(jres.state.nbrU)[:, :-1],
                                  direct.state.nbrU.numpy()[:, :-1])
    np.testing.assert_array_equal(np.asarray(jres.state.ext_ids), direct.state.ext_ids.numpy())
    assert int(jres.state.entry) == direct.state.entry and int(jres.state.n) == 1200
    ids = np.asarray(jres.search(X[:64], 1, ef_search=48)[1])[:, 0]
    assert (ids == np.arange(64)).mean() >= 0.95
