"""zvdb_tpu_torch.IVFIndex's write path against the JAX package, on the CPU.

Equal inputs, equal states:
  * a JAX-written build-plan checkpoint resumed in the port (the device
    pack) for f32, bf16 and int8 + rerank blocks under l2, cosine and dot;
  * `add` on a JAX-built index carried across by `from_numpy`, in both
    packages, through the O(new) append, the overflow repack (the host
    pack) and the repack a full shadow store forces (ids after it equal up
    to near-ties, see `_same`);
  * a port-written save file loaded by the JAX package.
Blocks, ids, counts, scales (the int8 codes and `b_scales` bit for bit: the
device pack and the append multiply by f32(1 / 127) as XLA compiles JAX's
jitted division, the host repack divides in numpy as JAX's does), the
shadow rows and the centroids are equal; the f32 squared norms are within
rtol 1e-6 (sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import zvdb_tpu as ZJ
import zvdb_tpu_torch as ZT
from zvdb_tpu.index import ivf as JI
from zvdb_tpu_torch.index import ivf as TI

CPU = "cpu"
NORMS = ("c_norms", "b_norms", "rerank_norms")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on shared cores, where torch's default (one thread a core)
    oversubscribes them and its waiting threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clustered(n, d, seed, nc=40):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


def assert_same_state(t_state, j_state):
    for f in TI._STATE_FIELDS:
        a, b = getattr(t_state, f), getattr(j_state, f)
        if f == "n":
            assert a == int(b)
            continue
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, f
        if a.dtype == torch.bfloat16:        # compare bf16 as f32 values
            a, b = a.float(), b.astype(np.float32)
        if f in NORMS:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


def _same(t, j):
    """Scores equal within rtol 1e-5 / atol 1e-4 slot by slot; ids equal
    except where a result ties another of its row (or is the k-th) within
    1e-5 of the score scale (the rule of test_torch_hnsw.py): l2 surrogates
    cancel terms far larger than the distance, so the last ulps of two
    summation orders can swap a near-tie."""
    (ts, ti), (js, ji) = t, j
    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    bad = np.argwhere(ti != ji)
    assert len(bad) <= 0.01 * ti.size, len(bad)
    tie = 1e-5 * max(1.0, float(np.abs(js[np.isfinite(js)]).max()))
    for row, col in bad:
        others = np.delete(js[row], col)
        assert col == js.shape[1] - 1 or np.abs(others - js[row, col]).min() <= tie, (row, col)


def carry(j):
    arrays = {f: np.asarray(getattr(j.state, f)) for f in JI.IVFState._fields}
    return ZT.IVFIndex.from_numpy(dataclasses.asdict(j.cfg), arrays,
                                  n_inserted=j._n_inserted, device=CPU)


KINDS = [("float32", 0), ("bfloat16", 0), ("int8", 4)]


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("dtype,rerank", KINDS)
def test_jax_plan_checkpoint_resumes_to_jax_state(tmp_path, metric, dtype, rerank):
    x = clustered(3000, 24, seed=1)
    cfg = dict(dim=24, n_clusters=48, nprobe=6, metric=metric, dtype=dtype, rerank=rerank)
    ckpt = str(tmp_path / "plan.npz")
    j = ZJ.IVFIndex(ZJ.IVFConfig(**cfg))
    j.build(x, checkpoint_path=ckpt)
    t = ZT.IVFIndex.resume_build(ckpt, device=CPU)
    assert t.cfg == ZT.IVFConfig(**cfg) and len(t) == len(j)
    assert t.state.blocks.dtype == t.cfg.storage_dtype
    assert_same_state(t.state, j.state)
    q = clustered(64, 24, seed=2)
    np.testing.assert_array_equal(t.search(q, 10)[1].numpy(), np.asarray(j.search(q, 10)[1]))


# (dtype, rerank, metric) x how the add is taken
ADD_CASES = [("float32", 0, "l2"), ("bfloat16", 0, "dot"), ("int8", 4, "cosine"),
             ("int8", 4, "l2")]


@pytest.mark.parametrize("path", ["append", "overflow", "shadow_full"])
@pytest.mark.parametrize("dtype,rerank,metric", ADD_CASES)
def test_add_on_a_carried_index_matches_jax(dtype, rerank, metric, path):
    """The same rows added to a JAX-built index in both packages (three
    adds: each flushes at the next search) leave equal states and ids.
    "append": 90 rows, the O(new) device append; "overflow": 700 rows
    around one row, a cluster overflows and the host repack runs (with
    its split); "shadow_full": 120 rows, whose third add (40 rows at id
    3080, padded to 1024) would run past the shadow store's 4096 rows, so
    int8 + rerank repacks there (the others append)."""
    x = clustered(3000, 16, seed=3)
    cfg = ZJ.IVFConfig(dim=16, n_clusters=32, nprobe=8, metric=metric, dtype=dtype,
                       rerank=rerank)
    j = ZJ.IVFIndex(cfg)
    j.build(x)
    j.remove(np.arange(0, 90, 3))
    t = carry(j)
    rng = np.random.default_rng(4)
    new = {"append": clustered(90, 16, seed=5),
           "overflow": (x[7] + 0.15 * rng.standard_normal((700, 16))).astype(np.float32),
           "shadow_full": clustered(120, 16, seed=6)}[path]
    repacks = []
    repack = t._repack_with_new
    t._repack_with_new = lambda *a: (repacks.append(a[1]), repack(*a))
    for part in np.array_split(new, 3):
        j.add(part)
        t.add(part)
        q = part[:40] + 0.01
        _same(t.search(q, 5), j.search(q, 5))
    assert bool(repacks) == (path == "overflow" or (path == "shadow_full" and rerank > 0))
    if path == "shadow_full" and rerank:
        assert repacks == [3080]
    assert t._dead == j._dead and len(t) == len(j)
    assert_same_state(t.state, j.state)
    q = x[::29] + 0.01
    _same(t.search(q, 10), j.search(q, 10))
    np.testing.assert_allclose(t.get(np.arange(3000, 3010)), j.get(np.arange(3000, 3010)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,rerank,metric", [("float32", 0, "l2"), ("bfloat16", 0, "dot"),
                                                 ("int8", 4, "cosine")])
def test_port_save_file_loads_in_jax(tmp_path, dtype, rerank, metric):
    x = clustered(3000, 16, seed=7)
    t = ZT.IVFIndex(ZT.IVFConfig(dim=16, n_clusters=32, nprobe=6, metric=metric, dtype=dtype,
                                 rerank=rerank), device=CPU)
    t.build(x)
    t.remove([5, 6, 7])
    t.add(clustered(100, 16, seed=8))
    p = str(tmp_path / "t.npz")
    t.save(p)
    j = ZJ.IVFIndex.load(p)
    assert j._dead == {5, 6, 7} and len(j) == len(t)
    q = x[::31] + 0.01
    for qq in (q[:4], q):
        np.testing.assert_array_equal(np.asarray(j.search(qq, 10)[1]),
                                      t.search(qq, 10)[1].numpy())
