"""zvdb_tpu_torch's device meshes (parallel/mesh.py) on the CPU.

Mirrors the five tests of tests/test_hybrid_mesh.py on the port: the
grouping by a runtime slice_index (stand-in devices carrying one), the
three ValueErrors of make_hybrid_mesh, the data-outer / shard-inner layout
and a sharded engine on a hybrid mesh. Eight entries of the CPU device
stand in for JAX's eight virtual devices. The port adds cyclic placement
(a grid larger than the devices given takes them in turn, so one card
holds every shard) and the error without a CUDA device when no devices=
is passed.
"""
import numpy as np
import pytest
import torch

import zvdb_tpu_torch as ZT
from zvdb_tpu_torch.bench.harness import recall_at_k
from zvdb_tpu_torch.index.flat import exact_ground_truth
from zvdb_tpu_torch.parallel.mesh import (
    DATA_AXIS, SHARD_AXIS, _group_by_slice, make_hybrid_mesh, make_mesh,
)

CPU8 = [torch.device("cpu")] * 8


class _Dev:
    def __init__(self, slice_index):
        self.slice_index = slice_index


def test_group_by_slice_uses_runtime_slice_index():
    devs = [_Dev(1), _Dev(0), _Dev(1), _Dev(0)]
    g = _group_by_slice(devs)
    assert set(g) == {0, 1} and all(len(v) == 2 for v in g.values())
    # torch devices (no slice_index) and slice_index=None land in slice 0
    assert set(_group_by_slice([torch.device("cpu"), _Dev(None)])) == {0}
    mesh = make_hybrid_mesh(devices=devs)   # the runtime's layout: one data row a slice
    assert mesh.shape == {DATA_AXIS: 2, SHARD_AXIS: 2}
    assert [d.slice_index for d in mesh.devices[1]] == [1, 1]


def test_uneven_slices_rejected():
    with pytest.raises(ValueError, match="uneven"):
        make_hybrid_mesh(devices=[_Dev(0), _Dev(0), _Dev(1)])
    with pytest.raises(ValueError, match="n_slices=3"):
        make_hybrid_mesh(n_slices=3, devices=[_Dev(0), _Dev(1)])


def test_single_slice_requires_n_slices():
    with pytest.raises(ValueError, match="n_slices"):
        make_hybrid_mesh(devices=CPU8)


def test_fallback_layout_data_outer_shard_inner():
    mesh = make_hybrid_mesh(n_slices=2, devices=CPU8)
    assert mesh.axis_names == (DATA_AXIS, SHARD_AXIS)
    assert mesh.shape[DATA_AXIS] == 2 and mesh.shape[SHARD_AXIS] == 4
    with pytest.raises(ValueError, match="divisible"):
        make_hybrid_mesh(n_slices=3, devices=CPU8)


def test_sharded_engine_on_hybrid_mesh():
    rng = np.random.default_rng(0)
    n, d, k = 4000, 16, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = ZT.ShardedFlat(ZT.FlatConfig(dim=d), mesh=make_hybrid_mesh(n_slices=2, devices=CPU8))
    idx.build(x)
    q = (x[rng.integers(0, n, 64)] + 0.02 * rng.standard_normal((64, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, k, device="cpu")
    _, ids = idx.search(q, k, approx=False)
    assert recall_at_k(ids.numpy(), gt, k) >= 0.99


def test_cyclic_placement_on_one_device():
    mesh = make_mesh(n_shards=4, devices=["cpu"])
    assert mesh.shape == {DATA_AXIS: 1, SHARD_AXIS: 4} and mesh.n_devices == 1
    assert all(mesh.shard_device(s) == torch.device("cpu") for s in range(4))
    devs = [_Dev(0), _Dev(0), _Dev(0)]
    grid = make_mesh(n_shards=4, n_data=2, devices=devs).devices
    assert [[devs.index(d) for d in row] for row in grid] == [[0, 1, 2, 0], [1, 2, 0, 1]]
    # as many cells as devices: each device once, in order (JAX's layout)
    assert list(make_mesh(n_shards=3, devices=devs).devices[0]) == devs
    assert make_mesh(devices=CPU8).shape == {DATA_AXIS: 1, SHARD_AXIS: 8}


def test_default_devices_are_the_gpus():
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh.shape[SHARD_AXIS] == torch.cuda.device_count()
        assert mesh.merge_device.type == "cuda"
    else:
        for make in (lambda: make_mesh(n_shards=4), lambda: make_hybrid_mesh(n_slices=1),
                     lambda: ZT.ShardedFlat(ZT.FlatConfig(dim=4))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_lazy_names():
    assert ZT.make_mesh is make_mesh and "make_hybrid_mesh" in ZT.__all__
    from zvdb_tpu_torch.parallel.sharded import ShardedHNSW
    from zvdb_tpu_torch.parallel.sharded_cagra import ShardedCagra
    from zvdb_tpu_torch.parallel.sharded_flat import ShardedFlat
    from zvdb_tpu_torch.parallel.sharded_ivf import ShardedIVF
    from zvdb_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQ
    from zvdb_tpu_torch.parallel.sharded_pq import ShardedPQFlat

    assert ZT.ShardedFlat is ShardedFlat and ZT.ShardedHNSW is ShardedHNSW
    assert ZT.ShardedPQFlat is ShardedPQFlat and ZT.ShardedIVFPQ is ShardedIVFPQ
    assert ZT.ShardedIVF is ShardedIVF and ZT.ShardedCagra is ShardedCagra
    assert not hasattr(ZT, "_NOT_PORTED")
    with pytest.raises(AttributeError):
        ZT.NoSuchName
