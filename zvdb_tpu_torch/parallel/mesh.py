"""Device meshes for the sharded engines (port of zvdb_tpu/parallel/mesh.py).

A `Mesh` is a [n_data, n_shards] grid of devices with JAX's axis names: the
sharded engines partition the corpus on `shard` and the query batch on
`data`. The port's engines are single-controller, as JAX's are: one process
holds every shard's tensors on its grid cell's device, runs each shard's
local work in turn and merges on the grid's first device. No
torch.distributed group is formed.

Differences from the JAX package, by design:
  * `make_mesh` takes every visible CUDA device by default and raises
    without one; pass `devices=` (for example [torch.device("cpu")]) to
    place shards elsewhere;
  * a grid larger than the devices given is filled cyclically
    (devices[i % len(devices)]), so one card holds several shards (JAX's
    reshape fails there);
  * a torch device has no `slice_index`, so every real device is in slice 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shard"   # corpus (N) partition
DATA_AXIS = "data"     # query-batch partition


def _as_device(d):
    """Strings and torch devices as torch.device; anything else (the tests'
    stand-ins with a slice_index) as it is."""
    return torch.device(d) if isinstance(d, (str, torch.device)) else d


class Mesh:
    """A [n_data, n_shards] grid of devices. `shape` maps the axis names to
    their sizes, as jax.sharding.Mesh.shape does."""

    def __init__(self, grid):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for r, row in enumerate(grid):
            for c, d in enumerate(row):
                self.devices[r, c] = _as_device(d)
        self.axis_names = (DATA_AXIS, SHARD_AXIS)
        self.shape = {DATA_AXIS: self.devices.shape[0], SHARD_AXIS: self.devices.shape[1]}

    def shard_device(self, s: int):
        """Where shard s's tensors live: its cell in the first data row."""
        return self.devices[0, s]

    @property
    def merge_device(self):
        """Where the per-shard results are merged: the grid's first device."""
        return self.devices[0, 0]

    @property
    def n_devices(self) -> int:
        """Distinct devices the grid spans (1 when every shard shares a card)."""
        return len({str(d) for d in self.devices.ravel()})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: make_mesh places shards on the GPUs by default; pass "
            "devices=[torch.device('cpu')] to place them on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_shards: Optional[int] = None, n_data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, shard) mesh. Default: every visible CUDA device on the
    shard axis. A grid larger than the devices takes them cyclically."""
    devs = [_as_device(d) for d in devices] if devices is not None else _cuda_devices()
    if n_shards is None:
        n_shards = len(devs) // n_data
    cells = [devs[i % len(devs)] for i in range(n_data * n_shards)]
    return Mesh([cells[r * n_shards:(r + 1) * n_shards] for r in range(n_data)])


def _group_by_slice(devs: Sequence) -> dict:
    """Group devices by their slice. Multi-slice runtimes expose
    `slice_index` on each device; torch devices have none and all land in
    slice 0."""
    groups: dict = {}
    for d in devs:
        groups.setdefault(getattr(d, "slice_index", 0) or 0, []).append(d)
    return groups


def make_hybrid_mesh(n_slices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """(data, shard) mesh laid out for multi-slice deployments: `shard`
    within a slice and `data` across slices, so every per-shard top-k merge
    stays inside a slice and only the query scatter and the [B/n_slices, k]
    results cross slices.

    Devices that report a `slice_index` are grouped by it; otherwise (every
    torch device) they are split evenly into `n_slices` contiguous groups."""
    devs = [_as_device(d) for d in devices] if devices is not None else _cuda_devices()
    groups = _group_by_slice(devs)
    if len(groups) > 1:
        sizes = {len(g) for g in groups.values()}
        if len(sizes) != 1:
            raise ValueError(f"uneven slices: {sorted(groups)} -> {sizes}")
        if n_slices is not None and n_slices != len(groups):
            raise ValueError(
                f"n_slices={n_slices} but runtime reports {len(groups)} "
                "slices; omit n_slices to use the hardware layout")
        return Mesh([groups[s] for s in sorted(groups)])
    if n_slices is None or n_slices <= 0:
        raise ValueError("single-slice backend: pass n_slices to emulate")
    if len(devs) % n_slices:
        raise ValueError(f"{len(devs)} devices not divisible by {n_slices}")
    return make_mesh(n_data=n_slices, devices=devs)
