"""The benchmark's inputs, made on the device from the run's seed.

A copy of `synthetic_clustered` (a Gaussian mixture: centres N(0, 1), each
row its centre plus `spread` N(0, 1)) and of the SIFT1M stand-in's query
rule (a pool of corpus rows plus `query_noise` N(0, 1)), drawn by a
torch.Generator on the device in a few large calls instead of numpy on the
host. The same seed gives the same corpus and pool on the same device.
Imports nothing of the program.
"""
from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def make_data(spec: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus [n, dim] f32, query pool [queries, dim] f32) on `device`.

    spec: n, dim, n_clusters, spread, queries, query_noise (a configuration
    file's "data")."""
    n, dim = int(spec["n"]), int(spec["dim"])
    gen = generator(seed, device)
    centres = torch.randn(int(spec["n_clusters"]), dim, generator=gen, device=device)
    assign = torch.randint(0, centres.shape[0], (n,), generator=gen, device=device)
    x = torch.randn(n, dim, generator=gen, device=device)
    x.mul_(float(spec["spread"])).add_(centres[assign])
    del assign, centres
    rows = torch.randint(0, n, (int(spec["queries"]),), generator=gen, device=device)
    pool = x[rows] + float(spec["query_noise"]) * torch.randn(
        rows.shape[0], dim, generator=gen, device=device)
    return x, pool
