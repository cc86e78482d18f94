"""zvdb_tpu_torch.utils.router against zvdb_tpu/utils/router.py, case for case
with tests/test_router.py: 128d uniform data routes to flat, clustered
SIFT-like data to the graph engine; the relative contrast equals JAX's (both
host numpy with a numpy RNG)."""
import numpy as np

import zvdb_tpu_torch as ZT
from zvdb_tpu.utils import router as JR
from zvdb_tpu_torch.utils.router import relative_contrast, suggest_engine


def _same_as_jax(x, **kw):
    assert relative_contrast(x, **kw) == JR.relative_contrast(x, **kw)


def test_uniform_routes_to_flat():
    rng = np.random.default_rng(0)
    x = rng.random((20000, 128), dtype=np.float32)   # the reference workload
    eng, rc = suggest_engine(x)
    assert eng == "flat" and rc < 1.5, (eng, rc)
    _same_as_jax(x)


def test_clustered_routes_to_graph():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((200, 128)).astype(np.float32)
    x = (centers[rng.integers(0, 200, 20000)]
         + 0.15 * rng.standard_normal((20000, 128))).astype(np.float32)
    eng, rc = suggest_engine(x)
    assert eng == "cagra" and rc > 2.0, (eng, rc)
    _same_as_jax(x, n_queries=64, n_refs=512, seed=3)


def test_gaussian_highdim_routes_to_flat():
    # isotropic gaussian at high dim concentrates too
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20000, 256)).astype(np.float32)
    eng, rc = suggest_engine(x)
    assert eng == "flat", (eng, rc)
    assert (eng, rc) == JR.suggest_engine(x)


def test_tiny_corpus_defaults_to_graphable():
    eng, rc = suggest_engine(np.zeros((4, 8), np.float32))
    assert rc == float("inf") and eng == "cagra"
    # every pair a duplicate: fully concentrated
    assert relative_contrast(np.ones((50, 8), np.float32)) == 1.0
    _same_as_jax(np.ones((50, 8), np.float32))


def test_exported_from_the_package():
    assert ZT.relative_contrast is relative_contrast and ZT.suggest_engine is suggest_engine
