"""zvdb_tpu_torch.SearchServer over a CPU FlatIndex: concurrent callers get
exactly what one batched search returns."""
import threading

import numpy as np
import pytest

import zvdb_tpu_torch as ZT


def _index(rng, n=2000, d=16, **cfg):
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = ZT.FlatIndex(ZT.FlatConfig(dim=d, **cfg), device="cpu")
    idx.add(x)
    return idx


@pytest.mark.parametrize("cfg", [{}, dict(scan="pallas", l_bins=64, pallas_chunk=128, rerank=4)])
def test_concurrent_requests_match_batched_search(rng, cfg):
    idx = _index(rng, **cfg)
    q = rng.standard_normal((300, 16)).astype(np.float32)
    want_s, want_i = (a.numpy() for a in idx.search(q, 5, approx=True))
    sizes = rng.integers(1, 6, 120)
    sizes[::2] = 1                                   # single queries and small batches
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    got = [None] * len(sizes)
    errors = []
    with ZT.SearchServer(idx, k=5, max_batch=64, max_wait_ms=1.0,
                         search_kwargs={"approx": True}) as srv:
        def worker(t):
            try:
                for r in range(t, len(sizes), 8):
                    lo = int(starts[r])
                    qq = q[lo] if sizes[r] == 1 else q[lo:lo + sizes[r]]
                    got[r] = srv.search(qq, timeout=60)
            except Exception as e:   # reported below, from the main thread
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for r, (s, i) in enumerate(got):
        lo, b = int(starts[r]), int(sizes[r])
        if b == 1:
            assert i.shape == (5,)
            s, i = s[None], i[None]
        assert isinstance(i, np.ndarray) and i.dtype == np.int32
        np.testing.assert_array_equal(i, want_i[lo:lo + b])
        np.testing.assert_allclose(s, want_s[lo:lo + b], rtol=1e-5, atol=1e-5)


def test_errors_reach_callers_and_shutdown(rng):
    idx = _index(rng, n=100)
    srv = ZT.SearchServer(idx, k=3)
    with pytest.raises(ValueError):                 # dimension mismatch in the batch
        srv.search(np.zeros(7, np.float32), timeout=60)
    srv.shutdown()
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros(16, np.float32))
