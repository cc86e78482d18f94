"""Serving layer: concurrent micro-batching query scheduler (port of
zvdb_tpu/serve.py).

A single query costs the device nearly as much as a large batch, so the
server's job is to coalesce concurrent callers into one device batch.
`SearchServer` collects requests from any number of threads into a pending
buffer; a dispatcher thread flushes the buffer when it reaches `max_batch` or
when the oldest request has waited `max_wait_ms`, runs one batched search,
and distributes per-caller results via futures.

Works with any of the port's engines exposing `search(q, k) -> (scores, ids)`
as tensors; results reach callers as numpy arrays.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np


class SearchServer:
    def __init__(
        self,
        index: Any,
        k: int,
        max_batch: int = 4096,
        max_wait_ms: float = 2.0,
        search_kwargs: Optional[dict] = None,
    ):
        self.index = index
        self.k = k
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.search_kwargs = search_kwargs or {}
        self._pending: List[Tuple[np.ndarray, Future]] = []
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------
    def submit(self, q) -> Future:
        """Enqueue one query [D] (or a small batch [b, D]); returns a Future
        resolving to (scores, ids) numpy arrays."""
        q = np.asarray(q, np.float32)
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("server is shut down")
            self._pending.append((np.atleast_2d(q), fut))
        self._event.set()
        return fut

    def search(self, q, timeout: Optional[float] = None):
        """Blocking convenience wrapper around submit()."""
        scores, ids = self.submit(q).result(timeout=timeout)
        if np.asarray(q).ndim == 1:
            return scores[0], ids[0]
        return scores, ids

    def shutdown(self, wait: bool = True):
        with self._lock:
            self._stop = True
        self._event.set()
        if wait:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- dispatcher -------------------------------------------------------
    def _loop(self):
        while True:
            self._event.wait(timeout=0.1)
            with self._lock:
                if self._stop and not self._pending:
                    return
                have = sum(b.shape[0] for b, _ in self._pending)
            if have == 0:
                self._event.clear()
                continue
            if have < self.max_batch:
                # wait out the batching window for more arrivals
                deadline = time.perf_counter() + self.max_wait_s
                while time.perf_counter() < deadline:
                    with self._lock:
                        have = sum(b.shape[0] for b, _ in self._pending)
                    if have >= self.max_batch or self._stop:
                        break
                    time.sleep(self.max_wait_s / 10)
            with self._lock:
                batch = self._pending
                self._pending = []
                self._event.clear()
            if not batch:
                continue
            self._dispatch(batch)

    def _dispatch(self, batch):
        qs = np.concatenate([b for b, _ in batch], axis=0)
        try:
            scores, ids = self.index.search(qs, self.k, **self.search_kwargs)
            # one device-to-host copy per batch (np.asarray cannot read a CUDA tensor)
            scores = scores.cpu().numpy()
            ids = ids.cpu().numpy()
            lo = 0
            for b, fut in batch:
                hi = lo + b.shape[0]
                fut.set_result((scores[lo:hi], ids[lo:hi]))
                lo = hi
        except Exception as e:  # propagate to every waiting caller
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
