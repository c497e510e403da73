"""In-process worker-pool primitives (the reference's legacy local pool,
downstream/utils/worker.py:24-369 — behavior parity, no code copied).

  * BatchedQueue: get(n) returns EXACTLY n items, caching leftovers from
    over-full batches (worker.py:203-314)
  * OrderedOutputs: releases results strictly in submission order via a
    next-expected counter (worker.py:64-107)
  * round_robin: the legacy sender's dispatch order (worker.py:24-58)

The modern serving plane (manager.py) supersedes these for deployment;
they remain for drop-in use by in-process pipelines (e.g. the data
collector's producer/consumer threads).

The port's own copy of `wiw_tpu/serve/queues.py` (it imports no JAX).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional


class BatchedQueue:
    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._leftover: List[Any] = []
        self._lock = threading.Lock()

    def put(self, item: Any) -> None:
        self._q.put(item)

    def put_many(self, items: Iterable[Any]) -> None:
        for it in items:
            self._q.put(it)

    def get_batch(self, n: int, timeout: Optional[float] = None) -> List[Any]:
        """Exactly n items; leftovers from previous gets are served first."""
        with self._lock:
            out: List[Any] = []
            while len(out) < n and self._leftover:
                out.append(self._leftover.pop(0))
            while len(out) < n:
                out.append(self._q.get(timeout=timeout))
            return out

    def stash_leftovers(self, items: Iterable[Any]) -> None:
        with self._lock:
            self._leftover.extend(items)

    def qsize(self) -> int:
        return self._q.qsize() + len(self._leftover)


class OrderedOutputs:
    """Results enter keyed by sequence id; `drain` yields them strictly in
    order, holding back early arrivals."""

    def __init__(self):
        self._buffer: Dict[int, Any] = {}
        self._next = 0
        self._lock = threading.Lock()

    def put(self, seq_id: int, result: Any) -> None:
        with self._lock:
            self._buffer[seq_id] = result

    def drain(self) -> Iterator[Any]:
        with self._lock:
            while self._next in self._buffer:
                yield self._buffer.pop(self._next)
                self._next += 1

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._buffer)


def round_robin(workers: List[Any]) -> Iterator[Any]:
    """Endless round-robin over the pool (legacy sender dispatch)."""
    return itertools.cycle(workers)
