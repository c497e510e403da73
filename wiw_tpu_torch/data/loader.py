"""Asynchronous training input pipeline: threaded item fetch + pipelined
host->device transfer.

Port of `wiw_tpu/data/loader.py` (a copy; the port imports nothing of
`wiw_tpu`). Two stages:

  1. a thread pool maps `dataset[idx]` concurrently (decode + resize are
     PIL/numpy and release the GIL), with an assembler thread stacking
     items into batches behind a bounded queue;
  2. an optional `place` hook, normally the trainer's `place_batch` (pinned
     host memory, then `.to(device, non_blocking=True)` on a copy stream),
     runs in the assembler thread, so batch N+1's host->device copy is in
     flight while step N computes.

In a run of several processes each loader fetches only its rank's rows of
each global batch (`rows`, which `parallel/mesh.batch_rows` gives): step
s's items s * batch_size + i for i in rows.

Bounded queues keep host memory flat; a poison pill + `close()` make
shutdown deterministic (no daemon-thread leaks in tests).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

_DONE = object()


def _stack(items, keys=None) -> dict:
    """Stack per-item dicts; without explicit keys, numeric fields only
    (dataset items also carry string frame paths the device can't hold)."""
    if keys is None:
        keys = [k for k, v in items[0].items()
                if np.asarray(v).dtype.kind in "biufc"]
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in keys}


class PrefetchLoader:
    """Iterate `num_steps` batches of `batch_size` items from `dataset`
    with background fetch/assembly.

    Args:
      dataset: indexable; `dataset[i]` -> dict of equally-shaped arrays.
      transform: optional host-side batch hook (e.g. the grad-accum
        leading-axis broadcast) run in the assembler thread.
      place: optional device placement hook (trainer.place_batch) also run
        in the assembler thread so the transfer overlaps the train step.
      num_workers: concurrent item fetches.
      prefetch_batches: assembled-batch queue depth (>=1).
      rows: the rows of each batch this process fetches (None: all of
        them); `batch_size` is then the global batch.
    """

    def __init__(self, dataset, batch_size: int, num_steps: int,
                 transform: Optional[Callable[[dict], dict]] = None,
                 place: Optional[Callable[[dict], dict]] = None,
                 num_workers: int = 4, prefetch_batches: int = 2,
                 keys=None, rows: Optional[range] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.transform = transform
        self.place = place
        self.keys = keys
        self.rows = range(batch_size) if rows is None else rows
        self.num_workers = max(1, num_workers)
        self.queue: "queue.Queue" = queue.Queue(max(1, prefetch_batches))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- background side --------------------------------------------------
    def _run(self):
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for step in range(self.num_steps):
                    if self._stop.is_set():
                        return
                    idxs = [step * self.batch_size + i for i in self.rows]
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                    batch = _stack(items, self.keys)
                    if self.transform is not None:
                        batch = self.transform(batch)
                    if self.place is not None:
                        batch = self.place(batch)
                    while not self._stop.is_set():
                        try:
                            self.queue.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self.queue.put(_DONE, timeout=0.2)
                    break
                except queue.Full:
                    continue

    # -- consumer side -----------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        try:
            while True:
                batch = self.queue.get()
                if batch is _DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield batch
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            # drain so the producer's blocked put can observe the stop
            try:
                while True:
                    self.queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
            self._thread = None

    def __len__(self) -> int:
        return self.num_steps
