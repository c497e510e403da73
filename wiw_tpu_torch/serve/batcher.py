"""Per-client request batcher: split client batches into worker sub-batches,
recompose results strictly in client-send order.

Semantics parity with the reference Batcher (worker_manager.py:448-517):
  * a client batch of size N splits into ceil(N / batch_size) sub-tasks
  * sub-tasks complete out of order across workers; a batch is released
    only when all its sub-tasks landed AND it is the oldest outstanding
    batch for that client (FIFO release)
  * a stall monitor reports queue state after `stall_secs` of silence

The port's own copy of `wiw_tpu/serve/batcher.py` (it imports no JAX).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

ARRAY_KEYS = ("b_action", "b_image", "pred_frames", "bbox_coords")
LIST_KEYS = ("save_dirs", "return_objects")


def split_input_dict(input_dict: dict, batch_size: int) -> List[dict]:
    """Split a batched input dict into sub-dicts of at most `batch_size`."""
    n = len(input_dict["save_dirs"])
    subs = []
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        sub = {}
        for k, v in input_dict.items():
            if isinstance(v, np.ndarray):
                sub[k] = v[start:end]
            elif isinstance(v, list) and len(v) == n:
                sub[k] = v[start:end]
            else:
                sub[k] = v
        subs.append(sub)
    return subs


def merge_output_dicts(parts: List[dict]) -> dict:
    """Inverse of split: concatenate results in sub-task order."""
    out: dict = {}
    keys = parts[0].keys()
    for k in keys:
        vals = [p[k] for p in parts]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.concatenate(vals, axis=0)
        elif isinstance(vals[0], list):
            out[k] = [x for v in vals for x in v]
        else:
            out[k] = vals[0]
    return out


class Batcher:
    """Tracks batch -> sub-task bookkeeping for one client connection."""

    def __init__(self, batch_size: int = 1, stall_secs: float = 600.0,
                 on_stall: Optional[Callable[[str], None]] = None):
        self.batch_size = batch_size
        self.stall_secs = stall_secs
        self.on_stall = on_stall or (lambda msg: print(msg, flush=True))
        self._lock = threading.Lock()
        self._next_batch_id = 0
        self._next_task_id = 0
        # batch_id -> {task_id -> result|None}, insertion-ordered
        self._pending: Dict[int, Dict[int, Any]] = {}
        self._task_to_batch: Dict[int, int] = {}
        self._last_progress = time.time()

    def split_batch(self, input_dict: dict) -> List[tuple[int, dict]]:
        """Returns [(task_id, sub_input_dict), ...] for dispatch."""
        with self._lock:
            batch_id = self._next_batch_id
            self._next_batch_id += 1
            subs = split_input_dict(input_dict, self.batch_size)
            tasks = []
            slot: Dict[int, Any] = {}
            for sub in subs:
                tid = self._next_task_id
                self._next_task_id += 1
                slot[tid] = None
                self._task_to_batch[tid] = batch_id
                tasks.append((tid, sub))
            self._pending[batch_id] = slot
            self._last_progress = time.time()
            return tasks

    def put_result(self, task_id: int, result: Any) -> None:
        with self._lock:
            batch_id = self._task_to_batch.pop(task_id)
            self._pending[batch_id][task_id] = result
            self._last_progress = time.time()

    def pop_ready(self) -> Optional[dict]:
        """Release the oldest batch iff complete (strict FIFO per client)."""
        with self._lock:
            if not self._pending:
                return None
            oldest = min(self._pending)
            slot = self._pending[oldest]
            if any(v is None for v in slot.values()):
                return None
            del self._pending[oldest]
            parts = [slot[tid] for tid in sorted(slot)]
            return merge_output_dicts(parts)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._pending)

    def check_stall(self) -> None:
        with self._lock:
            if self._pending and time.time() - self._last_progress > self.stall_secs:
                self.on_stall(
                    f"[batcher] stalled {self.stall_secs}s; pending batches: "
                    f"{ {b: sum(v is not None for v in s.values()) for b, s in self._pending.items()} }"
                )
                self._last_progress = time.time()
