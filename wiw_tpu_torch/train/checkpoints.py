"""Checkpoint save/restore with keep-limit pruning and resume.

Port of `wiw_tpu/train/checkpoints.py`, with the same layout and rules:
  * each save goes to <root>/checkpoint-<step>
  * keep-limit pruning, oldest first
  * restore the latest step, or an explicit one
The state is any nested structure of tensors and Python values (the
trainer's: model, optimizer, EMA and step), written with `torch.save` into
`checkpoint-<step>/state.pt`: the port's own format, not Orbax.

`async_save=True` overlaps the disk write with the next train steps: the
device-to-host snapshot is synchronous (every tensor copied to host memory
before `save` returns, so later in-place updates cannot reach it), the
`torch.save` runs on a background thread. A later save(), wait() or
restore() joins the write in flight first; with async saves the keep limit
is enforced at each save()'s join point, so disk never holds more than
total_limit + 1 checkpoints.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
import threading
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _ckpt_steps(root: str):
    if not osp.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and osp.isfile(osp.join(root, name, STATE_FILE)):
            out.append(int(m.group(1)))
    return sorted(out)


def to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, root: str, total_limit: Optional[int] = None,
                 async_save: bool = False):
        self.root = osp.abspath(root)
        self.total_limit = total_limit
        self.async_save = async_save
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, path: str, state: Any) -> None:
        try:
            os.makedirs(path, exist_ok=True)
            tmp = osp.join(path, STATE_FILE + ".tmp")
            torch.save(state, tmp)
            os.replace(tmp, osp.join(path, STATE_FILE))
        except BaseException as e:  # surfaced at the next join
            self._error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any) -> str:
        path = osp.join(self.root, f"checkpoint-{step}")
        self._join()  # the previous write has landed
        snapshot = to_host(state)
        if self.async_save:
            self._prune()
            self._thread = threading.Thread(target=self._write,
                                            args=(path, snapshot), daemon=True)
            self._thread.start()
        else:
            self._write(path, snapshot)
            self._join()
            self._prune()
        return path

    def wait(self) -> None:
        """Block until any in-flight async save has landed, then prune."""
        self._join()
        self._prune()

    def _prune(self):
        if self.total_limit is None:
            return
        steps = _ckpt_steps(self.root)
        while len(steps) > self.total_limit:
            victim = steps.pop(0)
            shutil.rmtree(osp.join(self.root, f"checkpoint-{victim}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        self._join()
        steps = _ckpt_steps(self.root)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved state (host tensors) of `step`, or of the latest step
        when it is None."""
        self._join()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        path = osp.join(self.root, f"checkpoint-{step}", STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)
