"""Joining the process group of a multi-process run.

Port of `wiw_tpu/parallel/multihost.py` on torch.distributed: one process
a device. `python -m torch.distributed.run` gives each process RANK,
WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/MASTER_PORT; `init_method` names a
rendezvous of one's own (a `file://` path or `tcp://host:port`, with
`world_size` and `rank`). The backend is NCCL for a CUDA device and gloo
for the CPU.

Where the reference skips a failed init and runs on one host
(`multihost.py:36-37`), this raises: a run that was asked to join a group
and cannot must not train alone.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(device: str = "cuda", init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: Optional[datetime.timedelta] = None) -> dict:
    """Join the process group the launcher's environment (or
    `init_method`) describes, once; without either, a single process with
    no group. Returns the reference's dict: process_index, process_count,
    local_devices (one a process) and global_devices."""
    device = torch.device(device)
    asked = init_method is not None or "WORLD_SIZE" in os.environ
    if asked and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        kw = {} if timeout is None else {"timeout": timeout}
        try:
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=init_method, world_size=world_size or -1,
                rank=-1 if rank is None else rank, **kw)
        except Exception as e:
            raise RuntimeError(
                f"joining the process group failed ({e!r}); refusing to run "
                "as a single process") from e
    n = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": n, "local_devices": 1, "global_devices": n}


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
