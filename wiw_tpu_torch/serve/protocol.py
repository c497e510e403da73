"""Worker wire protocol: 4-byte big-endian length + pickle payload.

The port's own copy of the framing a worker needs from
`wiw_tpu/serve/protocol.py` (pipe/stdin framing and the output contract).
The bytes on the wire are the same, so the JAX package's manager drives a
`wiw_tpu_torch` worker unchanged.
"""

from __future__ import annotations

import os
import pickle
import struct
import time
from typing import Any

import numpy as np

CHUNK = 1 << 19  # 512 KiB reads

# Largest frame a reader accepts: legit batches top out ~200 MB of uint8
# frames, so a larger length word means a desynced or corrupt stream.
MAX_FRAME_BYTES = 1 << 31  # 2 GiB


def _check_frame_length(length: int, where: str) -> None:
    if length > MAX_FRAME_BYTES:
        raise ValueError(
            f"{where}: frame length {length} exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}) — stream desynced or corrupt")


def check_outputdict(output_dict: dict) -> None:
    pred = output_dict.get("pred_frames")
    if pred is not None and not (
            isinstance(pred, np.ndarray) and pred.dtype == np.uint8):
        raise TypeError("pred_frames must be uint8 ndarray")
    if "video_tensors" in output_dict:
        raise KeyError("'video_tensors' is not part of the output contract")
    if not isinstance(output_dict.get("save_dirs"), list):
        raise TypeError("save_dirs must be a list")


def _loads_compat(data: bytes) -> Any:
    """Unpickle with NumPy 1.x <-> 2.x module-path tolerance: old peers
    pickle arrays under numpy.core.*, new ones under numpy._core.*."""
    try:
        return pickle.loads(data)
    except ModuleNotFoundError as e:
        msg = str(e)
        if "numpy._core" in msg or "numpy.core" in msg:
            import sys

            import numpy.core as _nc

            sys.modules.setdefault("numpy._core", _nc)
            sys.modules.setdefault("numpy._core.numeric", _nc.numeric)
            sys.modules.setdefault("numpy._core.multiarray", _nc.multiarray)
            return pickle.loads(data)
        raise


def write_pickled_fd(fd: int, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(struct.pack(">I", len(data)) + data)
    while view:
        written = os.write(fd, view[: 1 << 20])
        view = view[written:]


def _read_fully_fd(fd: int, n: int, watchdog_secs: float = 300.0) -> bytes:
    buf = bytearray()
    start = time.time()
    while len(buf) < n:
        if time.time() - start > watchdog_secs:
            raise TimeoutError(
                f"fd read stalled: got {len(buf)}/{n} bytes in {watchdog_secs}s")
        chunk = os.read(fd, min(CHUNK, n - len(buf)))
        if not chunk:
            raise EOFError("fd closed mid-frame")
        buf += chunk
    return bytes(buf)


def read_pickled_fd(fd: int, watchdog_secs: float = 300.0) -> Any:
    (length,) = struct.unpack(">I", _read_fully_fd(fd, 4, watchdog_secs))
    _check_frame_length(length, "read_pickled_fd")
    return _loads_compat(_read_fully_fd(fd, length, watchdog_secs))
