"""WM-server wire protocol: 4-byte big-endian length + pickle payload.

The port's own copy of `wiw_tpu/serve/protocol.py`: the request and output
contracts, socket framing (client <-> manager), pipe/stdin framing
(manager <-> worker) and the protocol-5 fast path for large arrays. The
bytes on the wire are the same, so either package's clients, managers and
workers talk to the other's.
"""

from __future__ import annotations

import io
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


_SERVER_KEYS = {
    "world_model": ["b_action", "save_dirs", "request_model_name"],
    "sam2": ["bbox_coords", "save_dirs", "pred_frames"],
    "gd_sam2": ["save_dirs"],
}


def _check_array(v, extra_types=()):
    ok = isinstance(v, np.ndarray) or isinstance(v, tuple(
        t for t in extra_types if isinstance(t, type)))
    if not ok and list in extra_types and isinstance(v, list):
        ok = True
    if not ok:
        raise TypeError(f"expected ndarray/list, got {type(v)}")


def check_inputdict(input_dict: dict, server_type: str = "world_model") -> None:
    if server_type not in _SERVER_KEYS:
        raise ValueError(f"Unknown server_type: {server_type}")
    if not isinstance(input_dict, dict):
        raise TypeError(f"input must be dict, got {type(input_dict)}")
    missing = [k for k in _SERVER_KEYS[server_type] if k not in input_dict]
    if missing:
        raise KeyError(f"Missing required keys: {missing}. "
                       f"Required: {_SERVER_KEYS[server_type]}")
    for k, v in input_dict.items():
        if k in ("b_image", "pred_frames"):
            _check_array(v)
        elif k == "b_action":
            _check_array(v, (np.int64, list))
        elif k == "save_dirs":
            if not (isinstance(v, list) and all(isinstance(d, str) for d in v)):
                raise TypeError(f"save_dirs must be list[str], got {v!r}")
        elif k == "return_objects":
            if not (isinstance(v, list) and all(isinstance(d, bool) for d in v)):
                raise TypeError(f"return_objects must be list[bool], got {v!r}")


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


def write_framed(sock, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exactly(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(CHUNK, n - len(buf)))
        if not chunk:
            raise EOFError("socket closed mid-frame")
        buf += chunk
    return bytes(buf)


def read_framed(sock) -> Any:
    (length,) = struct.unpack(">I", _recv_exactly(sock, 4))
    _check_frame_length(length, "read_framed")
    return _loads_compat(_recv_exactly(sock, length))


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


def dumps_fast(obj: Any) -> bytes:
    """Pickle protocol 5 with the out-of-band buffers after the pickle:
    [4B npickle][pickle]([8B nbytes][buffer])*."""
    buffers: list[pickle.PickleBuffer] = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    out = io.BytesIO()
    out.write(struct.pack(">I", len(payload)))
    out.write(payload)
    for b in buffers:
        raw = b.raw()
        out.write(struct.pack(">Q", raw.nbytes))
        out.write(raw)
    return out.getvalue()


def loads_fast(data: bytes) -> Any:
    view = memoryview(data)
    (plen,) = struct.unpack(">I", view[:4])
    payload = view[4:4 + plen]
    buffers = []
    off = 4 + plen
    while off < len(view):
        (blen,) = struct.unpack(">Q", view[off:off + 8])
        off += 8
        buffers.append(view[off:off + blen])
        off += blen
    return pickle.loads(payload, buffers=buffers)
