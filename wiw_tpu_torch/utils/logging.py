"""Process logging: tee stdout/stderr/warnings to per-process log files.

Behavioral parity (no code copied) with downstream/utils/logger.py:20-70:
every long-running process (manager, workers, solvers) calls
`setup_logger(exp_id, role)` and gets its streams mirrored to
<log_root>/<exp_id>/<role>_<pid>.log while still printing to the console.

The port's own copy of `wiw_tpu/utils/logging.py`; `log_worker_identity`
and `become_deterministic` are written on torch.
"""

from __future__ import annotations

import datetime
import os
import sys
import warnings


class _Tee:
    def __init__(self, stream, logfile):
        self.stream = stream
        self.logfile = logfile

    def write(self, data):
        self.stream.write(data)
        self.logfile.write(data)
        self.logfile.flush()

    def flush(self):
        self.stream.flush()
        self.logfile.flush()

    def fileno(self):
        return self.stream.fileno()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()


def setup_logger(exp_id: str, role: str, log_root: str = "logs") -> str:
    """Tee stdout/stderr (and warnings) into a per-process file; returns
    the log path."""
    os.makedirs(os.path.join(log_root, exp_id), exist_ok=True)
    stamp = datetime.datetime.now().strftime("%m%d_%H%M%S")
    path = os.path.join(log_root, exp_id, f"{role}_{os.getpid()}_{stamp}.log")
    f = open(path, "a", buffering=1)
    sys.stdout = _Tee(sys.__stdout__, f)
    sys.stderr = _Tee(sys.__stderr__, f)
    capture_warnings()
    print(f"[logger] {role} pid={os.getpid()} -> {path}")
    return path


def capture_warnings() -> None:
    """Route `warnings` through the (teed) stderr stream so they land in
    the per-process log (setup_warning_and_package_logging role,
    utils/logger.py:92-110)."""
    warnings.simplefilter("default")

    def _handler(message, category, filename, lineno, file=None, line=None):
        sys.stderr.write(
            warnings.formatwarning(message, category, filename, lineno, line)
        )

    warnings.showwarning = _handler


def log_args_and_env(args) -> None:
    """Dump the run's arguments plus the environment facts that change
    results (log_args_and_env role, utils/logger.py:113-120)."""
    import json

    cfg = vars(args) if hasattr(args, "__dict__") else dict(args)
    print("[args] " + json.dumps(cfg, default=str, sort_keys=True))
    keys = ("CUDA_VISIBLE_DEVICES", "WIW_QUANT", "WIW_CFG", "WIW_FUSED_FF",
            "WIW_FUSED_FF_GATE", "WIW_TEMPORAL_ATTN")
    env = {k: os.environ.get(k) for k in keys if os.environ.get(k)}
    print("[env] " + json.dumps(env, sort_keys=True))


def log_worker_identity() -> None:
    """Print the process's device placement (log_worker_identity role,
    utils/logger.py:148): each CUDA device torch sees, else the CPU."""
    import torch

    if torch.cuda.is_available():
        devs = ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                         for i in range(torch.cuda.device_count()))
    else:
        devs = "cpu"
    print(f"[worker] pid={os.getpid()} devices=[{devs}]")


def become_deterministic(seed: int = 0):
    """Seed python, numpy and torch (every device) and return a CPU
    `torch.Generator` seeded with `seed` (utils/util.py:245-266's role)."""
    import random as _random

    import numpy as _np
    import torch

    _random.seed(seed)
    _np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
