"""Worker SDK: `worker_main` for out-of-process workers.

The port's own copy of `wiw_tpu/serve/worker.py`: a background thread
drains framed tasks from stdin into a queue (terminating the process if the
backlog exceeds `max_backlog`); the main loop pops (client_id, task_id,
payload), runs `task_fn`, validates the output contract, and writes the
framed result to the pipe fd passed as the last argv.
"""

from __future__ import annotations

import os
import queue
import signal
import sys
import threading
from typing import Callable

from wiw_tpu_torch.serve.protocol import (
    check_outputdict,
    read_pickled_fd,
    write_pickled_fd,
)


def worker_main(pipe_fd: int, task_fn: Callable[[dict], dict],
                max_backlog: int = 200, validate: bool = True) -> None:
    inbox: "queue.Queue" = queue.Queue()

    def receiver():
        stdin_fd = sys.stdin.fileno()
        while True:
            try:
                msg = read_pickled_fd(stdin_fd, watchdog_secs=1e9)
            except (EOFError, OSError):
                inbox.put(None)
                return
            if inbox.qsize() > max_backlog:
                # backlog bomb: end the process so the manager notices
                print(f"[worker] backlog > {max_backlog}; terminating",
                      flush=True)
                os.kill(os.getpid(), signal.SIGTERM)
                return
            inbox.put(msg)

    threading.Thread(target=receiver, daemon=True).start()

    while True:
        msg = inbox.get()
        if msg is None:
            return
        client_id, task_id, payload = msg
        try:
            result = task_fn(payload)
            if validate:
                check_outputdict(result)
        except Exception as e:  # the worker keeps serving; the client sees the error
            result = {"error": repr(e), "save_dirs": payload.get("save_dirs", [])}
        write_pickled_fd(pipe_fd, (client_id, task_id, result))


def main_from_argv(task_fn: Callable[[dict], dict]) -> None:
    """Entry helper: the manager passes the pipe write-fd as the last argv."""
    worker_main(int(sys.argv[-1]), task_fn)
