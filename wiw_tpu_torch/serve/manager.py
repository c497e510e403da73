"""WM manager server: TCP accept loop + per-client handler + executors.

Port of `wiw_tpu/serve/manager.py` (serving-plane parity with the original
manager, worker_manager.py:303-758):

  * InProcessExecutor: one process owns the card; weights stay resident;
    queued sub-tasks from ALL clients merge into micro-batches before each
    generation call.
  * ContinuousExecutor: step-level admission through
    serve/continuous.ContinuousEngine; its loop thread sets the engine's
    CUDA device and draws each request's noise from a seeded
    `torch.Generator` on that device.
  * SubprocessExecutor: protocol-compatible with worker scripts (cmd +
    [w_fd]; framed stdin tasks, framed pipe results) so heterogeneous torch
    workers (the WM zoo) can attach, with restart and replay.

Ordering guarantees match the reference: per-client FIFO batch release via
`Batcher`; sub-tasks may complete out of order across executor slots.
"""

from __future__ import annotations

import os
import queue
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from wiw_tpu_torch.serve.batcher import Batcher, merge_output_dicts, split_input_dict
from wiw_tpu_torch.serve.protocol import (
    check_inputdict,
    check_outputdict,
    read_framed,
    read_pickled_fd,
    write_framed,
    write_pickled_fd,
)


class Executor:
    """Interface: submit (client_id, task_id, input_dict); completions are
    delivered to the manager's result queue."""

    alive: bool = True

    def submit(self, client_id: int, task_id: int, payload: dict) -> None:
        raise NotImplementedError

    def start(self, result_queue: "queue.Queue") -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def accepts(self, payload: dict) -> bool:
        """Shape/bucket routing hook: dispatch only offers this executor
        payloads it accepts (default: everything). Lets per-bucket
        continuous engines coexist behind one manager."""
        return True


class InProcessExecutor(Executor):
    """Micro-batching over an in-process task function.

    `task_fn(input_dict) -> output_dict` runs merged micro-batches of up to
    `max_batch` items. The loop drains whatever is queued (across clients)
    at each step — new requests admit at the next generation call without
    waiting for stragglers.
    """

    def __init__(self, task_fn: Callable[[dict], dict], max_batch: int = 8):
        self.task_fn = task_fn
        self.max_batch = max_batch
        self._inbox: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pending = 0
        # submit() runs on client-handler threads while _loop decrements on
        # the executor thread; unlocked += would let the counter drift and
        # skew least-pending dispatch and __stats__.
        self._pending_lock = threading.Lock()

    def start(self, result_queue):
        self._results = result_queue
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, client_id, task_id, payload):
        with self._pending_lock:
            self.pending += 1
        self._inbox.put((client_id, task_id, payload))

    def stop(self):
        self._stop.set()

    def _drain(self) -> List[tuple]:
        items = []
        try:
            items.append(self._inbox.get(timeout=0.05))
        except queue.Empty:
            return items
        # admit whatever else is already queued, up to max_batch items
        while len(items) < self.max_batch:
            try:
                items.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        return items

    def _loop(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            sizes = [len(p["save_dirs"]) for _, _, p in items]
            merged = merge_output_dicts([p for _, _, p in items]) if len(items) > 1 \
                else items[0][2]
            try:
                out = self.task_fn(merged)
                outs = split_input_dict(out, 1)  # per-item split
                # regroup per original sub-task sizes
                idx = 0
                for (cid, tid, _), n in zip(items, sizes):
                    part = merge_output_dicts(outs[idx : idx + n])
                    idx += n
                    with self._pending_lock:
                        self.pending -= 1
                    self._results.put((cid, tid, part))
            except Exception:
                # error isolation: one bad item must not fail co-batched
                # clients (reference isolates per sub-task; the merged
                # micro-batch is our optimization, so unmerge on failure
                # and run each sub-task alone, reporting its own error)
                for cid, tid, payload in items:
                    with self._pending_lock:
                        self.pending -= 1
                    try:
                        self._results.put((cid, tid, self.task_fn(payload)))
                    except Exception as e:
                        self._results.put(
                            (cid, tid, {"error": repr(e), "save_dirs": []}))


class ContinuousExecutor(Executor):
    """Step-level continuous batching executor: each request item claims a
    denoise slot; new items join BETWEEN Euler steps (no head-of-line
    blocking). Wraps serve/continuous.ContinuousEngine behind the same
    submit/complete surface as the other executors.

    `encode_item(payload, index)` -> (image [H,W,3], actions or None);
    `postprocess(video_01)` -> uint8 [T, C, H, W] per item.
    """

    def __init__(self, engine, encode_item: Callable, postprocess: Callable,
                 bucket: Optional[tuple] = None):
        self.engine = engine
        self.encode_item = encode_item
        self.postprocess = postprocess
        # (height, width) this engine generates at; None = accept anything
        self.bucket = bucket
        self._inbox: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.pending = 0
        self._pending_lock = threading.Lock()
        self._seed = 0
        # server-side phase attribution (seconds, cumulative, host clock):
        # encode = conditioning CLIP/VAE-encode dispatch, engine = denoise
        # ticks + async-decode harvest, post = host postprocess
        self.phase_s = {"encode": 0.0, "engine": 0.0, "post": 0.0}

    def start(self, result_queue):
        self._results = result_queue
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, client_id, task_id, payload):
        with self._pending_lock:
            self.pending += 1
        self._inbox.put((client_id, task_id, payload))

    def stop(self):
        self._stop.set()

    def accepts(self, payload: dict) -> bool:
        """Bucket routing: requests carrying extra['gen_size'] = [H, W] go
        to the matching engine; unsized requests go to the default-bucket
        executor (bucket=None accepts everything)."""
        if self.bucket is None:
            return True
        size = (payload.get("extra") or {}).get("gen_size")
        if size is None:
            return getattr(self, "is_default", False)
        return tuple(size) == tuple(self.bucket)

    def _loop(self):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        # request_id -> (cid, tid, item_idx); tid -> bookkeeping
        rid_map = {}
        task_state: Dict[tuple, dict] = {}
        waiting = []  # items waiting for a slot
        while not self._stop.is_set():
            # 1. pull new tasks (non-blocking after the first)
            try:
                block = not waiting and not rid_map
                item = self._inbox.get(timeout=0.05 if block else 0.0)
                cid, tid, payload = item
                n = len(payload["save_dirs"])
                task_state[(cid, tid)] = {
                    "payload": payload, "remaining": n, "videos": [None] * n,
                }
                for i in range(n):
                    waiting.append((cid, tid, i))
            except queue.Empty:
                pass
            # 2. admit as many waiting items as there are free slots
            admitted = []
            for cid, tid, i in waiting:
                payload = task_state[(cid, tid)]["payload"]
                try:
                    t_enc = time.perf_counter()
                    image, actions = self.encode_item(payload, i)
                    self._seed += 1
                    rid = self.engine.admit(
                        image, actions, torch.Generator(
                            device=self.engine.device).manual_seed(self._seed))
                    self.phase_s["encode"] += time.perf_counter() - t_enc
                except Exception as e:
                    # per-item error isolation: a malformed item (e.g. a
                    # bucket-mismatched image) fails alone
                    task_state[(cid, tid)]["videos"][i] = e
                    task_state[(cid, tid)]["remaining"] -= 1
                    admitted.append((cid, tid, i))
                    continue
                if rid is None:
                    break  # pool full; retry next tick
                rid_map[rid] = (cid, tid, i)
                admitted.append((cid, tid, i))
            for a in admitted:
                waiting.remove(a)
            # 3. one engine tick
            t_eng = time.perf_counter()
            finished = self.engine.step() if rid_map else {}
            self.phase_s["engine"] += time.perf_counter() - t_eng
            for rid, video in finished.items():
                cid, tid, i = rid_map.pop(rid)
                ts = task_state[(cid, tid)]
                t_post = time.perf_counter()
                ts["videos"][i] = self.postprocess(video)
                self.phase_s["post"] += time.perf_counter() - t_post
                ts["remaining"] -= 1
            # 4. deliver completed tasks
            for key in [k for k, ts in task_state.items() if ts["remaining"] == 0]:
                cid, tid = key
                ts = task_state.pop(key)
                errs = [v for v in ts["videos"] if isinstance(v, Exception)]
                with self._pending_lock:
                    self.pending -= 1
                if errs:
                    self._results.put((cid, tid, {
                        "error": repr(errs[0]), "save_dirs": [],
                    }))
                else:
                    self._results.put((cid, tid, {
                        "save_dirs": list(ts["payload"]["save_dirs"]),
                        "pred_frames": np.stack(ts["videos"]),
                    }))


class SubprocessExecutor(Executor):
    """One worker subprocess speaking the reference pipe protocol.

    Launch: cmd + [str(w_fd)] with stdin=PIPE and the write-end fd passed
    through; tasks go down stdin as framed (client_id, task_id, payload);
    results come back on the pipe (worker_manager.py:303-346).
    """

    def __init__(self, cmd: List[str], env: Optional[dict] = None,
                 restart_on_death: bool = False, max_restarts: int = 2):
        self.cmd = cmd
        self.env = env
        self.pending = 0
        self._lock = threading.Lock()
        # elastic recovery (beyond the reference, which logs + removes the
        # dead fd and tells the operator to restart manually,
        # worker_manager.py:369-379 / docs/09:36): relaunch the subprocess
        # and RESUBMIT its in-flight tasks so no client hangs
        self.restart_on_death = restart_on_death
        self.max_restarts = max_restarts
        self._restarts = 0
        self._stopping = False
        self._inflight: Dict[tuple, dict] = {}

    def start(self, result_queue):
        self._results = result_queue
        r_fd, w_fd = os.pipe()
        os.set_inheritable(w_fd, True)
        self.proc = subprocess.Popen(
            self.cmd + [str(w_fd)],
            stdin=subprocess.PIPE,
            pass_fds=(w_fd,),
            env=self.env,
        )
        os.close(w_fd)
        self.r_fd = r_fd
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def submit(self, client_id, task_id, payload):
        with self._lock:
            self.pending += 1
            self._inflight[(client_id, task_id)] = payload
            write_pickled_fd(self.proc.stdin.fileno(), (client_id, task_id, payload))
            self.proc.stdin.flush()

    def _read_loop(self):
        while True:
            try:
                cid, tid, result = read_pickled_fd(self.r_fd, watchdog_secs=1e9)
            except (EOFError, OSError):
                if (self.restart_on_death and not self._stopping
                        and self._restarts < self.max_restarts):
                    self._restart()
                    return  # the relaunch spawned a fresh reader thread
                # dead worker: mark unavailable so dispatch skips it
                # (the reference logs + removes the fd,
                # worker_manager.py:369-379); the manager keeps serving on
                # the remaining executors
                self.alive = False
                print(f"[manager] worker died: {self.cmd}", flush=True)
                break
            with self._lock:
                self.pending -= 1
                self._inflight.pop((cid, tid), None)
            self._results.put((cid, tid, result))

    def _restart(self):
        """Relaunch the worker and replay its in-flight tasks."""
        with self._lock:
            self._restarts += 1
            print(f"[manager] worker died, restarting "
                  f"({self._restarts}/{self.max_restarts}): {self.cmd}",
                  flush=True)
            try:
                os.close(self.r_fd)
            except OSError:
                pass
            try:
                self.proc.kill()
                self.proc.wait(timeout=5)
            except Exception:
                pass
            self.start(self._results)
            for (cid, tid), payload in list(self._inflight.items()):
                write_pickled_fd(self.proc.stdin.fileno(),
                                 (cid, tid, payload))
            self.proc.stdin.flush()

    def stop(self):
        # Reap hard: a lingering child holds the inherited stdout/stderr
        # pipes open, which blocks pytest's output-capture teardown (the
        # round-1 suite hang). terminate -> wait -> kill -> wait.
        self._stopping = True  # shutdown EOF must not trigger a restart
        try:
            self.proc.stdin.close()
        except Exception:
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=5)
        except Exception:
            try:
                self.proc.kill()
                self.proc.wait(timeout=5)
            except Exception:
                pass
        try:
            os.close(self.r_fd)
        except Exception:
            pass


class ManagerServer:
    """TCP server: framed request batches in, framed result batches out."""

    def __init__(
        self,
        executors: List[Executor],
        host: str = "127.0.0.1",
        port: int = 7000,
        batch_size: int = 1,
        server_type: str = "world_model",
        auto_increment_port: bool = True,
    ):
        self.executors = executors
        self.host = host
        self.port = port
        self.batch_size = batch_size
        self.server_type = server_type
        self.auto_increment_port = auto_increment_port
        self._results: "queue.Queue" = queue.Queue()
        self._clients: Dict[int, "ClientHandler"] = {}
        self._next_client = 0
        self._stop = threading.Event()
        # observability (the reference has none, SURVEY.md section 5):
        # per-request latency + counters, queryable in-band via
        # {"__stats__": True}
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "items": 0, "errors": 0,
            "latency_sum": 0.0, "latency_max": 0.0,
        }

    def record_latency(self, seconds: float, items: int, error: bool = False):
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["items"] += items
            self.stats["latency_sum"] += seconds
            self.stats["latency_max"] = max(self.stats["latency_max"], seconds)
            if error:
                self.stats["errors"] += 1

    def get_stats(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
        s["latency_avg"] = s["latency_sum"] / max(s["requests"], 1)
        s["pending"] = sum(e.pending for e in self.executors)
        s["workers_alive"] = sum(1 for e in self.executors if e.alive)
        s["worker_restarts"] = sum(
            getattr(e, "_restarts", 0) for e in self.executors)
        return s

    # ------------------------------------------------------------------
    def start(self) -> int:
        """Bind (auto-incrementing the port if busy, like
        init_worldmodel_manager.sh:37-53), start executors + router.
        Returns the bound port."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        port = self.port
        while True:
            try:
                self._sock.bind((self.host, port))
                break
            except OSError:
                if not self.auto_increment_port:
                    raise
                port += 1
        self.port = port
        self._sock.listen(64)
        for ex in self.executors:
            ex.start(self._results)
        self._router = threading.Thread(target=self._route_loop, daemon=True)
        self._router.start()
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()
        return port

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except Exception:
            pass
        for ex in self.executors:
            ex.stop()

    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            cid = self._next_client
            self._next_client += 1
            handler = ClientHandler(cid, conn, self)
            self._clients[cid] = handler
            handler.start()

    def _route_loop(self):
        """Single global router: executor completions -> client batchers
        (the reference's receiver_thread, worker_manager.py:352-389)."""
        while not self._stop.is_set():
            try:
                cid, tid, result = self._results.get(timeout=0.1)
            except queue.Empty:
                continue
            handler = self._clients.get(cid)
            if handler is not None:
                handler.deliver(tid, result)

    def dispatch(self, client_id: int, task_id: int, payload: dict):
        """Least-pending dispatch across live executors that accept the
        payload's bucket (worker_manager.py:555-570 + shape routing)."""
        live = [e for e in self.executors if e.alive]
        if not live:
            self._results.put((client_id, task_id,
                               {"error": "no live workers", "save_dirs": []}))
            return
        eligible = [e for e in live if e.accepts(payload)]
        if not eligible:
            self._results.put((client_id, task_id, {
                "error": "no worker accepts this request's generation "
                         "bucket; start the manager with a matching "
                         "--buckets entry",
                "save_dirs": [],
            }))
            return
        ex = min(eligible, key=lambda e: e.pending)
        ex.submit(client_id, task_id, payload)


class ClientHandler(threading.Thread):
    def __init__(self, client_id: int, conn: socket.socket, server: ManagerServer):
        super().__init__(daemon=True)
        self.client_id = client_id
        self.conn = conn
        self.server = server
        self.batcher = Batcher(batch_size=server.batch_size)
        self._send_lock = threading.Lock()
        self._recv_times: Dict[int, float] = {}
        self._batch_counter = 0

    def run(self):
        try:
            while True:
                input_dict = read_framed(self.conn)
                if isinstance(input_dict, dict) and input_dict.get("__stats__"):
                    with self._send_lock:
                        write_framed(self.conn, self.server.get_stats())
                    continue
                check_inputdict(input_dict, self.server.server_type)
                self._recv_times[self._batch_counter] = time.time()
                self._batch_counter += 1
                for tid, sub in self.batcher.split_batch(input_dict):
                    self.server.dispatch(self.client_id, tid, sub)
        except (EOFError, OSError):
            pass
        finally:
            self.server._clients.pop(self.client_id, None)
            try:
                self.conn.close()
            except Exception:
                pass

    def deliver(self, task_id: int, result: dict):
        self.batcher.put_result(task_id, result)
        while True:
            ready = self.batcher.pop_ready()
            if ready is None:
                break
            try:
                check_outputdict(ready)
            except Exception:
                pass  # surface malformed worker output to the client as-is
            sent_batch = min(self._recv_times) if self._recv_times else None
            if sent_batch is not None:
                t0 = self._recv_times.pop(sent_batch)
                self.server.record_latency(
                    time.time() - t0, len(ready.get("save_dirs", [])),
                    error="error" in ready,
                )
            with self._send_lock:
                try:
                    write_framed(self.conn, ready)
                except OSError:
                    return


class WMClient:
    """Solver-side client (parity: solver_base.connect_to_WM_server /
    send_batch_to_server, solver_base.py:645-688)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7000,
                 server_type: str = "world_model"):
        self.addr = (host, port)
        self.server_type = server_type
        self._sock: Optional[socket.socket] = None

    def connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr)
        return self

    def send_batch(self, input_dict: dict) -> dict:
        check_inputdict(input_dict, self.server_type)
        self.connect()
        write_framed(self._sock, input_dict)
        return read_framed(self._sock)

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None
