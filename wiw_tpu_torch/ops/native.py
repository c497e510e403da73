"""Build and load the hand-written CUDA kernels of `wiw_tpu_torch/csrc`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with nvcc
for sm_90a into `wiw_tpu_torch/_build/<name>-<digest>.so` at first use, then
loaded with ctypes. The digest covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited kernel or header rebuilds and a
built one is reused. `load_libraries` runs one nvcc
per source, all at once. Nothing here runs at import.

Two rules every kernel wrapper shares live here too: `on_cpu` (CPU tensors
take the plain version) and `recompute_backward` (a kernel without a
backward kernel is differentiated through its plain version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of csrc/, by library name
LIBRARIES = ("flash_attn_fwd", "flash_attn_bwd", "temporal_attn", "geglu_ffn",
             "group_norm", "w8a8", "flash_attn_i8")

_loaded: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent in nvcc, 0.0 when reused; ptxas report)
build_info: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "wiw_tpu_torch are built from source at first use")
    return found


def _target(name: str) -> Path:
    """The library's path: its name and a digest of the source, every
    shared header in `CSRC` (a `.cu` may include any of them) and the
    flags, so that an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Compile each `csrc/<name>.cu` that is not built yet, one nvcc per
    source, all started together, and return the loaded libraries."""
    todo = [n for n in dict.fromkeys(names)
            if n not in _loaded and not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, time.perf_counter(), subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, t0, proc) in jobs.items():
            log = proc.communicate()[0]
            build_info[name] = (time.perf_counter() - t0, log.strip())
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, _target(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, _, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    for name in names:
        if name not in _loaded:
            build_info.setdefault(name, (0.0, ""))
            _loaded[name] = ctypes.CDLL(str(_target(name)))
    return [_loaded[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    lib = _loaded.get(name)
    return lib if lib is not None else load_libraries(name)[0]


def on_cpu(*ts: torch.Tensor) -> bool:
    """Whether every operand lies on the CPU, where a wrapper computes its
    kernel's plain version."""
    return all(t.device.type == "cpu" for t in ts)


def recompute_backward(ctx, plain, grad: torch.Tensor, *args) -> list:
    """The backward of an autograd Function whose forward ran a kernel and
    saved only its tensor inputs: recompute `plain(*saved, *args)` with
    autograd and return the gradient of each saved input that needs one
    (None for the others)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = plain(*inputs, *args)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return [next(grads) if t.requires_grad else None for t in inputs]
