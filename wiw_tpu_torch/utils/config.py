"""Typed configuration system: one source of truth for model / server /
solver / deployment settings.

Replaces the reference's scattered config surfaces (SURVEY.md section 5
"Config / flag system"): the hard-coded per-host COMMON_ARGS table
(workers_cfg.py:5-241), the wm_type registry dict (vlm.py:27-33) + if/elif
ladder (worker_manager.py:732-758), exp_id substring sniffing
(solver_base.py:86-104), and ad-hoc argparse defaults — with dataclasses
loadable from JSON and overridable via `--key=value` CLI tokens
(the manager's unknown-flag forwarding, parser_additions.py parity).

The port's own copy of `wiw_tpu/utils/config.py` (it imports no JAX).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

# wm_type registry (vlm.py:27-33 + workers_cfg.py:21-241):
# name -> (imagination mode, worker module, default resolution); the SVD
# worlds and NWM run the port's workers, the zoo keeps its torch-ecosystem
# workers
WM_REGISTRY: Dict[str, dict] = {
    "igenex": {"mode": "action",
               "worker": "wiw_tpu_torch.workers.svd_action",
               "width": 1024, "height": 576},
    "igenex_manip": {"mode": "action",
                     "worker": "wiw_tpu_torch.workers.svd_action",
                     "width": 448, "height": 448,
                     "action_input_channel": 10},
    "svd": {"mode": "image", "worker": "wiw_tpu_torch.workers.svd_zero_shot",
            "width": 1024, "height": 576},
    "GTsim": {"mode": "GTsim", "worker": None},
    # torch/TF-ecosystem zoo workers (SURVEY.md 2.4): concrete subprocess
    # worker modules speaking the framed-pipe protocol; launched inside the
    # model's own env via worker.extra['python'] when that env differs
    "cosmos20": {"mode": "text", "worker": "wiw_tpu.workers.zoo.cosmos_worker"},
    "FTcosmos": {"mode": "text", "worker": "wiw_tpu.workers.zoo.cosmos_worker"},
    "cosmos25": {"mode": "text",
                 "worker": "wiw_tpu.workers.zoo.cosmos25_worker"},
    "ltx": {"mode": "text", "worker": "wiw_tpu.workers.zoo.ltx_worker"},
    "FTltx": {"mode": "text", "worker": "wiw_tpu.workers.zoo.ltx_worker"},
    "hunyuan": {"mode": "text", "worker": "wiw_tpu.workers.zoo.hunyuan_worker"},
    "wan21": {"mode": "text", "worker": "wiw_tpu.workers.zoo.wan_worker"},
    "wan22": {"mode": "text", "worker": "wiw_tpu.workers.zoo.wan_worker",
              "flags": {"variant": "wan22"}},
    "FTwan21": {"mode": "text",
                "worker": "wiw_tpu.workers.zoo.wan_diffsynth_worker"},
    "FTwan22": {"mode": "text",
                "worker": "wiw_tpu.workers.zoo.wan_diffsynth_worker"},
    "FTwan22-14B": {"mode": "text",
                    "worker": "wiw_tpu.workers.zoo.wan_diffsynth_worker"},
    "nwm": {"mode": "text", "worker": "wiw_tpu_torch.workers.nwm_worker",
            "width": 224, "height": 224},
    "se3ds": {"mode": "camera", "worker": "wiw_tpu.workers.zoo.se3ds_worker"},
    "pathdreamer": {"mode": "camera",
                    "worker": "wiw_tpu.workers.zoo.se3ds_worker",
                    "flags": {"variant": "pathdreamer"}},
    # commercial API world model (the reference references a runway worker
    # it never shipped, SURVEY.md 2.10)
    "gen4tur": {"mode": "text", "worker": "wiw_tpu.workers.zoo.runway_worker"},
    # 3D-Diffuser-Actor proposal policy for the manip diff-* arms
    # (diff_planner.py:29-108 runs it in-process; here it is an external
    # torch worker behind the pipe protocol, manip/policy.py)
    "diff_policy": {"mode": "policy",
                    "worker": "wiw_tpu.workers.diff_policy"},
}

OUT_WIDTH_DEFAULT = 480  # workers_cfg.py:14-16
OUT_HEIGHT_DEFAULT = 480


# post-trained text-WM family: pano-path imagination like 'action'
# (WORLD_MODEL_TYPES['FTtext'], vlm.py:27-33; imagine_by_model_type puts
# 'FTtext' on the pano branch, solver_base.py:703)
FTTEXT_MODELS = frozenset(
    {"FTcosmos", "FTltx", "FTwan21", "FTwan22", "FTwan22-14B"})


def solver_world_model_type(wm_name: str) -> str:
    """Model name -> the solver's imagination category
    ('action' | 'FTtext' | 'text' | 'camera' | 'GTsim'), the
    WORLD_MODEL_TYPES table's role (vlm.py:27-33). '' when unknown."""
    if wm_name in FTTEXT_MODELS:
        return "FTtext"
    entry = WM_REGISTRY.get(wm_name)
    if not entry:
        return ""
    return {"action": "action", "text": "text", "image": "text",
            "camera": "camera", "GTsim": "GTsim"}.get(entry["mode"], "")


def detect_wm_type_from_exp_id(exp_id: str) -> str:
    """Auto-detect the world-model name from `_<model>` tokens in the
    experiment id (solver_base.py:84-103 set_world_model_type parity):
    scans WM_REGISTRY keys, raises on an ambiguous id, returns '' when
    nothing matches (callers pick their default)."""
    hits = sorted({name for name in WM_REGISTRY
                   if f"_{name}" in exp_id})
    # a longer name containing a shorter one (wan22 vs wan22-14B,
    # igenex vs igenex_manip) is a single intent, not an ambiguity
    hits = [h for h in hits
            if not any(o != h and h in o for o in hits)]
    if len(hits) > 1:
        raise ValueError(
            f"ambiguous world-model types in exp_id {exp_id!r}: {hits}; "
            "pass --wm_type explicitly")
    return hits[0] if hits else ""


@dataclasses.dataclass
class WorkerConfig:
    wm_type: str = "igenex"
    num_workers: int = 1
    devices: Optional[List[int]] = None  # TPU/GPU ordinals, round-robin
    unet_path: str = ""
    svd_path: str = ""
    out_width: int = OUT_WIDTH_DEFAULT
    out_height: int = OUT_HEIGHT_DEFAULT
    batch_size: int = 1
    max_batch: int = 8  # continuous micro-batching admission cap
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 7000  # WM manager default; sam2 6001, gd_sam2 6002
    server_type: str = "world_model"
    worker: WorkerConfig = dataclasses.field(default_factory=WorkerConfig)


@dataclasses.dataclass
class SolverRunConfig:
    task: str = "AR"
    exp_id: str = "debug"
    world_model_type: str = ""  # derived from wm_type registry if empty
    wm_type: str = "igenex"
    wm_host: str = "127.0.0.1"
    wm_port: int = 7000
    vllm_hosts: List[str] = dataclasses.field(default_factory=list)
    worker_num: int = 1
    use_heur: bool = False
    query_num: int = 2
    look_ahead_action_num: int = 4
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolved_world_model_type(self) -> str:
        if self.world_model_type:
            return self.world_model_type
        return WM_REGISTRY.get(self.wm_type, {}).get("mode", "action")


@dataclasses.dataclass
class DeploymentConfig:
    """Per-host worker layout (replaces workers_cfg.COMMON_ARGS)."""

    servers: Dict[str, ServerConfig] = dataclasses.field(default_factory=dict)
    solver: SolverRunConfig = dataclasses.field(default_factory=SolverRunConfig)


def _apply_overrides(obj, overrides: Dict[str, str]):
    """Dotted-path overrides: {'worker.out_width': '512'} -> nested set with
    type coercion from the existing field value."""
    for key, raw in overrides.items():
        parts = key.split(".")
        node = obj
        for p in parts[:-1]:
            node = getattr(node, p)
        leaf = parts[-1]
        current = getattr(node, leaf, None)
        if isinstance(current, bool):
            val = str(raw).lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            val = int(raw)
        elif isinstance(current, float):
            val = float(raw)
        elif isinstance(current, list):
            val = raw if isinstance(raw, list) else json.loads(raw)
        else:
            val = raw
        setattr(node, leaf, val)
    return obj


def parse_extra_cli(tokens: List[str]) -> Dict[str, str]:
    """'--k=v' / '--k v' token stream -> dict (the manager forwards unknown
    flags to workers this way, worker_manager.py:716-721)."""
    out: Dict[str, str] = {}
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t.startswith("--"):
            if "=" in t:
                k, v = t[2:].split("=", 1)
                out[k] = v
            elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
                out[t[2:]] = tokens[i + 1]
                i += 1
            else:
                out[t[2:]] = "true"
        i += 1
    return out


def _from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = _from_dict(f.type, v)
        elif f.name == "worker" and isinstance(v, dict):
            v = _from_dict(WorkerConfig, v)
        elif f.name == "solver" and isinstance(v, dict):
            v = _from_dict(SolverRunConfig, v)
        elif f.name == "servers" and isinstance(v, dict):
            v = {k: _from_dict(ServerConfig, sv) for k, sv in v.items()}
        kwargs[f.name] = v
    return cls(**kwargs)


def build_worker_commands(
    worker: WorkerConfig, python: str = "python"
) -> List[tuple]:
    """[(argv, env), ...] for `num_workers` subprocess workers.

    Replaces workers_cfg.get_worldmodel_workers_cmd + set_cuda_devices
    (workers_cfg.py:244-333): per-worker device assignment round-robins
    over `devices` (CUDA_VISIBLE_DEVICES for torch workers; TPU workers
    normally run in-process instead).
    """
    import os

    spec = WM_REGISTRY.get(worker.wm_type, {})
    out = []
    for i in range(worker.num_workers):
        env = dict(os.environ)
        if worker.devices:
            dev = worker.devices[i % len(worker.devices)]
            env["CUDA_VISIBLE_DEVICES"] = str(dev)
        if "cmd" in worker.extra:  # operator escape hatch
            template = worker.extra["cmd"]
            argv = template.split() if isinstance(template, str) else list(template)
        else:
            module = spec.get("worker", "wiw_tpu_torch.workers.svd_action")
            # zoo workers usually live in their model's own env: the
            # interpreter is overridable per worker (replaces the
            # reference's hard-coded per-host python paths,
            # workers_cfg.py:21-241)
            py = worker.extra.get("python", python)
            argv = [py, "-m", module,
                    "--out_width", str(worker.out_width),
                    "--out_height", str(worker.out_height)]
            if worker.unet_path:
                argv += ["--unet_path", worker.unet_path]
            if worker.svd_path:
                argv += ["--svd_path", worker.svd_path]
            if "action_input_channel" in spec:
                argv += ["--action_input_channel", str(spec["action_input_channel"])]
            if "width" in spec:
                argv += ["--width", str(spec["width"]),
                         "--height", str(spec["height"])]
            for k, v in spec.get("flags", {}).items():
                argv += [f"--{k}", str(v)]
        for k, v in worker.extra.items():
            if k in ("cmd", "python"):
                continue
            if v is True:
                argv += [f"--{k}"]
            else:
                argv += [f"--{k}", str(v)]
        out.append((argv, env))
    return out


def load_deployment(path_or_dict, overrides: Optional[Dict[str, str]] = None
                    ) -> DeploymentConfig:
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            data = json.load(f)
    else:
        data = dict(path_or_dict)
    cfg = _from_dict(DeploymentConfig, data)
    if overrides:
        _apply_overrides(cfg, overrides)
    return cfg
