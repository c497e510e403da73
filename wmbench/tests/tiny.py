"""Tiny configurations of the benchmark's cells for CPU tests: every width
cut so that the served path, the training step and the reference run in
seconds on the host. Not collected as tests."""

from __future__ import annotations

import copy
import json
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name: str) -> dict:
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    c["unet"].update(block_out_channels=[32, 64], num_attention_heads=[1, 2],
                     cross_attention_dim=32, num_frames=3, action_input_channel=3)
    c["vae"].update(block_out_channels=[32, 32], layers_per_block=1)
    c["clip"].update(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
                     projection_dim=32)
    c["generation"].update(height=16, width=32, num_frames=3, num_inference_steps=4,
                           out_height=8, out_width=8)
    if "train" in c:
        c["unet"]["remat"] = False
    return c


def ctx(name: str, traffic: dict, seed: int = 5, seconds: float = 4.0,
        end_to_end=(), per_layer=(), trace: int = 0):
    import time

    return types.SimpleNamespace(
        args=types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace),
        cell={"chips": 1}, config=config(name), traffic=traffic, device="cpu",
        t_process=time.perf_counter(), end_to_end=list(end_to_end),
        per_layer=dict(per_layer))
