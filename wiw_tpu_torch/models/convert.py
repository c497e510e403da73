"""Weight conversion between the diffusers key grammar and flax trees.

The port's modules carry diffusers/transformers parameter names, so real
checkpoints load with `load_state_dict`. This module holds a jax-free copy
of the reference's key grammar (`wiw_tpu/models/convert.py`:
`_LIST_MERGES`, `translate_key`, `convert_tensor`) and its inverse, which
turns the reference's flax parameter trees (as numpy arrays) into state
dicts for the port: `flax_to_torch(params_np)`.

Layouts: torch Conv2d [O, I, kh, kw] <-> flax [kh, kw, I, O];
Conv3d [O, I, kt, kh, kw] <-> [kt, kh, kw, I, O]; Linear [O, I] <-> [I, O];
norm weight/bias <-> scale/bias.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

# forward grammar (torch key -> flax path), applied in order
_LIST_MERGES = [
    (r"(encoder|decoder)\.down_blocks\.(\d+)\.resnets\.(\d+)",
     r"\1/down_blocks_\2_resnets_\3"),
    (r"(encoder|decoder)\.down_blocks\.(\d+)\.downsamplers\.0",
     r"\1/down_blocks_\2_downsamplers_0"),
    (r"(encoder|decoder)\.up_blocks\.(\d+)\.resnets\.(\d+)",
     r"\1/up_blocks_\2_resnets_\3"),
    (r"(encoder|decoder)\.up_blocks\.(\d+)\.upsamplers\.0",
     r"\1/up_blocks_\2_upsamplers_0"),
    (r"(encoder|decoder)\.mid_block\.resnets\.(\d+)",
     r"\1/mid_block_resnets_\2"),
    (r"(encoder|decoder)\.mid_block\.attentions\.(\d+)",
     r"\1/mid_block_attentions_\2"),
    (r"down_blocks\.(\d+)\.downsamplers\.0", r"down_blocks_\1_downsamplers_0"),
    (r"down_blocks\.(\d+)\.resnets\.(\d+)", r"down_blocks_\1/resnets_\2"),
    (r"down_blocks\.(\d+)\.attentions\.(\d+)", r"down_blocks_\1/attentions_\2"),
    (r"up_blocks\.(\d+)\.upsamplers\.0", r"up_blocks_\1_upsamplers_0"),
    (r"up_blocks\.(\d+)\.resnets\.(\d+)", r"up_blocks_\1_resnets_\2"),
    (r"up_blocks\.(\d+)\.attentions\.(\d+)", r"up_blocks_\1_attentions_\2"),
    (r"mid_block\.resnets\.(\d+)", r"mid_block_resnets_\1"),
    (r"mid_block\.attentions\.(\d+)", r"mid_block_attentions_\1"),
    (r"transformer_blocks\.(\d+)", r"transformer_blocks_\1"),
    (r"temporal_transformer_blocks_action\.(\d+)",
     r"temporal_transformer_blocks_action_\1"),
    (r"temporal_transformer_blocks\.(\d+)", r"temporal_transformer_blocks_\1"),
    (r"to_out\.0", r"to_out_0"),
    (r"ff\.net\.0\.proj", r"ff/net_0_proj"),
    (r"ff\.net\.2", r"ff/net_2"),
    (r"ff_in\.net\.0\.proj", r"ff_in/net_0_proj"),
    (r"ff_in\.net\.2", r"ff_in/net_2"),
    (r"action_proj\.layers\.(\d+)", r"action_proj/layers_\1"),
    (r"add_action_proj\.proj", r"add_action_proj/proj"),
    (r"vision_model\.embeddings\.patch_embedding", r"patch_embedding"),
    (r"vision_model\.embeddings\.position_embedding\.weight",
     r"position_embedding"),
    (r"vision_model\.embeddings\.class_embedding", r"class_embedding"),
    (r"vision_model\.pre_layrnorm", r"pre_layrnorm"),
    (r"vision_model\.post_layernorm", r"post_layernorm"),
    (r"vision_model\.encoder\.layers\.(\d+)", r"layers_\1"),
    (r"mlp\.fc1", r"mlp_fc1"),
    (r"mlp\.fc2", r"mlp_fc2"),
    (r"^quant_conv", r"encoder/quant_conv"),
]

_NORM_MODULES = re.compile(
    r"(norm|norm1|norm2|norm3|norm_in|group_norm|conv_norm_out|layer_norm1|"
    r"layer_norm2|pre_layrnorm|post_layernorm|spatial_norm)$"
)

# inverse grammar (flax path joined by '/' -> torch key with '/' for '.'),
# applied in order after the leaf is renamed
_LIST_SPLITS = [
    (r"^class_embedding$", r"vision_model/embeddings/class_embedding"),
    (r"^position_embedding$",
     r"vision_model/embeddings/position_embedding/weight"),
    (r"^patch_embedding/", r"vision_model/embeddings/patch_embedding/"),
    (r"^(pre_layrnorm|post_layernorm)/", r"vision_model/\1/"),
    (r"^layers_(\d+)/", r"vision_model/encoder/layers/\1/"),
    (r"(^|/)mlp_fc(\d)/", r"\1mlp/fc\2/"),
    (r"^encoder/quant_conv/", r"quant_conv/"),
    (r"(down|up)_blocks_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)",
     r"\1_blocks/\2/\3/\4"),
    (r"mid_block_(resnets|attentions)_(\d+)", r"mid_block/\1/\2"),
    (r"^down_blocks_(\d+)/", r"down_blocks/\1/"),
    (r"(^|/)(resnets|attentions)_(\d+)/", r"\1\2/\3/"),
    (r"(^|/)((?:temporal_)?transformer_blocks(?:_action)?)_(\d+)/", r"\1\2/\3/"),
    (r"(^|/)to_out_0/", r"\1to_out/0/"),
    (r"(^|/)net_0_proj/", r"\1net/0/proj/"),
    (r"(^|/)net_2/", r"\1net/2/"),
    (r"(^|/)action_proj/layers_(\d+)/", r"\1action_proj/layers/\2/"),
]


def translate_key(torch_key: str) -> tuple[str, ...]:
    """Dotted torch key -> flax tree path (tuple of names)."""
    k = torch_key
    for pat, repl in _LIST_MERGES:
        k = re.sub(pat, repl, k)
    parts = k.replace(".", "/").split("/")
    leaf = parts[-1]
    if leaf in ("weight", "bias") and len(parts) >= 2:
        if _NORM_MODULES.search(parts[-2]):
            parts[-1] = "scale" if leaf == "weight" else "bias"
        elif leaf == "weight":
            parts[-1] = "kernel"
    return tuple(parts)


def convert_tensor(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """torch layout -> flax layout, by leaf name and rank."""
    if path[-1] == "kernel":
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)
        if value.ndim == 5:
            return value.transpose(2, 3, 4, 1, 0)
        if value.ndim == 2:
            return value.transpose(1, 0)
    return value


def torch_key(path: tuple[str, ...]) -> str:
    """Flax tree path -> dotted torch key; the inverse of `translate_key`
    (checked: raises when the round trip does not give `path` back)."""
    parts = list(path)
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    s = "/".join(parts)
    for pat, repl in _LIST_SPLITS:
        s = re.sub(pat, repl, s)
    key = s.replace("/", ".")
    if translate_key(key) != tuple(path):
        raise ValueError(f"no torch key for flax path {'/'.join(path)} "
                         f"(tried {key!r} -> {translate_key(key)})")
    return key


def unconvert_tensor(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """flax layout -> torch layout (inverse of `convert_tensor`)."""
    if path[-1] == "kernel":
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return value.transpose(4, 3, 0, 1, 2)
        if value.ndim == 2:
            return value.transpose(1, 0)
    return value


def _flatten(tree: Mapping, prefix=()) -> Iterable[tuple[tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> torch state dict (fp32 CPU)."""
    out = {}
    for path, value in _flatten(params_np):
        arr = unconvert_tensor(path, np.asarray(value, dtype=np.float32))
        out[torch_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_flax_params(module: nn.Module, params_np: Mapping) -> nn.Module:
    """Load a flax tree into `module`, requiring full coverage both ways:
    every module parameter gets a leaf and no leaf is left over. Values are
    cast to each parameter's dtype and device."""
    state = flax_to_torch(params_np)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    shape = sorted(k for k in set(own) & set(state)
                   if tuple(own[k].shape) != tuple(state[k].shape))
    if missing or extra or shape:
        raise ValueError(
            f"flax tree does not cover the module: missing {missing[:10]}, "
            f"unexpected {extra[:10]}, shape mismatch {shape[:10]}")
    module.load_state_dict(state, strict=True)
    return module


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the .safetensors files under `path` (a diffusers or
    transformers model directory), as one state dict."""
    from safetensors.torch import load_file

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state = {}
    for f in files:
        state.update(load_file(os.path.join(path, f)))
    return state
