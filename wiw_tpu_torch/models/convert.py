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

Quantised trees (the reference's `ops/quant.quantize_params`): an int8
`kernel` with its fp32 `kernel_scale` <-> the port's int8 `weight` with its
`weight_scale`, in the layout the port keeps for the int8 weight: Linear
[O, I] as above, Conv2d [O, kh, kw, I] <-> flax [kh, kw, I, O].
`load_flax_params` makes the module's layers int8 where the tree's kernels
are, then loads with full coverage both ways, as for a float tree.
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
    elif leaf == "weight_scale":
        parts[-1] = "kernel_scale"
    return tuple(parts)


def flax_axes(path: tuple[str, ...], ndim: int, int8: bool = False) -> tuple:
    """The torch axes of a leaf in the order of its flax layout: the flax
    value is the torch value transposed by them (a kernel by rank; an int8
    conv weight is the port's [O, kh, kw, I]; every other leaf as it is)."""
    if path[-1] == "kernel":
        if ndim == 4:
            return (1, 2, 3, 0) if int8 else (2, 3, 1, 0)
        if ndim == 5:
            return (2, 3, 4, 1, 0)
        if ndim == 2:
            return (1, 0)
    return tuple(range(ndim))


def convert_tensor(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """torch layout -> flax layout, by leaf name, rank and dtype."""
    return value.transpose(flax_axes(path, value.ndim, value.dtype == np.int8))


def torch_key(path: tuple[str, ...]) -> str:
    """Flax tree path -> dotted torch key; the inverse of `translate_key`
    (checked: raises when the round trip does not give `path` back)."""
    parts = list(path)
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    elif parts[-1] == "kernel_scale":
        parts[-1] = "weight_scale"
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
    axes = flax_axes(path, value.ndim, value.dtype == np.int8)
    return value.transpose(np.argsort(axes))


def _flatten(tree: Mapping, prefix=()) -> Iterable[tuple[tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> torch state dict (CPU; int8
    kernels stay int8, every other leaf becomes fp32)."""
    out = {}
    for path, value in _flatten(params_np):
        value = np.asarray(value)
        if value.dtype != np.int8:
            value = value.astype(np.float32)
        arr = unconvert_tensor(path, value)
        out[torch_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_flax_params(module: nn.Module, params_np: Mapping) -> nn.Module:
    """Load a flax tree into `module`, requiring full coverage both ways:
    every module parameter gets a leaf and no leaf is left over. Values are
    cast to each parameter's dtype and device. A layer whose kernel is int8
    in the tree (with its `kernel_scale`) is made int8 first
    (`ops/quant.make_int8_`, output in its compute dtype)."""
    from wiw_tpu_torch.ops.quant import make_int8_

    state = flax_to_torch(params_np)
    for key in [k for k in state if k.endswith(".weight_scale")]:
        name = key[:-len(".weight_scale")]
        try:
            m = module.get_submodule(name)
        except AttributeError:
            continue  # reported as unexpected below
        w8 = state.get(name + ".weight")
        if w8 is not None and w8.dtype == torch.int8:
            dev = m.weight.device
            make_int8_(m, torch.empty(w8.shape, dtype=torch.int8, device=dev),
                       torch.empty(w8.shape[0], device=dev), m.compute_dtype)
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


# ------------------------------------------------------------------ CDiT
# The inverse of the reference's `convert_cdit_state_dict` (NWM's torch key
# grammar -> `wiw_tpu.models.cdit` flax paths): flax path -> torch key, for
# every leaf but the cross-attention's q/k/v, which fuse into in_proj_*.
_CDIT_SPLITS = [
    (r"^x_embedder/(kernel|bias)$", r"x_embedder.proj.\1"),
    (r"^pos_embed$", r"pos_embed"),
    (r"^(t_embedder|time_embedder)/mlp_(\d)/(kernel|bias)$", r"\1.mlp.\2.\3"),
    (r"^y_embedder/(x_emb|y_emb|angle_emb)/mlp_(\d)/(kernel|bias)$",
     r"y_embedder.\1.mlp.\2.\3"),
    (r"^final_adaLN_1/(kernel|bias)$", r"final_layer.adaLN_modulation.1.\1"),
    (r"^final_linear/(kernel|bias)$", r"final_layer.linear.\1"),
    (r"^blocks_(\d+)/attn_(qkv|proj)/(kernel|bias)$", r"blocks.\1.attn.\2.\3"),
    (r"^blocks_(\d+)/cttn_out/(kernel|bias)$", r"blocks.\1.cttn.out_proj.\2"),
    (r"^blocks_(\d+)/cttn_(bias_k|bias_v)$", r"blocks.\1.cttn.\2"),
    (r"^blocks_(\d+)/mlp_(fc\d)/(kernel|bias)$", r"blocks.\1.mlp.\2.\3"),
    (r"^blocks_(\d+)/adaLN_modulation_1/(kernel|bias)$",
     r"blocks.\1.adaLN_modulation.1.\2"),
]
_CDIT_QKV = re.compile(r"^blocks_(\d+)/cttn_([qkv])/(kernel|bias)$")


def cdit_flax_to_torch(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's CDiT params (`wiw_tpu.models.cdit.CDiT`'s flax tree,
    numpy leaves, with or without the top `params` level) -> a state dict
    in NWM's torch key grammar (CPU, fp32): linear kernels IO -> OI, the
    patch conv HWIO -> OIHW, `cttn_{q,k,v}` fused into `in_proj_weight` /
    `in_proj_bias` ([q; k; v] rows), `bias_k` / `bias_v` as torch MHA's
    [1, 1, C]. Raises on a leaf it has no key for and on an incomplete q/k/v
    triple."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    out: Dict[str, torch.Tensor] = {}
    fused: Dict[tuple, np.ndarray] = {}
    for path, value in _flatten(params_np):
        flat = "/".join(path)
        value = np.asarray(value, np.float32)
        m = _CDIT_QKV.match(flat)
        if m:
            blk, part, leaf = m.groups()
            fused[(blk, leaf, part)] = value.T if leaf == "kernel" else value
            continue
        for pat, repl in _CDIT_SPLITS:
            key, hit = re.subn(pat, repl, flat)
            if hit:
                break
        else:
            raise ValueError(f"no NWM key for the CDiT flax path {flat}")
        if key.endswith(".kernel"):
            key = key[:-len("kernel")] + "weight"
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        elif key.endswith(("bias_k", "bias_v")):
            value = value.reshape(1, 1, -1)
        out[key] = torch.from_numpy(np.array(value, order="C"))
    for blk, leaf in sorted({(b, lf) for b, lf, _ in fused}):
        parts = [fused.get((blk, leaf, p)) for p in "qkv"]
        if any(x is None for x in parts):
            raise ValueError(f"blocks_{blk}: cttn q/k/v {leaf} incomplete")
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        out[f"blocks.{blk}.cttn.{name}"] = torch.from_numpy(
            np.ascontiguousarray(np.concatenate(parts, axis=0)))
    return out


def load_cdit_flax_params(module: nn.Module, params_np: Mapping) -> nn.Module:
    """Load the reference's CDiT flax tree into the port's `CDiT`, requiring
    full coverage both ways (every parameter gets a leaf, no leaf is left
    over, shapes agree); values are cast to each parameter's dtype."""
    state = cdit_flax_to_torch(params_np)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    shape = sorted(k for k in set(own) & set(state)
                   if tuple(own[k].shape) != tuple(state[k].shape))
    if missing or extra or shape:
        raise ValueError(
            f"CDiT flax tree does not cover the module: missing {missing[:10]}, "
            f"unexpected {extra[:10]}, shape mismatch {shape[:10]}")
    module.load_state_dict(state, strict=True)
    return module
