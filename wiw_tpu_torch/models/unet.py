"""Action-conditioned spatio-temporal UNet (SVD-dagger).

Port of `wiw_tpu/models/unet.py` with the `micro_cond` action strategy
(Fourier action embedder added to the per-frame time embedding). The
`action_block` strategies wait for a later port.

Precision: Linear/Conv compute in `dtype` (the reference's flax `dtype`);
their parameters are kept in `param_dtype` (None: the same, as in serving;
"float32" for training, as flax's default `param_dtype`). `remat`
recomputes each SpatioTemporalResBlock and TransformerSpatioTemporal in the
backward pass (`torch.utils.checkpoint`, non-reentrant), the reference's
`nn.remat` granularity for the trunk's blocks.

Layout: latents enter as [B, F, H, W, C]; spatial stages run with frames
folded into batch ([B*F, H, W, C]).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from wiw_tpu_torch.core.schedule import timestep_embedding
from wiw_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    Linear,
    SpatioTemporalResBlock,
    TimestepEmbedding,
    TransformerSpatioTemporal,
    Upsample2D,
    set_compute_dtype,
)
from wiw_tpu_torch.ops.fused_mlp import GATES
from wiw_tpu_torch.ops.temporal_attention import MODES


def env_switches(fused_ff: Optional[bool] = None,
                 temporal_attention: Optional[str] = None) -> dict:
    """The model switches the reference reads from the environment at trace
    time, for every caller, serving and training alike
    (wiw_tpu/models/layers.py `_fused_ff_on`, ops/fused_mlp.py's gate,
    ops/temporal_attention.py's mode); an explicit argument wins.

      WIW_FUSED_FF       '1' -> fused LN + feed-forward (K6), else off
      WIW_TEMPORAL_ATTN  'pallas' (K4) | 'xla', else 'batched' (default)
      WIW_FUSED_FF_GATE  'bf16' -> K6's gate in bf16 (K6-bf16), else 'f32'
                         (the environment only, as in the reference)

    Returns {fused_ff, temporal_attention, fused_ff_gate}: UNetConfig's
    fields of the same names."""
    env = os.environ
    if fused_ff is None:
        fused_ff = env.get("WIW_FUSED_FF", "0") == "1"
    if temporal_attention is None:
        mode = env.get("WIW_TEMPORAL_ATTN", "batched")
        temporal_attention = mode if mode in ("pallas", "xla") else "batched"
    gate = "bf16" if env.get("WIW_FUSED_FF_GATE", "f32") == "bf16" else "f32"
    return {"fused_ff": fused_ff, "temporal_attention": temporal_attention,
            "fused_ff_gate": gate}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SVD img2vid UNet configuration (defaults = the 14-frame SVD base)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    transformer_layers_per_block: int = 1
    num_frames: int = 14
    # None | 'micro_cond'
    action_strategy: Optional[str] = None
    # micro_cond input channel: 14 (nav idx codec) or 10 (manip pose codec)
    action_input_channel: int = 14
    dtype: str = "float32"
    # parameter dtype of Linear/Conv weights; None = `dtype`
    param_dtype: Optional[str] = None
    # recompute block activations in the backward pass (the reference's
    # remat, its --gradient_checkpointing)
    remat: bool = False
    # the transformers' LN + GEGLU feed-forward + residual through kernel
    # K6 where the reference's rule allows it (its WIW_FUSED_FF=1)
    fused_ff: bool = False
    # K6's gate: 'f32', or 'bf16' for K6-bf16 (the reference's
    # WIW_FUSED_FF_GATE=bf16); acts only where K6 runs
    fused_ff_gate: str = "f32"
    # frame attention formulation, as the reference's WIW_TEMPORAL_ATTN:
    # 'batched' | 'xla' | 'pallas' (kernel K4 where S % 64 == 0)
    temporal_attention: str = "batched"

    def __post_init__(self):
        if self.action_strategy not in (None, "micro_cond"):
            raise NotImplementedError(
                f"action_strategy {self.action_strategy!r} is not ported yet")
        if self.temporal_attention not in MODES:
            raise ValueError(f"temporal_attention {self.temporal_attention!r} "
                             f"not in {MODES}")
        if self.fused_ff_gate not in GATES:
            raise ValueError(f"fused_ff_gate {self.fused_ff_gate!r} not in {GATES}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype or self.dtype)


class ActionEmbedderFourier(nn.Module):
    """'micro_cond' embedder: 12 Fourier features per channel -> Linear(256)."""

    def __init__(self, in_channels: int, embed_dim: int = 256):
        super().__init__()
        self.proj = Linear(in_channels * 12, embed_dim)

    def forward(self, x):  # [B, F, A]
        B, Fr, A = x.shape
        xf = x.float()
        feats = []
        for m in (1.0, 2.0, 4.0, 6.0, 8.0, 10.0):
            feats.append(torch.cos(m * xf))
            feats.append(torch.sin(m * xf))
        # (cos x, sin x, cos 2x, ..., sin 10x) per channel, channel-major
        return self.proj(torch.stack(feats, dim=-1).reshape(B, Fr, A * 12))


class _Block(nn.Module):
    """One UNet level: resnets (+ transformers) (+ down/upsampler), with
    diffusers child names."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def attention(self, i):
        return self.attentions[i] if hasattr(self, "attentions") else None


class UNetSpatioTemporal(nn.Module):
    """Inputs:
      sample:          [B, F, H, W, C_in]  (noisy latents ++ image latents)
      timestep:        [B] continuous t = 0.25*log(sigma)
      context:         [B, S, cross_dim] CLIP image embeddings
      added_time_ids:  [B, 3] (fps-1, motion_bucket, noise_aug)
      action_ids:      [B, F, A] for micro_cond, else None
    Returns fp32 [B, F, H, W, C_out].
    """

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        ctx = cfg.cross_attention_dim
        tl = cfg.transformer_layers_per_block
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.add_embedding = TimestepEmbedding(
            3 * cfg.addition_time_embed_dim, temb)
        if cfg.action_strategy == "micro_cond":
            self.add_action_proj = ActionEmbedderFourier(
                cfg.action_input_channel)
            self.add_embedding_action = TimestepEmbedding(256, temb)
            self.add_embedding_noise = TimestepEmbedding(
                cfg.addition_time_embed_dim, temb)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)

        def res(cin, cout):
            return SpatioTemporalResBlock(cin, cout, eps=1e-5, temb_ch=temb)

        def attn(ch, heads):
            return TransformerSpatioTemporal(ch, heads, ch // heads, ctx, tl,
                                             cfg.fused_ff, cfg.temporal_attention,
                                             cfg.fused_ff_gate)

        n = len(cfg.block_out_channels)
        skip_ch = [ch0]
        ch = ch0
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(cfg.block_out_channels):
            final = i == n - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(res(ch, out_ch))
                ch = out_ch
                skip_ch.append(ch)
                if not final:
                    attns.append(attn(ch, cfg.num_attention_heads[i]))
            down = None if final else Downsample2D(ch)
            if down is not None:
                skip_ch.append(ch)
            self.down_blocks.append(_Block(resnets, attns, downsample=down))

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [res(mid, mid), res(mid, mid)],
            [attn(mid, cfg.num_attention_heads[-1])])

        rev_ch = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_attention_heads))
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(rev_ch):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(ch + skip_ch.pop(), out_ch))
                ch = out_ch
                if i != 0:
                    attns.append(attn(ch, rev_heads[i]))
            up = Upsample2D(ch) if i != n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(ch0, eps=1e-5, silu=True)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)
        if cfg.param_dtype is not None:
            set_compute_dtype(self, cfg.torch_dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.conv_in.compute_dtype

    def _block(self, module, *args):
        """A ResBlock or transformer call; recomputed in the backward pass
        under `remat` (no randomness inside, so no RNG state is kept)."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return module(*args)

    def forward(self, sample, timestep, context, added_time_ids,
                action_ids=None):
        cfg = self.config
        dt = self.dtype
        B, Fr, H, W, _ = sample.shape
        ch0 = cfg.block_out_channels[0]

        emb_time = self.time_embedding(timestep_embedding(timestep, ch0).to(dt))
        if cfg.action_strategy == "micro_cond":
            if action_ids is None or action_ids.ndim != 3:
                raise ValueError("micro_cond needs action_ids [B, F, A]")
            act = self.add_embedding_action(self.add_action_proj(action_ids))
            noise_emb = self.add_embedding_noise(timestep_embedding(
                added_time_ids[:, -1], cfg.addition_time_embed_dim).to(dt))
            # the per-frame embedding replaces the add_embedding path
            emb = (emb_time[:, None, :] + act + noise_emb[:, None, :]).reshape(
                B * Fr, -1)
        else:
            add = timestep_embedding(
                added_time_ids.reshape(-1), cfg.addition_time_embed_dim
            ).reshape(B, -1).to(dt)
            emb = (emb_time + self.add_embedding(add)).repeat_interleave(Fr, dim=0)

        x = self.conv_in(sample.to(dt).reshape(B * Fr, H, W, sample.shape[-1]))
        skips = [x]
        run = self._block
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                x = run(resnet, x, Fr, emb)
                if block.attention(i) is not None:
                    x = run(block.attention(i), x, Fr, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)

        x = run(self.mid_block.resnets[0], x, Fr, emb)
        x = run(self.mid_block.attentions[0], x, Fr, context)
        x = run(self.mid_block.resnets[1], x, Fr, emb)

        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                x = run(resnet, torch.cat([x, skips.pop()], dim=-1), Fr, emb)
                if block.attention(i) is not None:
                    x = run(block.attention(i), x, Fr, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.reshape(B, Fr, H, W, cfg.out_channels).float()
