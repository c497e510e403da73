"""Action-conditioned spatio-temporal UNet (SVD-dagger).

Port of `wiw_tpu/models/unet.py` with the `micro_cond` action strategy
(Fourier action embedder added to the per-frame time embedding). The
`action_block` strategies and `remat` wait for a later port.

Layout: latents enter as [B, F, H, W, C]; spatial stages run with frames
folded into batch ([B*F, H, W, C]).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
)


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

    def __post_init__(self):
        if self.action_strategy not in (None, "micro_cond"):
            raise NotImplementedError(
                f"action_strategy {self.action_strategy!r} is not ported yet")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


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
            return TransformerSpatioTemporal(ch, heads, ch // heads, ctx, tl)

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

        self.conv_norm_out = GroupNorm(ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

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
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(x, Fr, emb)
                if block.attention(i) is not None:
                    x = block.attention(i)(x, Fr, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, Fr, emb)
        x = self.mid_block.attentions[0](x, Fr, context)
        x = self.mid_block.resnets[1](x, Fr, emb)

        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=-1), Fr, emb)
                if block.attention(i) is not None:
                    x = block.attention(i)(x, Fr, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(B, Fr, H, W, cfg.out_channels).float()
