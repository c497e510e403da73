"""AutoencoderKL with temporal decoder (the SVD video VAE), channels-last.

Port of `wiw_tpu/models/vae.py`. Encode runs per frame ([N, H, W, 3] ->
latents [N, h, w, 4], unscaled); decode takes [B*F, h, w, 4] and convolves
over the frames of the chunk it is given. Module names are the diffusers
ones (`quant_conv` sits beside the encoder, not inside it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    SpatioTemporalResBlock,
    TemporalConv,
    Upsample2D,
)

SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = SCALING_FACTOR
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with GroupNorm + residual, as
    plain matmuls with fp32 logits (the reference's form)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        N, H, W, C = x.shape
        h = self.group_norm(x).reshape(N, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2))
        weights = torch.softmax(logits * C ** -0.5, dim=-1).to(v.dtype)
        h = self.to_out[0](torch.bmm(weights, v))
        return h.reshape(N, H, W, C) + x


class _Level(nn.Module):
    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class Encoder(nn.Module):
    """SD VAE encoder: [N, H, W, 3] -> pre-quant moments [N, H/8, W/8, 8]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, eps=1e-6))
                ch = out_ch
            down = (Downsample2D(ch, asymmetric_pad=True)
                    if i != len(chans) - 1 else None)
            self.down_blocks.append(_Level(resnets, downsample=down))
        self.mid_block = _Level(
            [ResnetBlock2D(ch, ch, eps=1e-6), ResnetBlock2D(ch, ch, eps=1e-6)],
            [VAEAttention(ch)])
        self.conv_norm_out = GroupNorm(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class TemporalDecoder(nn.Module):
    """[B*F, h, w, 4] latents -> [B, F, H, W, 3] fp32 video, temporal convs
    over F."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))

        def res(cin, cout):
            return SpatioTemporalResBlock(cin, cout, eps=1e-6, temporal_eps=1e-5,
                                          merge_factor=0.0, switch=True)

        self.conv_in = Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = _Level([res(chans[0], chans[0]), res(chans[0], chans[0])],
                                [VAEAttention(chans[0])])
        self.up_blocks = nn.ModuleList()
        ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(ch, out_ch))
                ch = out_ch
            up = Upsample2D(ch) if i != len(chans) - 1 else None
            self.up_blocks.append(_Level(resnets, upsample=up))
        self.conv_norm_out = GroupNorm(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, cfg.in_channels, 3, padding=1)
        self.time_conv_out = TemporalConv(cfg.in_channels, cfg.in_channels)

    def forward(self, z, num_frames: int):
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x, num_frames)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, num_frames)
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x, num_frames)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        BF, H, W, C = x.shape
        x = x.reshape(BF // num_frames, num_frames, H, W, C)
        return self.time_conv_out(x).float()


class AutoencoderKLTemporal(nn.Module):
    """encode -> posterior mean (unscaled); decode -> video frames."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode_moments(self, images):
        """images [N, H, W, 3] in [-1, 1] -> moments [N, h, w, 8]."""
        return self.quant_conv(self.encoder(images))

    def encode(self, images):
        """Posterior mean (the reference's encode without a key), UNSCALED."""
        return self.encode_moments(images).chunk(2, dim=-1)[0]

    def decode(self, latents, num_frames: int):
        """latents [B*F, h, w, 4] (un-scaled) -> [B, F, H, W, 3]."""
        return self.decoder(latents, num_frames)
