"""CDiT: the conditional diffusion transformer of the Navigation World Model
(NWM), and its DDIM sampler, on PyTorch.

Port of `wiw_tpu/models/cdit.py`, with its arithmetic:
  * one patch embedding shared by the noisy latent and the `context_size`
    past-frame latents, and a learned positional embedding per slot
    (`pos_embed` [context_size + 1, N, D]; the last slot is the target's)
  * the conditioning vector c = t_emb + rel_time_emb + action_emb; the
    action (x, y, yaw) embeds through three Fourier-MLP towers of widths
    h//3, h//3 and h - 2 (h//3), concatenated
  * CDiTBlock: adaLN-Zero with an 11-way modulation: self-attention (qkv
    bias), cross-attention to the context tokens with `bias_k` / `bias_v`
    appended as one extra kv row (the context's norm takes shift and scale
    only), a GELU-tanh MLP, each gated
  * the final adaLN (shift, scale) and linear, then the unpatchify;
    learn_sigma doubles the output channels (mean ++ variance)

Module and parameter names follow the NWM torch key grammar, the one
`wiw_tpu/models/convert.py:convert_cdit_state_dict` reads (timm
PatchEmbed / Attention / Mlp, torch MultiheadAttention's fused `in_proj_*`
and `bias_k` / `bias_v` for the cross-attention), so a real NWM state dict
loads with a strict `load_state_dict`; `models/convert.cdit_flax_to_torch`
maps the reference's flax trees onto them.

Attention goes through `ops/attention.attention_bsd`: kernel K1 on the card
(its head_dim 72 instance at the XL widths: 1152 / 16 heads), its plain
version on the CPU. The LayerNorms (no affine, eps 1e-6, fp32 statistics),
the modulations, GELU and the products are plain PyTorch, as the reference
leaves them to XLA. The parameters are in the config's dtype (bf16 for
serving); inputs are cast to it and the output is fp32.

`ddim_sample` is the reference's DDIM (eta 0) over a linear-beta schedule
with epsilon prediction: x0 clipped to +-4, the learned-variance channels
dropped. Its tables are the reference's to the bit (see `linspace_f32`,
`cumprod_f32`); its noise is an argument or a draw from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.core.schedule import timestep_embedding
from wiw_tpu_torch.ops.attention import attention_bsd


@dataclasses.dataclass(frozen=True)
class CDiTConfig:
    """CDiT-XL/2 by default (NWM's backbone, ~1.0 B parameters)."""

    input_size: int = 32
    context_size: int = 4
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    learn_sigma: bool = True
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)


class FourierMLP(nn.Module):
    """Sinusoidal(256) -> Linear -> SiLU -> Linear (NWM's TimestepEmbedder)."""

    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))

    def forward(self, v):  # [B] -> [B, hidden]
        emb = timestep_embedding(v, self.freq_dim)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))


class ActionEmbedderXYA(nn.Module):
    """(x, y, angle) -> hidden: three concatenated Fourier towers of widths
    h//3, h//3 and h - 2 (h//3)."""

    def __init__(self, hidden: int):
        super().__init__()
        h3 = hidden // 3
        self.x_emb = FourierMLP(h3)
        self.y_emb = FourierMLP(h3)
        self.angle_emb = FourierMLP(hidden - 2 * h3)

    def forward(self, xya):  # [B, 3]
        return torch.cat([self.x_emb(xya[:, 0]), self.y_emb(xya[:, 1]),
                          self.angle_emb(xya[:, 2])], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x):
    """LayerNorm without affine parameters, eps 1e-6, fp32 statistics."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


class Attention(nn.Module):
    """Self-attention with a qkv bias (timm's Attention)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)  # head views of one projection
        return self.proj(attention_bsd(q, k, v, self.heads))


class CrossAttention(nn.Module):
    """torch MultiheadAttention's parameters (fused `in_proj_*`, `bias_k` /
    `bias_v` appended as one extra kv row, `out_proj`) over the port's
    attention."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.bias_k = nn.Parameter(torch.empty(1, 1, dim))
        self.bias_v = nn.Parameter(torch.empty(1, 1, dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, ctx):
        w, b = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        B, C = ctx.shape[0], ctx.shape[-1]
        q = F.linear(x, w[0], b[0])
        k = torch.cat([F.linear(ctx, w[1], b[1]),
                       self.bias_k.to(ctx.dtype).expand(B, 1, C)], dim=1)
        v = torch.cat([F.linear(ctx, w[2], b[2]),
                       self.bias_v.to(ctx.dtype).expand(B, 1, C)], dim=1)
        return self.out_proj(attention_bsd(q, k, v, self.heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class CDiTBlock(nn.Module):
    def __init__(self, cfg: CDiTConfig):
        super().__init__()
        C = cfg.hidden_size
        self.attn = Attention(C, cfg.num_heads)
        self.cttn = CrossAttention(C, cfg.num_heads)
        self.mlp = Mlp(C, int(C * cfg.mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(C, 11 * C))

    def forward(self, x, c, x_cond):
        (s_msa, sc_msa, g_msa, s_cx, sc_cx, s_x, sc_x, g_cx, s_mlp, sc_mlp,
         g_mlp) = self.adaLN_modulation(c).chunk(11, dim=-1)
        x = x + g_msa[:, None, :] * self.attn(_modulate(_ln(x), s_msa, sc_msa))
        ctx = _modulate(_ln(x_cond), s_cx, sc_cx)
        x = x + g_cx[:, None, :] * self.cttn(_modulate(_ln(x), s_x, sc_x), ctx)
        return x + g_mlp[:, None, :] * self.mlp(_modulate(_ln(x), s_mlp, sc_mlp))


class PatchEmbed(nn.Module):
    """A P x P stride-P conv on channels-last [N, H, W, C] -> [N, N_p, D]."""

    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)

    def forward(self, img):
        y = self.proj(img.permute(0, 3, 1, 2))  # [N, D, h, w]
        return y.flatten(2).transpose(1, 2)


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 2 * dim))
        self.linear = nn.Linear(dim, out)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(_modulate(_ln(x), shift, scale))


class CDiT(nn.Module):
    """x [B, H, W, C] noisy latent; t [B]; action_xya [B, 3]; x_cond
    [B, context_size, H, W, C]; rel_t [B] -> [B, H, W, out_channels] fp32.
    Parameters in `cfg.dtype`; `init_weights` draws random ones from a
    generator (weights are otherwise loaded)."""

    def __init__(self, cfg: CDiTConfig = CDiTConfig()):
        super().__init__()
        self.cfg = cfg
        D, P = cfg.hidden_size, cfg.patch_size
        self.x_embedder = PatchEmbed(cfg.in_channels, D, P)
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.context_size + 1, cfg.num_patches, D))
        self.t_embedder = FourierMLP(D)
        self.time_embedder = FourierMLP(D)
        self.y_embedder = ActionEmbedderXYA(D)
        self.blocks = nn.ModuleList(CDiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(D, P * P * cfg.out_channels)
        self.to(cfg.torch_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CDiT":
        """Random weights as the reference's flax initialisers draw them
        (in distribution, not in bits): products and the patch conv
        N(0, 1 / fan_in), biases 0, `pos_embed`, `bias_k`, `bias_v`
        N(0, 0.02^2)."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32) * std)

        for name, p in self.named_parameters():
            if name == "pos_embed" or name.endswith(("bias_k", "bias_v")):
                normal(p, 0.02)
            elif name.endswith("bias"):
                p.zero_()
            else:  # a weight [O, I] or [O, I, P, P]
                normal(p, 1.0 / math.sqrt(p[0].numel()))
        return self

    def forward(self, x, t, action_xya, x_cond, rel_t):
        cfg = self.cfg
        dt = self.pos_embed.dtype
        B, H, W, Cin = x.shape
        P, D, T = cfg.patch_size, cfg.hidden_size, cfg.context_size
        n = (H // P) * (W // P)
        pos = self.pos_embed
        xt = self.x_embedder(x.to(dt)) + pos[T]
        ctx = self.x_embedder(x_cond.to(dt).reshape(B * T, H, W, Cin))
        ctx = (ctx.reshape(B, T, n, D) + pos[:T][None]).reshape(B, T * n, D)
        c = (self.t_embedder(t) + self.time_embedder(rel_t)
             + self.y_embedder(action_xya))
        for block in self.blocks:
            xt = block(xt, c, ctx)
        h = self.final_layer(xt, c)
        # unpatchify [B, n, P*P*C_out] -> [B, H, W, C_out]
        co = cfg.out_channels
        h = h.reshape(B, H // P, W // P, P, P, co).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, H, W, co).float()


# ---------------------------------------------------------------------------
# DDIM (the reference's gaussian_diffusion role)
# ---------------------------------------------------------------------------

def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in float32, to the bit, as XLA
    evaluates it on the CPU: step = i * f32(1 / (num - 1)),
    out = fma(i, f32(stop / (num - 1)), start * (1 - step)), the last
    entry `stop`. `torch.linspace` takes another formula: at num 10 and 25
    one truncated timestep differs (held against JAX in the CPU tests at
    num 1 ... 250)."""
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    s, e = np.float32(start), np.float32(stop)
    r = np.float32(np.float32(1) / np.float32(div))
    head = s * (np.float32(1) - i * r)
    # the fused multiply-add, rounded once (i * c is exact in float64)
    out = (i.astype(np.float64) * np.float64(e * r) + head).astype(np.float32)
    return np.concatenate([out, [e]]).astype(np.float32)


def cumprod_f32(x: np.ndarray) -> np.ndarray:
    """`jnp.cumprod` of a float32 vector of at most 4096 terms in XLA's CPU
    order, to the bit: sequential prefix products within blocks of 16, the
    blocks' totals likewise within blocks of 16, and those totals' exclusive
    prefix, each level's prefix multiplied onto the level below. A plain
    sequential float32 product differs in the last bits (up to 4e-7 on
    `alphas_bar`)."""
    x = np.asarray(x, np.float32)
    n, W = len(x), 16
    if n > W * W * W:
        raise ValueError(f"cumprod_f32 takes at most {W ** 3} terms, got {n}")

    def prefix(rows):  # [R, W] -> sequential inclusive prefix products
        out, acc = np.empty_like(rows), np.ones(rows.shape[0], np.float32)
        for j in range(rows.shape[1]):
            acc = acc * rows[:, j]
            out[:, j] = acc
        return out

    R = -(-n // W)
    level0 = np.ones(R * W, np.float32)
    level0[:n] = x
    level0 = prefix(level0.reshape(R, W))
    R1 = -(-R // W)
    level1 = np.ones(R1 * W, np.float32)
    level1[:R] = level0[:, -1]
    level1 = prefix(level1.reshape(R1, W))
    excl2 = np.ones(R1, np.float32)
    for i in range(1, R1):
        excl2[i] = excl2[i - 1] * level1[i - 1, -1]
    excl1 = np.ones(R, np.float32)
    excl1[1:] = (level1 * excl2[:, None]).reshape(-1)[:R - 1]
    return (level0 * excl1[:, None]).reshape(-1)[:n]


def linear_betas(num_steps: int = 1000, start: float = 1e-4,
                 end: float = 2e-2) -> np.ndarray:
    return linspace_f32(start, end, num_steps)


def ddim_tables(num_steps: int, train_steps: int = 1000):
    """(timesteps int32 [num_steps], alphas_bar float32 [train_steps]), the
    reference's: `linspace(train_steps - 1, 0, num_steps)` truncated, and
    the float32 cumulative product of 1 - betas."""
    ts = linspace_f32(train_steps - 1, 0, num_steps).astype(np.int32)
    return ts, cumprod_f32(np.float32(1) - linear_betas(train_steps))


def ddim_sample(model, shape, x_cond, action_xya, rel_t, num_steps: int = 50,
                train_steps: int = 1000, noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """DDIM (eta 0) over the linear-beta schedule with epsilon prediction;
    `model(x, t, action_xya, x_cond, rel_t)` as CDiT's forward; the
    learned-variance channels are dropped. The start is `noise` (a [shape]
    tensor) or a standard-normal draw from `generator`, on x_cond's device.
    Returns the fp32 latent [shape]."""
    ts, alphas_bar = ddim_tables(num_steps, train_steps)
    dev = x_cond.device
    if noise is None:
        noise = torch.randn(tuple(shape), generator=generator, device=dev)
    x = noise.to(dev, torch.float32)
    C = shape[-1]
    for i in range(num_steps):
        t = int(ts[i])
        ab_t = alphas_bar[t]
        ab_next = alphas_bar[ts[i + 1]] if i + 1 < num_steps else np.float32(1)
        one = np.float32(1)
        out = model(x, torch.full((shape[0],), float(t), device=dev),
                    action_xya, x_cond, rel_t)
        eps = out[..., :C]
        x0 = (x - float(np.sqrt(one - ab_t)) * eps) / float(np.sqrt(ab_t))
        x0 = x0.clamp(-4.0, 4.0)
        x = float(np.sqrt(ab_next)) * x0 + float(np.sqrt(one - ab_next)) * eps
    return x
