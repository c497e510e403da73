"""Plain PyTorch reference of SVD-dagger: the action-conditioned
spatio-temporal UNet (micro_cond), the SD VAE with its temporal decoder,
and the CLIP ViT image encoder, written from the published architectures
(diffusers' UNetSpatioTemporalConditionModel and
AutoencoderKLTemporalDecoder, transformers' CLIPVisionModelWithProjection)
in float32, NCHW, with no kernel, cache or batching of its own.

Parameters are one flat dict in the diffusers key grammar (`param_spec`),
so the same tensors load into the system under test by name. The functions
take that dict and never hold state.

Precision of the matrix products is a `Quant` value:
  * "int8" / "int4": the W8A8 serving rule on the UNet trunk's eligible
    layers (spatial 3x3 convs, resamplers, GEGLU in-projections): weights
    symmetric per output channel, a Linear's input per row (last axis), a
    conv's input one scale for the whole call; the products of the codes in
    float32. "int4" is the same rule at 7 levels instead of 127 (the
    serving control).
  * "fp8": every Linear and conv input and weight rounded to float8 e4m3
    with one scale per tensor (the training control; the gradient passes
    straight through the rounding).
  * None: float32 throughout.
Nothing here imports the system under test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

ACTION_STOP = 4
ACTION_TURN_LEFT = 2
ACTION_TURN_RIGHT = 3
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INT8_LAYERS = ("conv1", "conv2", "conv", "net.0.proj")
INT8_TREES = ("down_blocks.", "mid_block.", "up_blocks.")
INT8_DENY = ("temporal_res_block", "time_emb_proj")


@dataclasses.dataclass(frozen=True)
class Quant:
    mode: Optional[str] = None  # None | "int8" | "int4" | "fp8"
    # operations counted by kind ("int8" for the layers the int8 rule
    # takes, else "float"), when a dict is given (the benchmark's op count)
    tally: Optional[dict] = dataclasses.field(default=None, compare=False)

    def count(self, name: Optional[str], ops: float) -> None:
        if self.tally is not None:
            kind = "int8" if name is not None and self.mode in ("int8", "int4") \
                and self.applies(name) else "float"
            self.tally[kind] = self.tally.get(kind, 0.0) + float(ops)

    def applies(self, name: str) -> bool:
        if self.mode == "fp8":
            return True
        if self.mode not in ("int8", "int4"):
            return False
        return (name.startswith(INT8_TREES) and name.endswith(INT8_LAYERS)
                and not any(d in name for d in INT8_DENY))

    @property
    def levels(self) -> float:
        return 127.0 if self.mode == "int8" else 7.0


FP32 = Quant()


# ---------------------------------------------------------------- spec
def param_spec(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    """{tower: {name: (shape, init)}} for the configuration's towers; init
    is ("normal", std) or ("const", value)."""
    return {"unet": _unet_spec(cfg["unet"]), "vae": _vae_spec(cfg["vae"]),
            "clip": _clip_spec(cfg["clip"])}


class _Spec(dict):
    def lin(self, name, i, o, bias=True):
        self[f"{name}.weight"] = ((o, i), ("normal", i ** -0.5))
        if bias:
            self[f"{name}.bias"] = ((o,), ("const", 0.0))

    def conv(self, name, i, o, k, bias=True):
        self[f"{name}.weight"] = ((o, i, k, k), ("normal", (i * k * k) ** -0.5))
        if bias:
            self[f"{name}.bias"] = ((o,), ("const", 0.0))

    def tconv(self, name, c):
        self[f"{name}.weight"] = ((c, c, 3, 1, 1), ("normal", (3 * c) ** -0.5))
        self[f"{name}.bias"] = ((c,), ("const", 0.0))

    def norm(self, name, c):
        self[f"{name}.weight"] = ((c,), ("const", 1.0))
        self[f"{name}.bias"] = ((c,), ("const", 0.0))

    def temb(self, name, i, o, out=None):
        self.lin(f"{name}.linear_1", i, o)
        self.lin(f"{name}.linear_2", o, out or o)

    def resnet(self, name, cin, cout, temb=None):
        self.norm(f"{name}.norm1", cin)
        self.conv(f"{name}.conv1", cin, cout, 3)
        if temb:
            self.lin(f"{name}.time_emb_proj", temb, cout)
        self.norm(f"{name}.norm2", cout)
        self.conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            self.conv(f"{name}.conv_shortcut", cin, cout, 1)

    def st_resnet(self, name, cin, cout, temb, merge):
        self.resnet(f"{name}.spatial_res_block", cin, cout, temb)
        t = f"{name}.temporal_res_block"
        self.norm(f"{t}.norm1", cout)
        self.tconv(f"{t}.conv1", cout)
        if temb:
            self.lin(f"{t}.time_emb_proj", temb, cout)
        self.norm(f"{t}.norm2", cout)
        self.tconv(f"{t}.conv2", cout)
        self[f"{name}.time_mixer.mix_factor"] = ((1,), ("const", merge))

    def attn(self, name, q, inner, ctx=None):
        self.lin(f"{name}.to_q", q, inner, bias=False)
        self.lin(f"{name}.to_k", ctx or q, inner, bias=False)
        self.lin(f"{name}.to_v", ctx or q, inner, bias=False)
        self.lin(f"{name}.to_out.0", inner, q)

    def ff(self, name, dim):
        self.lin(f"{name}.net.0.proj", dim, dim * 8)
        self.lin(f"{name}.net.2", dim * 4, dim)

    def transformer(self, name, ch, ctx):
        self.norm(f"{name}.norm", ch)
        self.lin(f"{name}.proj_in", ch, ch)
        b = f"{name}.transformer_blocks.0"
        self.norm(f"{b}.norm1", ch)
        self.attn(f"{b}.attn1", ch, ch)
        self.norm(f"{b}.norm2", ch)
        self.attn(f"{b}.attn2", ch, ch, ctx)
        self.norm(f"{b}.norm3", ch)
        self.ff(f"{b}.ff", ch)
        t = f"{name}.temporal_transformer_blocks.0"
        self.norm(f"{t}.norm_in", ch)
        self.ff(f"{t}.ff_in", ch)
        self.norm(f"{t}.norm1", ch)
        self.attn(f"{t}.attn1", ch, ch)
        self.norm(f"{t}.norm2", ch)
        self.attn(f"{t}.attn2", ch, ch, ctx)
        self.norm(f"{t}.norm3", ch)
        self.ff(f"{t}.ff", ch)
        self.temb(f"{name}.time_pos_embed", ch, ch * 4, ch)
        self[f"{name}.time_mixer.mix_factor"] = ((1,), ("const", 0.5))
        self.lin(f"{name}.proj_out", ch, ch)


def _unet_spec(u: dict) -> dict:
    s = _Spec()
    chans, ctx = u["block_out_channels"], u["cross_attention_dim"]
    ch0 = chans[0]
    temb = 4 * ch0
    s.temb("time_embedding", ch0, temb)
    s.temb("add_embedding", 3 * u["addition_time_embed_dim"], temb)
    s.lin("add_action_proj.proj", u["action_input_channel"] * 12, 256)
    s.temb("add_embedding_action", 256, temb)
    s.temb("add_embedding_noise", u["addition_time_embed_dim"], temb)
    s.conv("conv_in", u["in_channels"], ch0, 3)
    skip, ch, n = [ch0], ch0, len(chans)
    for i, out in enumerate(chans):
        for j in range(u["layers_per_block"]):
            s.st_resnet(f"down_blocks.{i}.resnets.{j}", ch, out, temb, 0.5)
            ch = out
            skip.append(ch)
            if i < n - 1:
                s.transformer(f"down_blocks.{i}.attentions.{j}", ch, ctx)
        if i < n - 1:
            s.conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
            skip.append(ch)
    for j in range(2):
        s.st_resnet(f"mid_block.resnets.{j}", ch, ch, temb, 0.5)
    s.transformer("mid_block.attentions.0", ch, ctx)
    for i, out in enumerate(reversed(chans)):
        for j in range(u["layers_per_block"] + 1):
            s.st_resnet(f"up_blocks.{i}.resnets.{j}", ch + skip.pop(), out, temb, 0.5)
            ch = out
            if i > 0:
                s.transformer(f"up_blocks.{i}.attentions.{j}", ch, ctx)
        if i < n - 1:
            s.conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    s.norm("conv_norm_out", ch0)
    s.conv("conv_out", ch0, u["out_channels"], 3)
    return dict(s)


def _vae_spec(v: dict) -> dict:
    s = _Spec()
    chans, lc = v["block_out_channels"], v["latent_channels"]
    s.conv("encoder.conv_in", 3, chans[0], 3)
    ch = chans[0]
    for i, out in enumerate(chans):
        for j in range(v["layers_per_block"]):
            s.resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, out)
            ch = out
        if i < len(chans) - 1:
            s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
    for part in ("encoder", "decoder"):
        top = chans[-1]
        if part == "decoder":
            s.conv("decoder.conv_in", lc, top, 3)
        for j in range(2):
            if part == "encoder":
                s.resnet(f"encoder.mid_block.resnets.{j}", top, top)
            else:
                s.st_resnet(f"decoder.mid_block.resnets.{j}", top, top, None, 0.0)
        a = f"{part}.mid_block.attentions.0"
        s.norm(f"{a}.group_norm", top)
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            s.lin(f"{a}.{p}", top, top)
        if part == "encoder":
            s.norm("encoder.conv_norm_out", top)
            s.conv("encoder.conv_out", top, 2 * lc, 3)
            s.conv("quant_conv", 2 * lc, 2 * lc, 1)
    ch = chans[-1]
    for i, out in enumerate(reversed(chans)):
        for j in range(v["layers_per_block"] + 1):
            s.st_resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, out, None, 0.0)
            ch = out
        if i < len(chans) - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    s.norm("decoder.conv_norm_out", ch)
    s.conv("decoder.conv_out", ch, 3, 3)
    s.tconv("decoder.time_conv_out", 3)
    return dict(s)


def _clip_spec(c: dict) -> dict:
    s = _Spec()
    C, p = c["hidden_size"], c["patch_size"]
    e = "vision_model.embeddings"
    s.conv(f"{e}.patch_embedding", 3, C, p, bias=False)
    s[f"{e}.class_embedding"] = ((C,), ("normal", 0.02))
    n = (c["image_size"] // p) ** 2 + 1
    s[f"{e}.position_embedding.weight"] = ((n, C), ("normal", 0.02))
    s.norm("vision_model.pre_layrnorm", C)
    for i in range(c["num_layers"]):
        L = f"vision_model.encoder.layers.{i}"
        s.norm(f"{L}.layer_norm1", C)
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s.lin(f"{L}.self_attn.{q}", C, C)
        s.norm(f"{L}.layer_norm2", C)
        s.lin(f"{L}.mlp.fc1", C, c["intermediate_size"])
        s.lin(f"{L}.mlp.fc2", c["intermediate_size"], C)
    s.norm("vision_model.post_layernorm", C)
    s.lin("visual_projection", C, c["projection_dim"], bias=False)
    return dict(s)


# ---------------------------------------------------------------- weights
CHUNK = 1 << 28  # elements of one random draw


def chunk_plan(spec: dict):
    """The random leaves of `spec` grouped into draws of at most CHUNK
    elements: [[name, ...], ...], in the spec's order."""
    plan, cur, size = [], [], 0
    for name, (shape, (kind, _)) in spec.items():
        if kind != "normal":
            continue
        n = math.prod(shape)
        if cur and size + n > CHUNK:
            plan.append(cur)
            cur, size = [], 0
        cur.append(name)
        size += n
    if cur:
        plan.append(cur)
    return plan


def draw_chunk(spec: dict, names, seed: int, dtype, device) -> dict:
    """One draw: a standard normal of the chunk's size from a generator on
    `device` seeded with `seed`, cut into the leaves and scaled."""
    sizes = [math.prod(spec[n][0]) for n in names]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, dtype=dtype, device=device)
    leaves = [t.view(spec[n][0]) for t, n in zip(flat.split(sizes), names)]
    torch._foreach_mul_(leaves, [float(spec[n][1][1]) for n in names])
    return dict(zip(names, leaves))


def chunk_seed(seed: int, tower: str, index: int) -> int:
    """The seed of one draw: the run's seed, the tower and the draw's
    place, mixed into 63 bits."""
    h = (seed * 0x9E3779B97F4A7C15 + sum(map(ord, tower)) * 0x100000001B3
         + index * 0xC2B2AE3D27D4EB4F) % (1 << 63)
    return h


def make_tower(spec: dict, tower: str, seed: int, dtype, device) -> dict:
    """Every leaf of one tower, made on `device` in `dtype` from `seed` in
    a few large draws (constants filled)."""
    out = {}
    for i, names in enumerate(chunk_plan(spec)):
        out.update(draw_chunk(spec, names, chunk_seed(seed, tower, i), dtype, device))
    for name, (shape, (kind, value)) in spec.items():
        if kind == "const":
            out[name] = torch.full(shape, float(value), dtype=dtype, device=device)
    return {n: out[n] for n in spec}


# ---------------------------------------------------------------- layers
def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


def _codes_rows(x, levels):
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / levels
    return torch.round(x / s), s


def _weight_codes(w, levels):
    s = w.abs().amax(dim=tuple(range(1, w.ndim))).clamp_min(1e-8) / levels
    shape = (-1,) + (1,) * (w.ndim - 1)
    return torch.clamp(torch.round(w / s.view(shape)), -levels, levels), s


def linear(P, name, x, q: Quant = FP32, bias=True):
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias") if bias else None
    q.count(name, 2.0 * x.numel() * w.shape[0])
    if q.applies(name):
        if q.mode == "fp8":
            return F.linear(_round_fp8(x), _round_fp8(w), b)
        x8, sa = _codes_rows(x, q.levels)
        w8, sw = _weight_codes(w, q.levels)
        out = F.linear(x8, w8) * sa * sw
        return out if b is None else out + b
    return F.linear(x, w, b)


def conv(P, name, x, q: Quant = FP32, stride=1, padding=None):
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias")
    pad = w.shape[-1] // 2 if padding is None else padding
    N, _, H, W = x.shape
    oh, ow = (H + 2 * pad - w.shape[2]) // stride + 1, (W + 2 * pad - w.shape[3]) // stride + 1
    q.count(name, 2.0 * N * oh * ow * w[0].numel() * w.shape[0])
    if q.applies(name):
        if q.mode == "fp8":
            return F.conv2d(_round_fp8(x), _round_fp8(w), b, stride, pad)
        sa = x.abs().amax().clamp_min(1e-8) / q.levels
        w8, sw = _weight_codes(w, q.levels)
        out = F.conv2d(torch.round(x / sa), w8, None, stride, pad)
        out = out * (sa * sw)[None, :, None, None]
        return out if b is None else out + b[None, :, None, None]
    return F.conv2d(x, w, b, stride, pad)


def tconv(P, name, x, q: Quant = FP32):
    """(3, 1, 1) conv over the frames of [B, C, F, H, W]."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    q.count(name, 2.0 * x.numel() // x.shape[1] * w[0].numel() * w.shape[0])
    if q.mode == "fp8":
        x, w = _round_fp8(x), _round_fp8(w)
    return F.conv3d(x, w, b, padding=(1, 0, 0))


def group_norm(P, name, x, eps, silu=False, groups=32):
    C = x.shape[1]
    g = groups if C % groups == 0 and C >= groups else C
    out = F.group_norm(x, g, P[f"{name}.weight"], P[f"{name}.bias"], eps)
    return F.silu(out) if silu else out


def layer_norm(P, name, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(dim, flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def temb_mlp(P, name, x, q):
    return linear(P, f"{name}.linear_2", F.silu(linear(P, f"{name}.linear_1", x, q)), q)


def _heads(t, h):
    B, S, C = t.shape
    return t.view(B, S, h, C // h).transpose(1, 2)


def attention(P, name, x, ctx, heads, q):
    """x [B, S, C]; ctx [B, T, D] or None (self-attention)."""
    if ctx is not None and ctx.shape[1] == 1:  # one key: the softmax is 1
        v = linear(P, f"{name}.to_v", ctx, q, bias=False)
        return linear(P, f"{name}.to_out.0", v, q).expand(x.shape)
    src = x if ctx is None else ctx
    qh = _heads(linear(P, f"{name}.to_q", x, q, bias=False), heads)
    kh = _heads(linear(P, f"{name}.to_k", src, q, bias=False), heads)
    vh = _heads(linear(P, f"{name}.to_v", src, q, bias=False), heads)
    o = F.scaled_dot_product_attention(qh, kh, vh)
    q.count(None, 4.0 * qh.numel() * kh.shape[2])
    B, S, C = x.shape
    return linear(P, f"{name}.to_out.0", o.transpose(1, 2).reshape(B, S, C), q)


def feed_forward(P, name, x, q):
    h, gate = linear(P, f"{name}.net.0.proj", x, q).chunk(2, dim=-1)
    return linear(P, f"{name}.net.2", h * F.gelu(gate), q)


def mix(P, name, spatial, temporal, switch=False):
    a = torch.sigmoid(P[f"{name}.mix_factor"])[0]
    if switch:
        a = 1.0 - a
    return a * spatial + (1.0 - a) * temporal


def resnet(P, name, x, temb, eps, q):
    """x [N, C, H, W]; temb [N, T] or None."""
    h = conv(P, f"{name}.conv1", group_norm(P, f"{name}.norm1", x, eps, True), q)
    if temb is not None:
        h = h + linear(P, f"{name}.time_emb_proj", F.silu(temb), q)[:, :, None, None]
    h = conv(P, f"{name}.conv2", group_norm(P, f"{name}.norm2", h, eps, True), q)
    if f"{name}.conv_shortcut.weight" in P:
        x = conv(P, f"{name}.conv_shortcut", x, q)
    return x + h


def st_resnet(P, name, x, frames, temb, eps, t_eps, q, switch=False):
    """Spatial resnet on [B*F, C, H, W], then the temporal one over the
    frames, blended."""
    x = resnet(P, f"{name}.spatial_res_block", x, temb, eps, q)
    BF, C, H, W = x.shape
    x5 = x.view(BF // frames, frames, C, H, W).transpose(1, 2)  # [B, C, F, H, W]
    t = f"{name}.temporal_res_block"
    h = tconv(P, f"{t}.conv1", group_norm(P, f"{t}.norm1", x5, t_eps, True), q)
    if temb is not None:
        e = linear(P, f"{t}.time_emb_proj", F.silu(temb), q)
        h = h + e.view(BF // frames, frames, C).transpose(1, 2)[..., None, None]
    h = tconv(P, f"{t}.conv2", group_norm(P, f"{t}.norm2", h, t_eps, True), q)
    h = x5 + h
    out = mix(P, f"{name}.time_mixer", x5, h, switch)
    return out.transpose(1, 2).reshape(BF, C, H, W)


def transformer(P, name, x, frames, ctx, heads, q):
    """Spatial and temporal transformer on [B*F, C, H, W]; ctx [B, T, D]."""
    BF, C, H, W = x.shape
    B = BF // frames
    h = group_norm(P, f"{name}.norm", x, 1e-6).flatten(2).transpose(1, 2)  # [BF, HW, C]
    h = linear(P, f"{name}.proj_in", h, q)
    sctx = ctx.repeat_interleave(frames, dim=0)
    pos = temb_mlp(P, f"{name}.time_pos_embed", timestep_embedding(
        torch.arange(frames, dtype=torch.float32, device=x.device), C), q)
    b = f"{name}.transformer_blocks.0"
    h = h + attention(P, f"{b}.attn1", layer_norm(P, f"{b}.norm1", h), None, heads, q)
    h = h + attention(P, f"{b}.attn2", layer_norm(P, f"{b}.norm2", h), sctx, heads, q)
    h = h + feed_forward(P, f"{b}.ff", layer_norm(P, f"{b}.norm3", h), q)
    t = f"{name}.temporal_transformer_blocks.0"
    m = h.view(B, frames, H * W, C) + pos[None, :, None, :]
    m = m + feed_forward(P, f"{t}.ff_in", layer_norm(P, f"{t}.norm_in", m), q)
    # self-attention across frames, per (position, head)
    n = layer_norm(P, f"{t}.norm1", m)
    tq, tk, tv = (linear(P, f"{t}.attn1.to_{p}", n, q, bias=False) for p in "qkv")
    D = C // heads

    def fold(z):  # [B, F, S, C] -> [B*S*heads, F, D]
        return z.view(B, frames, H * W, heads, D).permute(0, 2, 3, 1, 4).reshape(-1, frames, D)

    w = torch.softmax(fold(tq) @ fold(tk).transpose(1, 2) * D ** -0.5, dim=-1)
    q.count(None, 4.0 * tq.numel() * frames)
    o = (w @ fold(tv)).view(B, H * W, heads, frames, D).permute(0, 3, 1, 2, 4)
    m = m + linear(P, f"{t}.attn1.to_out.0", o.reshape(B, frames, H * W, C), q)
    m = m + attention(P, f"{t}.attn2", layer_norm(P, f"{t}.norm2", m).view(B, -1, C),
                      ctx, heads, q).view(B, frames, H * W, C)
    m = m + feed_forward(P, f"{t}.ff", layer_norm(P, f"{t}.norm3", m), q)
    h = mix(P, f"{name}.time_mixer", h, m.reshape(BF, H * W, C))
    h = linear(P, f"{name}.proj_out", h, q)
    return h.transpose(1, 2).reshape(BF, C, H, W) + x


# ---------------------------------------------------------------- towers
def encode_idx(actions: torch.Tensor) -> torch.Tensor:
    """Nav ids [B, F] -> the micro_cond triangular codes [B, F, F]: row i
    holds the ids of frames 0..i, frame 0's forced to stop."""
    a = actions.float().clone()
    a[:, 0] = ACTION_STOP
    return a[:, None, :] * torch.tril(torch.ones(a.shape[1], a.shape[1], device=a.device))


def unet(P, u: dict, sample, t, ctx, noise_aug, action_codes, q: Quant = FP32,
         remat: bool = False):
    """sample [B, F, H, W, 8] (channels last, as served); t [B]; ctx
    [B, 1, D]; noise_aug [B]; action_codes [B, F, A]. Returns [B, F, H, W, 4]."""
    B, Fr, H, W, _ = sample.shape
    chans, heads = u["block_out_channels"], u["num_attention_heads"]
    ch0 = chans[0]
    emb_t = temb_mlp(P, "time_embedding", timestep_embedding(t, ch0), q)
    a = action_codes.float()
    feats = torch.stack([f(m * a) for m in (1.0, 2.0, 4.0, 6.0, 8.0, 10.0)
                         for f in (torch.cos, torch.sin)], dim=-1)
    act = linear(P, "add_action_proj.proj", feats.reshape(B, Fr, -1), q)
    act = temb_mlp(P, "add_embedding_action", act, q)
    noise = temb_mlp(P, "add_embedding_noise", timestep_embedding(
        noise_aug, u["addition_time_embed_dim"]), q)
    emb = (emb_t[:, None] + act + noise[:, None]).reshape(B * Fr, -1)

    def run(fn, *args):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def res(name):
        return lambda x, e: st_resnet(P, name, x, Fr, e, 1e-5, 1e-5, q)

    def tr(name, h):
        return lambda x, c: transformer(P, name, x, Fr, c, h, q)

    x = sample.reshape(B * Fr, H, W, -1).permute(0, 3, 1, 2).contiguous()
    x = conv(P, "conv_in", x, q)
    skips = [x]
    n = len(chans)
    for i in range(n):
        for j in range(u["layers_per_block"]):
            x = run(res(f"down_blocks.{i}.resnets.{j}"), x, emb)
            if i < n - 1:
                x = run(tr(f"down_blocks.{i}.attentions.{j}", heads[i]), x, ctx)
            skips.append(x)
        if i < n - 1:
            x = conv(P, f"down_blocks.{i}.downsamplers.0.conv", x, q, stride=2)
            skips.append(x)
    x = run(res("mid_block.resnets.0"), x, emb)
    x = run(tr("mid_block.attentions.0", heads[-1]), x, ctx)
    x = run(res("mid_block.resnets.1"), x, emb)
    for i in range(n):
        for j in range(u["layers_per_block"] + 1):
            x = run(res(f"up_blocks.{i}.resnets.{j}"), torch.cat([x, skips.pop()], dim=1), emb)
            if i > 0:
                x = run(tr(f"up_blocks.{i}.attentions.{j}", heads[n - 1 - i]), x, ctx)
        if i < n - 1:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = conv(P, f"up_blocks.{i}.upsamplers.0.conv", x, q)
    x = conv(P, "conv_out", group_norm(P, "conv_norm_out", x, 1e-5, True), q)
    return x.permute(0, 2, 3, 1).reshape(B, Fr, H, W, -1)


def vae_attention(P, name, x, q: Quant = FP32):
    """Single-head self-attention over positions, in blocks of queries."""
    N, C, H, W = x.shape
    h = group_norm(P, f"{name}.group_norm", x, 1e-6).flatten(2).transpose(1, 2)
    qh, kh, vh = (linear(P, f"{name}.to_{p}", h, q) for p in "qkv")
    q.count(None, 4.0 * N * (H * W) ** 2 * C)
    out = torch.empty_like(qh)
    for n in range(N):
        for s in range(0, H * W, 2048):
            w = torch.softmax(qh[n, s:s + 2048] @ kh[n].T * C ** -0.5, dim=-1)
            out[n, s:s + 2048] = w @ vh[n]
    o = linear(P, f"{name}.to_out.0", out, q)
    return o.transpose(1, 2).reshape(N, C, H, W) + x


def vae_encode(P, v: dict, images, eps=None, q: Quant = FP32):
    """images [N, H, W, 3] in [-1, 1] -> unscaled latents [N, h, w, 4]:
    the posterior mean, or mean + std * eps with eps [N, h, w, 4]."""
    x = conv(P, "encoder.conv_in", images.permute(0, 3, 1, 2).contiguous(), q)
    n = len(v["block_out_channels"])
    for i in range(n):
        for j in range(v["layers_per_block"]):
            x = resnet(P, f"encoder.down_blocks.{i}.resnets.{j}", x, None, 1e-6, q)
        if i < n - 1:
            x = conv(P, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     F.pad(x, (0, 1, 0, 1)), q, stride=2, padding=0)
    x = resnet(P, "encoder.mid_block.resnets.0", x, None, 1e-6, q)
    x = vae_attention(P, "encoder.mid_block.attentions.0", x, q)
    x = resnet(P, "encoder.mid_block.resnets.1", x, None, 1e-6, q)
    x = conv(P, "encoder.conv_out", group_norm(P, "encoder.conv_norm_out", x, 1e-6, True), q)
    moments = conv(P, "quant_conv", x, q).permute(0, 2, 3, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    if eps is None:
        return mean
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps


def vae_decode(P, v: dict, z, frames: int, q: Quant = FP32):
    """z [B*F, h, w, 4] unscaled -> video [B, F, H, W, 3] (not clamped)."""
    x = conv(P, "decoder.conv_in", z.permute(0, 3, 1, 2).contiguous(), q)

    def res(name, x):
        return st_resnet(P, name, x, frames, None, 1e-6, 1e-5, q, switch=True)

    x = res("decoder.mid_block.resnets.0", x)
    x = vae_attention(P, "decoder.mid_block.attentions.0", x, q)
    x = res("decoder.mid_block.resnets.1", x)
    n = len(v["block_out_channels"])
    for i in range(n):
        for j in range(v["layers_per_block"] + 1):
            x = res(f"decoder.up_blocks.{i}.resnets.{j}", x)
        if i < n - 1:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = conv(P, f"decoder.up_blocks.{i}.upsamplers.0.conv", x, q)
    x = conv(P, "decoder.conv_out", group_norm(P, "decoder.conv_norm_out", x, 1e-6, True), q)
    BF, C, H, W = x.shape
    x = x.view(BF // frames, frames, C, H, W).transpose(1, 2)
    x = tconv(P, "decoder.time_conv_out", x, q)
    return x.permute(0, 2, 3, 4, 1)


def clip_embed(P, c: dict, images, q: Quant = FP32):
    """images [N, H, W, 3] in [-1, 1] -> image embeddings [N, projection]."""
    px = resize_cubic(images.float(), (c["image_size"], c["image_size"]), dims=(1, 2))
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    px = (((px + 1.0) / 2.0 - mean) / std).permute(0, 3, 1, 2)
    e = "vision_model.embeddings"
    x = conv(P, f"{e}.patch_embedding", px, q, stride=c["patch_size"], padding=0)
    N, C = x.shape[:2]
    x = torch.cat([P[f"{e}.class_embedding"].expand(N, 1, C),
                   x.flatten(2).transpose(1, 2)], dim=1)
    x = x + P[f"{e}.position_embedding.weight"][None]
    x = layer_norm(P, "vision_model.pre_layrnorm", x, c["layer_norm_eps"])
    h = c["num_heads"]
    for i in range(c["num_layers"]):
        L = f"vision_model.encoder.layers.{i}"
        y = layer_norm(P, f"{L}.layer_norm1", x, c["layer_norm_eps"])
        qh, kh, vh = (_heads(linear(P, f"{L}.self_attn.{p}_proj", y, q), h) for p in "qkv")
        o = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(x.shape)
        q.count(None, 4.0 * qh.numel() * kh.shape[2])
        x = x + linear(P, f"{L}.self_attn.out_proj", o, q)
        y = layer_norm(P, f"{L}.layer_norm2", x, c["layer_norm_eps"])
        x = x + linear(P, f"{L}.mlp.fc2", F.gelu(linear(P, f"{L}.mlp.fc1", y, q)), q)
    x = layer_norm(P, "vision_model.post_layernorm", x[:, 0], c["layer_norm_eps"])
    return linear(P, "visual_projection", x, q, bias=False)


# ---------------------------------------------------------------- resize
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] antialiased Keys-cubic (a = -0.5) resampling, pixel
    centres aligned, each output's weights summing to one."""
    inv = n_in / n_out
    centres = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(centres[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    return (w / np.where(total != 0, total, 1)).astype(np.float32)


def resize_cubic(x: torch.Tensor, sizes, dims) -> torch.Tensor:
    for size, dim in zip(sizes, dims):
        if x.shape[dim] != size:
            m = torch.from_numpy(resize_matrix(x.shape[dim], size)).to(x.device)
            x = torch.matmul(x.movedim(dim, -1), m).movedim(-1, dim)
    return x


# ---------------------------------------------------------------- sampling
def karras_sigmas(n: int, sigma_min=0.002, sigma_max=700.0, rho=7.0) -> np.ndarray:
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0)


def tail_start(gen: dict) -> Optional[int]:
    """First step of the stale-uncond tail (sigma below gen['cfg_tail_sigma']),
    None when every step runs full CFG."""
    s = karras_sigmas(gen["num_inference_steps"])[:-1]
    k = int(np.sum(s >= gen["cfg_tail_sigma"]))
    if gen["cfg_tail_sigma"] <= 0 or k >= len(s):
        return None
    return max(k, 1)


def pano_noise(base: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """base [F, C, h, w]: a turn's frame takes the previous frame's noise
    rolled by w/16 (22.5 degrees of the pano); other frames keep their own."""
    shift = base.shape[-1] // 16
    frames = [base[0]]
    for f in range(1, base.shape[0]):
        a = int(actions[f])
        if a == ACTION_TURN_LEFT:
            frames.append(torch.roll(frames[-1], shift, dims=-1))
        elif a == ACTION_TURN_RIGHT:
            frames.append(torch.roll(frames[-1], -shift, dims=-1))
        else:
            frames.append(base[f])
    return torch.stack(frames)


@torch.no_grad()
def serve_clip(P, cfg: dict, image_u8: np.ndarray, actions: np.ndarray,
               noise_seed: int, kinds, q: Quant = FP32, device="cuda") -> np.ndarray:
    """One served candidate: image [H, W, 3] uint8, actions [F] nav ids, the
    noise from a generator on `device` seeded `noise_seed` (the
    augmentation noise, then the latent noise), `kinds[i]` "full" (both CFG
    rows) or "cond" (the cond row against the last full step's uncond).
    Returns uint8 frames [F, 3, oh, ow]."""
    u, v, c, gen = cfg["unet"], cfg["vae"], cfg["clip"], cfg["generation"]
    Fr = gen["num_frames"]
    scale = 2 ** (len(v["block_out_channels"]) - 1)
    img = torch.from_numpy(image_u8.astype(np.float32) / 127.5 - 1.0).to(device)[None]
    H, W = img.shape[1:3]
    h, w = H // scale, W // scale
    g = torch.Generator(device=device).manual_seed(int(noise_seed))
    aug = img + gen["noise_aug_strength"] * torch.randn(img.shape, generator=g, device=device)
    base = torch.randn((Fr, 4, h, w), generator=g, device=device)
    acts = torch.as_tensor(actions)
    noise = pano_noise(base, acts).permute(0, 2, 3, 1)  # [F, h, w, 4]
    emb = clip_embed(P, c, img)[:, None]  # [1, 1, D]
    img_lat = vae_encode(P, v, aug)  # [1, h, w, 4]
    img_lat = img_lat[:, None].expand(1, Fr, h, w, 4)
    codes = encode_idx(acts[None].to(device))
    sig = torch.tensor(karras_sigmas(gen["num_inference_steps"]), dtype=torch.float64)
    scales = torch.linspace(gen["min_guidance_scale"], gen["max_guidance_scale"], Fr,
                           device=device)[None, :, None, None, None]
    x = (noise * float(sig[0]))[None].double()
    aug_t = torch.full((2,), gen["noise_aug_strength"], device=device)
    uncond = None
    for i, kind in enumerate(kinds):
        s, s_next = float(sig[i]), float(sig[i + 1])
        xin = (x / math.sqrt(s * s + 1.0)).float()
        t = torch.full((1,), 0.25 * math.log(s), device=device)
        cond_in = torch.cat([xin, img_lat], dim=-1)
        if kind == "full":
            both = torch.cat([torch.cat([xin, torch.zeros_like(img_lat)], dim=-1), cond_in])
            pred = unet(P, u, both, t.expand(2), torch.cat([torch.zeros_like(emb), emb]),
                        aug_t, codes.expand(2, -1, -1), q)
            uncond, cond = pred[:1], pred[1:]
        else:
            cond = unet(P, u, cond_in, t, emb, aug_t[:1], codes, q)
        pred = (uncond + scales * (cond - uncond)).double()
        denoised = -s / math.sqrt(s * s + 1.0) * pred + x / (s * s + 1.0)
        x = x + (x - denoised) / s * (s_next - s)
    z = (x.float() / v["scaling_factor"]).reshape(Fr, h, w, 4)
    video = (vae_decode(P, v, z, Fr)[0] / 2.0 + 0.5).clamp(0.0, 1.0)
    oh, ow = gen["out_height"], gen["out_width"]
    video = resize_cubic(video, (oh, ow), dims=(1, 2)).clamp(0.0, 1.0)
    return torch.round(video * 255.0).to(torch.uint8).permute(0, 3, 1, 2).cpu().numpy()


# ---------------------------------------------------------------- training
def dropout_flags(u: float):
    """The 8-scenario discrete conditioning dropout of one sample's uniform
    draw u: (drop actions, drop the CLIP embedding, drop the image latents)."""
    a = u < 0.1 or 0.4 <= u < 0.7
    b = 0.1 <= u < 0.2 or 0.3 <= u < 0.5 or 0.6 <= u < 0.7
    c = 0.2 <= u < 0.4 or 0.5 <= u < 0.7
    return a, b, c


def train_sample_loss(P, cfg, frames, actions, d: dict, q: Quant = FP32):
    """One clip's EDM loss. frames [F, H, W, 3] in [-1, 1], actions [F] nav
    ids; d the sample's draws: vae_eps [F, h, w, 4], cond_sigma_z,
    cond_noise [H, W, 3], latent_noise [F, 4, h, w], sigma_z, dropout_u."""
    u, v, c, t = cfg["unet"], cfg["vae"], cfg["clip"], cfg["train"]
    Fr = frames.shape[0]
    with torch.no_grad():
        lat = torch.cat([vae_encode(P, v, frames[i:i + 2], d["vae_eps"][i:i + 2])
                         for i in range(0, Fr, 2)]) * v["scaling_factor"]
        cond = frames[:1]
        sigma_c = math.exp(-3.0 + 0.5 * float(d["cond_sigma_z"]))
        cond_lat = vae_encode(P, v, cond + sigma_c * d["cond_noise"][None])
        emb = clip_embed(P, c, cond)[:, None]
        noise = pano_noise(d["latent_noise"], actions.cpu()).permute(0, 2, 3, 1)
        sigma = math.exp(0.7 + 1.6 * float(d["sigma_z"]))
        noisy = lat + noise * sigma
        inp = noisy / math.sqrt(sigma * sigma + 1.0)
        codes = encode_idx(actions[None])
        drop_a, drop_b, drop_c = dropout_flags(float(d["dropout_u"]))
        if drop_a:
            codes = torch.full_like(codes, -1.0)
        if drop_b:
            emb = torch.zeros_like(emb)
        if drop_c:
            cond_lat = torch.zeros_like(cond_lat)
        sample = torch.cat([inp, cond_lat.expand(Fr, *cond_lat.shape[1:])], dim=-1)[None]
        dev = frames.device
    pred = unet(P, u, sample, torch.full((1,), 0.25 * math.log(sigma), device=dev), emb,
                torch.full((1,), sigma_c, device=dev), codes, q, remat=True)[0]
    denoised = -sigma / math.sqrt(sigma * sigma + 1.0) * pred + noisy / (sigma * sigma + 1.0)
    return (1.0 + sigma * sigma) / (sigma * sigma) * ((denoised - lat) ** 2).mean()


def train_reference(cfg, P, steps, q: Quant = FP32, half: bool = False,
                    start: Optional[dict] = None) -> dict:
    """The training steps `steps` (each (batch, draws): batch pixel_values
    [A, B, F, H, W, 3], actions [A, B, F]; draws one dict a micro-step) on
    the UNet leaves of P (float32, trained whole), in float32: the mean
    loss, gradients averaged over the step's clips, clipped by their global
    norm, AdamW (torch's decoupled form), then the EMA. `half` leaves out
    the second half of every micro-batch (a fault, for the check's
    calibration). The optimizer starts fresh (moments nought, the EMA the
    parameters), or from `start`: {"m", "v", "ema": leaf name -> tensor,
    "step": the steps already taken}. Returns each step's loss, the first
    step's clipped gradient norm a leaf, and the change of the parameters
    and of the EMA a leaf from the start to the last step."""
    t = cfg["train"]
    names = list(param_spec(cfg)["unet"])
    p0 = [P[n].detach().clone() for n in names]
    params = [P[n].detach().requires_grad_(True) for n in names]
    Pt = dict(P)
    Pt.update(zip(names, params))
    if start is None:
        m = [torch.zeros_like(p) for p in params]
        v2 = [torch.zeros_like(p) for p in params]
        ema = [p.detach().clone() for p in params]
        e0, step0 = p0, 0
    else:
        m, v2, ema = ([start[key][n] for n in names] for key in ("m", "v", "ema"))
        e0, step0 = [e.clone() for e in ema], int(start["step"])
    b1, b2, lr, wd, eps = t["adam_beta1"], t["adam_beta2"], t["learning_rate"], \
        t["weight_decay"], t["adam_eps"]
    out = {"loss": []}
    for k, (batch, draws) in enumerate(steps):
        for p in params:
            p.grad = None
        A, B = batch["actions"].shape[:2]
        rows = range(B // 2) if half else range(B)
        total = 0.0
        for a in range(A):
            for b in rows:
                d = {key: (val[b * batch["pixel_values"].shape[2]:(b + 1) * batch["pixel_values"].shape[2]]
                           if key == "vae_eps" else val[b]) for key, val in draws[a].items()}
                loss = train_sample_loss(Pt, cfg, batch["pixel_values"][a, b].float(),
                                         batch["actions"][a, b], d, q) / (A * len(rows))
                loss.backward()
                total += float(loss.detach())
        out["loss"].append(total)
        for p in params:
            if p.grad is None:  # a leaf the loss does not reach: a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        if norm >= t["max_grad_norm"]:
            torch._foreach_mul_(grads, t["max_grad_norm"] / norm)
        if k == 0:
            out["grad"] = {n: g.norm().item() for n, g in zip(names, grads)}
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** (step0 + k + 1), 1 - b2 ** (step0 + k + 1)
            for i, (p, g) in enumerate(zip(params, grads)):
                p.mul_(1 - lr * wd)
                m[i].mul_(b1).add_(g, alpha=1 - b1)
                v2[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.addcdiv_(m[i], v2[i].sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)
                ema[i].mul_(t["ema_decay"]).add_(p, alpha=1 - t["ema_decay"])
    with torch.no_grad():
        out["change"] = {n: (p - p_).norm().item() for n, p, p_ in zip(names, params, p0)}
        out["ema_change"] = {n: (e - e_).norm().item() for n, e, e_ in zip(names, ema, e0)}
    return out


def leaf_gap(program: dict, reference: dict, ref_grad: dict, floor: float = 1e-3):
    """The worst leaf's gap between two norms a leaf: |program - reference|
    over the larger of the reference's norm of that leaf and of the median
    leaf, over the leaves whose reference gradient is above `floor` of the
    median leaf's (a leaf whose gradient is nought to rounding moves by
    round-off alone). Returns (gap, the leaf's name)."""
    med_g = float(np.median(list(ref_grad.values())))
    keep = [n for n in reference if ref_grad[n] > floor * med_g]
    med = float(np.median([reference[n] for n in keep]))
    return max((abs(program[n] - reference[n]) / max(reference[n], med), n) for n in keep)
