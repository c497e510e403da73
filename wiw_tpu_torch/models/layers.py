"""Building blocks for the SVD-family models, as torch `nn.Module`s.

Port of `wiw_tpu/models/layers.py`. Activations keep the reference's
channels-last layouts ([N, H, W, C], [B, F, H, W, C], [N, S, C]); convs
permute to NCHW views at their edges, which for a contiguous channels-last
tensor is a channels_last-strided view, so no copy is made.

Precision follows the reference (flax `promote_dtype`): Linear/Conv cast
their input, weight and bias to the module's compute dtype at use. That is
the weight dtype unless `set_compute_dtype` says otherwise, so serving
(bf16 weights) computes in bf16 with no cast, and training keeps fp32
parameters that compute in bf16. Norm parameters stay fp32 and norms
compute in fp32, returning the input dtype (`cast_matmul_weights` casts
only Linear/Conv weights, never a norm). No `torch.autocast`: its per-op
rules are not the reference's.

W8A8 int8 (the reference's `Dense`/`Conv` int8 route): a Linear or Conv2d
whose weight `ops/quant.quantize_params` made int8, with an fp32
`weight_scale` beside it, computes through kernel K7 (`w8a8_dense`,
`w8a8_conv`) on its input as it arrives, never promoted first, and returns
its compute dtype (the model dtype). `cast_matmul_weights` leaves such a
layer as it is (int8 weight, fp32 scale and bias).

Under shard_clip (`parallel/clip_sharding.activate`) the layers that see
more than one position run row-sharded: a 3x3 conv on this rank's halo'd
rows, the resamplers with their output re-split to the next level,
GroupNorm on K8's split entries, spatial self-attention head-sharded, and
every int8 conv with the amax of the whole call. Per-position layers
(1x1 convs, the temporal (3, 1, 1) conv, Linear, LayerNorm, K6) are
unchanged; outside the context nothing changes.

Submodule and parameter names are the diffusers ones, so checkpoints load
with `load_state_dict` and `models/convert.py` maps the reference's flax
trees onto them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.core.schedule import timestep_embedding
from wiw_tpu_torch.ops.attention import attention_bsd
from wiw_tpu_torch.ops.fused_mlp import (
    C_STEP,
    ln_geglu_ffn_residual,
    lnff_eligible,
)
from wiw_tpu_torch.ops.group_norm import group_norm
from wiw_tpu_torch.ops.quant import w8a8_conv, w8a8_conv_halo, w8a8_dense
from wiw_tpu_torch.ops.temporal_attention import temporal_self_attention
from wiw_tpu_torch.parallel import clip_sharding


class _Promote:
    """Compute dtype of a Linear/Conv: `set_compute_dtype`'s, else the
    weight's."""

    _compute_dtype = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return self._compute_dtype or self.weight.dtype

    @property
    def int8(self) -> bool:
        return self.weight.dtype == torch.int8

    def _promoted(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every Linear/Conv of `module` compute in `dtype` whatever its
    parameters' dtype (flax's `dtype` beside `param_dtype`)."""
    for m in module.modules():
        if isinstance(m, _Promote):
            m._compute_dtype = dtype
    return module


class Linear(_Promote, nn.Linear):
    """nn.Linear that casts input, weight and bias to its compute dtype."""

    def forward(self, x):
        if self.int8:
            if x.numel() == 0:  # a rank without rows under shard_clip
                return x.new_empty(*x.shape[:-1], self.out_features,
                                   dtype=self.compute_dtype)
            return w8a8_dense(x, self.weight, self.weight_scale, self.bias,
                              self.compute_dtype)
        return F.linear(*self._promoted(x))


class Conv2d(_Promote, nn.Conv2d):
    """3x3/1x1 conv on channels-last [N, H, W, C]; `pad` is
    (left, right, top, bottom) when asymmetric padding is needed."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 bias=True, pad=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.pad = pad

    def forward(self, x):
        cs = clip_sharding.current()
        if cs is not None and (self.int8 or cs.row_split):
            return self.sharded(cs, x)
        if self.int8:
            return w8a8_conv(x.contiguous(), self.weight, self.weight_scale,
                             self.bias, stride=self.stride[0],
                             padding=self.padding[0], dtype=self.compute_dtype)
        x, w, b = self._promoted(x)
        x = x.permute(0, 3, 1, 2)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return self._conv_forward(x, w, b).permute(0, 2, 3, 1)

    def valid(self, x, amax=None, padding=0):
        """The conv at `padding` (0: of an x padded by hand), with the int8
        activation amax given where it spans more than x; an x too short
        for one output row gives an empty output and no launch."""
        kh, kw = self.kernel_size
        s = self.stride[0]
        N, H, W, _ = x.shape
        if H + 2 * padding < kh:
            return x.new_empty(N, 0, (W + 2 * padding - kw) // s + 1,
                               self.out_channels, dtype=self.compute_dtype)
        if self.int8:
            return w8a8_conv(x.contiguous(), self.weight, self.weight_scale,
                             self.bias, stride=s, padding=padding,
                             dtype=self.compute_dtype, amax=amax)
        x, w, b = self._promoted(x)
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, s, padding).permute(0, 2, 3, 1)

    def sharded(self, cs, x, resample=None):
        """The conv under shard_clip (`parallel/clip_sharding`): an int8
        conv's amax over every rank of the call; with rows split, a 3x3 conv
        on this rank's halo'd rows (`resample`: the level's stride-2 conv or
        nearest x2 + conv, `clip_sharding.downsample` / `upsample`)."""
        if self.pad is not None or self.padding[0] != self.kernel_size[0] // 2:
            raise ValueError("shard_clip takes SAME convs only")
        amax = clip_sharding.global_amax(cs, x) if self.int8 else None
        if not cs.row_split or self.kernel_size[0] == 1:
            return self.valid(x, amax, self.padding[0])
        if resample is not None:
            return resample(cs, x, lambda e: self.valid(e, amax))
        if self.stride[0] != 1:
            raise ValueError("shard_clip: a strided conv runs as a resampler")
        if self.int8:  # the neighbour rows go straight into the kernel's pass
            return w8a8_conv_halo(x.contiguous(), *clip_sharding.neighbour_rows(cs, x),
                                  self.weight, self.weight_scale, self.bias, amax=amax,
                                  dtype=self.compute_dtype)
        return self.valid(clip_sharding.halo(cs, x), amax)


class TemporalConv(_Promote, nn.Conv3d):
    """(3, 1, 1) conv over the frame axis of channels-last [B, F, H, W, C]."""

    def __init__(self, in_ch, out_ch):
        super().__init__(in_ch, out_ch, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        if x.numel() == 0:  # a rank without rows under shard_clip
            return x.new_empty(*x.shape[:-1], self.out_channels,
                               dtype=self.compute_dtype)
        x, w, b = self._promoted(x)
        return self._conv_forward(x.permute(0, 4, 1, 2, 3), w, b).permute(
            0, 2, 3, 4, 1)


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast Linear/Conv parameters to `dtype`, leaving norms, mix factors
    and embeddings in fp32 (the reference casts those at use), and int8
    layers as they are."""
    for m in module.modules():
        if (isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d))
                and m.weight.dtype != torch.int8):
            m.to(dtype)
    return module


class GroupNorm(nn.Module):
    """GroupNorm over the last (channel) axis in fp32, exact two-pass
    statistics, each batch row on its own, then SiLU when `silu` (the
    reference's `silu(norm(x))`). Channel grouping matches torch's
    (contiguous chunks). Kernel K8 on a CUDA tensor (`ops/group_norm.py`)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.groups = (num_groups if num_channels % num_groups == 0
                       and num_channels >= num_groups else num_channels)
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        cs = clip_sharding.row_sharded()
        if cs is not None:  # positions split over ranks (shard_clip)
            return clip_sharding.group_norm(cs, x, self.weight, self.bias,
                                            self.groups, self.eps, self.silu)
        return group_norm(x, self.weight, self.bias, self.groups, self.eps,
                          self.silu)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in fp32; returns the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        out = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                           self.eps)
        return out.to(x.dtype)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers embeddings.TimestepEmbedding)."""

    def __init__(self, in_dim: int, embed_dim: int, out_dim: int | None = None):
        super().__init__()
        self.linear_1 = Linear(in_dim, embed_dim)
        self.linear_2 = Linear(embed_dim, out_dim or embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward; `net` indices follow diffusers (0 = GEGLU,
    1 = dropout slot, 2 = out projection)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    """diffusers `Attention` in its transformer-block configuration: no qkv
    bias, output projection with bias. Each projection is its own Linear
    (the reference's fused-projection fold path is not ported), so an int8
    to_q/to_k/to_v/to_out (the aggressive W8A8 set) takes K7 like any other
    Linear, as the reference steps aside from its fold path for int8."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None):
        if context is not None and context.shape[-2] == 1:
            # exact shortcut: with one key token the softmax is identically
            # 1, so every query's output is V's projection
            o = self.to_out[0](self.to_v(context))  # [B, 1, C]
            o = o.reshape(o.shape[0], *([1] * (x.ndim - 2)), o.shape[-1])
            return o.expand(x.shape)
        if x.ndim == 4:
            # temporal cross-attention with a multi-token context (the
            # past_images tokens) on [B, F, S, C]: positions folded into the
            # batch, each row's context repeated per position as the
            # reference repeats it (projected first: the projection is per
            # token, so the values are the same)
            B, F_, S, C = x.shape
            xq = x.transpose(1, 2).reshape(B * S, F_, C)
            k, v = (p(context).repeat_interleave(S, dim=0)
                    for p in (self.to_k, self.to_v))
            out = self.to_out[0](attention_bsd(self.to_q(xq), k, v, self.heads))
            return out.reshape(B, S, F_, C).transpose(1, 2)
        spatial = context is None  # self-attention over a map's positions
        context = x if context is None else context
        out = attention_bsd(self.to_q(x), self.to_k(context),
                            self.to_v(context), self.heads, spatial)
        return self.to_out[0](out)


class TemporalSelfAttention(CrossAttention):
    """Self-attention across frames on [B, F, S, C]; same parameters as
    CrossAttention. `mode` is the formulation (ops/temporal_attention.py)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 mode: str = "batched"):
        super().__init__(query_dim, heads, dim_head)
        self.mode = mode

    def forward(self, x):
        out = temporal_self_attention(
            self.to_q(x), self.to_k(x), self.to_v(x), self.heads, self.mode)
        return self.to_out[0](out)


def _ln_ff_residual(x, ln: LayerNorm, ff: FeedForward, fused: bool,
                    gate: str = "f32"):
    """x + ff(ln(x)). With `fused`, kernel K6 (its gate in `gate`: K6-bf16
    for "bf16") where `lnff_eligible` (the reference's rule) allows it, C
    is a multiple of the kernel's C_STEP and neither projection is int8 (in
    W8A8 mode the reference takes the unfused path, its projections through
    K7); elsewhere the unfused modules, the function the reference's
    unfused oracle computes (a route by shape, see `fused_mlp`; the
    reference's gate switch acts only inside its kernel).
    The modules keep their parameters either way, so checkpoints map alike.
    The weights and biases go to K6 in the Linear layers' compute dtype, as
    they would through the modules."""
    proj, out = ff.net[0].proj, ff.net[2]
    if (fused and x.shape[-1] % C_STEP == 0 and not out.int8
            and lnff_eligible(x, proj.weight, out.weight)):
        dt = proj.compute_dtype
        return ln_geglu_ffn_residual(
            x, ln.weight, ln.bias, proj.weight.to(dt), proj.bias.to(dt),
            out.weight.to(dt), out.bias.to(dt), ln.eps, gate)
    return x + ff(ln(x))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 fused_ff: bool = False, fused_ff_gate: str = "f32"):
        super().__init__()
        self.fused_ff = fused_ff
        self.fused_ff_gate = fused_ff_gate
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return _ln_ff_residual(x, self.norm3, self.ff, self.fused_ff,
                               self.fused_ff_gate)


class TemporalBasicTransformerBlock(nn.Module):
    """ff_in -> self-attn over frames -> cross-attn -> ff on [B, F, S, C]."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 fused_ff: bool = False, temporal_attention: str = "batched",
                 fused_ff_gate: str = "f32"):
        super().__init__()
        self.fused_ff = fused_ff
        self.fused_ff_gate = fused_ff_gate
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = TemporalSelfAttention(dim, heads, dim_head,
                                           temporal_attention)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = _ln_ff_residual(x, self.norm_in, self.ff_in, self.fused_ff,
                            self.fused_ff_gate)
        x = x + self.attn1(self.norm1(x))
        if context is not None:
            x = x + self.attn2(self.norm2(x), context)
        return _ln_ff_residual(x, self.norm3, self.ff, self.fused_ff,
                               self.fused_ff_gate)


class AlphaBlender(nn.Module):
    """alpha*x_spatial + (1-alpha)*x_temporal with alpha = sigmoid(mix);
    `switch` flips the roles (temporal VAE)."""

    def __init__(self, alpha_init: float = 0.5, switch: bool = False):
        super().__init__()
        self.alpha_init = alpha_init
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha_init)))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor)[0].to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> (+temb) -> GN -> silu -> conv -> +skip on NHWC."""

    def __init__(self, in_ch: int, out_ch: int, eps: float = 1e-6,
                 temb_ch: int | None = None):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, eps=eps, silu=True)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch is not None:
            self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch, eps=eps, silu=True)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """Temporal resnet over [B, F, H, W, C] with (3, 1, 1) convs; channels
    in == out (it always follows the spatial block of the same width)."""

    def __init__(self, ch: int, eps: float = 1e-6, temb_ch: int | None = None):
        super().__init__()
        self.norm1 = GroupNorm(ch, eps=eps, silu=True)
        self.conv1 = TemporalConv(ch, ch)
        if temb_ch is not None:
            self.time_emb_proj = Linear(temb_ch, ch)
        self.norm2 = GroupNorm(ch, eps=eps, silu=True)
        self.conv2 = TemporalConv(ch, ch)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = self.conv2(self.norm2(h))
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet (frames in batch) + temporal resnet, alpha-blended.
    Input [B*F, H, W, C]; temb [B*F, C_temb] or None."""

    def __init__(self, in_ch: int, out_ch: int, eps: float = 1e-6,
                 temporal_eps: float | None = None, merge_factor: float = 0.5,
                 switch: bool = False, temb_ch: int | None = None):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_ch, out_ch, eps, temb_ch)
        self.temporal_res_block = TemporalResnetBlock(
            out_ch, temporal_eps if temporal_eps is not None else eps, temb_ch)
        self.time_mixer = AlphaBlender(merge_factor, switch)

    def forward(self, x, num_frames: int, temb=None):
        x = self.spatial_res_block(x, temb)
        BF, H, W, C = x.shape
        x5 = x.reshape(BF // num_frames, num_frames, H, W, C)
        temb5 = (temb.reshape(BF // num_frames, num_frames, -1)
                 if temb is not None else None)
        h = self.temporal_res_block(x5, temb5)
        return self.time_mixer(x5, h).reshape(BF, H, W, C)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; `asymmetric_pad` is the VAE encoder's (0, 1) pad."""

    def __init__(self, ch: int, asymmetric_pad: bool = False):
        super().__init__()
        if asymmetric_pad:
            self.conv = Conv2d(ch, ch, 3, stride=2, pad=(0, 1, 0, 1))
        else:
            self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        cs = clip_sharding.row_sharded()
        if cs is not None:  # re-split to the next level's rule
            return self.conv.sharded(cs, x, clip_sharding.downsample)
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv on NHWC."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        cs = clip_sharding.row_sharded()
        if cs is not None:  # re-split to the next level's rule
            return self.conv.sharded(cs, x, clip_sharding.upsample)
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)


class TransformerSpatioTemporal(nn.Module):
    """Spatial + temporal (+ optional action) transformer over feature maps
    [B*F, H, W, C]; `context` is [B, S_ctx, cross_dim] CLIP embeddings
    (tiled per frame inside). With `action_dim` set (the action_block
    strategies) each layer adds the action branch:
    `temporal_transformer_blocks_action_{l}`, a BasicTransformerBlock whose
    cross-attention reads the per-frame action token `action_context`
    [B*F, 1, action_dim], merged by `time_mixer_action` (alpha init 1.0)."""

    def __init__(self, ch: int, heads: int, dim_head: int, context_dim: int,
                 num_layers: int = 1, fused_ff: bool = False,
                 temporal_attention: str = "batched", fused_ff_gate: str = "f32",
                 action_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(ch, eps=1e-6)
        self.proj_in = Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim, fused_ff,
                                   fused_ff_gate)
             for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, dim_head, context_dim,
                                           fused_ff, temporal_attention,
                                           fused_ff_gate)
             for _ in range(num_layers)])
        if action_dim is not None:
            self.temporal_transformer_blocks_action = nn.ModuleList(
                [BasicTransformerBlock(inner, heads, dim_head, action_dim,
                                       fused_ff, fused_ff_gate)
                 for _ in range(num_layers)])
            self.time_mixer_action = AlphaBlender(1.0)
        self.time_pos_embed = TimestepEmbedding(ch, ch * 4, out_dim=ch)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = Linear(inner, ch)

    def forward(self, x, num_frames: int, context=None, action_context=None):
        BF, H, W, C = x.shape
        B = BF // num_frames
        residual = x
        h = self.proj_in(self.norm(x).reshape(BF, H * W, C))
        inner = h.shape[-1]
        spatial_context = (context.repeat_interleave(num_frames, dim=0)
                           if context is not None else None)
        frame_ids = torch.arange(num_frames, dtype=torch.float32,
                                 device=x.device)
        t_emb = timestep_embedding(frame_ids, C).to(self.proj_in.compute_dtype)
        pos = self.time_pos_embed(t_emb)  # [F, C]
        actions = getattr(self, "temporal_transformer_blocks_action",
                          [None] * len(self.transformer_blocks))
        for block, tblock, ablock in zip(self.transformer_blocks,
                                         self.temporal_transformer_blocks,
                                         actions):
            h = block(h, spatial_context)
            hmix = h.reshape(B, num_frames, H * W, inner) + pos[None, :, None, :]
            hmix = tblock(hmix, context).reshape(BF, H * W, inner)
            h = self.time_mixer(h, hmix)
            if ablock is not None:
                h = self.time_mixer_action(h, ablock(h, action_context))
        return self.proj_out(h).reshape(BF, H, W, C) + residual
