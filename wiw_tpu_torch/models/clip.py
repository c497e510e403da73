"""CLIP ViT image encoder with projection (SVD's conditioning tower).

Port of `wiw_tpu/models/clip.py`: ViT-H/14 by default (hidden 1280, 32
layers, 16 heads, 224x224 input, projected to 1024), with the transformers
`CLIPVisionModelWithProjection` parameter names. `preprocess_for_clip`
resizes with the shared JAX-matching cubic antialiased resize.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from wiw_tpu_torch.ops.resize import resize_cubic

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        C = c.hidden_size
        self.heads = c.num_heads
        self.q_proj = Linear(C, C)
        self.k_proj = Linear(C, C)
        self.v_proj = Linear(C, C)
        self.out_proj = Linear(C, C)

    def forward(self, x):
        B, S, C = x.shape
        hd = C // self.heads
        q = self.q_proj(x) * hd ** -0.5

        def heads(t):
            return t.reshape(B, S, self.heads, hd).transpose(1, 2)

        logits = torch.matmul(heads(q).float(), heads(self.k_proj(x)).float()
                              .transpose(-1, -2))
        v = heads(self.v_proj(x))
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, S, C)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    """fc1 -> exact gelu -> fc2 (laion ViT-H's activation)."""

    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.fc1 = Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.self_attn = CLIPAttention(c)
        self.layer_norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.mlp = CLIPMLP(c)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        n_patches = (c.image_size // c.patch_size) ** 2
        self.patch_embedding = Conv2d(3, c.hidden_size, c.patch_size,
                                      stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.position_embedding = nn.Embedding(n_patches + 1, c.hidden_size)

    def forward(self, pixels):
        patches = self.patch_embedding(pixels)  # [B, h, w, C]
        B, C = patches.shape[0], patches.shape[-1]
        dt = patches.dtype
        x = torch.cat([self.class_embedding.to(dt).expand(B, 1, C),
                       patches.reshape(B, -1, C)], dim=1)
        return x + self.position_embedding.weight.to(dt)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(c) for _ in range(c.num_layers)])


class CLIPVisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(c)
        self.pre_layrnorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.encoder = CLIPEncoder(c)
        self.post_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """[B, 224, 224, 3] normalized pixels -> image_embeds [B, projection_dim]."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim,
                                        bias=False)

    def forward(self, pixels):
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def preprocess_for_clip(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> CLIP-normalized fp32 [B, 224, 224, 3]."""
    resized = resize_cubic(images.float(), (224, 224), dims=(1, 2))
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return ((resized + 1.0) / 2.0 - mean) / std
