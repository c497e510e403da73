"""Attention dispatch for the UNet's spatial self-attention.

Port of `wiw_tpu/ops/attention.py`. Dispatch is by tensor device: every
call goes to `flash_attention` (kernel K1 on a CUDA tensor, its plain version
on a CPU tensor). The reference's S >= 1024 threshold for its Pallas kernel
was a TPU speed choice; the math below it is the same, so on the card every
spatial self-attention (S = 9216, 2304, 576 and 144 at 576x1024) takes K1.

Under shard_clip (`parallel/clip_sharding`) a spatial self-attention's
positions are this rank's rows of the feature map: the call goes through
`clip_sharding.spatial_attention` (the Ulysses reshard around K1), as the
reference's `dot_product_attention` does under its context. The reference
recognises such a call by Sq == Sk at trace time, where shapes are global;
here shapes are this rank's, so the caller says it (`spatial`).
"""

from __future__ import annotations

import torch

from wiw_tpu_torch.ops.flash_attention import flash_attention
from wiw_tpu_torch.parallel import clip_sharding


def attention_bsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int, spatial: bool = False) -> torch.Tensor:
    """Attention over [B, S, H*D] projections (transformer layout). Heads
    are strided views: the kernel reads them in place. `spatial`: a
    self-attention over the positions of a feature map, head-sharded when
    shard_clip splits its rows."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // heads
    qh = q.view(B, Sq, heads, D).transpose(1, 2)
    kh = k.view(B, Sk, heads, D).transpose(1, 2)
    vh = v.view(B, Sk, heads, D).transpose(1, 2)
    cs = clip_sharding.row_sharded() if spatial else None
    if cs is not None:
        out = clip_sharding.spatial_attention(cs, qh, kh, vh)
    else:
        out = flash_attention(qh, kh, vh)
    return out.transpose(1, 2).reshape(B, Sq, HD)
