"""Attention dispatch for the UNet's spatial self-attention.

Port of `wiw_tpu/ops/attention.py`. Dispatch is by tensor device: every
call goes to `flash_attention` (kernel K1 on a CUDA tensor, its plain version
on a CPU tensor). The reference's S >= 1024 threshold for its Pallas kernel
was a TPU speed choice; the math below it is the same, so on the card every
spatial self-attention (S = 9216, 2304, 576 and 144 at 576x1024) takes K1.
"""

from __future__ import annotations

import torch

from wiw_tpu_torch.ops.flash_attention import flash_attention


def attention_bsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Attention over [B, S, H*D] projections (transformer layout). Heads
    are strided views: the kernel reads them in place."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // heads
    qh = q.view(B, Sq, heads, D).transpose(1, 2)
    kh = k.view(B, Sk, heads, D).transpose(1, 2)
    vh = v.view(B, Sk, heads, D).transpose(1, 2)
    out = flash_attention(qh, kh, vh)
    return out.transpose(1, 2).reshape(B, Sq, HD)
