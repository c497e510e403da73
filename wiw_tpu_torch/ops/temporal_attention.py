"""Temporal self-attention over frames on [B, F, S, H*D].

Port of the reference's default formulation,
`temporal_self_attention_batched` (wiw_tpu/ops/temporal_attention.py):
(batch, position, head) fold into one batch axis and the F x F attention
runs as batched matmuls. The reference's Pallas `_kernel` for this op is
kernel K4, not ported yet (it is off the serving path by default).
"""

from __future__ import annotations

import torch


def temporal_self_attention_batched(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, heads: int) -> torch.Tensor:
    """q, k, v: [B, F, S, H*D] -> [B, F, S, H*D]; attention over F for each
    (position, head). Logits and softmax in fp32, weights cast to v's dtype."""
    B, F, S, HD = q.shape
    D = HD // heads

    def fold(x):
        return (x.reshape(B, F, S, heads, D).permute(0, 2, 3, 1, 4)
                .reshape(B * S * heads, F, D))

    qf, kf, vf = fold(q), fold(k), fold(v)
    logits = torch.bmm(qf.float(), kf.float().transpose(1, 2))  # [N, F, G]
    w = torch.softmax(logits * D ** -0.5, dim=-1).to(v.dtype)
    out = torch.bmm(w, vf)
    return (out.reshape(B, S, heads, F, D).permute(0, 3, 1, 2, 4)
            .reshape(B, F, S, HD))
