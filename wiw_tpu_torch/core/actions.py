"""Action codecs for the `micro_cond` strategy.

Port of `wiw_tpu/core/actions.py` (`encode_idx` and the navigation branch
of `get_action_ids`). The one-hot `action_block` codec
and the manipulation pose codecs wait for the UNet's action-block port.

Nav action vocabulary: 1 = forward, 2 = turn_left, 3 = turn_right,
4 = stop, 0 = placeholder.
"""

from __future__ import annotations

import torch

ACTION_FORWARD = 1
ACTION_TURN_LEFT = 2
ACTION_TURN_RIGHT = 3
ACTION_STOP = 4
ACTION_PLACEHOLDER = 0


def encode_idx(actions: torch.Tensor) -> torch.Tensor:
    """'micro_cond' nav codec: [B, F] ids -> [B, F, F] triangular encoding.

    out[b, i, j] = a[b, j] for j <= i else 0, with a[b, 0] forced to stop.
    """
    if actions.ndim != 2:
        raise ValueError(f"expected [B, F], got {tuple(actions.shape)}")
    F = actions.shape[1]
    a = actions.to(torch.int32).clone()
    a[:, 0] = ACTION_STOP
    mask = torch.tril(torch.ones(F, F, dtype=torch.int32, device=a.device))
    return a[:, None, :] * mask[None, :, :]


def get_action_ids(actions: torch.Tensor, strategy: str) -> torch.Tensor:
    """Encode [B, F] nav ids for `strategy`; fp32 [B, F, F] for micro_cond."""
    if strategy == "micro_cond":
        if actions.ndim != 2:
            raise NotImplementedError(
                "manipulation pose actions ([B, F, 8]) are not ported yet")
        return encode_idx(actions).to(torch.float32)
    if strategy in ("action_block", "action_block_nocfg"):
        raise NotImplementedError(
            f"action strategy {strategy!r} is not ported yet")
    return torch.zeros(0, dtype=torch.float32, device=actions.device)
