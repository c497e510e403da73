"""Pano-correlated initial latent noise.

Port of `wiw_tpu/core/noise.py`. Frame 0 keeps its own Gaussian noise; a
later frame whose action is turn_left (2) takes the previous frame's noise
rolled by +W/16 (22.5 deg of a 360 deg pano), turn_right (3) by -W/16, any
other action keeps its own noise. The base noise comes from a
`torch.Generator` or is injected by the caller, so tests can hand the same
draw to both packages.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import torch

from wiw_tpu_torch.core.actions import ACTION_TURN_LEFT, ACTION_TURN_RIGHT

# angle (deg) -> fraction of the pano width
ANGLE_TO_FRACTION = {
    22.5: Fraction(1, 16),
    45.0: Fraction(1, 8),
    67.5: Fraction(3, 16),
    90.0: Fraction(1, 4),
    112.5: Fraction(5, 16),
    180.0: Fraction(1, 2),
}


def rotation_shift(angle: float, width: int) -> int:
    """Lane shift for a pano rotation by `angle` degrees at width `width`."""
    a = float(angle)
    if a in (0.0, 360.0, -360.0):
        return 0
    frac = ANGLE_TO_FRACTION.get(abs(a))
    if frac is None:
        raise ValueError(f"Unsupported pano rotation angle {angle}")
    num = width * frac.numerator
    if num % frac.denominator != 0:
        raise ValueError(f"width {width} not divisible for angle {angle}")
    shift = num // frac.denominator
    return shift if a > 0 else -shift


def rotate_pano(x: torch.Tensor, angle: float) -> torch.Tensor:
    """Cyclic roll of the last (width) axis by `angle` degrees of pano yaw."""
    shift = rotation_shift(angle, x.shape[-1])
    if shift == 0:
        return x
    return torch.roll(x, shift, dims=-1)


def sample_latent_noise(
    actions: torch.Tensor,
    shape: tuple,
    *,
    generator: Optional[torch.Generator] = None,
    fresh: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    turn_degrees: float = 22.5,
) -> torch.Tensor:
    """Correlated init noise for navigation panos.

    actions: [B, F] int ids; shape: [B, F, C, H, W]. `fresh` is the base
    Gaussian draw of that shape; without it one is drawn from `generator`
    on the actions' device.
    """
    B, F = actions.shape
    if shape[0] != B or shape[1] != F:
        raise ValueError(f"shape {shape} does not match actions {tuple(actions.shape)}")
    if fresh is None:
        fresh = torch.randn(shape, generator=generator, dtype=dtype,
                            device=actions.device)
    elif tuple(fresh.shape) != tuple(shape):
        raise ValueError(f"fresh noise {tuple(fresh.shape)} != {shape}")
    try:
        left_shift = rotation_shift(turn_degrees, shape[-1])
    except ValueError:
        # non-pano-divisible latent width: uncorrelated noise, as the
        # reference does (the correlation is a prior)
        return fresh
    frames = [fresh[:, 0]]
    for f in range(1, F):
        prev = frames[-1]
        act = actions[:, f].to(fresh.device).view(B, 1, 1, 1)
        out = torch.where(
            act == ACTION_TURN_LEFT, torch.roll(prev, left_shift, dims=-1),
            torch.where(act == ACTION_TURN_RIGHT,
                        torch.roll(prev, -left_shift, dims=-1), fresh[:, f]))
        frames.append(out)
    return torch.stack(frames, dim=1)
