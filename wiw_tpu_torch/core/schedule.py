"""EDM / Euler-discrete diffusion schedule numerics.

Port of `wiw_tpu/core/schedule.py`. Tensor functions take and return torch
tensors; the static step partition (`cfg_row_segments`) is host numpy, as
in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """Schedule hyperparameters pinned by the reference operating point."""

    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    # training-time sigma ~ logN(p_mean, p_std)
    p_mean: float = 0.7
    p_std: float = 1.6
    # conditioning-image noise sigma ~ logN(cond_p_mean, cond_p_std)
    cond_p_mean: float = -3.0
    cond_p_std: float = 0.5


def karras_sigmas_np(num_steps: int, cfg: EDMConfig = EDMConfig()) -> np.ndarray:
    """Host view of the Karras ladder, for static step decisions."""
    ramp = np.linspace(0.0, 1.0, num_steps)
    min_inv_rho = cfg.sigma_min ** (1.0 / cfg.rho)
    max_inv_rho = cfg.sigma_max ** (1.0 / cfg.rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** cfg.rho
    return np.concatenate([sigmas, np.zeros((1,), sigmas.dtype)])


def karras_sigmas(num_steps: int, cfg: EDMConfig = EDMConfig(),
                  device=None) -> torch.Tensor:
    """Karras et al. (2022) sigmas, highest first, fp32 [num_steps + 1];
    the final entry is 0 (the terminal state)."""
    ramp = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32,
                          device=device)
    min_inv_rho = cfg.sigma_min ** (1.0 / cfg.rho)
    max_inv_rho = cfg.sigma_max ** (1.0 / cfg.rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** cfg.rho
    return torch.cat([sigmas, sigmas.new_zeros(1)])


@dataclasses.dataclass(frozen=True)
class CFGSchedule:
    """Row schedule for classifier-free guidance across the sigma ladder.

    tail_sigma: below this sigma the uncond row is no longer refreshed.
    tail_policy: 'stale' (reuse the last uncond prediction), 'alt'
      (refresh every other tail step) or 'cond' (guidance off).
    head_sigma: above this sigma run cond-only. inf = guidance from step 0.
    """

    tail_sigma: float = 0.0
    tail_policy: str = "stale"
    head_sigma: float = float("inf")

    def __post_init__(self):
        if self.tail_policy not in ("stale", "alt", "cond"):
            raise ValueError(
                f"tail_policy {self.tail_policy!r} not in stale|alt|cond")

    @property
    def is_full(self) -> bool:
        return self.tail_sigma <= 0.0 and self.head_sigma == float("inf")


# The serving schedule: stale-uncond tail below sigma 0.2 (the last 5 of 25
# steps reuse the step-19 uncond prediction).
SERVING_CFG = CFGSchedule(tail_sigma=0.2, tail_policy="stale")


def cfg_row_segments(num_steps: int, cfg: CFGSchedule,
                     edm: EDMConfig = EDMConfig()):
    """Partition the denoise steps into contiguous CFG row segments:
    a tuple of (kind, start, end), kind in {'full', 'cond', 'stale', 'alt'}."""
    sig = karras_sigmas_np(num_steps, edm)[:num_steps]
    head = int(np.sum(sig > cfg.head_sigma))
    k = int(np.sum(sig >= cfg.tail_sigma))  # steps 0..k-1 keep full CFG
    k = min(max(k, head), num_steps)
    if cfg.tail_policy in ("stale", "alt") and k < num_steps:
        # stale reuse needs at least one refreshed uncond prediction
        k = max(k, head + 1)
    segs = []
    if head > 0:
        segs.append(("cond", 0, head))
    if k > head:
        segs.append(("full", head, k))
    if num_steps > k:
        segs.append((cfg.tail_policy, k, num_steps))
    return tuple(segs)


def sigma_to_t(sigma: torch.Tensor) -> torch.Tensor:
    """Continuous timestep fed to the UNet: t = 0.25 * log(sigma)."""
    return 0.25 * torch.log(sigma)


def precondition_inputs(noisy: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """c_in scaling: x / sqrt(sigma^2 + 1)."""
    return noisy / torch.sqrt(sigma ** 2 + 1.0)


def precondition_outputs(model_out: torch.Tensor, noisy: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """EDM v-prediction combine: c_out * model_out + c_skip * noisy."""
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    return c_out * model_out + c_skip * noisy


def edm_loss_weight(sigma: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE weight (1 + sigma^2) / sigma^2."""
    return (1.0 + sigma ** 2) / sigma ** 2


def _standard_normal(shape, z, generator, device):
    if z is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"draw {tuple(z.shape)} != {tuple(shape)}")
    return z.to(device=device, dtype=torch.float32)


def sample_training_sigmas(batch_size: int, cfg: EDMConfig = EDMConfig(), *,
                           generator: Optional[torch.Generator] = None,
                           z: Optional[torch.Tensor] = None,
                           device=None) -> torch.Tensor:
    """sigma ~ logNormal(p_mean, p_std), fp32 [B, 1, 1, 1, 1]. The
    standard-normal draw `z` is injected, or drawn from `generator`."""
    z = _standard_normal((batch_size, 1, 1, 1, 1), z, generator, device)
    return torch.exp(cfg.p_mean + cfg.p_std * z)


def sample_cond_sigmas(batch_size: int, cfg: EDMConfig = EDMConfig(), *,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """Conditioning-image noise scale ~ logNormal(cond_p_mean, cond_p_std),
    fp32 [B, 1, 1, 1]; `z` as in `sample_training_sigmas`."""
    z = _standard_normal((batch_size, 1, 1, 1), z, generator, device)
    return torch.exp(cfg.cond_p_mean + cfg.cond_p_std * z)


def euler_step(latents: torch.Tensor, denoised: torch.Tensor,
               sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
    """One Euler ODE step: x' = x + (x - denoised)/sigma * (sigma_next - sigma)."""
    d = (latents - denoised) / sigma
    return latents + d * (sigma_next - sigma)


def guidance_scales(num_frames: int, min_scale: float = 1.0,
                    max_scale: float = 3.0, device=None) -> torch.Tensor:
    """Per-frame CFG scale, linspace(min, max, F), fp32 [F]."""
    return torch.linspace(min_scale, max_scale, num_frames,
                          dtype=torch.float32, device=device)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding identical to diffusers `Timesteps(dim, True, 0)`
    (max period 1e4, cos first): [...] -> [..., dim], computed in fp32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    args = timesteps.to(torch.float32)[..., None] * torch.exp(exponent)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
