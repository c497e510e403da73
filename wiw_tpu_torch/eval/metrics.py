"""Video quality metrics: PSNR and SSIM.

Port of the part of `wiw_tpu/eval/metrics.py` that the training CLI's
validation uses: per-(batch, frame) PSNR and SSIM over channels-last
[B, T, H, W, C] videos in [0, 1], and `evaluate_video_metrics` for
("psnr", "ssim"). LPIPS and FVD wait for the rest of M8 (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(video1: torch.Tensor, video2: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] in [0,1] -> per-(batch,frame) PSNR [B, T] in dB."""
    mse = ((video1 - video2) ** 2).mean(dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse.clamp_min(1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation over [N, H, W] maps."""
    return F.conv2d(img[:, None], kernel[None, None])[:, 0]


def ssim(video1: torch.Tensor, video2: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] in [0,1] -> per-(batch,frame) SSIM [B, T]: 11x11
    gaussian window (sigma 1.5), K1 = 0.01, K2 = 0.03, L = 1, mean over
    channels and positions."""
    B, T, H, W, C = video1.shape
    x = video1.float().permute(0, 1, 4, 2, 3).reshape(B * T * C, H, W)
    y = video2.float().permute(0, 1, 4, 2, 3).reshape(B * T * C, H, W)
    k = _gaussian_kernel(device=x.device)
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = _filter2(x, k), _filter2(y, k)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sx = _filter2(x * x, k) - mu_x2
    sy = _filter2(y * y, k) - mu_y2
    sxy = _filter2(x * y, k) - mu_xy
    m = ((2 * mu_xy + C1) * (2 * sxy + C2)) / ((mu_x2 + mu_y2 + C1) * (sx + sy + C2))
    return m.reshape(B, T, C, -1).mean(dim=(2, 3))


def evaluate_video_metrics(videos1: torch.Tensor, videos2: torch.Tensor,
                           metrics: tuple[str, ...] = ("ssim", "psnr")) -> dict:
    """Per-metric means over [B, T, H, W, C] videos in [0,1]."""
    unknown = set(metrics) - {"psnr", "ssim"}
    if unknown:
        raise NotImplementedError(
            f"metrics {sorted(unknown)} are not ported yet (ROADMAP M8)")
    out = {}
    if "psnr" in metrics:
        out["psnr"] = float(psnr(videos1, videos2).mean())
    if "ssim" in metrics:
        out["ssim"] = float(ssim(videos1, videos2).mean())
    return out
