"""Video quality metrics: PSNR, SSIM, LPIPS and the Frechet distance.

Port of `wiw_tpu/eval/metrics.py`: per-(batch, frame) PSNR and SSIM over
channels-last [B, T, H, W, C] videos in [0, 1]; `frechet_distance` with
the symmetric matrix square root by eigendecomposition (the reference's
replacement of scipy's sqrtm); `evaluate_video_metrics`, the harness's
per-metric means, LPIPS through `lpips_fn` or the weights WIW_LPIPS_WEIGHTS
names (eval/lpips.py). FVD is computed apart (eval/fvd.py), as in the
reference.
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


def frechet_distance(feats1: torch.Tensor, feats2: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Frechet distance between feature sets [N1, D], [N2, D]:
    ||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), the cross term as the
    symmetric sqrt(S1^1/2 S2 S1^1/2) by eigendecomposition (exact for PSD
    inputs); covariances unbiased, eps on their diagonals, fp32. Computed
    on the host whatever the features' device (a CPU scalar): on the H100,
    cuSOLVER's fp32 `eigh` is ~20x less exact than LAPACK's (chip_smoke.py's
    eval phase prints both), and D <= 1024 matrices once an evaluation
    cost the card nothing worth keeping."""
    f1, f2 = feats1.detach().float().cpu(), feats2.detach().float().cpu()
    eye = torch.eye(f1.shape[1], dtype=f1.dtype, device=f1.device)
    c1 = torch.cov(f1.T) + eps * eye
    c2 = torch.cov(f2.T) + eps * eye

    def psd_sqrt(m):
        w, v = torch.linalg.eigh(m)
        return (v * torch.sqrt(w.clamp_min(0.0))) @ v.T

    s1h = psd_sqrt(c1)
    cross = psd_sqrt(s1h @ c2 @ s1h)
    diff = f1.mean(0) - f2.mean(0)
    return diff @ diff + torch.trace(c1) + torch.trace(c2) - 2.0 * torch.trace(cross)


def evaluate_video_metrics(videos1: torch.Tensor, videos2: torch.Tensor,
                           metrics: tuple[str, ...] = ("ssim", "psnr", "lpips"),
                           lpips_fn=None) -> dict:
    """Per-metric means over [B, T, H, W, C] videos in [0, 1]. LPIPS takes
    `lpips_fn` ((img1, img2) -> [N]) or else `default_lpips()`, and is left
    out only when that finds no weights, as in the reference; an error in
    the tower raises."""
    out = {}
    if "psnr" in metrics:
        out["psnr"] = float(psnr(videos1, videos2).mean())
    if "ssim" in metrics:
        out["ssim"] = float(ssim(videos1, videos2).mean())
    if "lpips" in metrics:
        if lpips_fn is None:
            from wiw_tpu_torch.eval.lpips import default_lpips

            lpips_fn = default_lpips()
        if lpips_fn is not None:
            B, T = videos1.shape[:2]
            out["lpips"] = float(lpips_fn(videos1.reshape(B * T, *videos1.shape[2:]),
                                          videos2.reshape(B * T, *videos2.shape[2:])
                                          ).mean())
    return out
