"""Antialiased resizes matching `jax.image.resize(..., "cubic")` and
`jax.image.resize(..., "bilinear")`.

The reference resizes twice on the serving path: the conditioning image to
CLIP's 224x224 (wiw_tpu/models/clip.py `preprocess_for_clip`) and the
decoded frames to the output size (wiw_tpu/sampling/pipeline.py
`_decode_impl`), both with JAX's Keys cubic (a = -0.5) and antialias on.
`F.interpolate(mode="bicubic", antialias=True)` uses a = -0.75, so the
separable resampling matrices are built here, as JAX builds them, and
applied with matmuls. The eval towers resize with JAX's bilinear (the
FVD's I3D input, `video_metrics_cli --resize`), which is the same
resampling with the triangle kernel; `F.interpolate(mode="bilinear",
antialias=True)` computes the same function to rounding, but its sums are
its own.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def weight_matrix(in_size: int, out_size: int, kernel: str,
                  antialias: bool = True) -> np.ndarray:
    """[in_size, out_size] fp32 resampling matrix (JAX's compute_weight_mat
    with scale out/in, no translation) for `kernel` in KERNELS."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # double, then rounded
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    weights = KERNELS[kernel](x / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def _resize(x: torch.Tensor, out_sizes: Sequence[int], dims: Sequence[int],
            kernel: str) -> torch.Tensor:
    for size, dim in zip(out_sizes, dims):
        in_size = x.shape[dim]
        if in_size == size:
            continue
        w = torch.from_numpy(weight_matrix(in_size, size, kernel)).to(x.device)
        x = torch.matmul(x.movedim(dim, -1), w).movedim(-1, dim)
    return x


def resize_cubic(x: torch.Tensor, out_sizes: Sequence[int],
                 dims: Sequence[int]) -> torch.Tensor:
    """Resize fp32 `x` along `dims` to `out_sizes` (cubic, antialiased).
    Dims whose size does not change are left as they are, as in JAX."""
    return _resize(x, out_sizes, dims, "cubic")


def resize_bilinear(x: torch.Tensor, out_sizes: Sequence[int],
                    dims: Sequence[int]) -> torch.Tensor:
    """As `resize_cubic`, with JAX's "bilinear" (the triangle kernel)."""
    return _resize(x, out_sizes, dims, "linear")
