"""FVD: Frechet Video Distance over I3D features, as torch modules.

Port of `wiw_tpu/eval/fvd.py`. `InceptionI3d` (Inception-v1 inflated to
3-D, Kinetics-400) carries the module names of the upstream pytorch-i3d
checkpoint, so `i3d_pretrained_400.pt` loads with `load_state_dict`;
`load_i3d_weights` checks it against the pinned layout (eval/manifest.py)
first, by default. `FVDEvaluator` takes its weights from
`WIW_I3D_WEIGHTS` (read once at import, as the reference reads it) unless
given a path or a module.

What makes it the reference's function, not torch's defaults:
  * convolutions and max-pools pad TF-SAME: total = max(0, (ceil(s/stride)
    - 1) * stride + k - s), pad_before = total // 2 (torch's symmetric
    padding differs by a pixel at stride 2); max-pools pad with -inf
  * BatchNorm in inference, eps 1e-3
  * the head: the spatial mean, the temporal pair average (end frames weigh
    half), the 1x1x1 logits conv, then the temporal mean
  * the input resize to 224x224 is JAX's antialiased bilinear
    (ops/resize.py); `F.interpolate` does not antialias by default

Videos are [B, T >= 10, H, W, 3] in [0, 1], rescaled to [-1, 1]. The
convolutions are `F.conv3d`, in fp32: the reference's are XLA
convolutions, outside any Pallas kernel.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wiw_tpu_torch.eval.manifest import _MIXED_SPECS
from wiw_tpu_torch.eval.metrics import frechet_distance
from wiw_tpu_torch.ops.resize import resize_bilinear


def _same_pads(x: torch.Tensor, kernel, stride) -> list:
    """F.pad's list (W, H, T order) for TF-SAME over x [B, C, T, H, W]."""
    pads = []
    for d in (4, 3, 2):
        s, k, st = x.shape[d], kernel[d - 2], stride[d - 2]
        total = max(0, (math.ceil(s / st) - 1) * st + k - s)
        pads += [total // 2, total - total // 2]
    return pads


class Unit3D(nn.Module):
    """conv3d (no bias under a BatchNorm) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_relu: bool = True, use_bn: bool = True):
        super().__init__()
        self.kernel, self.stride, self.use_relu = kernel, stride, use_relu
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=not use_bn)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, _same_pads(x, self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Max-pool with TF-SAME padding of -inf (possibly uneven)."""
    x = F.pad(x, _same_pads(x, kernel, stride), value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, spec: tuple):
        super().__init__()
        self.b0 = Unit3D(cin, spec[0])
        self.b1a = Unit3D(cin, spec[1])
        self.b1b = Unit3D(spec[1], spec[2], (3, 3, 3))
        self.b2a = Unit3D(cin, spec[3])
        self.b2b = Unit3D(spec[3], spec[4], (3, 3, 3))
        self.b3b = Unit3D(cin, spec[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


def _out_channels(spec: tuple) -> int:
    return spec[0] + spec[2] + spec[4] + spec[5]


class InceptionI3d(nn.Module):
    """[B, T, H, W, 3] in [-1, 1] -> (pooled [B, 1024], logits [B, 400])."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, spec in _MIXED_SPECS.items():
            self.add_module(name, InceptionModule(cin, spec))
            cin = _out_channels(spec)
        self.logits = Unit3D(cin, num_classes, use_relu=False, use_bn=False)
        self.eval()

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3).float()  # -> [B, C, T, H, W]
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        pooled = x.mean(dim=(3, 4))  # [B, 1024, T']
        pooled = 0.5 * (pooled[:, :, 1:] + pooled[:, :, :-1])  # [B, 1024, T'-1]
        logits = self.logits(pooled[..., None, None])[:, :, :, 0, 0]
        return pooled.mean(dim=2), logits.mean(dim=2)


def load_i3d_weights(path: str, validate: bool = True) -> InceptionI3d:
    """An `InceptionI3d` (eval mode, CPU) holding the upstream
    `i3d_pretrained_400.pt` state dict at `path`. `validate` checks it
    against the pinned layout (eval/manifest.py) and raises with the full
    missing / unexpected / mis-shaped report on a mismatch, a partial dict
    included. Without `validate`, the keys that match load and the others
    keep their initial values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if validate:
        from wiw_tpu_torch.eval.manifest import validate_i3d_state_dict

        res = validate_i3d_state_dict(sd)
        if not res["ok"]:
            raise ValueError(
                f"{path} does not match the pinned i3d_pretrained_400 "
                f"layout (eval/manifest.py): {res}")
    model = InceptionI3d()
    model.load_state_dict(sd, strict=validate)
    return model.eval().requires_grad_(False)


_DEFAULT_I3D = os.environ.get("WIW_I3D_WEIGHTS", "")


class FVDEvaluator:
    """I3D features and the Frechet distance between two sets of clips.
    `model` (an InceptionI3d) wins, else `weights_path`, else the
    WIW_I3D_WEIGHTS read at import; `model` stays None when there are no
    weights (callers then leave FVD out). It runs on the clips' device."""

    def __init__(self, model: Optional[InceptionI3d] = None,
                 weights_path: Optional[str] = None):
        if model is None:
            path = weights_path or _DEFAULT_I3D
            if path and os.path.exists(path):
                model = load_i3d_weights(path)
        self.model = model

    @torch.no_grad()
    def features(self, videos: torch.Tensor, use_logits: bool = True):
        """videos [B, T >= 10, H, W, 3] in [0, 1] -> features [B, D]."""
        assert videos.shape[1] >= 10, "FVD needs clips of >= 10 frames"
        resized = resize_bilinear(videos.float(), (224, 224), dims=(2, 3))
        pooled, logits = self.model.to(videos.device)(resized * 2.0 - 1.0)
        return logits if use_logits else pooled

    def fvd(self, videos1: torch.Tensor, videos2: torch.Tensor) -> float:
        return float(frechet_distance(self.features(videos1),
                                      self.features(videos2)))
