"""LPIPS perceptual distance (AlexNet trunk + linear heads) as torch modules.

Port of `wiw_tpu/eval/lpips.py`. The modules carry the upstream names
(torchvision's `features.N` indices for the trunk, the `lpips` package's
`lin{i}.model.1` heads), so the merged upstream checkpoint loads straight
into `LPIPS` with `load_state_dict`; `load_lpips_weights` checks it against
the pinned layout (eval/manifest.py) first, by default. Without weights
(`WIW_LPIPS_WEIGHTS` unset or missing, read once at import, as the
reference reads it) `default_lpips` returns None and callers leave the
metric out, as the reference does.

Images are [N, H, W, 3] in [0, 1]; scaled to [-1, 1] and normalised by
the LPIPS shift and scale constants. Convolutions are `F.conv2d`, in fp32:
the reference's are XLA convolutions, outside any Pallas kernel.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch import nn

# lpips normalization constants (net input = (x - shift) / scale on [-1,1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
_TAPS = (1, 4, 7, 9, 11)  # the ReLUs after each conv of `features`


class AlexNetFeatures(nn.Module):
    """torchvision's AlexNet conv trunk (`features`, the same indices);
    returns the 5 ReLU feature maps LPIPS taps, NCHW."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(),
        )

    def forward(self, x):
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAPS:
                feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    """An lpips head: `model` = (dropout slot, 1x1 conv to one channel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)  # the reference's init


class LPIPS(nn.Module):
    """(img1, img2) [N, H, W, 3] in [0, 1] -> [N] distances: unit-normalised
    features (1e-10 under the root), squared differences weighted by each
    head's max(w, 0), summed over channels, averaged over positions, summed
    over the 5 taps."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(_ALEX_CHANNELS):
            self.add_module(f"lin{i}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, img1, img2):
        n = img1.shape[0]
        x = torch.cat([img1, img2]).float().permute(0, 3, 1, 2)
        x = (x * 2.0 - 1.0 - self.shift) / self.scale
        total = 0.0
        for i, f in enumerate(self.net(x)):
            f = f / torch.sqrt((f ** 2).sum(dim=1, keepdim=True) + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.clamp_min(0.0)
            total = total + (diff * w.view(1, -1, 1, 1)).sum(dim=1).mean(dim=(1, 2))
        return total


def load_lpips_weights(path: str, validate: bool = True) -> LPIPS:
    """An `LPIPS` (eval mode, CPU) holding the upstream checkpoint at `path`
    (the lpips heads and torchvision's AlexNet trunk in one state dict).
    `validate` checks it against the pinned layout (eval/manifest.py) and
    raises with the full report on a mismatch. A heads-only checkpoint
    passes the check, as in the reference, but cannot run without its
    trunk: it raises here. Without `validate`, the keys that match load and
    the others keep their initial values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if validate:
        from wiw_tpu_torch.eval.manifest import validate_lpips_state_dict

        res = validate_lpips_state_dict(sd)
        if not res["ok"]:
            raise ValueError(
                f"{path} does not match the pinned lpips layout "
                f"(eval/manifest.py): {res}")
        if "trunk" in res:
            raise ValueError(
                f"{path} holds the lpips heads only: merge torchvision's "
                "AlexNet trunk into it as net.features.N.* entries")
    model = LPIPS()
    model.load_state_dict(sd, strict=validate)
    return model.eval().requires_grad_(False)


_DEFAULT_WEIGHTS = os.environ.get("WIW_LPIPS_WEIGHTS", "")


def lpips_with_params(state_dict: dict) -> Callable:
    """A callable (img1, img2) -> [N] distances over an LPIPS holding
    `state_dict`; it runs on the images' device."""
    model = LPIPS()
    model.load_state_dict(state_dict)
    return _on_inputs_device(model.eval().requires_grad_(False))


def default_lpips() -> Optional[Callable]:
    """A callable (img1, img2) -> [N] distances over the weights that
    WIW_LPIPS_WEIGHTS named at import, or None when there are none."""
    if not _DEFAULT_WEIGHTS or not os.path.exists(_DEFAULT_WEIGHTS):
        return None
    return _on_inputs_device(load_lpips_weights(_DEFAULT_WEIGHTS))


def _on_inputs_device(model: LPIPS) -> Callable:
    @torch.no_grad()
    def fn(img1, img2):
        return model.to(img1.device)(img1, img2)

    return fn
