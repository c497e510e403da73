"""The NWM (CDiT) world-model worker, on PyTorch: autoregressive
single-frame rollout.

Port of `wiw_tpu/workers/nwm_worker.py`, with its contract and arithmetic.
Each nav action id maps to a pose delta (dx, dy, dyaw); the model predicts
the next latent conditioned on the last `context_size` frame latents, and
the rollout runs `num_frames - 1` times (frame 0 is the conditioning
image):
  * encode the conditioning image's posterior mean, unscaled, and take
    `context_size` copies of it as the warm context;
  * for each frame f >= 1: a DDIM rollout (`models/cdit.ddim_sample`,
    `num_steps` steps) with rel_t = f / F, a single-frame decode, then
    clip(x * 0.5 + 0.5, 0, 1) * 255 truncated to uint8 (not rounded), and
    the context shifted by one.

The CDiT (CDiT-XL/2 at 224x224: latent 28, 196 tokens, context 4) and the
SD VAE (`AutoencoderKLTemporal`) run in bf16 on the card by default (the
device is an argument): every attention of the CDiT launches K1's head_dim
72 instance, every GroupNorm of the VAE K8. The reference draws each
frame's noise from splits of its jax key, which torch cannot reproduce:
`generate` takes the draws (`noise`), else draws from its own generator.

`main()` serves it through the port's worker SDK
(`serve/worker.main_from_argv`), behind `server_cli --wm_type nwm
--external_cmd "python -m wiw_tpu_torch.workers.nwm_worker"`. With
`NWM_CKPT` set it loads the NWM torch state dict from that directory's
safetensors with a strict `load_state_dict`, and the VAE from `<ckpt>/vae`
in the diffusers grammar (the reference's loader, R5 in ROADMAP, reads the
CDiT through the UNet's key translator and cannot load one); without, it
makes random weights from a seed and says so.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional

import numpy as np
import torch

from wiw_tpu_torch.agents.solver import UNIT_FORWARD_M, UNIT_TURN_DEG
from wiw_tpu_torch.models.cdit import CDiT, CDiTConfig, ddim_sample
from wiw_tpu_torch.models.convert import load_safetensors_dir
from wiw_tpu_torch.models.layers import cast_matmul_weights
from wiw_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from wiw_tpu_torch.sampling.pipeline import init_weights_
from wiw_tpu_torch.workers.base import WorkerModelBase

# nav action id -> (dx_m, dy_m, dyaw_rad)
_ACTION_DELTAS = {
    1: (UNIT_FORWARD_M, 0.0, 0.0),
    2: (0.0, 0.0, np.deg2rad(UNIT_TURN_DEG)),
    3: (0.0, 0.0, -np.deg2rad(UNIT_TURN_DEG)),
    4: (0.0, 0.0, 0.0),
    0: (0.0, 0.0, 0.0),
}


def action_deltas(ids) -> np.ndarray:
    """Nav action ids [B] -> pose deltas [B, 3] float32 (unknown ids: 0)."""
    return np.asarray([_ACTION_DELTAS.get(int(a), (0.0, 0.0, 0.0)) for a in ids],
                      np.float32)


class NWMWorker(WorkerModelBase):
    task_type = "navigation"
    width = height = 224

    def __init__(self, checkpoint: str = "", context_size: int = 4,
                 image_size: int = 224, num_steps: int = 20, seed: int = 0,
                 device: str = "cuda", cdit_config: Optional[CDiTConfig] = None,
                 vae_config: VAEConfig = VAEConfig(dtype="bfloat16")):
        """The reference's worker: CDiT-XL/2 over the latent of an
        `image_size` image, bf16, unless `cdit_config` says otherwise (the
        tests' tiny models); `vae_config` the VAE's (bf16 for serving, as
        the reference's)."""
        self.width = self.height = image_size
        self.device = torch.device(device)
        latent = image_size // 8
        self.cfg = cdit_config or CDiTConfig(
            input_size=latent, context_size=context_size, dtype="bfloat16")
        with torch.device("meta"):
            self.model = CDiT(self.cfg)
            self.vae = AutoencoderKLTemporal(vae_config)
        self.model.to_empty(device=self.device)
        self.vae.to_empty(device=self.device)
        self.num_steps = num_steps
        if checkpoint:
            self.model.load_state_dict(load_safetensors_dir(checkpoint), strict=True)
            self.vae.load_state_dict(
                load_safetensors_dir(osp.join(checkpoint, "vae")), strict=True)
        else:
            print("[nwm] no checkpoint: random-init weights (debug)", flush=True)
            g = torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad():
                self.model.init_weights(g)
                init_weights_(self.vae, g)
        self.model.eval().requires_grad_(False)
        cast_matmul_weights(self.vae, vae_config.torch_dtype).eval().requires_grad_(False)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, images: np.ndarray, actions: np.ndarray, prompts,
                 noise=None) -> np.ndarray:
        """[B, H, W, 3] uint8 and nav ids [B, F] -> [B, F, H, W, 3] uint8.
        `noise` ([F - 1, B, h, w, 4], one DDIM start a frame) replaces the
        draws from the worker's generator."""
        B, F = images.shape[0], actions.shape[1]
        latent, ctx_n, dev = self.cfg.input_size, self.cfg.context_size, self.device
        imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                               device=dev) / 127.5 - 1.0
        z0 = self.vae.encode(imgs).float()  # the posterior mean, unscaled
        frames = [np.asarray(images, np.uint8)]
        ctx = z0[:, None].repeat(1, ctx_n, 1, 1, 1)  # warm context
        for f in range(1, F):
            z = ddim_sample(
                self.model, (B, latent, latent, 4), x_cond=ctx,
                action_xya=torch.from_numpy(action_deltas(actions[:, f])).to(dev),
                rel_t=torch.full((B,), f / F, device=dev),
                num_steps=self.num_steps,
                noise=None if noise is None else torch.as_tensor(noise[f - 1]),
                generator=self._generator)
            decoded = self.vae.decode(z, 1)[:, 0]
            u8 = ((decoded * 0.5 + 0.5).clamp(0, 1) * 255).to(torch.uint8)
            frames.append(u8.cpu().numpy())
            ctx = torch.cat([ctx[:, 1:], z[:, None]], dim=1)
        return np.stack(frames, axis=1)  # [B, F, H, W, 3]


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _unknown = ap.parse_known_args(argv)  # the pipe fd comes last
    worker = NWMWorker(checkpoint=os.environ.get("NWM_CKPT", ""),
                       device=args.device)
    from wiw_tpu_torch.serve.worker import main_from_argv

    main_from_argv(worker)


if __name__ == "__main__":
    main()
