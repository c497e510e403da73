"""SVD-dagger post-training: the EDM objective on one GPU.

Port of `wiw_tpu/train/trainer.py`. One micro-batch's loss is the
reference's `Trainer.loss_fn` step by step:
  * latents = VAE posterior sample of the frames * 0.18215 (frozen VAE)
  * conditioning image = frame 0, noised with sigma_c ~ logN(-3, 0.5),
    VAE-encoded (posterior mean, unscaled); its CLIP embedding (frozen)
  * init noise correlated by pano turns (core/noise.sample_latent_noise)
  * sigma ~ logN(0.7, 1.6); input preconditioning 1/sqrt(sigma^2+1); EDM
    v-combine; loss weight (1+sigma^2)/sigma^2
  * added_time_ids = (fps, motion_bucket, sigma_c)
  * discrete 8-scenario (or continuous) conditioning dropout
Every random tensor of a micro-batch (the VAE eps, sigma_c's and sigma's
standard-normal draws, the cond-image noise, the latent noise, the dropout
uniforms) is drawn from a `torch.Generator` or injected as `draws`, so the
tests can hand JAX's own draws to both packages.

The step: gradients averaged over a leading [A, ...] micro-batch axis
(grad accumulation), optax's `clip_by_global_norm` rule (g * max / norm
only when norm >= max), AdamW with optax's beta, eps and decoupled weight
decay (torch.optim.AdamW computes the same update), the LR schedules of
optax's `constant`, `constant_with_warmup`, `linear` and `cosine` as the
reference builds them, and the EMA over all UNet parameters. Parameters,
optimizer state and EMA are updated in place (the PyTorch idiom; it saves
a copy of each).

Not ported: the bf16-moment AdamW and Adafactor (`optimizer='adamw_bf16m'`,
`'adafactor'`) and the (dp, fsdp) mesh: both raise NotImplementedError
(ROADMAP M10; DDP/FSDP needs more than one card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from wiw_tpu_torch.core import schedule as S
from wiw_tpu_torch.core.actions import get_action_ids
from wiw_tpu_torch.core.noise import sample_latent_noise
from wiw_tpu_torch.models.clip import preprocess_for_clip


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    ema_decay: float = 0.9999
    use_ema: bool = False
    conditioning_dropout: str = "discrete"  # 'discrete' | 'continuous' | 'none'
    conditioning_dropout_prob: float = 0.1
    fps: int = 7
    motion_bucket_id: int = 127
    # which params train: 'full' | 'new' | 'new+temp_layer'
    train_params: str = "full"
    # 'constant' | 'constant_with_warmup' | 'linear' | 'cosine'
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    # total steps for decaying schedules (linear/cosine)
    lr_total_steps: int = 0
    # 'adamw' (fp32 moments); 'adamw_bf16m' and 'adafactor' are not ported
    optimizer: str = "adamw"
    edm: S.EDMConfig = S.EDMConfig()


_ACTION_PARAM_PAT = ("action", "add_embedding_noise")
_TEMPORAL_PARAM_PAT = ("temporal_transformer_blocks", "temporal_res_block",
                       "time_mixer")


def trainable_mask(unet: torch.nn.Module, mode: str) -> dict:
    """{parameter name: trains?}, the reference's name-based selection on
    the port's diffusers names: 'new' trains only the action-conditioning
    parameters, 'new+temp_layer' adds the temporal layers, 'full' all."""
    if mode not in ("full", "new", "new+temp_layer"):
        raise ValueError(f"unknown train_params {mode!r}")

    def trains(name: str) -> bool:
        if mode == "full" or any(p in name for p in _ACTION_PARAM_PAT):
            return True
        return mode == "new+temp_layer" and any(p in name for p in _TEMPORAL_PARAM_PAT)

    return {n: trains(n) for n, _ in unet.named_parameters()}


def apply_discrete_dropout(u, clip_embeds, cond_latents, action_ids):
    """8-scenario CFG dropout: the uniform draw u [B] of each sample picks
    which of (actions, CLIP embedding, image latents) to drop."""
    B = clip_embeds.shape[0]
    drop_a = (u < 0.1) | ((u >= 0.4) & (u < 0.7))
    drop_b = (((u >= 0.1) & (u < 0.2)) | ((u >= 0.3) & (u < 0.5))
              | ((u >= 0.6) & (u < 0.7)))
    drop_c = ((u >= 0.2) & (u < 0.4)) | ((u >= 0.5) & (u < 0.7))
    clip_embeds = torch.where(drop_b[:, None, None], 0.0, clip_embeds)
    cond_latents = torch.where(drop_c[:, None, None, None], 0.0, cond_latents)
    if action_ids is not None:
        shape = (B,) + (1,) * (action_ids.ndim - 1)
        action_ids = torch.where(drop_a.reshape(shape), -1.0, action_ids)
    return clip_embeds, cond_latents, action_ids


def apply_continuous_dropout(u, prob, clip_embeds, cond_latents, action_ids):
    """The instruct-pix2pix-style dropout, from the uniform draw u [B]."""
    prompt_mask = u < 2 * prob
    image_keep = 1.0 - ((u >= prob) & (u < 3 * prob)).to(cond_latents.dtype)
    clip_embeds = torch.where(prompt_mask[:, None, None], 0.0, clip_embeds)
    cond_latents = cond_latents * image_keep[:, None, None, None]
    return clip_embeds, cond_latents, action_ids


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps)(count)."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(c: TrainConfig):
    """count -> learning rate, optax's schedules as the reference builds
    them (the count of updates made so far, from 0)."""
    lr, warm, total = c.learning_rate, c.lr_warmup_steps, c.lr_total_steps
    w = max(warm, 1)
    if c.lr_scheduler == "constant" and not warm:
        return lambda count: lr
    if c.lr_scheduler in ("constant", "constant_with_warmup"):
        return lambda count: _linear(0.0, lr, w, count) if count < w else lr
    if c.lr_scheduler not in ("linear", "cosine"):
        raise ValueError(f"unknown lr_scheduler {c.lr_scheduler!r}")
    if not total:
        raise ValueError(f"lr_scheduler={c.lr_scheduler!r} needs lr_total_steps")
    if c.lr_scheduler == "linear":
        tail = max(total - warm, 1)
        return lambda count: (_linear(0.0, lr, w, count) if count < w
                              else _linear(lr, 0.0, tail, count - w))
    decay = total - w
    if decay <= 0:
        raise ValueError(f"cosine schedule needs lr_total_steps > warmup, got {total}")

    def cosine(count):
        if count < w:
            return _linear(0.0, lr, w, count)
        t = min(count - w, decay)
        return lr * 0.5 * (1 + math.cos(math.pi * t / decay))

    return cosine


class TrainState:
    """The UNet's parameters (the live modules' tensors), the optimizer,
    the EMA and the step. `state_dict()` / `load_state_dict()` are what
    checkpoints hold."""

    def __init__(self, params: dict, optimizer, ema: Optional[list], step: int = 0):
        self.params = params
        self.optimizer = optimizer
        self.ema = ema
        self.step = step

    def state_dict(self) -> dict:
        sd = {"params": {n: p.detach() for n, p in self.params.items()},
              "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema is not None:
            sd["ema_params"] = dict(zip(self.params, self.ema))
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for n, p in self.params.items():
            p.copy_(sd["params"][n])
        self.optimizer.load_state_dict(sd["opt_state"])
        if self.ema is not None:
            for e, n in zip(self.ema, self.params):
                e.copy_(sd["ema_params"][n])
        self.step = int(sd["step"])


class Trainer:
    """Train steps of the SVD-dagger objective for `pipeline`, whose UNet
    holds the parameters that train (UNetConfig(param_dtype='float32') for
    fp32 parameters computing in the model dtype)."""

    # frames per VAE-encode call: the encoder is per image, so chunking is
    # exact and bounds the encoder's activations at 576x1024
    ENCODE_CHUNK = 2

    def __init__(self, pipeline, train_config: TrainConfig, mesh=None):
        c = train_config
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (DDP/FSDP over several cards) is not ported "
                "yet (ROADMAP M10): train on one device")
        if c.optimizer in ("adamw_bf16m", "adafactor"):
            raise NotImplementedError(
                f"optimizer {c.optimizer!r} is not ported yet (ROADMAP M10); "
                "use 'adamw'")
        if c.optimizer != "adamw":
            raise ValueError(f"unknown optimizer {c.optimizer!r}")
        if c.conditioning_dropout not in ("discrete", "continuous", "none"):
            raise ValueError(f"unknown conditioning_dropout {c.conditioning_dropout!r}")
        self.pipe = pipeline
        self.cfg = c
        self.device = pipeline.device
        self.lr_at = lr_schedule(c)
        self._copy_stream = None

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Unfreeze the trainable UNet parameters and build the optimizer
        (over those only, as the reference's masked chain) and the EMA."""
        c = self.cfg
        unet = self.pipe.unet
        mask = trainable_mask(unet, c.train_params)
        params = dict(unet.named_parameters())
        for n, p in params.items():
            p.requires_grad_(mask[n])
        trainable = [p for n, p in params.items() if mask[n]]
        opt = torch.optim.AdamW(
            trainable, lr=self.lr_at(0), betas=(c.adam_beta1, c.adam_beta2),
            eps=c.adam_eps, weight_decay=c.weight_decay,
            fused=self.device.type == "cuda")
        ema = ([p.detach().clone() for p in params.values()]
               if c.use_ema else None)
        return TrainState(params, opt, ema)

    # ------------------------------------------------------------------
    def place_batch(self, batch: dict) -> dict:
        """Numpy batch -> tensors on the device. On a GPU: pinned host
        memory and a non-blocking copy on a copy stream, finished before it
        returns, so the loader's assembler thread (not the train loop)
        waits for it; the tensors are marked as used by the default stream
        so that their memory is not reused under a running step."""
        dev = self.device
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if dev.type != "cuda":
            return {k: v.to(dev) for k, v in host.items()}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.pin_memory().to(dev, non_blocking=True)
                   for k, v in host.items()}
        self._copy_stream.synchronize()
        for v in out.values():
            v.record_stream(torch.cuda.default_stream(dev))
        return out

    # ------------------------------------------------------------------
    def sample_draws(self, frames_shape, nav_actions: bool,
                     generator: Optional[torch.Generator] = None) -> dict:
        """Every random tensor of one micro-batch's loss, from `generator`
        (on the trainer's device)."""
        B, F, H, W, _ = frames_shape
        scale = self.pipe.vae_config.spatial_scale
        h, w, lc = H // scale, W // scale, self.pipe.vae_config.latent_channels

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=self.device)

        return {
            "vae_eps": normal(B * F, h, w, lc),
            "cond_sigma_z": normal(B, 1, 1, 1),
            "cond_noise": normal(B, H, W, 3),
            "latent_noise": normal(B, F, lc, h, w) if nav_actions else normal(B, F, h, w, lc),
            "sigma_z": normal(B, 1, 1, 1, 1),
            "dropout_u": torch.rand(B, generator=generator, device=self.device),
        }

    def _encode_frames(self, flat, eps):
        vae = self.pipe.vae
        n = self.ENCODE_CHUNK
        return torch.cat([vae.encode(flat[i:i + n], eps=eps[i:i + n])
                          for i in range(0, flat.shape[0], n)])

    def loss_fn(self, batch: dict, draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One micro-batch EDM loss. batch: pixel_values [B, F, H, W, 3] in
        [-1, 1]; actions [B, F] nav ids (or None)."""
        pipe, c, dev = self.pipe, self.cfg, self.device
        frames = batch["pixel_values"].to(dev, torch.float32)
        actions = batch.get("actions")
        if actions is not None:
            actions = actions.to(dev)
        B, F, H, W, _ = frames.shape
        scale = pipe.vae_config.spatial_scale
        h, w = H // scale, W // scale
        nav = actions is not None and actions.ndim == 2
        d = draws if draws is not None else self.sample_draws(frames.shape, nav, generator)
        d = {k: v.to(dev) for k, v in d.items()}

        with torch.no_grad():
            # VAE-encode the target frames (posterior sample) -> scaled latents
            latents = self._encode_frames(
                frames.reshape(B * F, H, W, 3), d["vae_eps"])
            latents = latents.reshape(B, F, h, w, -1) * pipe.vae_config.scaling_factor

            # conditioning image = first frame, noised with sigma_c
            cond_img = frames[:, 0]
            sigma_c = S.sample_cond_sigmas(B, c.edm, z=d["cond_sigma_z"], device=dev)
            cond_latents = pipe.vae.encode(cond_img + sigma_c * d["cond_noise"])

            # CLIP embedding of the clean conditioning frame
            clip_embeds = pipe.clip(preprocess_for_clip(cond_img))[:, None, :]

            # action-correlated init noise
            if nav:
                noise = sample_latent_noise(actions, tuple(d["latent_noise"].shape),
                                            fresh=d["latent_noise"]).movedim(2, -1)
            else:
                noise = d["latent_noise"]
            sigma = S.sample_training_sigmas(B, c.edm, z=d["sigma_z"], device=dev)
            noisy = latents + noise * sigma
            inp = S.precondition_inputs(noisy, sigma)

            strategy = pipe.unet_config.action_strategy
            action_ids = (get_action_ids(actions, strategy)
                          if strategy and actions is not None else None)
            if c.conditioning_dropout == "discrete":
                clip_embeds, cond_latents, action_ids = apply_discrete_dropout(
                    d["dropout_u"], clip_embeds, cond_latents, action_ids)
            elif c.conditioning_dropout == "continuous":
                clip_embeds, cond_latents, action_ids = apply_continuous_dropout(
                    d["dropout_u"], c.conditioning_dropout_prob, clip_embeds,
                    cond_latents, action_ids)

            added_time_ids = torch.tensor(
                [[c.fps, c.motion_bucket_id, 0.0]], dtype=torch.float32,
                device=dev).repeat(B, 1)
            added_time_ids[:, 2] = sigma_c[:, 0, 0, 0]
            cond_per_frame = cond_latents[:, None].expand(B, F, *cond_latents.shape[1:])
            sample = torch.cat([inp, cond_per_frame.to(inp.dtype)], dim=-1)
            t = S.sigma_to_t(sigma[:, 0, 0, 0, 0])

        pred = pipe.unet(sample, t, clip_embeds, added_time_ids, action_ids)
        denoised = S.precondition_outputs(pred, noisy, sigma)
        weight = S.edm_loss_weight(sigma)
        return torch.mean(weight * (denoised - latents) ** 2)

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[list] = None) -> dict:
        """One optimizer step, in place on `state`. With grad_accum_steps
        A > 1 every batch tensor carries a leading [A, ...] micro-step axis
        and the gradients average over it; `draws` (one dict per micro-step)
        replaces the generator's draws. Returns {'loss': mean loss}."""
        c = self.cfg
        A = c.grad_accum_steps
        micro = ([batch] if A == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(A)])
        trainable = [p for group in state.optimizer.param_groups
                     for p in group["params"]]
        for p in trainable:
            p.grad = None
        loss_sum = 0.0
        for i, mb in enumerate(micro):
            loss = self.loss_fn(mb, None if draws is None else draws[i], generator)
            (loss / A).backward()
            loss_sum = loss_sum + loss.detach()
        for p in trainable:
            # a parameter the loss does not reach (add_embedding under
            # micro_cond) has a zero gradient, as in JAX: AdamW still
            # decays it, where torch would skip a None gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in trainable]

        # optax.clip_by_global_norm: g / norm * max where norm >= max
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = norm >= c.max_grad_norm
        div = torch.where(clip, norm, torch.ones_like(norm))
        mul = torch.where(clip, torch.full_like(norm, c.max_grad_norm),
                          torch.ones_like(norm))
        for g in grads:
            g.div_(div).mul_(mul)

        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_at(state.step)
        state.optimizer.step()
        if state.ema is not None:
            d = c.ema_decay
            with torch.no_grad():
                torch._foreach_mul_(state.ema, d)
                torch._foreach_add_(state.ema, list(state.params.values()),
                                    alpha=1.0 - d)
        state.step += 1
        return {"loss": loss_sum / A, "grad_norm": norm.detach()}
