"""Image-to-video generation pipeline (SVD-dagger) on one device.

Port of `wiw_tpu/sampling/pipeline.py`:
  * CLIP-embed the conditioning image; CFG uncond = zero embedding
  * VAE-encode the noise-augmented image (unscaled); CFG uncond = zeros
  * added_time_ids = (fps-1, motion_bucket_id, noise_aug_strength)
  * Karras sigmas; pano-correlated init noise for navigation, or injected
    `init_latents`; init scale sqrt(sigma_0^2 + 1)
  * denoise loop over CFG row segments (core/schedule.cfg_row_segments):
    'full' folds both CFG rows into the batch, 'stale' reuses the last
    uncond prediction, 'cond' runs guidance off
  * chunked temporal VAE decode, then optional resize to the output size
    and uint8 on the device
  * W8A8 int8 serving (`quantize_unet`, `quantize_vae`): the reference's
    policy (ops/quant.py) makes the UNet trunk's (the VAE decoder's) 3x3
    convs and GEGLU in-projections int8, quantised from the weights as
    loaded, before the cast to the serving dtype, as the reference
    quantises its fp32 tree; those layers then run kernel K7

Actions: [B, F] nav ids or [B, F, 8] manipulation poses, encoded for the
UNet's strategy (core/actions.get_action_ids); under `action_block` the
CFG uncond half takes the dropped-action sentinel.

The reference's 'alt' segment, `past_images`, the mesh and `shard_clip`
paths are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from wiw_tpu_torch.core import schedule as S
from wiw_tpu_torch.core.actions import get_action_ids
from wiw_tpu_torch.core.noise import sample_latent_noise
from wiw_tpu_torch.models.clip import (
    CLIPVisionConfig,
    CLIPVisionModel,
    preprocess_for_clip,
)
from wiw_tpu_torch.models.convert import load_flax_params
from wiw_tpu_torch.models.layers import cast_matmul_weights
from wiw_tpu_torch.models.unet import (
    ACTION_DROPPED,
    UNetConfig,
    UNetSpatioTemporal,
)
from wiw_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from wiw_tpu_torch.ops import quant as Q
from wiw_tpu_torch.ops.resize import resize_cubic


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    height: int = 576
    width: int = 1024
    num_frames: int = 14
    num_inference_steps: int = 30
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    task_type: str = "navigation"  # 'navigation' | 'manipulation' | None
    # None = auto (resolved_decode_chunk)
    decode_chunk_frames: Optional[int] = None
    edm: S.EDMConfig = S.EDMConfig()
    cfg: S.CFGSchedule = S.CFGSchedule()

    def resolved_decode_chunk(self, dtype_bytes: int = 4) -> int:
        """Frames per decode chunk, exactly as the reference resolves it.
        The temporal decoder convolves across the frames of one chunk, so
        the chunking is part of the output, not only of the memory use."""
        if self.decode_chunk_frames is not None:
            return min(self.decode_chunk_frames, self.num_frames)
        budget_px = (2 * 576 * 1024) * 4 // dtype_bytes
        return max(1, min(self.num_frames,
                          budget_px // (self.height * self.width)))


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal (+-2 sd), variance 1/fan_in."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    lo, hi = 0.022750131948179195, 0.9772498680518208  # Phi(-2), Phi(2)
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    w.erfinv_().mul_(std * 2 ** 0.5).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_weights_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Random-init with flax's initialiser families: lecun-normal
    Linear/Conv kernels, zero biases, unit/zero norms, mix factors at their
    initial alpha, CLIP embeddings ~ N(0, 0.02), the action-block position
    embedding ~ N(0, 1)."""
    from wiw_tpu_torch.models import clip as C
    from wiw_tpu_torch.models import layers as L
    from wiw_tpu_torch.models.unet import ActionEmbedderBlock

    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (L.GroupNorm, L.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, L.AlphaBlender):
            m.mix_factor.fill_(m.alpha_init)
        elif isinstance(m, C.CLIPEmbeddings):
            m.class_embedding.normal_(0.0, 0.02, generator=generator)
            m.position_embedding.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, ActionEmbedderBlock):
            m.pos_embedding.normal_(0.0, 1.0, generator=generator)


class SVDPipeline:
    """Holds the three towers on one device and runs `generate`."""

    def __init__(
        self,
        unet_config: UNetConfig,
        vae_config: VAEConfig = VAEConfig(dtype="bfloat16"),
        clip_config: CLIPVisionConfig = CLIPVisionConfig(),
        device: torch.device | str = "cuda",
    ):
        self.unet_config = unet_config
        self.vae_config = vae_config
        self.clip_config = clip_config
        self.device = torch.device(device)
        # built on the meta device: no memory until weights are placed
        with torch.device("meta"):
            self.unet = UNetSpatioTemporal(unet_config)
            self.vae = AutoencoderKLTemporal(vae_config)
            self.clip = CLIPVisionModel(clip_config)
        # W8A8 asked for before the weights are placed: tower -> extra_deny
        self._int8 = {}

    def _towers(self):
        return ((self.unet, self.unet_config), (self.vae, self.vae_config),
                (self.clip, self.clip_config))

    def _place(self, tower):
        return tower.to_empty(device=self.device)

    def _finish(self):
        """Quantise the weights `quantize_unet`/`quantize_vae` asked for,
        from their values as loaded; cast each tower's other Linear/Conv
        weights to its parameter dtype (the UNet's `param_dtype`, else the
        model dtype) and freeze it; a trainer unfreezes the UNet parameters
        it trains. int8 layers output the model dtype."""
        for tower, cfg in self._towers():
            dtype = getattr(cfg, "param_torch_dtype", cfg.torch_dtype)
            if tower is self.unet and "unet" in self._int8:
                Q.quantize_params(tower, self._int8["unet"])
            elif tower is self.vae and "vae" in self._int8:
                Q.quantize_vae_decoder(tower)
            for m in tower.modules():  # quantised here or loaded int8
                if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and (
                        m.weight.dtype == torch.int8):
                    m._compute_dtype = cfg.torch_dtype
            cast_matmul_weights(tower, dtype).eval().requires_grad_(False)

    def init_params(self, generator: torch.Generator) -> None:
        """Random-init all three towers on the device, from `generator`
        (which must live on that device)."""
        for tower, _ in self._towers():
            init_weights_(self._place(tower), generator)
        self._finish()

    def load_flax_params(self, params_np: dict) -> None:
        """Load the reference's parameter trees {'unet','vae','clip'} (numpy
        leaves), with full coverage both ways."""
        for (tower, _), name in zip(self._towers(), ("unet", "vae", "clip")):
            load_flax_params(self._place(tower), params_np[name])
        self._finish()

    def load_state_dicts(self, unet: dict, vae: dict, clip: dict) -> None:
        """Load diffusers/transformers state dicts (strict)."""
        for (tower, _), sd in zip(self._towers(), (unet, vae, clip)):
            self._place(tower).load_state_dict(sd, strict=True)
        self._finish()

    def replica(self, device: torch.device | str) -> "SVDPipeline":
        """This pipeline with a copy of its towers on `device`, the weights
        as they are (int8 layers included): one replica per card for
        per-device serving."""
        twin = copy.copy(self)
        twin.device = torch.device(device)
        twin.unet, twin.vae, twin.clip = (
            copy.deepcopy(t).to(twin.device)
            for t in (self.unet, self.vae, self.clip))
        twin._int8 = dict(self._int8)
        return twin

    def _before_weights(self, name: str) -> None:
        if not self.unet.conv_in.weight.is_meta:
            raise RuntimeError(
                f"quantize_{name}() comes before the weights are loaded: it "
                "quantises them as loaded, before the cast to the serving "
                "dtype, as the reference quantises its fp32 tree")

    def quantize_unet(self, extra_deny=()) -> int:
        """Switch the UNet to the W8A8 int8 serving path (ops/quant.py):
        call it before `init_params`/`load_*`, which then quantise the
        trunk's eligible weights from the values they load, before the cast
        to the serving dtype (the reference quantises its fp32 tree). Those
        layers run kernel K7. Inference only. Returns the number of int8
        weights there will be."""
        self._before_weights("unet")
        self._int8["unet"] = tuple(extra_deny)
        return len(Q.eligible_modules(self.unet, extra_deny))

    def quantize_vae(self) -> int:
        """Switch the VAE DECODER to the W8A8 serving path, as
        `quantize_unet` (call before loading); the encoder stays high
        precision. Returns the number of int8 weights there will be."""
        self._before_weights("vae")
        self._int8["vae"] = ()
        return len(Q.eligible_modules(self.vae.decoder, prefix="decoder."))

    # ------------------------------------------------------------------
    def _prepare_action_ids(self, actions):
        """Encode raw actions and build the CFG-duplicated tensor:
        action_block's uncond half is the dropped (-1) sentinel; micro_cond
        (and action_block_nocfg) share the same ids in both halves."""
        cfg = self.unet_config
        if cfg.action_strategy is None or actions is None:
            return None
        encoded = get_action_ids(actions, cfg.action_strategy)
        if cfg.action_strategy == "action_block":
            return torch.cat([torch.full_like(encoded, ACTION_DROPPED), encoded])
        return torch.cat([encoded, encoded], dim=0)

    @torch.inference_mode()
    def generate(
        self,
        image: torch.Tensor,
        gen: GenerationConfig,
        actions: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        init_latents: Optional[torch.Tensor] = None,
        out_uint8_hw: Optional[tuple] = None,
    ) -> torch.Tensor:
        """image: [B, H, W, 3] in [-1, 1]; actions: [B, F] ids, [B, F, 8]
        poses or None. Returns fp32 video [B, F, H, W, 3] in [0, 1], or
        uint8 [B, F, oh, ow, 3] with `out_uint8_hw=(oh, ow)` (resize and
        uint8 on the device). Noise comes from `generator` (on the device)
        unless `init_latents` [B, F, h, w, 4] is injected."""
        latents = self.denoise(image, gen, actions, generator=generator,
                               init_latents=init_latents)
        return self._decode_chunked(latents, gen, out_uint8_hw)

    @torch.inference_mode()
    def denoise(
        self,
        image: torch.Tensor,
        gen: GenerationConfig,
        actions: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        init_latents: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """`generate` up to the decode: the denoised latents divided by the
        VAE's scaling factor, fp32 [B, F, h, w, 4]."""
        dev = self.device
        image = image.to(dev, torch.float32)
        B, H, W, _ = image.shape
        F = gen.num_frames
        scale = self.vae_config.spatial_scale
        h, w = H // scale, W // scale

        # 1. CLIP conditioning [B, 1, D]; uncond = zeros
        embeds = self.clip(preprocess_for_clip(image))[:, None, :]
        context = torch.cat([torch.zeros_like(embeds), embeds], dim=0)

        # 2. VAE-encode the noise-augmented conditioning image (unscaled)
        aug = image + gen.noise_aug_strength * torch.randn(
            image.shape, generator=generator, device=dev)
        img_latents = self.vae.encode(aug).float()
        img_latents = torch.cat([torch.zeros_like(img_latents), img_latents])
        img_latents = img_latents[:, None].expand(2 * B, F, h, w, -1)

        # 3. added_time_ids + action conditioning
        added_time_ids = torch.tensor(
            [[gen.fps - 1, gen.motion_bucket_id, gen.noise_aug_strength]],
            dtype=torch.float32, device=dev).expand(2 * B, 3)
        if actions is not None:
            actions = actions.to(dev)
        action_ids = self._prepare_action_ids(actions)

        # 4. schedule + init noise
        sigmas = S.karras_sigmas(gen.num_inference_steps, gen.edm, device=dev)
        if init_latents is not None:
            noise = init_latents.to(dev, torch.float32)
        elif (gen.task_type == "navigation" and actions is not None
              and actions.ndim == 2):
            noise = sample_latent_noise(actions, (B, F, 4, h, w),
                                        generator=generator)
            noise = noise.movedim(2, -1)  # -> [B, F, h, w, 4]
        else:
            noise = torch.randn((B, F, h, w, 4), generator=generator, device=dev)
        latents = noise * torch.sqrt(sigmas[0] ** 2 + 1.0)
        guidance = S.guidance_scales(F, gen.min_guidance_scale,
                                     gen.max_guidance_scale,
                                     device=dev)[None, :, None, None, None]

        def unet_rows(latents, sigma, both):
            if both:
                latent_in = torch.cat([latents, latents])
                img, ctx, atids, acts = (img_latents, context, added_time_ids,
                                         action_ids)
            else:
                latent_in = latents
                img, ctx, atids = img_latents[B:], context[B:], added_time_ids[B:]
                acts = None if action_ids is None else action_ids[B:]
            latent_in = torch.cat(
                [S.precondition_inputs(latent_in, sigma), img], dim=-1)
            t = S.sigma_to_t(sigma).expand(latent_in.shape[0])
            return self.unet(latent_in, t, ctx, atids, acts)

        def advance(latents, pred, sigma, sigma_next):
            denoised = S.precondition_outputs(pred, latents, sigma)
            return S.euler_step(latents, denoised, sigma, sigma_next)

        uncond = torch.zeros_like(latents)
        for kind, start, end in S.cfg_row_segments(
                gen.num_inference_steps, gen.cfg, gen.edm):
            if kind == "alt":
                raise NotImplementedError(
                    "the 'alt' CFG tail policy is not ported yet")
            for i in range(start, end):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                if kind == "full":
                    uncond, cond = unet_rows(latents, sigma, True).chunk(2)
                    pred = uncond + guidance * (cond - uncond)
                elif kind == "stale":
                    cond = unet_rows(latents, sigma, False)
                    pred = uncond + guidance * (cond - uncond)
                else:  # cond
                    pred = unet_rows(latents, sigma, False)
                latents = advance(latents, pred, sigma, sigma_next)
        return latents / self.vae_config.scaling_factor

    def _decode_chunked(self, latents, gen: GenerationConfig, out_hw=None):
        """Chunked VAE decode; each chunk is one temporal unit."""
        B, F, h, w, _ = latents.shape
        chunk = gen.resolved_decode_chunk(
            dtype_bytes=self.vae_config.torch_dtype.itemsize)
        videos = []
        for start in range(0, F, chunk):
            size = min(chunk, F - start)
            part = latents[:, start:start + size].reshape(B * size, h, w, 4)
            vid = (self.vae.decode(part, size) / 2.0 + 0.5).clamp(0.0, 1.0)
            if out_hw is not None:
                vid = resize_cubic(vid, out_hw, dims=(2, 3)).clamp(0.0, 1.0)
                vid = torch.round(vid * 255.0).to(torch.uint8)
            videos.append(vid)
        return torch.cat(videos, dim=1)
