"""Step-level continuous batching for diffusion serving, on PyTorch.

Port of `wiw_tpu/serve/continuous.py`. Requests arriving in bursts join
the batch between Euler steps instead of waiting for the previous clip:

  * a fixed pool of S slots; slot state = latents + conditioning + its own
    sigma index; inactive slots are computed too and their results ignored
  * `_step_once` applies ONE per-slot-sigma Euler step to the whole pool:
    rows at different denoise depths share one UNet batch (the UNet takes
    t per row)
  * the host loop each tick admits pending requests into free slots
    (`_encode_request`), calls `_step_once`, and harvests slots whose sigma
    index reached num_steps (whole-clip decode, resize, uint8)

With a stale CFG tail (`gen.cfg`), a tick where every active slot is past
the tail boundary runs the cond-only form: S UNet rows against each slot's
carried uncond prediction. The host mirrors each slot's step count and
chooses from it, with no device sync.

Finished slots decode asynchronously on the card: the slot's latents are
cloned on the compute stream, the decode runs on a stream of its own after
it, and the uint8 frames are copied to pinned host memory there; an event
says when they are ready. The slot is free at once, and a re-admitted slot
never races the decode of its last occupant (the decode reads the clone).
On the CPU the decode runs in place.

Randomness comes from a `torch.Generator` on the engine's device, passed
to `admit` (the reference's PRNG key).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from wiw_tpu_torch.core import schedule as S
from wiw_tpu_torch.core.actions import get_action_ids
from wiw_tpu_torch.core.noise import sample_latent_noise
from wiw_tpu_torch.models.clip import preprocess_for_clip
from wiw_tpu_torch.models.unet import ACTION_DROPPED
from wiw_tpu_torch.ops.resize import resize_cubic


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    active: bool = False
    steps: int = 0  # host mirror of this slot's sigma index


@dataclasses.dataclass
class _Decode:
    """A finished slot's decode in flight: the frames (pinned host memory
    on the card) and the event recorded after their copy (None on the
    CPU, where the decode ran in place)."""

    request_id: int
    frames: torch.Tensor
    done: Optional[torch.cuda.Event]

    def ready(self) -> bool:
        return self.done is None or self.done.query()

    def result(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.frames.numpy()


class ContinuousEngine:
    """Step-granular denoise engine over a fixed slot pool, on the device
    of `pipe` (for "cuda", the current card). One engine serves one (H, W) bucket (`gen`); engines of
    other buckets share the pipeline's resident weights.

    `out_hw=(oh, ow)` with `out_uint8=True` fuses the serving resize (cubic,
    antialiased) and the uint8 conversion into the decode; the default
    keeps float [0, 1] frames at the generation size."""

    def __init__(self, pipe, gen, num_slots: int = 4, out_hw=None,
                 out_uint8: bool = False):
        self.pipe = pipe
        self.gen = gen
        self.device = pipe.device
        if self.device.type == "cuda" and self.device.index is None:
            # a concrete card, which the serving thread makes its own
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.out_hw = tuple(out_hw) if out_hw is not None else None
        self.out_uint8 = out_uint8
        self.S = num_slots
        scale = pipe.vae_config.spatial_scale
        self.F = gen.num_frames
        self.h, self.w = gen.height // scale, gen.width // scale
        self.num_steps = gen.num_inference_steps
        self.sigmas = S.karras_sigmas(self.num_steps, gen.edm, device=self.device)
        segs = S.cfg_row_segments(self.num_steps, gen.cfg, gen.edm)
        self._tail_start = None
        if len(segs) >= 2 and segs[-1][0] == "stale" and all(
                k == "full" for k, _, _ in segs[:-1]):
            self._tail_start = segs[-1][1]
        elif not gen.cfg.is_full and any(k != "full" for k, _, _ in segs):
            raise ValueError(
                "ContinuousEngine supports CFGSchedule tails with "
                f"tail_policy='stale' and no head interval; got {segs}")
        self._slots = [_Slot() for _ in range(num_slots)]
        self._next_req = 0
        self._state = self._empty_state()
        self._pending_decodes: List[_Decode] = []
        self._decode_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

    # ---------------- device state ------------------------------------
    def _empty_state(self) -> Dict[str, torch.Tensor]:
        S_, F, h, w = self.S, self.F, self.h, self.w
        cfg = self.pipe.unet_config

        def zeros(*shape):
            return torch.zeros(shape, device=self.device)

        state = {
            "latents": zeros(S_, F, h, w, 4),
            "img_latents": zeros(S_, F, h, w, 4),
            "context": zeros(S_, 1, cfg.cross_attention_dim),
            "sigma_idx": torch.zeros(S_, dtype=torch.int64, device=self.device),
            "active": torch.zeros(S_, dtype=torch.bool, device=self.device),
        }
        if cfg.action_strategy == "micro_cond":
            state["action_ids"] = zeros(S_, F, cfg.action_input_channel)
        elif cfg.uses_action_block:
            state["action_ids"] = zeros(S_, F, 4)
        if self._tail_start is not None:
            # last refreshed uncond prediction per slot (the stale-CFG carry)
            state["uncond"] = zeros(S_, F, h, w, 4)
        return state

    # ---------------- device pieces ------------------------------------
    @torch.no_grad()
    def _encode_request(self, generator: torch.Generator, image: torch.Tensor,
                        actions: Optional[torch.Tensor]) -> dict:
        """One request's conditioning: CLIP embedding, the noise-augmented
        image's latents, init noise (pano-correlated for navigation ids)
        and the encoded action ids. Draws the augmentation noise, then the
        latent noise, from `generator`."""
        pipe, dev = self.pipe, self.device
        img = image.to(dev, torch.float32)[None]  # [1, H, W, 3]
        embeds = pipe.clip(preprocess_for_clip(img))[:, None, :]
        aug = img + self.gen.noise_aug_strength * torch.randn(
            img.shape, generator=generator, device=dev)
        img_lat = pipe.vae.encode(aug).float()[0]  # [h, w, 4]
        img_lat = img_lat[None].expand(self.F, -1, -1, -1)
        if actions is not None:
            actions = actions.to(dev)
        if (self.gen.task_type == "navigation" and actions is not None
                and actions.ndim == 1):
            noise = sample_latent_noise(actions[None], (1, self.F, 4, self.h, self.w),
                                        generator=generator)
            noise = noise.movedim(2, -1)[0]
        else:
            noise = torch.randn((self.F, self.h, self.w, 4), generator=generator,
                                device=dev)
        action_ids = None
        cfg = pipe.unet_config
        if cfg.action_strategy is not None and actions is not None:
            action_ids = get_action_ids(actions[None], cfg.action_strategy)[0]
        return {"context": embeds[0], "img_latents": img_lat,
                "latents": noise * self.sigmas[0], "action_ids": action_ids}

    @torch.no_grad()
    def _step_once(self, state: Dict[str, torch.Tensor],
                   cond_only: bool = False) -> Dict[str, torch.Tensor]:
        """One Euler step for every slot at ITS OWN sigma index; returns the
        new state (the input's tensors are not written).

        `cond_only` is the stale-CFG tail form: S UNet rows (the cond half
        only), guidance-combined against each slot's carried `uncond`."""
        gen, cfg = self.gen, self.pipe.unet_config
        n = self.num_steps
        idx = state["sigma_idx"]
        sigma = self.sigmas[idx.clamp(0, n - 1)]
        sigma_next = self.sigmas[(idx + 1).clamp(0, n)]
        sig5 = sigma[:, None, None, None, None]
        latents, img_lat, ctx = (state["latents"], state["img_latents"],
                                 state["context"])
        if cond_only:
            latent_in = torch.cat([S.precondition_inputs(latents, sig5), img_lat],
                                  dim=-1)
            ctx_in = ctx
            t = S.sigma_to_t(sigma)
        else:
            latent_in = S.precondition_inputs(torch.cat([latents, latents]),
                                              torch.cat([sig5, sig5]))
            latent_in = torch.cat(
                [latent_in, torch.cat([torch.zeros_like(img_lat), img_lat])],
                dim=-1)
            ctx_in = torch.cat([torch.zeros_like(ctx), ctx])
            t = S.sigma_to_t(torch.cat([sigma, sigma]))
        atids = torch.tensor(
            [[gen.fps - 1, gen.motion_bucket_id, gen.noise_aug_strength]],
            dtype=torch.float32, device=self.device).expand(latent_in.shape[0], 3)
        action_ids = None
        if "action_ids" in state:
            a = state["action_ids"]
            if cond_only:
                action_ids = a
            elif cfg.action_strategy == "action_block":
                action_ids = torch.cat([torch.full_like(a, ACTION_DROPPED), a])
            else:
                action_ids = torch.cat([a, a])

        pred = self.pipe.unet(latent_in, t, ctx_in, atids, action_ids)
        out = dict(state)
        if cond_only:
            uncond, cond = state["uncond"], pred
        else:
            uncond, cond = pred.chunk(2)
            if "uncond" in state:
                out["uncond"] = uncond.to(state["uncond"].dtype)
        guidance = S.guidance_scales(self.F, gen.min_guidance_scale,
                                     gen.max_guidance_scale,
                                     device=self.device)[None, :, None, None, None]
        pred = uncond + guidance * (cond - uncond)
        denoised = S.precondition_outputs(pred, latents, sig5)
        new_latents = S.euler_step(latents, denoised, sig5,
                                   sigma_next[:, None, None, None, None])
        # inactive slots keep their latents; active ones advance
        active = state["active"]
        out["latents"] = torch.where(active[:, None, None, None, None],
                                     new_latents, latents)
        out["sigma_idx"] = torch.where(active, idx + 1, idx)
        return out

    @torch.no_grad()
    def _decode_slot(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [1, F, h, w, 4] -> video [F, H, W, 3] in [0, 1], or uint8
        [F, oh, ow, 3] with out_hw / out_uint8: one decode of the whole
        clip, as the reference's engine (not the pipeline's chunks)."""
        z = (latents / self.pipe.vae_config.scaling_factor).reshape(
            self.F, self.h, self.w, 4)
        video = self.pipe.vae.decode(z, self.F)
        vid = (video.float() / 2.0 + 0.5).clamp(0.0, 1.0)[0]
        if self.out_hw is not None and self.out_hw != tuple(vid.shape[1:3]):
            vid = resize_cubic(vid, self.out_hw, dims=(1, 2)).clamp(0.0, 1.0)
        if self.out_uint8:
            vid = torch.round(vid * 255.0).to(torch.uint8)
        return vid

    def _dispatch_decode(self, request_id: int, i: int) -> _Decode:
        """Start slot i's decode: on the CPU in place; on the card on the
        decode stream, after the compute stream's work so far, from a clone
        of the slot's latents, ending in a copy to pinned host memory."""
        lat = self._state["latents"][i:i + 1].clone()
        if self._decode_stream is None:
            return _Decode(request_id, self._decode_slot(lat), None)
        stream = self._decode_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            video = self._decode_slot(lat)
            host = torch.empty(video.shape, dtype=video.dtype, pin_memory=True)
            host.copy_(video, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        lat.record_stream(stream)  # made on the compute stream, read here
        return _Decode(request_id, host, done)

    # ---------------- host-side loop ----------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if not s.active]

    def admit(self, image, actions, generator: torch.Generator) -> Optional[int]:
        """Place one request into a free slot; returns its request id, or
        None when the pool is full. `image` [H, W, 3] in [-1, 1] must match
        this engine's bucket (ValueError otherwise); `actions` [F] nav ids,
        [F, 8] poses or None."""
        expect = (self.gen.height, self.gen.width, 3)
        if tuple(np.shape(image)) != expect:
            raise ValueError(
                f"image shape {tuple(np.shape(image))} does not match this "
                f"engine's bucket {expect}; configure a matching bucket "
                "(server_cli --buckets) or resize the conditioning image")
        free = self._free_slots()
        if not free:
            return None
        i = free[0]
        payload = self._encode_request(
            generator, torch.as_tensor(np.asarray(image, np.float32)),
            torch.as_tensor(np.asarray(actions)) if actions is not None else None)
        st = self._state
        for key in ("latents", "img_latents", "context"):
            st[key][i] = payload[key]
        if payload["action_ids"] is not None and "action_ids" in st:
            st["action_ids"][i] = payload["action_ids"]
        st["sigma_idx"][i] = 0
        st["active"][i] = True
        rid = self._next_req
        self._next_req += 1
        self._slots[i] = _Slot(request_id=rid, active=True)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abandon one request (client death, superseded candidate): frees
        its slot at once and drops a decode already dispatched for it. Other
        slots are untouched. False if the id is unknown or delivered."""
        hit = False
        for i, slot in enumerate(self._slots):
            if slot.active and slot.request_id == request_id:
                self._slots[i] = _Slot()
                self._state["active"][i] = False
                hit = True
        before = len(self._pending_decodes)
        self._pending_decodes = [d for d in self._pending_decodes
                                 if d.request_id != request_id]
        return hit or len(self._pending_decodes) < before

    @property
    def busy(self) -> bool:
        """True while any slot is denoising or any decode is in flight."""
        return any(s.active for s in self._slots) or bool(self._pending_decodes)

    def step(self) -> Dict[int, np.ndarray]:
        """One engine tick; returns {request_id: video} for finished slots
        whose decode is ready (all of them when nothing is denoising)."""
        active = [s for s in self._slots if s.active]
        stepping = bool(active)
        if stepping:
            # the stale-CFG tail only when EVERY active slot is past the
            # boundary; a mixed-depth pool keeps uncond fresh for everyone
            cond_only = (self._tail_start is not None
                         and all(s.steps >= self._tail_start for s in active))
            self._state = self._step_once(self._state, cond_only)
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                slot.steps += 1
                if slot.steps >= self.num_steps:
                    self._pending_decodes.append(
                        self._dispatch_decode(slot.request_id, i))
                    self._slots[i] = _Slot()
                    self._state["active"][i] = False
        finished: Dict[int, np.ndarray] = {}
        still = []
        for d in self._pending_decodes:
            if not stepping or d.ready():
                finished[d.request_id] = d.result()
            else:
                still.append(d)
        self._pending_decodes = still
        return finished

    def run_to_completion(self, requests) -> Dict[int, np.ndarray]:
        """Admit all (queueing over capacity) and run until done;
        `requests` are (image, actions, generator) triples."""
        pending = list(requests)
        results: Dict[int, np.ndarray] = {}
        while pending or self.busy:
            while pending and self._free_slots():
                self.admit(*pending.pop(0))
            results.update(self.step())
        return results
