"""wiw_tpu_torch — the PyTorch/CUDA port of `wiw_tpu`'s SVD-dagger serving path.

Mirrors the reference package's layout, one port file per reference file:
  core/      schedule, action codecs, pano-correlated noise
  ops/       attention dispatch and the hand-written Hopper kernels, each
             beside its plain version: flash attention K1
             (csrc/flash_attn_fwd.cu), frame attention K4
             (csrc/temporal_attn.cu), the fused GEGLU feed-forward K5/K6
             (csrc/geglu_ffn.cu); the cubic antialiased resize
  models/    layers, spatio-temporal UNet, temporal VAE, CLIP ViT, and the
             diffusers-key weight converter
  sampling/  SVDPipeline.generate on one device
  workers/   the svd_action world-model worker
  serve/     the worker SDK and its wire protocol (the reference's bytes)
  agents/    the video writer the worker uses

Public layouts match `wiw_tpu`: image [B,H,W,3] in [-1,1], latents
[B,F,h,w,4], video [B,F,H,W,3]. The package imports torch and never jax.
"""

__version__ = "0.1.0"
