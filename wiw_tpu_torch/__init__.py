"""wiw_tpu_torch — the PyTorch/CUDA port of `wiw_tpu`'s SVD-dagger serving path.

Mirrors the reference package's layout, one port file per reference file:
  core/      schedule, action codecs, pano-correlated noise
  ops/       attention dispatch, the hand-written Hopper flash-attention
             kernel (csrc/flash_attn_fwd.cu) and its plain version, frame
             attention, the cubic antialiased resize
  models/    layers, spatio-temporal UNet, temporal VAE, CLIP ViT, and the
             diffusers-key weight converter
  sampling/  SVDPipeline.generate on one device
  workers/   the svd_action world-model worker

Public layouts match `wiw_tpu`: image [B,H,W,3] in [-1,1], latents
[B,F,h,w,4], video [B,F,H,W,3]. The package imports torch and never jax.
"""

__version__ = "0.1.0"
