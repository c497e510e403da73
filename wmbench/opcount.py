"""The yardstick's arithmetic: operations and bytes of the model and of the
kernels, from the configuration's shapes, and the H100's peaks.

The model's counts come from the plain reference run on the meta device
with its tally on: two operations a multiply-add for every Linear, conv and
attention product the mathematics needs (a cross-attention over one
context token needs none of q and k), nothing for elementwise work, no
recomputation. Products the int8 rule takes count as int8 operations, the
rest as floating-point ones. A kernel's count is what its call's shapes
need: each input byte read once, each output byte written once.
"""

from __future__ import annotations

import functools
import json
import time

from wmbench.reference import svd as ref

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK = {"int8": 1979e12, "bf16": 989e12, "float": 989e12}
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(ops / peak, nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------- kernels
def k1(B, Hh, Sq, Sk, D, itemsize=2, lse=False):
    """K1 (attention forward): QK^T and PV; q, k, v read, out written (and
    the fp32 log-sum-exp when saved for the backward)."""
    ops = 4.0 * B * Hh * Sq * Sk * D
    nbytes = itemsize * B * Hh * D * (2 * Sq + 2 * Sk) + (4 * B * Hh * Sq if lse else 0)
    return ops, nbytes


def k3(B, Hh, Sq, Sk, D, itemsize=2):
    """K3 (attention backward): the five products of the flash backward
    (QK^T again, dP = dO V^T, dV, dQ, dK); q, k, v, out, dout and the fp32
    log-sum-exp read, dq, dk, dv written."""
    ops = 10.0 * B * Hh * Sq * Sk * D
    nbytes = itemsize * B * Hh * D * (3 * Sq + 2 * Sk + 3 * Sk) + 4 * B * Hh * Sq
    return ops, nbytes


def k7_dense(M, K, N, x_itemsize=2, out_itemsize=2, bias=True):
    """K7 dense: the per-row quantisation of x [M, K] and the int8 product
    with w8 [N, K]; x, w8, the scales and the bias read, out written."""
    return 2.0 * M * N * K, (M * K * x_itemsize + N * K + 4 * N
                             + (4 * N if bias else 0) + M * N * out_itemsize)


def k7_conv(N, Hh, W, C, O, k, stride, padding, x_itemsize=2, out_itemsize=2, bias=True):
    """K7 conv: amax, the quantisation pass and the implicit-GEMM int8
    conv of x [N, H, W, C] with w8 [O, k, k, C]; x read once, w8, scales
    and bias read, out written."""
    oh = (Hh + 2 * padding - k) // stride + 1
    ow = (W + 2 * padding - k) // stride + 1
    ops = 2.0 * N * oh * ow * O * k * k * C
    nbytes = (N * Hh * W * C * x_itemsize + O * k * k * C + 4 * O
              + (4 * O if bias else 0) + N * oh * ow * O * out_itemsize)
    return ops, nbytes


class KernelCalls:
    """Wrappers around the kernels' entry points as the model calls them:
    each call a span (`wmbench.k7`, `wmbench.k1`, `wmbench.k3`), and its
    bound time, by its shapes, kept with its host time."""

    def __init__(self):
        self.calls = {"k7": [], "k1": [], "k3": []}

    def install(self, spans, which=("k7",)):
        from wiw_tpu_torch.models import layers
        from wiw_tpu_torch.ops import attention, flash_attention

        peak_i8, peak_bf = PEAK["int8"], PEAK["bf16"]

        def note(kind, ops, nbytes, peak):
            self.calls[kind].append((time.perf_counter(), bound_s(ops, nbytes, peak)))

        if "k7" in which:
            dense, conv = layers.w8a8_dense, layers.w8a8_conv

            def on_dense(args, kwargs):
                x, w8 = args[0], args[1]
                bias = args[3] if len(args) > 3 else kwargs.get("bias")
                note("k7", *k7_dense(x.numel() // x.shape[-1], x.shape[-1], w8.shape[0],
                                     x.element_size(), 2, bias is not None), peak_i8)

            def on_conv(args, kwargs):
                x, w8 = args[0], args[1]
                bias = args[3] if len(args) > 3 else kwargs.get("bias")
                n, hh, ww, c = x.shape
                note("k7", *k7_conv(n, hh, ww, c, w8.shape[0], w8.shape[1],
                                    kwargs.get("stride", 1), kwargs.get("padding", 0),
                                    x.element_size(), 2, bias is not None), peak_i8)

            layers.w8a8_dense = spans.wrap(dense, "wmbench.k7", on_dense)
            layers.w8a8_conv = spans.wrap(conv, "wmbench.k7", on_conv)
        if "k1" in which:
            fwd = attention.flash_attention

            def on_fwd(args, kwargs):
                q, k = args[0], args[1]
                B, Hh, Sq, D = q.shape
                note("k1", *k1(B, Hh, Sq, k.shape[2], D, q.element_size(),
                               lse=q.requires_grad), peak_bf)

            attention.flash_attention = spans.wrap(fwd, "wmbench.k1", on_fwd)
        if "k3" in which:
            bwd = flash_attention.flash_attention_bwd

            def on_bwd(args, kwargs):
                q, k = args[0], args[1]
                B, Hh, Sq, D = q.shape
                note("k3", *k3(B, Hh, Sq, k.shape[2], D, q.element_size()), peak_bf)

            flash_attention.flash_attention_bwd = spans.wrap(bwd, "wmbench.k3", on_bwd)

    def bound_in(self, kind: str, t0: float, t1: float) -> float:
        return sum(b for t, b in self.calls[kind] if t0 <= t < t1)


# ---------------------------------------------------------------- the model
@functools.lru_cache(maxsize=None)
def _tower_ops(config_json: str, what: str, rows: int) -> tuple:
    """(int8 ops, float ops) of one call of `what` on `rows` rows, by the
    reference on the meta device."""
    import torch

    config = json.loads(config_json)
    u, v, c, g = config["unet"], config["vae"], config["clip"], config["generation"]
    mode = (config.get("serving") or {}).get("quantize")
    tally = {}
    q = ref.Quant(mode if mode in ("int8",) else None, tally)
    spec = ref.param_spec(config)
    scale = 2 ** (len(v["block_out_channels"]) - 1)
    Fr, Hh, W = g["num_frames"], g["height"], g["width"]
    h, w = Hh // scale, W // scale
    meta = torch.device("meta")

    def params(tower):
        return {n: torch.empty(s, device=meta) for n, (s, _) in spec[tower].items()}

    with torch.no_grad():
        if what == "unet":
            ref.unet(params("unet"), u, torch.empty(rows, Fr, h, w, 2 * v["latent_channels"],
                                                    device=meta),
                     torch.empty(rows, device=meta), torch.empty(rows, 1, u["cross_attention_dim"],
                                                                 device=meta),
                     torch.empty(rows, device=meta),
                     torch.empty(rows, Fr, u["action_input_channel"], device=meta), q)
        elif what == "vae_decode":
            ref.vae_decode(params("vae"), v, torch.empty(rows * Fr, h, w, v["latent_channels"],
                                                         device=meta), Fr, q)
        elif what == "vae_encode":
            ref.vae_encode(params("vae"), v, torch.empty(rows, Hh, W, 3, device=meta), None, q)
        elif what == "clip":
            ref.clip_embed(params("clip"), c, torch.empty(rows, Hh, W, 3, device=meta), q)
    return tally.get("int8", 0.0), tally.get("float", 0.0)


def tower_ops(config: dict, what: str, rows: int = 1) -> dict:
    """{"int8": ops, "float": ops} of one call of the tower `what` ("unet":
    `rows` samples of every frame; "vae_encode"/"clip": `rows` images;
    "vae_decode": `rows` clips)."""
    i8, fl = _tower_ops(json.dumps(config, sort_keys=True), what, rows)
    return {"int8": i8, "float": fl}


def serve_work(config: dict, rows: dict, clips: float) -> dict:
    """The serving work credited to a window: the UNet rows of the active
    slots (two a slot in a full CFG tick, one in a cond-only tick), and for
    each clip its conditioning encode (CLIP, VAE encode) and its decode."""
    unet = tower_ops(config, "unet")
    per_clip = [tower_ops(config, t) for t in ("vae_encode", "clip", "vae_decode")]
    n = 2.0 * rows["full"] + rows["cond"]
    return {k: n * unet[k] + clips * sum(p[k] for p in per_clip) for k in ("int8", "float")}


def train_ops_per_clip(config: dict) -> float:
    """One training clip: the UNet's forward and backward (3 x its forward),
    the frozen VAE encode of every frame and of the conditioning image, and
    the CLIP embedding (forward only)."""
    Fr = config["generation"]["num_frames"]
    unet = tower_ops(config, "unet")["float"]
    enc = tower_ops(config, "vae_encode")["float"]
    return 3.0 * unet + (Fr + 1) * enc + tower_ops(config, "clip")["float"]


def utilisation(work: dict, seconds: float) -> float:
    """Share of the card's peaks, %: each kind's operations over its peak,
    summed, over the seconds."""
    return 100.0 * sum(work[k] / PEAK[k] for k in work) / seconds
