"""Port parity for W8A8 int8 serving: `wiw_tpu_torch.ops.quant` (kernel K7's
plain versions and the quantisation policy) against `wiw_tpu.ops.quant`.

The reference quantises flax trees whose output channel is the last axis;
the port quantises torch layouts whose output channel is the first (a conv's
int8 weight laid out [O, kh, kw, I]). Inputs are made with numpy from a
seed and go through both, fp32 on the CPU. Tolerances, stated per test:
  * weight and activation codes and scales: exactly equal (the same fp32
    division and round-half-to-even; no code differs at any tie here);
  * `w8a8_dense` / `w8a8_conv` on the same int8 weights: fp32 output within
    1e-6 relative, bf16 within one bf16 ulp (the int32 sums are exact on
    both sides and the epilogue's fp32 operations are the same ones);
  * the quantised module sets of TINY_UNET (both module sets) and of
    TINY_VAE's decoder: equal as flax paths, and equal in number to
    `count_quantized`;
  * a quantised TINY_UNET forward against the reference's after
    `quantize_params`: 2e-5 where no activation code moves, max 0.1 /
    mean 0.02 with the whole set, where the reference's own int8 forward
    moves as much under 1e-6 input noise (the test says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_models import TINY_UNET, TINY_VAE
from wiw_tpu.models.unet import UNetSpatioTemporal as JUNet
from wiw_tpu.models.vae import AutoencoderKLTemporal as JVAE
from wiw_tpu.ops import quant as JQ
from wiw_tpu_torch.models import convert as TCV
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.models import vae as TV
from wiw_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)


def port_cfg(cls, jcfg, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    return cls(**dict(kw, **over))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _flax_to_port(w8: np.ndarray) -> torch.Tensor:
    """A reference int8 kernel ([K, N] or [kh, kw, I, O]) in the port's
    layout ([N, K] or [O, kh, kw, I])."""
    w8 = np.asarray(w8)
    perm = (1, 0) if w8.ndim == 2 else (3, 0, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(w8.transpose(perm)))


@pytest.mark.parametrize("shape", [(64, 96), (3, 3, 32, 48), (1, 1, 16, 24)])
def test_quantize_kernel_codes_and_scales_equal_reference(shape):
    w = _rand(shape, 0)
    j8, js = JQ.quantize_kernel(jnp.asarray(w))
    perm = (1, 0) if len(shape) == 2 else (3, 0, 1, 2)
    t8, ts = TQ.quantize_kernel(torch.from_numpy(np.ascontiguousarray(
        w.transpose(perm))))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    assert torch.equal(t8, _flax_to_port(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_codes_equal_reference(dtype):
    """Per-row codes and scales over 32768 values, with rows at several
    magnitudes and a row of zeros (the 1e-8 floor)."""
    x = _rand((128, 256), 1, 3.0) * np.logspace(-3, 3, 128, dtype=np.float32)[:, None]
    x[5] = 0.0
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    j8, js = JQ._quant_rows(jx)
    t8, ts = TQ._quant_rows(tx)
    differ = int((t8.numpy().astype(int) != np.asarray(j8).astype(int)).sum())
    assert differ == 0, f"{differ} of {x.size} codes differ"
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _dense_args(bias, seed=2, lead=(3, 50), K=64, N=96):
    x = _rand(lead + (K,), seed)
    w = _rand((K, N), seed + 1, 0.2)
    b = _rand((N,), seed + 2) if bias else None
    j8, js = JQ.quantize_kernel(jnp.asarray(w))
    return x, j8, js, b


def _assert_out_close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    else:  # one bf16 ulp: 2^-7 relative to the value's binade
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out - ref) <= ulp).all()


# the widths K7's tiling singles out: N 320 (160-wide tiles), K 320 and 960
# (not multiples of 128), a few rows
@pytest.mark.parametrize("lead,K,N", [((3, 50), 64, 96), ((2, 7), 320, 320),
                                      ((5,), 960, 160)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a8_dense_matches_reference(x_dtype, out_dtype, bias, lead, K, N):
    x, j8, js, b = _dense_args(bias, lead=lead, K=K, N=N)
    ref = JQ.w8a8_dense(jnp.asarray(x).astype(x_dtype), j8, js,
                        None if b is None else jnp.asarray(b),
                        dtype=getattr(jnp, out_dtype))
    out = TQ.w8a8_dense(torch.from_numpy(x).to(getattr(torch, x_dtype)),
                        _flax_to_port(j8), torch.from_numpy(np.array(js)),
                        None if b is None else torch.from_numpy(b),
                        dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    _assert_out_close(out, ref, out_dtype)


@pytest.mark.parametrize("C,O", [(32, 48), (320, 320), (960, 64)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_conv_matches_reference(stride, out_dtype, C, O):
    """3x3 pad 1 at stride 1 (resnets, upsamplers) and 2 (downsamplers) on
    odd spatial sizes; one activation scale for the whole call; input
    channels off the 64-byte chunk (32) and on it (320, 960), N 320."""
    x = _rand((2, 9, 11, C), 3, 2.0)
    w = _rand((3, 3, C, O), 4, 0.1)
    b = _rand((O,), 5)
    j8, js = JQ.quantize_kernel(jnp.asarray(w))
    ref = JQ.w8a8_conv(jnp.asarray(x).astype(jnp.bfloat16), j8, js,
                       jnp.asarray(b), strides=(stride, stride),
                       padding=((1, 1), (1, 1)), dtype=getattr(jnp, out_dtype))
    out = TQ.w8a8_conv(torch.from_numpy(x).bfloat16(), _flax_to_port(j8),
                       torch.from_numpy(np.array(js)), torch.from_numpy(b),
                       stride=stride, padding=1, dtype=getattr(torch, out_dtype))
    _assert_out_close(out, ref, out_dtype)


def test_conv_scale_spans_the_whole_call():
    """The conv's activation scale covers every row of the call, as the
    reference's does: a row's output changes when a larger row is batched
    with it (the per-row rule of K8 does not hold here)."""
    x = torch.from_numpy(_rand((1, 6, 6, 16), 6))
    big = x * 50.0
    w8, ws = TQ.quantize_kernel(torch.from_numpy(_rand((8, 3, 3, 16), 7)))
    alone = TQ.w8a8_conv(x, w8, ws, padding=1, dtype=torch.float32)
    batched = TQ.w8a8_conv(torch.cat([x, big]), w8, ws, padding=1,
                           dtype=torch.float32)[:1]
    assert not torch.equal(alone, batched)
    j8 = jnp.asarray(w8.numpy().transpose(1, 2, 3, 0))
    ref = JQ.w8a8_conv(jnp.asarray(torch.cat([x, big]).numpy()), j8,
                       jnp.asarray(ws.numpy()), strides=(1, 1),
                       padding=((1, 1), (1, 1)), dtype=jnp.float32)[:1]
    np.testing.assert_allclose(batched.numpy(), np.asarray(ref), rtol=1e-6)


MICRO_UNET = dataclasses.replace(TINY_UNET, action_strategy="micro_cond",
                                 action_input_channel=3)


def _unet_inputs(B=2, H=8, W=8):
    F = MICRO_UNET.num_frames
    acts = np.asarray([[[4, 0, 0], [4, 2, 0], [4, 2, 1]],
                       [[4, 0, 0], [4, 3, 0], [4, 3, 3]]], np.float32)[:B]
    return dict(
        sample=_rand((B, F, H, W, MICRO_UNET.in_channels), 11),
        timestep=np.asarray([0.9, -1.2], np.float32)[:B],
        context=_rand((B, 1, MICRO_UNET.cross_attention_dim), 12, 0.3),
        added_time_ids=np.tile(np.asarray([[6.0, 127.0, 0.02]], np.float32), (B, 1)),
        action_ids=acts,
    )


@pytest.fixture(scope="module")
def unet_params():
    """(the reference's jitted apply, inputs, fp32 params)."""
    jmod = JUNet(MICRO_UNET)
    inputs = _unet_inputs()
    params = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), **inputs)["params"])
    return jax.jit(jmod.apply), inputs, params


def _int8_paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _int8_paths(v, prefix + (k,))
        elif np.asarray(v).dtype == np.int8:
            out.add(prefix)
    return out


def _port_paths(found, prefix=""):
    skip = 1 if prefix else 0
    return {TCV.translate_key(f"{prefix}{name}.weight")[skip:-1] for name, _ in found}


@pytest.mark.parametrize("modules", ["default", "aggressive"])
def test_quantized_unet_module_set_equals_reference(unet_params, modules):
    mods = (JQ.QUANT_KERNEL_MODULES if modules == "default"
            else JQ.QUANT_KERNEL_MODULES_AGGRESSIVE)
    assert mods == (TQ.QUANT_KERNEL_MODULES if modules == "default"
                    else TQ.QUANT_KERNEL_MODULES_AGGRESSIVE)
    _, _, params = unet_params
    qtree = JQ.quantize_params(params, modules=mods)
    port = TU.UNetSpatioTemporal(port_cfg(TU.UNetConfig, MICRO_UNET))
    found = TQ.eligible_modules(port, modules=mods)
    assert _port_paths(found) == _int8_paths(qtree)
    TQ.quantize_params(port, modules=mods)
    assert TQ.count_quantized(port) == JQ.count_quantized(qtree) == len(found) > 0
    # an extra deny list removes the same modules on both sides
    qtree2 = JQ.quantize_params(params, extra_deny=("net_0_proj",), modules=mods)
    assert _port_paths(TQ.eligible_modules(
        TU.UNetSpatioTemporal(port_cfg(TU.UNetConfig, MICRO_UNET)),
        ("net_0_proj",), mods)) == _int8_paths(qtree2)


def test_quantized_vae_decoder_module_set_equals_reference():
    jmod = JVAE(TINY_VAE)
    params = _np(jax.jit(lambda k: jmod.init(k, jnp.zeros((2, 16, 16, 3)), 2))(
        jax.random.PRNGKey(0))["params"])
    qtree = JQ.quantize_vae_decoder(params)
    assert _int8_paths(qtree["encoder"]) == set()
    port = TV.AutoencoderKLTemporal(port_cfg(TV.VAEConfig, TINY_VAE))
    found = TQ.eligible_modules(port.decoder, prefix="decoder.")
    assert _port_paths(found, "decoder.") == _int8_paths(qtree["decoder"])
    TQ.quantize_vae_decoder(port)
    assert TQ.count_quantized(port) == JQ.count_quantized(qtree) == len(found) > 0
    # the quantised tree loads into a fresh port VAE, both ways covered
    fresh = TCV.load_flax_params(
        TV.AutoencoderKLTemporal(port_cfg(TV.VAEConfig, TINY_VAE)), _np(qtree))
    assert TQ.count_quantized(fresh) == len(found)


@pytest.mark.parametrize("deny,atol,mean_atol", [
    (("conv1", "conv", "net_0_proj"), 2e-5, 2e-6),
    (("conv1", "conv2", "net_0_proj"), 2e-5, 2e-6),
    ((), 0.1, 0.02),
])
def test_quantized_unet_forward_matches_reference(unet_params, deny, atol,
                                                  mean_atol):
    """The reference's quantised tree carried across (`load_flax_params`
    makes the layers int8) and the port quantising the fp32 tree it loaded
    give the same codes, and the forward agrees with the reference's.

    Tolerance: the int8 forward is chaotic at the level of codes: a ~1e-7
    reordering upstream moves an activation code by one (a step of
    amax/127), and the next int8 layers carry it on. The reference's own
    int8 forward moves by max 0.044 / mean 0.0085 when its input moves by
    1e-6 relative (its fp32 forward by 5e-6). With the 8 conv2 layers
    alone, or the 2 samplers' convs alone, no code moves at these seeds:
    2e-5 (measured 2e-6; both together already move one, 6.5e-3). With the
    whole default set (30): max 0.1, mean 0.02 (measured 0.044 / 0.0074)."""
    apply, inputs, params = unet_params
    qtree = _np(JQ.quantize_params(params, extra_deny=deny))
    ref = np.asarray(apply({"params": qtree}, **inputs))
    cfg = port_cfg(TU.UNetConfig, MICRO_UNET)
    carried = TCV.load_flax_params(TU.UNetSpatioTemporal(cfg), qtree)
    own = TQ.quantize_params(TCV.load_flax_params(TU.UNetSpatioTemporal(cfg), params),
                             extra_deny=deny)
    for (k, a), (k2, b) in zip(carried.state_dict().items(), own.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = carried(**targs).numpy()
        fp32 = TCV.load_flax_params(TU.UNetSpatioTemporal(cfg), params)(**targs).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    diff = np.abs(out - ref)
    assert diff.max() <= atol and diff.mean() <= mean_atol, (diff.max(), diff.mean())
    # int8 moved the output of both (the route was taken)
    full = np.asarray(apply({"params": params}, **inputs))
    assert np.abs(full - ref).max() > 1e-3 and np.abs(fp32 - out).max() > 1e-3


def test_converter_round_trip_of_a_quantized_tree(unet_params):
    """flax_to_torch keeps int8 kernels int8 in the port's layout beside
    `weight_scale`; translate_key/convert_tensor give the tree back."""
    _, _, params = unet_params
    qtree = _np(JQ.quantize_params(params))
    state = TCV.flax_to_torch(qtree)
    conv = "down_blocks.0.resnets.0.spatial_res_block.conv1"
    ff = ("down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj")
    assert state[conv + ".weight"].dtype == torch.int8
    assert state[conv + ".weight"].shape[1:3] == (3, 3)  # [O, kh, kw, I]
    assert state[conv + ".weight_scale"].dtype == torch.float32
    assert state[ff + ".weight"].dtype == torch.int8
    back = {}
    for key, value in state.items():
        path = TCV.translate_key(key)
        back[path] = TCV.convert_tensor(path, value.numpy())
    flat = {}

    def walk(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = np.asarray(v)

    walk(qtree)
    assert set(back) == set(flat)
    for path, value in flat.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path


def test_full_width_int8_count_equals_reference():
    """At the served configuration (SVD† widths, micro_cond with 14 action
    channels) the count the worker prints, `SVDPipeline.quantize_unet()`,
    equals `count_quantized` of the reference's policy on its parameter
    tree (traced abstractly: no weights are made on either side)."""
    from wiw_tpu.models.unet import UNetConfig as JUNetConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    jcfg = JUNetConfig(action_strategy="micro_cond", action_input_channel=14)
    jmod, F = JUNet(jcfg), jcfg.num_frames

    def quantized_tree():
        params = jmod.init(
            jax.random.PRNGKey(0), sample=jnp.zeros((1, F, 8, 16, jcfg.in_channels)),
            timestep=jnp.zeros((1,)), context=jnp.zeros((1, 1, jcfg.cross_attention_dim)),
            added_time_ids=jnp.zeros((1, 3)), action_ids=jnp.zeros((1, F, 14)))["params"]
        return JQ.quantize_params(params)

    want = JQ.count_quantized(jax.eval_shape(quantized_tree))
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, jcfg), device="cpu")
    assert pipe.quantize_unet() == want == 98


@pytest.mark.parametrize("args,plan", [
    ((320,), (160, 0)), ((2560,), (160, 0)), ((10240,), (160, 0)),
    ((72,), (128, 0)), ((256,), (128, 0)),
    ((320, 320, 1, 128), (160, 128)), ((640, 640, 1, 64), (160, 64)),
    ((1280, 1280, 1, 16), (256, 16)), ((128, 128, 1, 1024), (128, 128)),
    ((512, 512, 1, 256), (256, 128)), ((64, 64, 1, 15), (128, 16)),
    ((64, 64, 1, 1), (128, 1)), ((320, 320, 2, 64), (160, 0)),
    ((1280, 1280, 2, 16), (160, 0)), ((64, 48, 1, 11), (128, 0))])
def test_k7_plan_rules(args, plan):
    """K7's tile width (the widest that divides N: dense 160; a conv with
    TMA boxes 256, then 160; the gathered conv 160; else 128) and its A
    producer (TMA boxes in bw x 128 / bw output rectangles at stride 1 with
    C a multiple of 64, bw the power of two >= OW up to 128; else the
    cp.async gather, bw 0)."""
    assert TQ.k7_plan(*args) == plan


def _served_input_width(name: str, vae: bool) -> int:
    """The input width of the conv `name` when the worker serves 576x1024
    (a 72x128 latent): the UNet halves it at each down block's downsampler
    and doubles it at each up block's upsampler (levels 128, 64, 32, 16);
    the VAE decoder starts at the latent's 128 and doubles it after each
    of its up blocks 0-2 (128 .. 1024)."""
    parts = name.split(".")
    if parts[0] == "mid_block":
        return 128 if vae else 16
    block = int(parts[1])
    up = parts[2] == "upsamplers"  # runs on the upsampled map
    if vae:
        return 128 << (block + up)
    level = block if parts[0] == "down_blocks" else 3 - block - up
    return 128 >> level


def test_k7_plan_full_width_shapes():
    """At every int8 layer of the full-width UNet (SVD† widths, micro_cond
    with 14 action channels) and of the W8A8 VAE decoder, at the widths the
    worker serves (576x1024), K7's tiles do not pad N; the A operand comes
    by TMA but at the three stride-2 downsamplers, in output rectangles as
    wide as the output row up to 128 (the next power of two of OW), so no
    column of a tile pads either. The pipeline builds its modules on the
    meta device: no weights are made."""
    from wiw_tpu.models.unet import UNetConfig as JUNetConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    jcfg = JUNetConfig(action_strategy="micro_cond", action_input_channel=14)
    pipe = SVDPipeline(port_cfg(TU.UNetConfig, jcfg), device="cpu")
    unet = TQ.eligible_modules(pipe.unet)
    vae = TQ.eligible_modules(pipe.vae.decoder, prefix="decoder.")
    assert len(unet) == 98 and vae
    gathered, widths = [], set()
    for is_vae, layers in ((False, unet), (True, vae)):
        for name, m in layers:
            if isinstance(m, torch.nn.Linear):
                bn, bw = TQ.k7_plan(m.out_features)
                assert m.out_features % bn == 0 and m.in_features % 64 == 0
                continue
            (kw,), (s,), (pad,) = m.kernel_size[1:], m.stride[1:], m.padding[1:]
            OW = (_served_input_width(name, is_vae) + 2 * pad - kw) // s + 1
            bn, bw = TQ.k7_plan(m.out_channels, m.in_channels, s, OW)
            assert m.out_channels % bn == 0, name
            if bw == 0:
                gathered.append(m)
                continue
            assert bw == min(128, 1 << (OW - 1).bit_length()) and OW % bw == 0, name
            widths.add(bw)
    assert len(gathered) == 3 and all(m.stride[0] == 2 for m in gathered)
    assert widths == {16, 32, 64, 128}
