"""Tests that need an NVIDIA GPU: the hand-written kernels against their
plain versions, on the card. They skip elsewhere (the CUDA kernels have no
CPU mode). This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, for every kernel, that of chip_smoke.py, scaled by the plain
output (K1's shrinks as 1/sqrt(S)): each element within 0.05 rms(ref) plus
2^-6 |ref| (two bf16 ulps at worst), and a relative Frobenius error within
5e-3. K1 rounds P to bf16 before the PV product, its plain version rounds
the softmax weights; K2 rounds P against a running max, its plain version
against the row max; K4, K5, K6, K6-bf16 and K8 round where their plain
versions do, but sum in another order, so a bf16 rounding (of the output,
or of K5/K6's intermediates) may land one step apart. K3 sums dQ over kv
tiles by reductions in L2 in the order the CTAs reach them, so dq's last
bits change from run to run: the same tolerance holds.
"""

import pytest
import torch

from wiw_tpu_torch.ops import attention as TAtt
from wiw_tpu_torch.ops import flash_attention as TFA
from wiw_tpu_torch.ops import fused_mlp as TF
from wiw_tpu_torch.ops import group_norm as TG
from wiw_tpu_torch.ops import temporal_attention as TT
from wiw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _close(out, ref):
    out, ref = out.float(), ref.float()
    rms = ref.square().mean().sqrt()
    assert bool(((out - ref).abs() <= 0.05 * rms + 2.0 ** -6 * ref.abs()).all())
    assert torch.linalg.vector_norm(out - ref) <= 5e-3 * torch.linalg.vector_norm(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S", [(4, 144), (3, 1000), (2, 2304)])
def test_kernel_matches_plain_on_card(cuda_device, BH, S):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, BH, S, 64, generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v)
    _close(out, ref)


@pytest.mark.cuda
def test_kernel_reads_strided_heads_and_rejects_bad_inputs(cuda_device):
    x = torch.randn(2, 144, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    out = TAtt.attention_bsd(x, x, x, 3)
    heads = x.view(2, 144, 3, 64).transpose(1, 2)
    ref = flash_attention_plain(heads, heads, heads).transpose(1, 2).reshape(
        2, 144, 192)
    _close(out, ref)
    with pytest.raises(TypeError):
        flash_attention(*(t.float() for t in (heads, heads, heads)))
    d80 = torch.zeros(1, 1, 16, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(d80, d80, d80)


def _heads(rows, S, H, g, dev):
    """[rows, H, S, 64] head views of a bf16 [rows, S, H*64] projection."""
    x = torch.randn(rows, S, H * 64, generator=g, device=dev).to(torch.bfloat16)
    return x.view(rows, S, H, 64).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H", [(9216, 5), (2304, 10), (144, 20)])
def test_kernel_at_three_kv_tokens_on_card(cuda_device, S, H):
    """K1 as past_images' spatial cross-attention gives it (Np = 2): the
    2 x 14 frames' queries against Skv = Np + 1 = 3 context tokens, one
    launch, within the tolerance of its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = _heads(28, S, H, g, cuda_device), *(_heads(28, 3, H, g, cuda_device)
                                                  for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_split_temporal_fold_on_card(cuda_device):
    """The temporal cross-attention's fold at level 0 of a 2-row forward:
    2 x 9216 positions of 14 frames, 5 heads, against 3 tokens, B*H 92160
    above the grid's 65535: `batch_splits` gives two launches, and the
    whole output is within the tolerance of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, H = 2 * 9216, 5
    q, k, v = _heads(B, 14, H, g, cuda_device), *(_heads(B, 3, H, g, cuda_device)
                                                  for _ in range(2))
    assert TFA.batch_splits(B, H) == [(0, 13107), (13107, B)]
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    _close(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv", [
    (1, 3, 144, 144), (2, 2, 200, 72), (1, 2, 1000, 1000), (1, 2, 64, 64),
    (2, 3, 65, 65), (2, 2, 200, 200), (1, 2, 2304, 2304), (2, 2, 200, 65),
    (1, 3, 64, 2304), (2, 2, 2304, 144),
    (28, 5, 144, 144),  # B*H 140: above one wave of 132 SMs
])
def test_backward_kernel_and_lse_match_plain_on_card(cuda_device, B, H, Sq, Skv):
    """K1 (wgmma, TMA-fed k/v stages) with and without its LSE flag, then K3
    (one wgmma pass of five products, dQ by TMA reduce-add) through the
    autograd Function, on head views of [B, S, H*64] projections (ragged S,
    Sq != Skv), against the plain forward, LSE and backward on the same
    bf16 inputs: one launch each, K1's output bits the same with and
    without the LSE."""
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def heads(S):
        return (torch.randn(B, S, H * 64, generator=g, device=cuda_device)
                .bfloat16().view(B, S, H, 64).transpose(1, 2))

    q, k, v, dout = heads(Sq), heads(Skv), heads(Skv), heads(Sq)
    with torch.no_grad():
        serving = flash_attention(q, k, v)
    _close(serving, flash_attention_plain(q, k, v))
    out, lse = TFA._forward(q, k, v, with_lse=True)
    assert torch.equal(out, serving)
    # the LSE sums fp32 exponentials in another order: 2e-3 absolute on
    # values of ~log(Skv) (a wrong scale or a dropped tile moves it by > 0.1)
    torch.testing.assert_close(lse, TFA.flash_attention_lse_plain(q, k),
                               rtol=0, atol=2e-3)
    fwd, bwd = TFA.flash_attention.launches, TFA.flash_attention_bwd.launches
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = TFA.flash_attention(*leaves)
    o.backward(dout)
    torch.cuda.synchronize()
    assert TFA.flash_attention.launches == fwd + 1
    assert TFA.flash_attention_bwd.launches == bwd + 1
    ref = TFA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == r.shape
        _close(leaf.grad, r)


@pytest.mark.cuda
def test_backward_kernel_refuses_scratch_of_another_q_tile(cuda_device, monkeypatch):
    """K3's wrapper sizes its fp32 scratch by Q_TILE; the kernel writes rows
    up to Sq rounded to its own q tile, so a wrapper whose tile disagrees
    raises before any launch instead of writing past the scratch."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, dout = (torch.randn(1, 2, 144, 64, generator=g, device=cuda_device)
                     .bfloat16() for _ in range(4))
    out, lse = TFA._forward(q, k, v, with_lse=True)
    before = TFA.flash_attention_bwd.launches
    monkeypatch.setattr(TFA, "Q_TILE", 128)
    with pytest.raises(RuntimeError, match="cudaError"):
        TFA.flash_attention_bwd(q, k, v, out, lse, dout)
    assert TFA.flash_attention_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("S", [144, 576])
def test_lse_flag_leaves_output_bits_unchanged(cuda_device, S):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 3, S, 64, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    with torch.no_grad():
        serving = TFA.flash_attention(q, k, v)
    training, lse = TFA._forward(q, k, v, with_lse=True)
    assert lse is not None and torch.isfinite(lse).all()
    assert torch.equal(serving, training)


def _heads72(B, S, H, g, dev, parts=1):
    """`parts` [B, H, S, 72] head views of one bf16 [B, S, parts*H*72]
    projection (parts 3: a fused qkv, as the CDiT's self-attention)."""
    x = torch.randn(B, S, parts * H * 72, generator=g, device=dev).bfloat16()
    return [x[..., i * H * 72:(i + 1) * H * 72].view(B, S, H, 72).transpose(1, 2)
            for i in range(parts)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv", [
    (2, 16, 196, 196),    # the CDiT's self-attention
    (2, 16, 196, 785),    # its cross-attention: 4 x 196 context tokens + bias_kv
    (2, 16, 2304, 2304),  # a long shape, B*H 32
    (1, 3, 65, 1),        # one kv row, a ragged q tile
])
def test_k1_d72_matches_plain_on_card(cuda_device, B, H, Sq, Skv):
    """K1's D = 72 instance (64-column parts in the 128-byte swizzle, the
    16-column tails in the 32-byte one) on head views of [B, S, H*72]
    projections, where columns 72-79 of a tail box are the next head's,
    ragged in q and kv: one launch, within the tolerance of the plain
    version on the same bf16 inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    if Sq == Skv:
        q, k, v = _heads72(B, Sq, H, g, cuda_device, parts=3)
    else:
        q, = _heads72(B, Sq, H, g, cuda_device)
        k, v = _heads72(B, Skv, H, g, cuda_device, parts=2)
    before = flash_attention.launches, flash_attention.launches_d72
    with torch.no_grad():
        out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_d72) == (
        before[0], before[1] + 1)
    assert out.shape == (B, H, Sq, 72)
    _close(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(196, 785), (144, 144), (1000, 200)])
def test_k1_d72_tail_adds_nothing_to_d64_bits(cuda_device, Sq, Skv):
    """With columns 64-71 of q, k and v zero, the D = 72 instance's first 64
    output columns are the D = 64 instance's bit for bit (the fifth k16
    step adds exact zeros to S; the tail product has its own accumulator)
    and its last 8 are zero: what the D = 64 instance computes is what it
    computed, and the tail's maps and products touch nothing else. Both run
    at the D = 72 scale, 72^-0.5."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn(2, 3, S, 72, generator=g, device=cuda_device).bfloat16()
               for S in (Sq, Skv, Skv))
    for t in (q, k, v):
        t[..., 64:] = 0
    with torch.no_grad():
        o72 = flash_attention(q, k, v)
        o64 = TFA._launch_fwd(*(t[..., :64] for t in (q, k, v)), with_lse=False,
                              sm_scale=72 ** -0.5)[0]
    torch.cuda.synchronize()
    assert torch.equal(o72[..., :64], o64)
    assert not o72[..., 64:].any()


@pytest.mark.cuda
def test_k1_d72_refuses_what_it_does_not_take(cuda_device):
    """The D = 72 instance is a serving forward: a gradient (which would need
    its LSE and K3) raises, and so does any other head width on CUDA."""
    q = torch.zeros(1, 2, 64, 72, device=cuda_device, dtype=torch.bfloat16)
    leaf = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(leaf, q, q)
    for d in (48, 80, 128):
        x = torch.zeros(1, 2, 64, d, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(x, x, x)
    q128 = torch.zeros(1, 2, 128, 72, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        TFA.attention_floor(q128, q128, q128)


@pytest.mark.cuda
def test_frame_attention_refuses_grad_on_card(cuda_device):
    x = torch.zeros(1, 14, 64, 128, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        TT.frame_attention(x, x, x, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,S,H", [(2, 14, 64, 5), (1, 14, 144, 2), (3, 3, 65, 1)])
def test_frame_attention_matches_plain_on_card(cuda_device, B, F, S, H):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, F, S, H * 64, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = TT.frame_attention.launches
    out = TT.frame_attention(q, k, v, H)
    torch.cuda.synchronize()
    assert TT.frame_attention.launches == before + 1
    _close(out, TT.frame_attention_plain(q, k, v, H))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 7, 14, 16])
@pytest.mark.parametrize("S,H", [(65, 5), (143, 10), (66, 20)])
def test_frame_attention_tensor_core_kernel_on_card(cuda_device, F, S, H):
    """The mma.sync kernel at 1..16 frames (padded to one m16 tile, frames
    past F read as zeros and masked), at S not a multiple of the 4
    positions a stage, at the UNet's head counts."""
    g = torch.Generator(device=cuda_device).manual_seed(F * 1000 + S)
    q, k, v = (torch.randn(2, F, S, H * 64, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    out = TT.frame_attention(q, k, v, H)
    torch.cuda.synchronize()
    _close(out, TT.frame_attention_plain(q, k, v, H))
    assert torch.equal(TT.frame_attention(q, k, v, H), out)


@pytest.mark.cuda
def test_frame_attention_saturating_logits_on_card(cuda_device):
    """q scaled by 30: logits of hundreds, softmax weights of 0 and 1 at
    the fp32 limits; the bf16 hi + lo split of each weight keeps them."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(2, 14, 130, 5 * 64, generator=g, device=cuda_device)
               for _ in range(3))
    q, k, v = (q * 30).bfloat16(), k.bfloat16(), v.bfloat16()
    out = TT.frame_attention(q, k, v, 5)
    assert torch.isfinite(out.float()).all()
    _close(out, TT.frame_attention_plain(q, k, v, 5))


@pytest.mark.cuda
def test_frame_attention_rejects_inputs_it_does_not_take(cuda_device):
    x = torch.zeros(1, 14, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        TT.frame_attention(x.float(), x.float(), x.float(), 2)
    with pytest.raises(ValueError):  # head_dim 32
        TT.frame_attention(x, x, x, 4)
    with pytest.raises(ValueError):  # not contiguous
        t = x.transpose(1, 2)
        TT.frame_attention(t, t, t, 2)
    big = torch.zeros(1, 17, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # more frames than the kernel holds
        TT.frame_attention(big, big, big, 1)


def _ffn(dev, M, C, c_out=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    inner, c_out = 4 * C, c_out or C

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    return dict(
        x=r(M, C).bfloat16(), ln_w=1 + r(C, scale=0.1), ln_b=r(C, scale=0.1),
        w1=r(2 * inner, C, scale=C ** -0.5).bfloat16(),
        b1=r(2 * inner, scale=0.1).bfloat16(),
        w2=r(c_out, inner, scale=inner ** -0.5).bfloat16(),
        b2=r(c_out, scale=0.1).bfloat16())


# K6's cases: (rows, C). Both splits (C <= 320: row halves of 128-row tiles;
# above: column halves of 64-row tiles), C off 64 (96, 336, 624: the C-tail
# read as zeros), clusters of 2 left half-empty (an odd count of 128-row
# tiles: one at C = 320 and 96, three at C = 64 and 128), and more tiles
# than one wave of 132 SMs (300 and 256)
K6_CASES = [(128, 320), (256, 640), (384, 64), (128, 640), (384, 128), (128, 96),
            (256, 336), (384, 624), (38400, 64), (16384, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,C", K6_CASES)
def test_ln_geglu_ffn_residual_matches_plain_on_card(cuda_device, M, C):
    p = _ffn(cuda_device, M, C)
    args = (p["x"], p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    before = TF.ln_geglu_ffn_residual.launches
    out = TF.ln_geglu_ffn_residual(*args)
    torch.cuda.synchronize()
    assert TF.ln_geglu_ffn_residual.launches == before + 1
    _close(out, TF.ln_geglu_ffn_residual_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("M,C", [(256, 320), (128, 640)])
def test_ln_geglu_ffn_residual_function_launches_k6_once_on_card(cuda_device, M, C):
    """K6's autograd Function: one K6 launch forward, the backward
    recomputed through the unfused formulation; all seven gradients against
    autograd through the plain version."""
    p = _ffn(cuda_device, M, C, seed=5)
    args = (p["x"], p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    dout = torch.randn_like(p["x"])

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in args]
        fn(*leaves).backward(dout)
        return [t.grad for t in leaves]

    before = TF.ln_geglu_ffn_residual.launches
    got = grads(TF.ln_geglu_ffn_residual)
    torch.cuda.synchronize()
    assert TF.ln_geglu_ffn_residual.launches == before + 1
    for a, b in zip(got, grads(TF.ln_geglu_ffn_residual_plain)):
        _close(a, b)


# K5's cases: (rows, C, C_out). Both UNet widths, both splits, C_out above
# and below C (the output staged in more chunks than x; a split by C alone,
# whose second warpgroup stores nothing), C and C_out off 64 (48, 96, 160,
# 336), half-empty clusters and more tiles than one wave of 132 SMs
K5_CASES = [(128, 320, 320), (256, 640, 640), (128, 128, 192), (384, 96, 160),
            (256, 160, 96), (128, 48, 48), (256, 96, 336), (256, 336, 96),
            (128, 640, 320), (38400, 64, 80), (16384, 320, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,c_out", K5_CASES)
def test_geglu_ffn_matches_plain_on_card(cuda_device, M, C, c_out):
    p = _ffn(cuda_device, M, C, c_out)
    args = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
    before = TF.geglu_ffn.launches
    out = TF.geglu_ffn(*args)
    torch.cuda.synchronize()
    assert TF.geglu_ffn.launches == before + 1
    assert out.shape == (M, c_out)
    _close(out, TF.geglu_ffn_plain(*args))


@pytest.mark.cuda
def test_geglu_ffn_c_entry_refuses_another_plan(cuda_device):
    """K5's C entry takes `ffn_plan`'s plan only: the other split, or other
    stage counts, return cudaErrorInvalidValue before any launch."""
    import ctypes

    from wiw_tpu_torch.ops import native

    p = _ffn(cuda_device, 128, 96, 160)
    fn = TF._bind(native.load_library(TF._LIB), residual=False)
    b1, b2 = p["b1"].float(), p["b2"].float()
    out = torch.empty(128, 160, dtype=torch.bfloat16, device=cuda_device)
    plan = TF.ffn_plan(96, 160, residual=False)
    for split, s1, s2 in ((1 - plan.split, plan.w1_stages, plan.w2_stages),
                          (plan.split, plan.w1_stages + 1, plan.w2_stages),
                          (plan.split, plan.w1_stages, plan.w2_stages + 1)):
        err = fn(p["x"].data_ptr(), p["w1"].data_ptr(), b1.data_ptr(),
                 p["w2"].data_ptr(), b2.data_ptr(), out.data_ptr(), 128, 96, 384,
                 160, int(split), s1, s2,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err != 0


@pytest.mark.cuda
def test_ffn_kernels_reject_inputs_they_do_not_take(cuda_device):
    p = _ffn(cuda_device, 256, 320)
    ln = (p["ln_w"], p["ln_b"])
    w = (p["w1"], p["b1"], p["w2"], p["b2"])
    with pytest.raises(TypeError):  # dtype
        TF.ln_geglu_ffn_residual(p["x"].float(), *ln, *w)
    with pytest.raises(ValueError):  # rows not a multiple of 128
        TF.ln_geglu_ffn_residual(p["x"][:200], *ln, *w)
    with pytest.raises(ValueError):  # layout
        TF.geglu_ffn(p["x"], p["w1"].t().contiguous().t(), *w[1:])
    with pytest.raises(ValueError):  # K5: C_out = 100, off the step of 16
        q = _ffn(cuda_device, 128, 96, 100)
        TF.geglu_ffn(q["x"], q["w1"], q["b1"], q["w2"], q["b2"])
    # C > 640; C = 100, off the kernel's step of 16
    for C in (1280, 100):
        p = _ffn(cuda_device, 128, C)
        with pytest.raises(ValueError):
            TF.ln_geglu_ffn_residual(p["x"], p["ln_w"], p["ln_b"], p["w1"],
                                     p["b1"], p["w2"], p["b2"])


@pytest.mark.cuda
@pytest.mark.parametrize("M,C", [(128, 320), (256, 640), (128, 96), (16384, 640)])
def test_bf16_gate_kernel_matches_plain_on_card(cuda_device, M, C):
    p = _ffn(cuda_device, M, C, seed=3)
    args = (p["x"], p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    before = (TF.ln_geglu_ffn_residual.launches,
              TF.ln_geglu_ffn_residual.launches_bf16_gate)
    out = TF.ln_geglu_ffn_residual(*args, gate="bf16")
    torch.cuda.synchronize()
    assert (TF.ln_geglu_ffn_residual.launches,
            TF.ln_geglu_ffn_residual.launches_bf16_gate) == (before[0], before[1] + 1)
    ref = TF.ln_geglu_ffn_residual_plain(*args, gate="bf16")
    _close(out, ref)
    assert not torch.equal(out, TF.ln_geglu_ffn_residual(*args))
    # the gates differ by about an ulp, inside _close: the kernel must sit
    # with its own plain version, not with the fp32 gate's
    same_f32 = (out == TF.ln_geglu_ffn_residual_plain(*args)).float().mean()
    assert (out == ref).float().mean() > same_f32


@pytest.mark.cuda
@pytest.mark.parametrize("unroll2", [False, True])
@pytest.mark.parametrize("BH,S", [(4, 144), (3, 256), (2, 2304), (2, 200)])
def test_v1_kernel_matches_plain_on_card(cuda_device, BH, S, unroll2):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(1, BH, S, 64, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = (TFA.flash_attention_v1.launches,
              TFA.flash_attention_v1.launches_unroll2)
    out = flash_attention(q, k, v, kernel="v1", unroll2=unroll2)
    torch.cuda.synchronize()
    pair = unroll2 and S % 128 == 0
    assert (TFA.flash_attention_v1.launches,
            TFA.flash_attention_v1.launches_unroll2) == (before[0] + (not pair),
                                                         before[1] + pair)
    _close(out, TFA.flash_attention_v1_plain(q, k, v))
    # v1 is K1's arithmetic and unroll2's pair of 64-row blocks is one of
    # K1's 128-row stages: both launch K1's kernel, so the same bits
    assert torch.equal(out, flash_attention(q, k, v))
    assert torch.equal(out, flash_attention(q, k, v, kernel="v1",
                                            unroll2=not unroll2))


@pytest.mark.cuda
def test_v1_kernel_refuses_a_gradient_on_card(cuda_device):
    x = torch.zeros(1, 1, 128, 64, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        flash_attention(x, x, x, kernel="v1")


def _gn_inputs(dev, shape, dtype, seed=0, shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = shape[-1]
    x = (torch.randn(*shape, generator=g, device=dev) * 1.5 + shift).to(dtype)
    w = 1 + 0.2 * torch.randn(C, generator=g, device=dev)
    b = 0.3 * torch.randn(C, generator=g, device=dev)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [
    ((4, 9, 16, 320), 32), ((2, 3, 9, 16, 640), 32), ((3, 300, 2560), 32),
    ((2, 7, 24), 24), ((1, 1000, 96), 32), ((5, 1, 128), 32)])
def test_group_norm_kernel_matches_plain_on_card(cuda_device, shape, groups,
                                                 dtype, silu):
    x, w, b = _gn_inputs(cuda_device, shape, dtype)
    before = TG.group_norm.launches
    out = TG.group_norm(x, w, b, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert TG.group_norm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, TG.group_norm_plain(x, w, b, groups, 1e-6, silu))


@pytest.mark.cuda
def test_group_norm_kernel_rows_are_independent_bit_for_bit(cuda_device):
    good, w, b = _gn_inputs(cuda_device, (1, 4000, 320), torch.bfloat16, 1)
    bad = _gn_inputs(cuda_device, (1, 4000, 320), torch.bfloat16, 2, 1e4)[0]
    alone = TG.group_norm(good, w, b, 32, 1e-5, True)
    batched = TG.group_norm(torch.cat([bad, good, bad]), w, b, 32, 1e-5, True)
    assert torch.equal(batched[1], alone[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((1, 64, 16), 1200.0), ((2, 9216, 320), 1200.0),
                                          ((1, 64, 16), 500.0)])
def test_group_norm_kernel_ill_conditioned_matches_float64(cuda_device, shape, offset):
    """|mean|/std ~ 1e3 in fp32, the CPU test's bounds against float64 (a
    raw sum/sum-of-squares variance is wrong here)."""
    x, _, _ = _gn_inputs(cuda_device, shape, torch.float32, 3)
    x = x / 1.5
    x[..., :shape[-1] // 4] += offset
    C, groups = shape[-1], 4
    ones, zeros = torch.ones(C, device=cuda_device), torch.zeros(C, device=cuda_device)
    out = TG.group_norm(x, ones, zeros, groups, 1e-5)
    g = x.double().reshape(shape[0], -1, groups, C // groups)
    ref = ((g - g.mean(dim=(1, 3), keepdim=True))
           / torch.sqrt(g.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)
           ).reshape(shape)
    atol = 2e-3 if offset > 1000 else 1e-3
    torch.testing.assert_close(out.double(), ref, atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 9253, 320), 32), ((3, 2, 2, 75, 96), 32),
                                          ((1, 300, 64), 8)])
def test_group_norm_kernel_merges_tiles_whose_statistics_differ(cuda_device, shape,
                                                                groups):
    """Rows whose mean and scale change from one 256-row stats tile to the
    next, each row by another ramp, with a partial last tile (L = 9253,
    300, 300), in fp32 against float64: a tile merged with the wrong row
    count or dropped moves the group mean by about a tile's offset step,
    far beyond the bound."""
    x, _, _ = _gn_inputs(cuda_device, shape, torch.float32, 5)
    N, C = shape[0], shape[-1]
    flat = x.reshape(N, -1, C)
    tile = (torch.arange(flat.shape[1], device=cuda_device) // 256).float()[None, :, None]
    n = torch.arange(N, device=cuda_device).float()[:, None, None]
    x = (flat * (1 + tile / 8) + 4 * tile * (n + 1) - 9 * n).reshape(shape)
    ones, zeros = torch.ones(C, device=cuda_device), torch.zeros(C, device=cuda_device)
    out = TG.group_norm(x, ones, zeros, groups, 1e-5)
    g = x.double().reshape(N, -1, groups, C // groups)
    ref = ((g - g.mean(dim=(1, 3), keepdim=True))
           / torch.sqrt(g.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)
           ).reshape(shape)
    torch.testing.assert_close(out.double(), ref, atol=2e-3, rtol=2e-3)


def _plan(dev, x, groups):
    N, C = x.shape[0], x.shape[-1]
    return TG.k8_plan(N, x.numel() // (N * C), C, groups, x.dtype,
                      torch.cuda.get_device_properties(dev).multi_processor_count)


def _gn64(x, groups):
    """x normalised per (row, group) in float64, no affine."""
    g = x.double().reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
    return ((g - g.mean(dim=(1, 3), keepdim=True))
            / torch.sqrt(g.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)
            ).reshape(x.shape)


# K8's paths: R (a cluster holds the slab: portable, and 12 CTAs with the
# non-portable attribute) and S (the grid walks whole rows: a row that the
# L2 holds, and larger ones), at a ragged L, 3-channel groups, fp32
K8_PATHS = [((2, 9253, 320), 32, torch.bfloat16, "R", True),
            ((3, 9253, 96), 32, torch.float32, "R", True),
            ((2, 9253, 960), 32, torch.bfloat16, "R", True),
            ((2, 9253, 960), 32, torch.float32, "S", False),
            ((1, 70001, 96), 32, torch.bfloat16, "S", True),
            ((1, 600000, 32), 8, torch.bfloat16, "S", False),
            ((1, 1000003, 16), 4, torch.bfloat16, "S", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,path,resident", K8_PATHS)
def test_group_norm_kernel_paths_match_plain_on_card(cuda_device, shape, groups,
                                                     dtype, path, resident):
    x, w, b = _gn_inputs(cuda_device, shape, dtype, 6)
    plan = _plan(cuda_device, x, groups)
    assert (plan.path, plan.resident) == (path, resident)
    for silu in (False, True):
        before = TG.group_norm.launches
        out = TG.group_norm(x, w, b, groups, 1e-6, silu)
        torch.cuda.synchronize()
        assert TG.group_norm.launches == before + 1
        _close(out, TG.group_norm_plain(x, w, b, groups, 1e-6, silu))
    # no atomics, every sum in a fixed order: the bits repeat
    assert torch.equal(TG.group_norm(x, w, b, groups, 1e-6, True), out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path", [((1, 4000, 320), "R"), ((1, 70001, 96), "S")])
def test_group_norm_kernel_rows_are_independent_on_both_paths(cuda_device, shape, path):
    good, w, b = _gn_inputs(cuda_device, shape, torch.bfloat16, 1)
    bad = _gn_inputs(cuda_device, shape, torch.bfloat16, 2, 1e4)[0]
    assert _plan(cuda_device, good, 32).path == path
    alone = TG.group_norm(good, w, b, 32, 1e-5, True)
    batched = TG.group_norm(torch.cat([bad, good, bad]), w, b, 32, 1e-5, True)
    assert torch.equal(batched[1], alone[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,path", [((2, 4000, 320), 4, "R"),
                                               ((2, 9216, 320), 4, "R"),
                                               ((2, 40000, 320), 4, "S"),
                                               ((1, 500001, 16), 4, "S")])
def test_group_norm_kernel_ill_conditioned_on_both_paths(cuda_device, shape, groups,
                                                         path):
    """|mean|/std ~ 1200 in fp32 against float64, on path R (clusters of
    14) and path S (half-row slabs, and one slab a row)."""
    x, _, _ = _gn_inputs(cuda_device, shape, torch.float32, 3)
    x = x / 1.5
    x[..., :shape[-1] // 4] += 1200.0
    assert _plan(cuda_device, x, groups).path == path
    C = shape[-1]
    ones, zeros = torch.ones(C, device=cuda_device), torch.zeros(C, device=cuda_device)
    out = TG.group_norm(x, ones, zeros, groups, 1e-5)
    torch.testing.assert_close(out.double(), _gn64(x, groups), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 9253, 960), 32), ((1, 500001, 16), 4)])
def test_group_norm_kernel_path_s_merges_ranges_whose_statistics_differ(
        cuda_device, shape, groups):
    """Path S on rows whose mean and scale change along the positions, each
    row by another ramp, in fp32 against float64: a block's range merged
    with the wrong count or dropped moves the mean."""
    x, _, _ = _gn_inputs(cuda_device, shape, torch.float32, 5)
    N, C = shape[0], shape[-1]
    flat = x.reshape(N, -1, C)
    tile = (torch.arange(flat.shape[1], device=cuda_device) // 256).float()[None, :, None]
    n = torch.arange(N, device=cuda_device).float()[:, None, None]
    x = (flat * (1 + tile / 8) + 4 * tile * (n + 1) - 9 * n).reshape(shape)
    assert _plan(cuda_device, x, groups).path == "S"
    ones, zeros = torch.ones(C, device=cuda_device), torch.zeros(C, device=cuda_device)
    out = TG.group_norm(x, ones, zeros, groups, 1e-5)
    torch.testing.assert_close(out.double(), _gn64(x, groups), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_group_norm_function_gradients_on_card(cuda_device):
    """K8 forward through the autograd Function, backward recomputed through
    the plain version: the same gradients as autograd through the plain
    version (the recomputation is that very graph), the output K8's."""
    x, w, b = _gn_inputs(cuda_device, (2, 3, 8, 8, 64), torch.bfloat16, 4)
    dy = torch.randn(x.shape, device=cuda_device).bfloat16()

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        out = fn(*leaves, 32, 1e-6, True)
        out.backward(dy)
        return out.detach(), [t.grad for t in leaves]

    before = TG.group_norm.launches
    out, got = grads(TG.group_norm)
    assert TG.group_norm.launches == before + 1
    ref_out, ref = grads(TG.group_norm_plain)
    _close(out, ref_out)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_group_norm_kernel_rejects_inputs_it_does_not_take(cuda_device):
    x, w, b = _gn_inputs(cuda_device, (2, 64, 36), torch.bfloat16)
    with pytest.raises(ValueError):  # C not a multiple of 8
        TG.group_norm(x, w, b, 36, 1e-6)
    x, w, b = _gn_inputs(cuda_device, (2, 64, 64), torch.bfloat16)
    with pytest.raises(TypeError):
        TG.group_norm(x.half(), w, b, 32, 1e-6)
    with pytest.raises(ValueError):  # parameters on another device
        TG.group_norm(x, w.cpu(), b.cpu(), 32, 1e-6)
    with pytest.raises(ValueError):  # C not a multiple of the groups
        TG.group_norm(x, w, b, 24, 1e-6)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)  # made contiguous
    _close(TG.group_norm(strided, w, b, 32, 1e-6), TG.group_norm_plain(x, w, b, 32, 1e-6))


@pytest.mark.cuda
def test_copy_plus_one_on_card(cuda_device):
    x = torch.randn(3, 1000, 64, device=cuda_device).bfloat16()
    before = TG.copy_plus_one.launches
    assert torch.equal(TG.copy_plus_one(x), x + 1)
    assert TG.copy_plus_one.launches == before + 1
    with pytest.raises(ValueError):
        TG.copy_plus_one(x.float())


def _rel(a, b) -> float:
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.cuda
def test_training_step_on_card_matches_the_cpu_step(cuda_device):
    """One optimizer step of a tiny UNet whose spatial attentions have
    head_dim 64 (so K1 and K3 carry them on the card): on the card with
    bf16 compute over fp32 parameters and remat, against the same step in
    fp32 on the CPU (the plain versions there), from the same weights (the
    card's bf16-rounded VAE and CLIP for both), batch and draws. bf16
    rounding through ~40 layers moves the gradients by a few percent; a
    wrong K3 (a dropped scale, a missing Delta) moves the attention
    projections' gradients by tens of percent."""
    import dataclasses

    import numpy as np

    from wiw_tpu_torch.models.clip import CLIPVisionConfig
    from wiw_tpu_torch.models.unet import UNetConfig
    from wiw_tpu_torch.models.vae import VAEConfig
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline
    from wiw_tpu_torch.train.trainer import TrainConfig, Trainer

    unet = UNetConfig(block_out_channels=(64, 128), num_attention_heads=(1, 2),
                      layers_per_block=1, cross_attention_dim=32, num_frames=3,
                      action_strategy="micro_cond", action_input_channel=3,
                      param_dtype="float32")
    vae = VAEConfig(block_out_channels=(32, 64), layers_per_block=1)
    clip = CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                            num_heads=2, patch_size=32, projection_dim=32)
    cpu = SVDPipeline(unet, vae, clip, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    card = SVDPipeline(dataclasses.replace(unet, dtype="bfloat16", remat=True),
                       dataclasses.replace(vae, dtype="bfloat16"),
                       dataclasses.replace(clip, dtype="bfloat16"), device=cuda_device)
    card.load_state_dicts(cpu.unet.state_dict(), cpu.vae.state_dict(),
                          cpu.clip.state_dict())
    for tower, cpu_tower in ((card.vae, cpu.vae), (card.clip, cpu.clip)):
        cpu_tower.load_state_dict({k: v.float().cpu() for k, v in
                                   tower.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(
        rng.uniform(-1, 1, (1, 3, 64, 64, 3)).astype(np.float32)),
        "actions": torch.tensor([[2, 1, 3]])}
    trainers = {"cpu": Trainer(cpu, TrainConfig(learning_rate=1e-3)),
                "card": Trainer(card, TrainConfig(learning_rate=1e-3))}
    states = {d: t.init_state() for d, t in trainers.items()}
    draws = trainers["cpu"].sample_draws(batch["pixel_values"].shape, True,
                                         torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in states["cpu"].params.items()}
    fwd, bwd = TFA.flash_attention.launches, TFA.flash_attention_bwd.launches
    loss = {d: float(t.train_step(states[d], batch, draws=[draws])["loss"])
            for d, t in trainers.items()}
    torch.cuda.synchronize()
    n_bwd = TFA.flash_attention_bwd.launches - bwd
    assert n_bwd > 0 and TFA.flash_attention.launches - fwd == 2 * n_bwd  # remat
    assert abs(loss["card"] - loss["cpu"]) <= 2e-2 * abs(loss["cpu"])
    grads = {d: {n: p.grad.float().cpu() for n, p in s.params.items()}
             for d, s in states.items()}
    flat = {d: torch.cat([g.flatten() for g in gs.values()]) for d, gs in grads.items()}
    assert _rel(flat["card"], flat["cpu"]) <= 5e-2
    attn = [n for n in grads["cpu"] if ".attn1.to_" in n and n.endswith("weight")
            and "temporal" not in n]
    assert attn
    for n in attn:
        assert _rel(grads["card"][n], grads["cpu"][n]) <= 1e-1, n
    for d, s in states.items():
        assert not torch.equal(s.params["conv_in.weight"].detach().cpu(),
                               before["conv_in.weight"])


# ------------------------------------------------- K7 (W8A8), K9, K10
# K7 repeats its plain version's arithmetic exactly (the same IEEE
# division and round-half-to-even for the codes, exact int32 sums, the same
# fp32 epilogue operations in the same order), so its output bits equal the
# plain version's. K9 and K10 round where their plain versions do but sum
# in another order: the tolerance above (`_close`), the plain versions at
# the kernels' kv block width (64).


def _k7_dense_args(dev, M, K, N, x_dtype, bias):
    from wiw_tpu_torch.ops import quant as TQ

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = (torch.randn(M, K, generator=g, device=dev) * 2).to(x_dtype)
    x[3] = 0.0  # a zero row: the 1e-8 floor of the scale
    w8, ws = TQ.quantize_kernel(torch.randn(N, K, generator=g, device=dev) * 0.1)
    b = torch.randn(N, generator=g, device=dev) if bias else None
    return x, w8, ws, b


@pytest.mark.cuda
# every tile width (BN 128; 160 at N 320), a ragged last N tile (N 72), M
# not a multiple of the 128-row tile, K not a multiple of the 64-byte chunk
# (K 80), and more tiles than 132 SMs x 6 stages (M 40000, N 2560: 6260
# tiles, the persistent walk)
@pytest.mark.parametrize("M,K,N", [(1000, 320, 2560), (77, 64, 72), (4032, 1280, 1280),
                                   (300, 320, 320), (129, 80, 640),
                                   (40000, 320, 2560)])
@pytest.mark.parametrize("x_dtype,out_dtype,bias", [
    (torch.bfloat16, torch.bfloat16, True), (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float32, True)])
def test_w8a8_dense_kernel_equals_plain_on_card(cuda_device, M, K, N, x_dtype,
                                                out_dtype, bias):
    from wiw_tpu_torch.ops import quant as TQ

    x, w8, ws, b = _k7_dense_args(cuda_device, M, K, N, x_dtype, bias)
    before = TQ.w8a8_dense.launches
    out = TQ.w8a8_dense(x.view(1, M, K), w8, ws, b, out_dtype)
    torch.cuda.synchronize()
    assert TQ.w8a8_dense.launches == before + 1
    assert out.shape == (1, M, N) and out.dtype == out_dtype
    assert torch.equal(out[0], TQ.w8a8_dense_plain(x, w8, ws, b, out_dtype))


# both A producers (TMA boxes at stride 1 with C % 64 == 0, the cp.async
# gather at stride 2 or other C), every tile width (BN 128, 160, 256; 256
# with an fp32 output has its own 4-stage layout), output rectangles that
# straddle H (18 x 32: 4-row tiles; 9 x 16: 8-row tiles) or W (W 24, 15,
# 10), a VAE-like C 128 at W 512 with fp32 in and out, an all-zero x (the
# 1e-8 floor of the one scale; `amp` 0), and more tiles than 132 SMs x 6
# stages (8 x 72 x 128 at N 320: 1152 tiles)
@pytest.mark.cuda
@pytest.mark.parametrize("shape,O,k,stride,pad,out_dtype,amp", [
    ((3, 20, 24, 64), 72, 3, 1, 1, torch.bfloat16, 1.5),
    ((2, 17, 15, 32), 64, 3, 2, 1, torch.bfloat16, 1.5),
    ((2, 9, 10, 48), 40, 1, 1, 0, torch.bfloat16, 1.5),
    ((1, 72, 128, 320), 320, 3, 1, 1, torch.bfloat16, 1.5),
    ((2, 18, 32, 640), 640, 3, 1, 1, torch.bfloat16, 1.5),
    ((2, 9, 16, 1280), 1280, 3, 1, 1, torch.bfloat16, 1.5),
    ((2, 17, 15, 320), 320, 3, 2, 1, torch.bfloat16, 1.5),
    ((1, 9, 11, 48), 64, 3, 1, 1, torch.bfloat16, 1.5),
    ((1, 8, 512, 128), 128, 3, 1, 1, torch.float32, 1.5),
    ((1, 8, 256, 256), 512, 3, 1, 1, torch.float32, 1.5),
    ((2, 17, 15, 64), 256, 3, 2, 1, torch.bfloat16, 1.5),
    ((2, 9, 16, 64), 64, 3, 1, 1, torch.bfloat16, 0.0),
    ((8, 72, 128, 320), 320, 3, 1, 1, torch.bfloat16, 1.5)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_conv_kernel_equals_plain_on_card(cuda_device, shape, O, k, stride,
                                               pad, out_dtype, amp, x_dtype):
    from wiw_tpu_torch.ops import quant as TQ

    g = torch.Generator(device=cuda_device).manual_seed(O)
    x = (torch.randn(*shape, generator=g, device=cuda_device) * amp).to(x_dtype)
    w8, ws = TQ.quantize_kernel(torch.randn(O, k, k, shape[-1], generator=g,
                                            device=cuda_device) * 0.05)
    b = torch.randn(O, generator=g, device=cuda_device)
    before = TQ.w8a8_conv.launches
    out = TQ.w8a8_conv(x, w8, ws, b, stride=stride, padding=pad, dtype=out_dtype)
    torch.cuda.synchronize()
    assert TQ.w8a8_conv.launches == before + 1
    ref = TQ.w8a8_conv_plain(x, w8, ws, b, stride=stride, padding=pad,
                             dtype=out_dtype)
    assert out.shape == ref.shape and out.dtype == out_dtype
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_w8a8_kernels_reject_inputs_they_do_not_take(cuda_device):
    from wiw_tpu_torch.ops import quant as TQ

    x, w8, ws, b = _k7_dense_args(cuda_device, 64, 64, 64, torch.bfloat16, True)
    with pytest.raises(ValueError):  # K not a multiple of 16
        TQ.w8a8_dense(x[:, :40], w8[:, :40].contiguous(), ws, b)
    with pytest.raises(TypeError):  # a float weight
        TQ.w8a8_dense(x, w8.float(), ws, b)
    with pytest.raises(ValueError):  # a bf16 bias
        TQ.w8a8_dense(x, w8, ws, b.bfloat16())
    xc = torch.randn(1, 8, 8, 24, device=cuda_device)
    w8c, wsc = TQ.quantize_kernel(torch.randn(16, 3, 3, 24, device=cuda_device))
    with pytest.raises(ValueError):  # C not a multiple of 16
        TQ.w8a8_conv(xc, w8c, wsc, padding=1)
    xc = torch.randn(1, 8, 8, 32, device=cuda_device)
    w8c, wsc = TQ.quantize_kernel(torch.randn(16, 3, 3, 32, device=cuda_device))
    with pytest.raises(ValueError):  # not contiguous NHWC
        TQ.w8a8_conv(xc.transpose(1, 2), w8c, wsc, padding=1)


@pytest.mark.cuda
def test_int8_unet_layers_take_k7_on_card(cuda_device):
    """A quantised Linear and Conv2d of the model route through K7 on the
    card, with the module's compute dtype as output dtype."""
    from wiw_tpu_torch.models.layers import Conv2d, Linear
    from wiw_tpu_torch.ops import quant as TQ

    lin = Linear(64, 128).to(cuda_device)
    conv = Conv2d(32, 48, 3, padding=1).to(cuda_device)
    for m in (lin, conv):
        TQ.quantize_module_(m, torch.bfloat16)
    d, c = TQ.w8a8_dense.launches, TQ.w8a8_conv.launches
    y = lin(torch.randn(2, 5, 64, device=cuda_device, dtype=torch.bfloat16))
    z = conv(torch.randn(2, 6, 7, 32, device=cuda_device, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert (TQ.w8a8_dense.launches, TQ.w8a8_conv.launches) == (d + 1, c + 1)
    assert y.dtype == z.dtype == torch.bfloat16 and z.shape == (2, 6, 7, 48)


def _bhsd(dev, B, H, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, H * 64, generator=g, device=dev).to(torch.bfloat16)
            .view(B, S, H, 64).transpose(1, 2) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["floor", "noexp", "v2"])
@pytest.mark.parametrize("B,H,S", [(1, 3, 256), (2, 2, 1024)])
def test_ablation_kernels_match_plain_on_card(cuda_device, variant, B, H, S):
    fn = getattr(TFA, f"attention_{variant}")
    plain = getattr(TFA, f"attention_{variant}_plain")
    q, k, v = _bhsd(cuda_device, B, H, S, S + B)
    before = fn.launches
    out = fn(q, k, v)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if variant == "noexp":
        # out = acc / (d + 1) has a pole where a row's denominator nears -1;
        # there the two sides' ~1e-6 difference in S is amplified without
        # bound: the rows with |d + 1| >= 1 are held to the tolerance, the
        # others must be finite. The reference sums in float64 (near the
        # pole fp32 sums are off by up to ~1% on either side)
        ref, d1 = plain(q, k, v, bkv=TFA.KV_TILE, with_denominator=True,
                        dtype=torch.float64)
        well = (d1.abs() >= 1).expand_as(ref)
        assert bool(torch.isfinite(out).all()) and well.float().mean() > 0.99
        _close(out[well], ref[well])
    else:
        # all three run K1's kernel and its 128-row kv stages (KV_TILE)
        _close(out, plain(q, k, v, bkv=TFA.KV_TILE))


@pytest.mark.cuda
def test_ablation_v2_is_k1_code_on_card(cuda_device):
    """K9 v2 is K1's kernel on the pre-scaled q with a unit scale: the same
    bits."""
    q, k, v = _bhsd(cuda_device, 1, 2, 576, 3)
    out = TFA.attention_v2(q, k, v)
    ref = TFA._launch_fwd(TFA.prescale_q(q), k, v, False, sm_scale=1.0)[0]
    assert torch.equal(out, ref)
    # floor and noexp take Skv a multiple of K1's kv stage (128) only: the
    # wrapper refuses 100 and 192, and so does the C entry
    for n in (100, 192):
        for fn in (TFA.attention_noexp, TFA.attention_floor):
            with pytest.raises(ValueError):
                fn(q[:, :, :n], k[:, :, :n], v[:, :, :n])
    for mode in (TFA._FLOOR, TFA._NOEXP):
        with pytest.raises(RuntimeError):
            TFA._launch_fwd(q, k[:, :, :192], v[:, :, :192], False, mode=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("i8pv", [False, True])
@pytest.mark.parametrize("BH,S", [(2, 256), (3, 1024), (1, 9216)])
def test_int8_qk_attention_kernel_matches_plain_on_card(cuda_device, i8pv, BH, S):
    from wiw_tpu_torch.ops import int8_attention as TI

    g = torch.Generator(device=cuda_device).manual_seed(BH * S)

    def i8(*shape):
        return (torch.randn(*shape, generator=g, device=cuda_device) * 40).round(
        ).clamp(-127, 127).to(torch.int8)

    q8, k8 = i8(BH, S, 64), i8(BH, S, 64)
    v = i8(BH, S, 65) if i8pv else torch.randn(
        BH, S, 65, generator=g, device=cuda_device).bfloat16()
    v[..., 64] = 1
    attr = "launches_i8pv" if i8pv else "launches"
    before = getattr(TI.int8_qk_attention, attr)
    out = TI.int8_qk_attention(q8, k8, v, 1e-3, i8pv)
    torch.cuda.synchronize()
    assert getattr(TI.int8_qk_attention, attr) == before + 1
    assert out.shape == (BH, S, 65) and out.dtype == torch.bfloat16
    # the plain version at the kernel's 128-row kv block (TI.KV_TILE)
    _close(out, TI.int8_qk_attention_plain(q8, k8, v, 1e-3, i8pv))
    with pytest.raises(ValueError):  # v of the other PV type
        TI.int8_qk_attention(q8, k8, v, 1e-3, not i8pv)
    with pytest.raises(ValueError, match="multiple"):  # S off the 128-row stage
        TI.int8_qk_attention(*(t[:, :192].contiguous() for t in (q8, k8, v)),
                             1e-3, i8pv)
    packed = TI.repack_v(v, i8pv)
    with pytest.raises(ValueError):  # v not as repack_v lays it out
        TI.int8_qk_attention_packed(q8, k8, packed[1], packed[0], 1e-3, i8pv)
    assert torch.equal(TI.int8_qk_attention_packed(q8, k8, *packed, 1e-3, i8pv), out)


@pytest.mark.cuda
def test_collect_pano_on_card_matches_cpu(cuda_device):
    """`collect_cli.HabitatNavEnv`'s pano at the CLI's size (512^2 faces to
    1000x2000) under the habitat-sim double: the card's equals the CPU's
    within one uint8 step (the grid is the same, built on the CPU; the
    weights' arithmetic may round apart), and comes home as uint8."""
    import numpy as np

    import habitat_sim_double
    from wiw_tpu_torch.data.collect_cli import HabitatNavEnv

    with habitat_sim_double.installed():
        envs = [HabitatNavEnv("roomA.glb", 1000, 2000, device=d) for d in ("cuda", "cpu")]
        for env in envs:
            env.reset_to(np.array([0.3, 0.0, -0.4], np.float32))
            env.step("turn_left")
        card, cpu = (env.observe()["rgb"] for env in envs)
    assert card.shape == (1000, 2000, 3) and card.dtype == np.uint8
    d = np.abs(card.astype(np.int16) - cpu.astype(np.int16))
    assert d.max() <= 1, int(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adamw_bf16m", "adafactor"])
def test_optimizer_step_on_card_matches_cpu(cuda_device, optimizer):
    """One step of each of the trainer's optimizers (the card's AdamW fused)
    on leaves of the UNet's kinds (1-D, a dense weight, 3x3 convs with
    Cin = Cout and not, a temporal conv), card against CPU at lr 1e-3:
    chip_smoke.py's bounds, parameters within 1e-6 and adamw_bf16m's bf16
    first moment within one bf16 step (2^-7 of its value)."""
    from wiw_tpu_torch.train.trainer import TrainConfig, build_optimizer

    g = torch.Generator().manual_seed(0)
    leaves = {"blk.norm1.weight": (320,), "blk.attn1.to_q.weight": (320, 320),
              "blk.conv1.weight": (640, 640, 3, 3), "blk.conv2.weight": (640, 320, 3, 3),
              "blk.temporal_res_block.conv1.weight": (320, 320, 3, 1, 1)}
    start = {n: torch.randn(s, generator=g) * 0.05 for n, s in leaves.items()}
    grads = {n: torch.randn(s, generator=g) * 1e-3 for n, s in leaves.items()}
    cfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-2, optimizer=optimizer)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        named = [(n, v.to(dev, copy=True).requires_grad_(True)) for n, v in start.items()]
        for n, p in named:
            p.grad = grads[n].to(dev)
        opt = build_optimizer(cfg, named, fused=dev.type == "cuda")
        opt.step()
        runs.append((named, opt))
    for (n, pc), (_, pu) in zip(runs[0][0], runs[1][0]):
        assert float((pu.detach() - start[n]).abs().max()) > 1e-4, n  # it moved
        assert float((pc.detach().cpu() - pu.detach()).abs().max()) <= 1e-6, n
        if optimizer == "adamw_bf16m":
            mc, mu = (r[1].state[p]["mu"] for r, p in zip(runs, (pc, pu)))
            assert mc.dtype == mu.dtype == torch.bfloat16
            rel = (mc.float().cpu() - mu.float()).abs() / mu.float().abs().clamp_min(1e-30)
            assert float(rel.max()) <= 2.0 ** -7, n


# ------------------------------------------------- shard_clip's split entries
def _row_shards(H: int, n: int):
    from wiw_tpu_torch.parallel.clip_sharding import split_rows

    return [r for r in split_rows(H, n) if len(r)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,silu", [
    ((6, 18, 32, 320), 32, torch.bfloat16, True),
    ((2, 14, 9, 16, 1280), 32, torch.bfloat16, True),
    ((4, 5, 24, 64), 32, torch.float32, False)])
@pytest.mark.parametrize("n", [2, 4])
def test_split_group_norm_entries_match_plain_on_card(cuda_device, shape, groups, dtype,
                                                      silu, n):
    """K8's statistics entry on each row shard (the height, axis -3),
    combined by Chan's rule, then the apply entry on each shard: against
    the plain version and the one-launch K8 on the whole x; each entry
    launches once a shard."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    C = shape[-1]
    w = torch.randn(C, generator=g, device=cuda_device)
    b = torch.randn(C, generator=g, device=cuda_device)
    shards = [x.narrow(-3, r.start, len(r)) for r in _row_shards(shape[-3], n)]
    s0, a0 = TG.group_norm_stats.launches, TG.group_norm_apply.launches
    stats = torch.stack([TG.group_norm_stats(s, groups) for s in shards])
    mean, rstd = TG.combine_stats(stats, 1e-5)
    out = torch.cat([TG.group_norm_apply(s, mean, rstd, w, b, silu) for s in shards], dim=-3)
    torch.cuda.synchronize()
    assert TG.group_norm_stats.launches == s0 + len(shards)
    assert TG.group_norm_apply.launches == a0 + len(shards)
    _close(out, TG.group_norm_plain(x, w, b, groups, 1e-5, silu))
    _close(out, TG.group_norm(x, w, b, groups, 1e-5, silu))
    plain = TG.group_norm_stats_plain(x, groups)
    whole = TG.combine_stats(stats, 0.0)
    torch.testing.assert_close(whole[0], plain[..., 1].float(), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [2, 4])
def test_given_amax_conv_on_halo_rows_equals_the_whole_conv(cuda_device, x_dtype, n):
    """K7's amax entry on each row shard, their max given to K7-conv on
    each shard's halo'd rows (a zero column each side, padding 0): the
    codes and outputs equal the rows of the one-launch conv, bit for bit."""
    from wiw_tpu_torch.ops import quant as TQ

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 18, 32, 320, generator=g, device=cuda_device).to(x_dtype)
    w8 = torch.randint(-127, 128, (320, 3, 3, 320), generator=g, device=cuda_device,
                       dtype=torch.int8)
    ws = torch.rand(320, generator=g, device=cuda_device) * 1e-3
    bias = torch.randn(320, generator=g, device=cuda_device)
    whole = TQ.w8a8_conv(x, w8, ws, bias, padding=1)
    shards = _row_shards(18, n)
    a0, c0 = TQ.conv_amax.launches, TQ.w8a8_conv.launches_given
    amax = torch.stack([TQ.conv_amax(x[:, r.start:r.stop]) for r in shards]).amax(0)
    assert torch.equal(amax, TQ.conv_amax_plain(x))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.cat([TQ.w8a8_conv(xp[:, r.start:r.stop + 2].contiguous(), w8, ws, bias,
                                  padding=0, amax=amax) for r in shards], dim=1)
    torch.cuda.synchronize()
    assert TQ.conv_amax.launches == a0 + len(shards)
    assert TQ.w8a8_conv.launches_given == c0 + len(shards)
    assert torch.equal(out, whole)


# K8-stats against its plain version: the counts equal, each mean within
# STATS_RTOL of its group's standard deviation and each M2 within STATS_RTOL
# of it (chip_smoke.py's STATS_RTOL: both sides sum fp32 values in another
# order, ~1e-7 apart)
STATS_RTOL = 1e-5


def _stats_close(st, ref):
    assert torch.equal(st[..., 0], ref[..., 0])
    std = (ref[..., 2] / ref[..., 0]).sqrt()
    assert bool(((st[..., 1] - ref[..., 1]).abs() <= STATS_RTOL * std).all())
    assert bool(((st[..., 2] - ref[..., 2]).abs() <= STATS_RTOL * ref[..., 2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    # chip_smoke's SPLIT_GN_SHAPES, the largest shard of each at fsdp 4
    ((28, 18, 128, 320), torch.bfloat16),        # level 0, C/G 10
    ((2, 14, 18, 128, 320), torch.bfloat16),     # the temporal rows of level 0
    ((28, 3, 16, 1280), torch.bfloat16),         # level 3, C/G 40
    ((6, 9, 32, 640), torch.float32),            # fp32, C/G 20
    ((5, 7, 13, 640), torch.bfloat16),           # C/G 20, L 91: the last tile ragged
    ((3, 5, 7, 2560), torch.float32)])           # a position wider than the block
def test_stats_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.3).to(dtype)
    N, C = shape[0], shape[-1]
    L = x.numel() // (N * C)
    plan = TG.stats_plan(N, L, C, 32, dtype,
                         torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    if shape == (5, 7, 13, 640):
        assert plan.tiles > 1 and L % plan.tile != 0
    before = TG.group_norm_stats.launches
    st = TG.group_norm_stats(x, 32)
    torch.cuda.synchronize()
    assert TG.group_norm_stats.launches == before + 1
    assert st.shape == (N, 32, 3) and st.dtype == torch.float64
    _stats_close(st, TG.group_norm_stats_plain(x, 32))


@pytest.mark.cuda
def test_stats_kernel_is_deterministic_across_calls_and_streams(cuda_device):
    """Two calls give the same bits, also two launched at once on two
    streams (each call has its own arrival counters)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(2, 14, 18, 128, 320, generator=g, device=cuda_device).to(torch.bfloat16)
    a = TG.group_norm_stats(x, 32)
    b = TG.group_norm_stats(x, 32)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    out = []
    for s in streams:
        with torch.cuda.stream(s):
            out.append(TG.group_norm_stats(x, 32))
    torch.cuda.synchronize()
    for t in [b] + out:
        assert torch.equal(a, t)


@pytest.mark.cuda
def test_combine_entry_matches_cpu_combine_stats(cuda_device):
    """K8's combine entry on the card against `combine_stats` on the CPU,
    over the parts of four row shards of which one holds no rows."""
    rng = torch.Generator().manual_seed(5)
    x = torch.randn(3, 11, 8, 320, generator=rng) * 3 + 0.7
    parts = [x[:, :4], x[:, 4:4], x[:, 4:8], x[:, 8:]]
    every = torch.stack([TG.group_norm_stats_plain(p, 32) for p in parts])
    before = TG.combine_stats.launches
    mean, rstd = TG.combine_stats(every.to(cuda_device), 1e-5)
    torch.cuda.synchronize()
    assert TG.combine_stats.launches == before + 1
    want_mean, want_rstd = TG.combine_stats(every, 1e-5)
    torch.testing.assert_close(mean.cpu(), want_mean, rtol=2.0 ** -22, atol=1e-7)
    torch.testing.assert_close(rstd.cpu(), want_rstd, rtol=2.0 ** -22, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["last", "negative", "zeros", "fp32", "ragged", "decoder"])
def test_amax_kernel_equals_plain_bit_for_bit(cuda_device, case):
    """K7-amax against `conv_amax_plain`, bit for bit: the max in the last
    vector, a negative extreme, all zeros, fp32, a size that is not a
    multiple of a block's work (the grid's 4 loads of 16 bytes a thread),
    and a decoder-sized tensor (the frame-parallel decode's int8 convs)."""
    from wiw_tpu_torch.ops import quant as TQ

    g = torch.Generator(device=cuda_device).manual_seed(6)
    shape = {"decoder": (4, 288, 512, 512), "ragged": (1081357, 8),
             "fp32": (3, 17, 40, 64)}.get(case, (28, 18, 128, 320))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    if case == "zeros":
        x.zero_()
    elif case == "negative":
        x.view(-1)[x.numel() // 3] = -97.5
    else:
        x.view(-1)[-1] = 55.25 if case != "fp32" else -55.125
    before = TQ.conv_amax.launches
    out = TQ.conv_amax(x)
    torch.cuda.synchronize()
    assert TQ.conv_amax.launches == before + 1
    assert out.shape == (1,) and out.dtype == torch.float32
    assert torch.equal(out, TQ.conv_amax_plain(x))
