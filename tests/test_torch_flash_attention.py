"""Kernels K1 (flash-attention forward) and K2 (the reference's v1 forward):
plain versions against the reference.

On the CPU the port's wrapper computes `flash_attention_plain`; it is held
against the reference's Pallas v2 kernel run in interpret mode (as
tests/test_pallas_attention.py runs it) and, for ragged S the Pallas kernel
does not tile, against the reference's plain XLA form. Tolerance 2e-5: all
fp32, only the summation order differs (the reference's own kernel tests
use the same bound).

K2's plain version (`flash_attention_v1_plain`, reached through
`flash_attention(kernel="v1")`) is held against the reference's v1 kernels
(`_attn_kernel`, and `_attn_kernel_unroll2` with `unroll2`) in interpret
mode: fp32 at 2e-5, and in bf16, where both round P to bf16 before the PV
product but against another running max, within 1e-2 on outputs of
magnitude up to ~2 (one bf16 ulp).

On the card K2's unroll2 launches K1's kernel, whose 128-row kv stage is
the reference unroll2's pair of 64-row blocks under one running max. That
rests on the reference's own equivalence, held here in interpret mode:
`_attn_kernel_unroll2` at bkv 64 equals `_attn_kernel` at bkv 128 up to the
order of its fp32 sums (2e-5 in fp32; in bf16 both round the same P to
bf16, against the same max, so within one bf16 ulp of the output, 1e-2).

The kernels themselves only run on the card: tests/test_torch_cuda.py holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

from wiw_tpu.ops.attention import _xla_attention
from wiw_tpu.ops.pallas_attention import flash_attention_bhsd
from wiw_tpu_torch.ops import attention as TAtt
from wiw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_v1,
    flash_attention_v1_plain,
)

torch.set_num_threads(1)


def _qkv(B, H, S, D, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Skv or S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Skv or S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,S,D,bq,bkv", [
    (1, 2, 128, 64, 128, 128),
    (2, 2, 256, 64, 128, 128),
    (1, 3, 384, 64, 128, 384),
    (2, 2, 256, 16, 128, 128),
])
def test_plain_matches_pallas_v2_interpret(B, H, S, D, bq, bkv):
    q, k, v = _qkv(B, H, S, D)
    ref = np.asarray(flash_attention_bhsd(q, k, v, bq=bq, bkv=bkv,
                                          interpret=True, kernel="v2"))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,Skv,D", [(144, 144, 64), (200, 200, 16),
                                     (100, 37, 64)])
def test_plain_ragged_matches_reference_plain(S, Skv, D):
    q, k, v = _qkv(2, 3, S, D, seed=1, Skv=Skv)
    ref = np.asarray(_xla_attention(q, k, v, D ** -0.5))
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_attention_bsd_head_views_match_reference():
    from wiw_tpu.ops.attention import attention_bsd as jax_attention_bsd

    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 144, 3 * 64)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax_attention_bsd(q, k, v, 3, use_pallas=False))
    out = TAtt.attention_bsd(*(torch.from_numpy(a) for a in (q, k, v)), 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_wrapper_counts_no_cpu_launch_and_refuses_other_devices():
    q = torch.zeros(1, 1, 16, 64)
    before = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.launches == before  # the plain path launches nothing
    m = torch.zeros(1, 1, 16, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(m, m, m)


@pytest.mark.parametrize("unroll2", [False, True])
@pytest.mark.parametrize("B,H,S,D,bq,bkv", [
    (1, 2, 256, 64, 128, 64),   # unroll2 takes two 64-row kv blocks a step
    (2, 1, 192, 16, 64, 64),    # 192 % 128 != 0: unroll2 falls to one block
])
def test_v1_plain_matches_pallas_v1_interpret(B, H, S, D, bq, bkv, unroll2):
    q, k, v = _qkv(B, H, S, D, seed=3)
    ref = np.asarray(flash_attention_bhsd(q, k, v, bq=bq, bkv=bkv, interpret=True,
                                          kernel="v1", unroll2=unroll2))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          kernel="v1", unroll2=unroll2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("unroll2", [False, True])
def test_v1_plain_matches_pallas_v1_interpret_bf16(unroll2):
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 64, seed=4)
    ref = np.asarray(flash_attention_bhsd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), bq=128, bkv=64,
        interpret=True, kernel="v1", unroll2=unroll2), np.float32)
    out = flash_attention_v1_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("B,H,S", [(1, 2, 256), (1, 3, 512)])
def test_reference_unroll2_at_64_is_v1_at_128(B, H, S):
    q, k, v = _qkv(B, H, S, 64, seed=6)
    pair = np.asarray(flash_attention_bhsd(q, k, v, bq=128, bkv=64, interpret=True,
                                           kernel="v1", unroll2=True))
    stage = np.asarray(flash_attention_bhsd(q, k, v, bq=128, bkv=128,
                                            interpret=True, kernel="v1"))
    np.testing.assert_allclose(pair, stage, atol=2e-5, rtol=2e-5)


def test_reference_unroll2_at_64_is_v1_at_128_bf16():
    import jax.numpy as jnp

    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, 2, 256, 64, seed=7))
    pair = np.asarray(flash_attention_bhsd(q, k, v, bq=128, bkv=64, interpret=True,
                                           kernel="v1", unroll2=True), np.float32)
    stage = np.asarray(flash_attention_bhsd(q, k, v, bq=128, bkv=128,
                                            interpret=True, kernel="v1"), np.float32)
    np.testing.assert_allclose(pair, stage, atol=1e-2, rtol=0)


def test_kernel_choice_follows_the_reference():
    q = torch.from_numpy(_qkv(1, 1, 32, 64, seed=5)[0])
    with pytest.raises(ValueError, match="unroll2"):
        flash_attention(q, q, q, kernel="v2", unroll2=True)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kernel="v3")
    before = flash_attention_v1.launches, flash_attention_v1.launches_unroll2
    torch.testing.assert_close(flash_attention(q, q, q, kernel="v1", unroll2=True),
                               flash_attention_plain(q, q, q), atol=2e-6, rtol=2e-6)
    assert (flash_attention_v1.launches,
            flash_attention_v1.launches_unroll2) == before  # plain on the CPU
    m = torch.zeros(1, 1, 16, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(m, m, m, kernel="v1")


def test_build_target_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a digest of its source, every shared
    header of csrc/ (K1 and K3 include sm90.cuh) and the flags: an edit to
    a header names another library, so a stale one is never reused. No
    nvcc is run."""
    from wiw_tpu_torch.ops import native

    monkeypatch.setattr(native, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "sm90.cuh"\n')
    (tmp_path / "sm90.cuh").write_text("// v1\n")
    first = native._target("k")
    assert native._target("k") == first and first.name.startswith("k-")
    (tmp_path / "sm90.cuh").write_text("// v2\n")
    second = native._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("\n")
    assert native._target("k") != second
    (tmp_path / "k.cu").write_text('#include "sm90.cuh"\n// edited\n')
    assert native._target("k") not in (first, second)


def test_plain_d72_matches_reference_at_the_cdit_shapes():
    """K1's plain version at head_dim 72 (the CDiT's heads, 1152 / 16), on
    head views of [B, S, H*72] projections: the cross-attention's Sq 196
    against Skv 785 (4 x 196 context tokens + bias_kv), neither a multiple
    of the kernel's tiles, and the self-attention's 196, against the
    reference's `attention_bsd` (its XLA form on the CPU). fp32, 2e-5."""
    from wiw_tpu.ops.attention import attention_bsd as jax_attention_bsd

    rng = np.random.default_rng(8)
    for Skv in (785, 196):
        q = rng.standard_normal((2, 196, 16 * 72)).astype(np.float32)
        k, v = (rng.standard_normal((2, Skv, 16 * 72)).astype(np.float32)
                for _ in range(2))
        ref = np.asarray(jax_attention_bsd(q, k, v, 16, use_pallas=False))
        before = flash_attention.launches, flash_attention.launches_d72
        out = TAtt.attention_bsd(*(torch.from_numpy(a) for a in (q, k, v)), 16)
        assert (flash_attention.launches, flash_attention.launches_d72) == before
        assert out.shape == (2, 196, 16 * 72)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_plain_d72_matches_pallas_v2_interpret():
    """The reference's own kernel takes D from the shape: at D = 72 (S 256,
    Skv 384, its tiles of 128) in interpret mode against the plain version,
    fp32, 2e-5."""
    q = _qkv(1, 2, 256, 72, seed=9)[0]
    _, k, v = _qkv(1, 2, 384, 72, seed=10)
    ref = np.asarray(flash_attention_bhsd(q, k, v, bq=128, bkv=128,
                                          interpret=True, kernel="v2"))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
