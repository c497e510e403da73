"""Kernel K3 (flash-attention backward) and K1's LSE: plain versions and the
autograd Function against the reference, on the CPU.

The reference trains spatial attention through its custom VJP, whose
backward is the stock Pallas TPU flash-attention kernel; that kernel cannot
run on the CPU, and the reference says (wiw_tpu/ops/attention.py,
`_custom_flash_fn`) that its gradient is the exact-attention gradient. So
the oracle is `jax.vjp` of the reference's XLA form `_xla_attention`, in
fp32. Tolerance: relative Frobenius error 1e-5 (all fp32; only the
summation order differs). The kernels themselves run on the card only:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiw_tpu.ops.attention import _xla_attention
from wiw_tpu_torch.ops import attention as TAtt
from wiw_tpu_torch.ops import flash_attention as TFA

torch.set_num_threads(1)

REL = 1e-5


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def _inputs(B, H, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for S in (Sq, Skv, Skv))
    dout = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, dout


def _reference(q, k, v, dout):
    D = q.shape[-1]
    out, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, D ** -0.5),
                       q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


SHAPES = [(2, 2, 64, 64, 64), (1, 3, 72, 72, 64), (2, 1, 144, 144, 64),
          (1, 2, 72, 40, 16)]


@pytest.mark.parametrize("B,H,Sq,Skv,D", SHAPES)
def test_plain_backward_and_lse_match_reference(B, H, Sq, Skv, D):
    q, k, v, dout = _inputs(B, H, Sq, Skv, D, seed=Sq + D)
    out, grads = _reference(q, k, v, dout)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    lse = TFA.flash_attention_lse_plain(tq, tk)
    ref_lse = jax.nn.logsumexp(
        jnp.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5, axis=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert _rel(lse.numpy(), ref_lse) < REL
    tout = TFA.flash_attention_plain(tq, tk, tv)
    assert _rel(tout.numpy(), out) < REL
    for got, ref in zip(TFA.flash_attention_bwd_plain(tq, tk, tv, tout, lse, tdo),
                        grads):
        assert got.shape == ref.shape
        assert _rel(got.numpy(), ref) < REL


@pytest.mark.parametrize("B,H,Sq,Skv,D", SHAPES[:3])
def test_autograd_function_matches_reference(B, H, Sq, Skv, D):
    q, k, v, dout = _inputs(B, H, Sq, Skv, D, seed=7 + Sq)
    out, grads = _reference(q, k, v, dout)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = TFA.flash_attention_bwd.launches
    tout = TFA.flash_attention(tq, tk, tv)
    assert tout.grad_fn is not None
    tout.backward(torch.from_numpy(dout))
    assert TFA.flash_attention_bwd.launches == before  # plain on the CPU
    assert _rel(tout.detach().numpy(), out) < REL
    for t, ref in zip((tq, tk, tv), grads):
        assert _rel(t.grad.numpy(), ref) < REL


def test_head_views_train_through_attention_bsd():
    """The UNet's layout: head views of [B, S, H*D] projections; gradients
    come back in the projections' layout."""
    from wiw_tpu.ops.attention import attention_bsd as jax_attention_bsd

    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((2, 72, 2 * 64)).astype(np.float32)
                  for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_bsd(a, b, c, 2,
                                                       use_pallas=False), q, k, v)
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    TAtt.attention_bsd(tq, tk, tv, 2).backward(torch.from_numpy(g))
    for t, r in zip((tq, tk, tv), ref):
        assert _rel(t.grad.numpy(), r) < REL


def test_no_grad_serving_saves_nothing():
    q = torch.randn(1, 1, 16, 64, requires_grad=True)
    with torch.no_grad():
        assert TFA.flash_attention(q, q, q).grad_fn is None
    with torch.inference_mode():
        assert TFA.flash_attention(q, q, q).grad_fn is None
    x = torch.randn(1, 1, 16, 64)  # nothing requires grad
    assert TFA.flash_attention(x, x, x).grad_fn is None
    m = torch.zeros(1, 1, 16, 64, device="meta")
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(m, m, m, m, torch.zeros(1, 1, 16, device="meta"), m)
