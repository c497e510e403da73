"""Kernel K1 (flash-attention forward): plain version against the reference.

On the CPU the port's wrapper computes `flash_attention_plain`; it is held
against the reference's Pallas v2 kernel run in interpret mode (as
tests/test_pallas_attention.py runs it) and, for ragged S the Pallas kernel
does not tile, against the reference's plain XLA form. Tolerance 2e-5: all
fp32, only the summation order differs (the reference's own kernel tests
use the same bound).

The kernel itself only runs on the card: tests/test_torch_cuda.py holds it
against this plain version there.
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
