"""Tests that need an NVIDIA GPU: the hand-written kernels against their
plain versions, on the card. They skip elsewhere (the CUDA kernels have no
CPU mode). This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance for K1: 2e-2 absolute plus 1e-2 relative, i.e. about two bf16
ulps of the output (bf16 inputs; the kernel rounds P to bf16 before the PV
product and rounds the output to bf16, the plain version rounds the
softmax weights to bf16, so the two may land one rounding step apart).
"""

import pytest
import torch

from wiw_tpu_torch.ops import attention as TAtt
from wiw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


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
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_kernel_reads_strided_heads_and_rejects_bad_inputs(cuda_device):
    x = torch.randn(2, 144, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    out = TAtt.attention_bsd(x, x, x, 3)
    heads = x.view(2, 144, 3, 64).transpose(1, 2)
    ref = flash_attention_plain(heads, heads, heads).transpose(1, 2).reshape(
        2, 144, 192)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=1e-2)
    with pytest.raises(TypeError):
        flash_attention(*(t.float() for t in (heads, heads, heads)))
    d80 = torch.zeros(1, 1, 16, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(d80, d80, d80)
