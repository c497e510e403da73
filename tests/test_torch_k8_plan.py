"""K8's plan (`ops/group_norm.k8_plan`), on the CPU: at every GroupNorm
shape of a served request at 576x1024 with 14 frames (a 2-row UNet forward,
the VAE encoder, a 4-frame decode chunk), the slab is whole groups of whole
16-byte vectors, at least 16 channels; path R's slab fits its cluster's
shared memory, and path S is taken only where no legal slab fits a cluster;
nothing in the plan but the grid depends on the batch rows. The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import collections
import math

import pytest
import torch

from wiw_tpu_torch.models import layers as TL
from wiw_tpu_torch.models import unet as TU
from wiw_tpu_torch.ops import group_norm as TG

# (N, L, C) of every GroupNorm at 576x1024 (a 72x128 latent), 14 frames, 32
# groups, with its calls: a 2-row UNet forward (CFG pair folded: spatial
# norms on 28 frames, temporal ones on 2 rows of 14 frames), the VAE encoder
# on the conditioning image, and one 4-frame decode chunk
UNET = {(28, 9216, 960): 1, (28, 9216, 640): 2, (28, 2304, 1920): 1,
        (28, 9216, 320): 13, (2, 129024, 320): 10, (28, 2304, 1280): 1,
        (28, 2304, 960): 1, (28, 2304, 640): 11, (2, 32256, 640): 10,
        (28, 576, 2560): 2, (28, 576, 1920): 1, (28, 2304, 320): 1,
        (28, 576, 1280): 11, (2, 8064, 1280): 10, (28, 576, 640): 1,
        (28, 144, 2560): 3, (28, 144, 1280): 12, (2, 2016, 1280): 14}
ENCODER = {(1, 589824, 128): 4, (1, 147456, 256): 3, (1, 147456, 128): 1,
           (1, 36864, 512): 3, (1, 36864, 256): 1, (1, 9216, 512): 10}
DECODE_CHUNK = {(4, 589824, 256): 1, (4, 147456, 512): 1, (4, 589824, 128): 6,
                (1, 2359296, 128): 6, (4, 147456, 256): 5, (1, 589824, 256): 6,
                (4, 36864, 512): 6, (1, 147456, 512): 6, (4, 9216, 512): 11,
                (1, 36864, 512): 10}
SHAPES = sorted(set(UNET) | set(ENCODER) | set(DECODE_CHUNK))
DTYPES = [torch.bfloat16, torch.float32]


def _isz(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def _legal_widths(C, groups, dtype):
    unit = math.lcm(C // groups, 8)
    widths = [w for w in range(unit, C + 1, unit)
              if C % w == 0 and w * _isz(dtype) <= 16 * TG.K8_THREADS_R]
    return [w for w in widths if w >= 16] or widths


def _check_plan(N, L, C, groups, dtype):
    plan = TG.k8_plan(N, L, C, groups, dtype)
    w, isz = plan.slab, _isz(dtype)
    assert w % (C // groups) == 0 and w % 8 == 0 and C % w == 0
    legal = _legal_widths(C, groups, dtype)
    assert w in legal
    if any(v >= 16 for v in range(8, C + 1, 8) if C % v == 0 and v % (C // groups) == 0):
        assert w >= 16
    big = TG.K8_SMEM - max(TG.k8_smem_extra(v, C, groups, dtype) for v in legal)
    if plan.path == "R":
        assert 1 <= plan.cluster <= TG.K8_CLUSTER_MAX and w * isz >= 64
        assert plan.cluster * plan.rows >= L > (plan.cluster - 1) * plan.rows
        smem = plan.rows * w * isz + TG.k8_smem_extra(w, C, groups, dtype)
        assert smem <= TG.K8_SMEM
        # two CTAs an SM, or one on a slab of at least 128 bytes a position
        assert 2 * smem <= 233472 or w * isz >= 128
        assert plan.blocks == N * (C // w) * plan.cluster
    else:
        assert plan.path == "S" and plan.cluster == 1
        # no legal slab of 64 bytes a position fits 16 CTAs two an SM, nor
        # one of 128 bytes 16 CTAs one an SM
        for v in legal:
            assert v * isz < 64 or L * v * isz > TG.K8_CLUSTER_MAX * TG.K8_SHARD
            assert v * isz < 128 or L * v * isz > TG.K8_CLUSTER_MAX * big
        # whole rows a batch, on the widest slab of at most half a row
        assert w == max((v for v in legal if v <= C // 2), default=legal[-1])
        rb = plan.slabs_per_batch // (C // w)
        assert plan.slabs_per_batch == rb * (C // w) and 1 <= rb <= N
        assert plan.blocks == TG.H100_SMS * TG.K8_BLOCKS_S
        assert plan.rows == -(-L // (plan.blocks // (C // w)))
        assert plan.resident == (L * C * isz <= TG.K8_L2_BATCH)
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k8_plan_at_every_served_groupnorm_shape(shape, dtype):
    N, L, C = shape
    plan = _check_plan(N, L, C, 32, dtype)
    # what sets the arithmetic does not depend on N: a row's bits do not
    # either (path R's grid and path S's rows a batch do)
    other = TG.k8_plan(3 if N != 3 else 5, L, C, 32, dtype)
    assert plan._replace(blocks=0, slabs_per_batch=0) == other._replace(
        blocks=0, slabs_per_batch=0)


def test_k8_plan_paths_at_the_served_shapes():
    """bf16, as served: every UNet norm but the temporal rows of levels 0-1
    is resident in a cluster; those rows and the VAE's rows from 144x256
    up take path S."""
    paths = {s: TG.k8_plan(*s, 32, torch.bfloat16) for s in SHAPES}
    assert {s for s, p in paths.items() if p.path == "S"} == {
        (2, 129024, 320), (2, 32256, 640), (1, 589824, 128), (1, 589824, 256),
        (1, 147456, 128), (1, 147456, 256), (1, 147456, 512), (1, 36864, 256),
        (1, 36864, 512), (4, 589824, 128), (4, 589824, 256), (4, 147456, 256),
        (4, 147456, 512), (4, 36864, 512), (1, 2359296, 128)}
    # the level-0 spatial slab: 4 groups of 10 channels, 8 CTAs of 92 KB
    # (two an SM)
    assert paths[(28, 9216, 320)] == TG.K8Plan("R", 40, 8, 1152, 1792, 0, True)
    # the level-0 temporal rows: half a row a slab, a row a batch, over two
    # blocks an SM; a row (82.6 MB) exceeds the L2
    assert paths[(2, 129024, 320)] == TG.K8Plan("S", 160, 1, 978, 264, 2, False)
    # 30-channel groups at level 0: 11 CTAs of 196 KB, one an SM
    # (non-portable cluster)
    assert paths[(28, 9216, 960)] == TG.K8Plan("R", 120, 11, 838, 2464, 0, True)


# (N, L, C, groups) and the (path, slab) of bf16, then of fp32
@pytest.mark.parametrize("N,L,C,groups,bf16,fp32", [
    (2, 9253, 96, 32, ("R", 48), ("R", 24)),     # 3-channel groups: lcm 24
    (1, 70001, 96, 32, ("S", 48), ("S", 48)),    # too long for a cluster: half a row
    (28, 9216, 960, 32, ("R", 120), ("S", 480)),  # 30-channel groups: lcm 120
    (2, 7, 24, 24, ("S", 24), ("R", 24)),        # C = 24: 48 bytes a position in bf16
    (5, 1, 128, 32, ("R", 32), ("R", 16)),
    (1, 64, 16, 4, ("S", 16), ("R", 16)),        # 32 bytes a position in bf16
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_plan_slab_rules(N, L, C, groups, bf16, fp32, dtype):
    plan = _check_plan(N, L, C, groups, dtype)
    assert (plan.path, plan.slab) == (bf16 if dtype == torch.bfloat16 else fp32)


def test_k8_plan_prefers_two_ctas_an_sm_then_a_portable_cluster():
    # C = 320 at level 0: 40 channels (80 bytes a position) fit 8 CTAs of 90
    # KB; 80 channels (whole sectors) would need 16 of them
    assert TG.k8_plan(28, 9216, 320, 32, torch.bfloat16)[:3] == ("R", 40, 8)
    # level 1: 80 channels fit 4 CTAs of 92 KB, and are whole sectors
    assert TG.k8_plan(28, 2304, 640, 32, torch.bfloat16)[:3] == ("R", 80, 4)
    # fp32 at level 0: 40 channels (160 bytes) fit 16 CTAs of 92 KB
    assert TG.k8_plan(28, 9216, 320, 32, torch.float32)[:3] == ("R", 40, 16)


def test_k8_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        TG.k8_plan(2, 64, 64, 32, torch.float16)
    with pytest.raises(ValueError):  # C not a multiple of 8
        TG.k8_plan(2, 64, 36, 36, torch.bfloat16)
    with pytest.raises(ValueError):  # C not a multiple of the groups
        TG.k8_plan(2, 64, 64, 24, torch.bfloat16)
    with pytest.raises(ValueError):
        TG.k8_plan(TG.MAX_ROWS + 1, 64, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError):  # a group wider than a block's columns
        TG.k8_plan(1, 64, 4096, 1, torch.bfloat16)


def test_k8_work_bytes():
    plan = TG.k8_plan(2, 129024, 320, 32, torch.bfloat16)
    gs = plan.slab // 10
    assert TG.k8_work_bytes(plan, 320, 32) == (264 * gs * 16 + 2 * 2 * gs * 8 + 2 * 4)
    assert TG.k8_work_bytes(TG.k8_plan(28, 9216, 320, 32, torch.bfloat16), 320, 32) == 0


def test_served_groupnorm_shapes_are_the_listed_ones(monkeypatch):
    """The shape lists above are those the full-width towers run: a 2-row
    UNet forward, the VAE encoder at 576x1024 and a 4-frame decode chunk,
    traced on the meta device (no weights are made) with the norm recorded
    and the attention kernels stubbed."""
    from wiw_tpu_torch.sampling.pipeline import SVDPipeline

    seen = collections.Counter()

    def record(x, weight, bias, groups, eps, silu=False):
        assert groups == 32
        seen[(x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1])] += 1
        return x

    monkeypatch.setattr(TL, "group_norm", record)
    monkeypatch.setattr(TL, "attention_bsd",
                        lambda q, k, v, heads, spatial=False: torch.empty_like(q))
    cfg = TU.UNetConfig(action_strategy="micro_cond", action_input_channel=14)
    pipe = SVDPipeline(cfg, device="cpu")
    with torch.device("meta"), torch.no_grad():
        pipe.unet(torch.randn(2, 14, 72, 128, 8), torch.full((2,), 0.5),
                  torch.randn(2, 1, 1024), torch.ones(2, 3), torch.zeros(2, 14, 14))
        assert dict(seen) == UNET
        seen.clear()
        pipe.vae.encode(torch.randn(1, 576, 1024, 3))
        assert dict(seen) == ENCODER
        seen.clear()
        pipe.vae.decode(torch.randn(4, 72, 128, 4), 4)
        assert dict(seen) == DECODE_CHUNK
