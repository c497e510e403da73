"""Port parity for K10 (int8 q k^T attention) and K9 (the attention
ablations): the port's plain versions against the reference's Pallas
kernel bodies, run as the reference's own tests run its kernels on the CPU
(`pl.pallas_call(..., interpret=True)`).

The bodies live in benchmark scripts that start a benchmark when imported
(scripts/probe_int8_attention.py `_kernel_i8qk`, scripts/tune_attention2.py
`_kern_floor`, `_kern_noexp`, `_kern_v2`), so each is taken out with `ast`:
only the FunctionDef nodes are kept and run with the scripts' constants
(D = 64, NEG_INF = -1e30). Inputs are made with numpy from a seed, at
B*H = 2, S = 256, q blocks of 128, and the kv block width of the port's
kernels, since the values of K10's P and p8 and of K9 noexp's scale depend
on the running max at each block: K10's (`TI.KV_TILE`, 128, a stage of its
TMA ring) for K10, and K1's (`TFA.KV_TILE`, 128, a stage of its ring) for
K9's floor, noexp and v2, v2 also against the reference K1 at that width.
v's column 64 (K10's ones column) is 1.

K10 on the card reads v repacked (`repack_v`): int8 v with its kv index
permuted within each 32 to match the kernel's s8 A fragments. The tests
below hold that permutation to a bijection and the permuted int32 PV to
the unpermuted one, exactly.

Tolerances, on bf16 outputs: the two sides take exp and sum in another
order (XLA's CPU exp against torch's), so a bf16 rounding of P, or an
output rounding, may land one step apart: K10 and K9 v2 within 1e-2
absolute on outputs of magnitude ~1 (measured below 4e-3); K9 floor,
whose outputs reach ~100, within 1e-2 relative to max|ref|; K9 noexp, a
ratio of two running sums that the identity for exp leaves unnormalised,
likewise 1e-2 of max|ref|. K9 v2 is K1's function: its body with the
caller's pre-scale gives the bits of the reference's K1 kernel.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wiw_tpu.ops.pallas_attention import flash_attention_bhsd
from wiw_tpu_torch.ops import flash_attention as TFA
from wiw_tpu_torch.ops import int8_attention as TI

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
BH, S, D, BQ = 2, 256, 64, 128
BKV = TI.KV_TILE  # K10's kv block width
K9_BKV = TFA.KV_TILE  # K9's floor, noexp and v2's (a stage of K1's kernel)


def _bodies(script: str) -> dict:
    """The script's functions, without running its module-level code."""
    tree = ast.parse((SCRIPTS / script).read_text())
    tree.body = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu,
          "functools": functools, "D": D, "NEG_INF": -1e30}
    exec(compile(tree, script, "exec"), ns)
    return ns


def _interpret(body, q, k, v, out_d, out_dtype, **kw):
    """The body over a (B*H, S/BQ) grid, as the scripts call it."""
    Bh, Sq, Dq = q.shape
    Skv, Dv = k.shape[1], v.shape[2]
    return np.asarray(pl.pallas_call(
        functools.partial(body, **kw),
        grid=(Bh, Sq // BQ),
        in_specs=[
            pl.BlockSpec((1, BQ, Dq), lambda bh, qi: (bh, qi, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, Skv, Dq), lambda bh, qi: (bh, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, Skv, Dv), lambda bh, qi: (bh, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, BQ, out_d), lambda bh, qi: (bh, qi, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Bh, Sq, out_d), out_dtype),
        interpret=True,
    )(q, k, v).astype(jnp.float32))


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _int8(shape, seed):
    x = np.clip(np.rint(np.random.default_rng(seed).standard_normal(shape) * 40),
                -127, 127).astype(np.int8)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("i8pv", [False, True])
def test_int8_qk_attention_plain_matches_reference_body(i8pv):
    body = _bodies("probe_int8_attention.py")["_kernel_i8qk"]
    jq, tq = _int8((BH, S, D), 0)
    jk, tk = _int8((BH, S, D), 1)
    if i8pv:
        v = np.clip(np.rint(np.random.default_rng(2).standard_normal((BH, S, D + 1))
                            * 40), -127, 127).astype(np.int8)
        v[..., D] = 1
        jv, tv = jnp.asarray(v), torch.from_numpy(v)
    else:
        jv, tv = _bf16((BH, S, D + 1), 2)
        jv, tv = jv.at[..., D].set(1.0), tv.clone()
        tv[..., D] = 1.0
    qk_scale = 1e-3
    ref = _interpret(body, jq, jk, jv, D + 1, jnp.bfloat16, bkv=BKV,
                     qk_scale=qk_scale, i8pv=i8pv)
    before = (TI.int8_qk_attention.launches, TI.int8_qk_attention.launches_i8pv)
    out = TI.int8_qk_attention(tq, tk, tv, qk_scale, i8pv)
    assert (TI.int8_qk_attention.launches,
            TI.int8_qk_attention.launches_i8pv) == before  # CPU: plain version
    assert out.dtype == torch.bfloat16 and out.shape == (BH, S, D + 1)
    out = out.float().numpy()
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1
    np.testing.assert_array_equal(out[..., D], 1.0)
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)


def _k9_inputs():
    jq, tq = _bf16((BH, S, D), 3)
    jk, tk = _bf16((BH, S, D), 4)
    jv, tv = _bf16((BH, S, D), 5)
    return (jq, jk, jv), (tq[None], tk[None], tv[None])


@pytest.mark.parametrize("variant", ["floor", "noexp"])
def test_ablation_plain_matches_reference_body(variant):
    body = _bodies("tune_attention2.py")[f"_kern_{variant}"]
    (jq, jk, jv), (tq, tk, tv) = _k9_inputs()
    ref = _interpret(body, jq, jk, jv, D, jnp.bfloat16, bkv=K9_BKV)
    fn = {"floor": TFA.attention_floor, "noexp": TFA.attention_noexp}[variant]
    before = fn.launches
    out = fn(tq, tk, tv)
    assert fn.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (1, BH, S, D)
    out = out[0].float().numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


def test_ablation_v2_plain_matches_reference_body_and_k1_bits():
    """`_kern_v2` with its caller's pre-scale and ones column (as the
    script's `v2` calls it) gives the reference K1's bits
    (`flash_attention_bhsd(kernel="v2")`, interpret mode); the port's plain
    version agrees with both, and with the port's K1 plain version."""
    body = _bodies("tune_attention2.py")["_kern_v2"]
    (jq, jk, jv), (tq, tk, tv) = _k9_inputs()
    qs = (jq.astype(jnp.float32) * D ** -0.5).astype(jnp.bfloat16)
    vp = jnp.concatenate([jv, jnp.ones((BH, S, 1), jnp.bfloat16)], axis=-1)
    ref = _interpret(body, qs, jk, vp, D + 1, jnp.bfloat16, bkv=K9_BKV)[..., :D]
    k1 = np.asarray(flash_attention_bhsd(jq[None], jk[None], jv[None], bq=BQ,
                                         bkv=K9_BKV, interpret=True)[0]
                    ).astype(np.float32)
    np.testing.assert_array_equal(ref, k1)
    before = TFA.attention_v2.launches
    out = TFA.attention_v2(tq, tk, tv)
    assert TFA.attention_v2.launches == before
    out = out[0].float().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)
    np.testing.assert_allclose(
        out, TFA.flash_attention_plain(tq, tk, tv)[0].float().numpy(), atol=1e-2)


def test_noexp_plain_in_float64_is_the_same_arithmetic():
    """The float64 option of noexp's plain version (the card's reference)
    computes the same function: within 1e-2 of max|ref| of the fp32 one,
    and its denominators within 1e-3 relative, on the K9 inputs."""
    _, (tq, tk, tv) = _k9_inputs()
    o32, d32 = TFA.attention_noexp_plain(tq, tk, tv, with_denominator=True)
    o64, d64 = TFA.attention_noexp_plain(tq, tk, tv, with_denominator=True,
                                         dtype=torch.float64)
    assert o64.dtype == torch.bfloat16 and d64.dtype == torch.float64
    o32, o64 = o32.float(), o64.float()
    assert (o64 - o32).abs().max() <= 1e-2 * o32.abs().max()
    assert ((d64 - d32.double()).abs() <= 1e-3 * d64.abs()).all()


def test_ablation_plain_versions_depend_on_the_block_width():
    """noexp's scale (m - m_new) and v2's rounded P follow the running max
    at each kv block: the plain versions take the kernels' width, and
    another width gives other values (floor's does not, up to sum order)."""
    _, (tq, tk, tv) = _k9_inputs()
    for plain in (TFA.attention_noexp_plain, TFA.attention_v2_plain):
        assert not torch.equal(plain(tq, tk, tv, bkv=64), plain(tq, tk, tv, bkv=128))
    floor64 = TFA.attention_floor_plain(tq, tk, tv, bkv=64).float()
    floor128 = TFA.attention_floor_plain(tq, tk, tv, bkv=128).float()
    assert (floor64 - floor128).abs().max() <= 1e-2 * floor64.abs().max()


def test_int8_qk_attention_plain_depends_on_the_block_width():
    """P and p8 follow the running max at each kv block: the plain version
    takes the kernel's width (128), and 64 gives other bits."""
    q8, k8 = _int8((BH, S, D), 6)[1], _int8((BH, S, D), 7)[1]
    v = _int8((BH, S, D + 1), 8)[1]
    v[..., D] = 1
    for i8pv in (False, True):
        vv = v if i8pv else v.bfloat16()
        assert not torch.equal(TI.int8_qk_attention_plain(q8, k8, vv, 1e-3, i8pv),
                               TI.int8_qk_attention_plain(q8, k8, vv, 1e-3, i8pv,
                                                          bkv=64))


def test_kv_permutation_is_a_bijection_within_each_32():
    perm = TI.KV_PERM
    assert sorted(perm) == list(range(32))
    # logical k 4t..4t+3 of the A fragment is kv 2t, 2t+1 of two 8-wide
    # accumulator blocks (8 apart); 16 + 4t.. likewise 16 further on
    for t in range(4):
        assert perm[4 * t:4 * t + 4] == (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)
        assert perm[16 + 4 * t:20 + 4 * t] == tuple(16 + p for p in perm[4 * t:4 * t + 4])


def test_repacked_int8_pv_equals_the_unpermuted_one_exactly():
    """p8 read in the kernel's fragment order (`KV_PERM` applied to kv
    within each 32) against v8 and its column as `repack_v` lays them out
    (kv permuted alike, d along the rows) gives the int32 PV of the
    reference's order, every one of the 65 columns."""
    rng = np.random.default_rng(9)
    p8 = torch.from_numpy(rng.integers(0, 128, (BH, 64, S)))
    v = _int8((BH, S, D + 1), 10)[1]
    want = torch.einsum("bqk,bkd->bqd", p8, v.long())
    main, col = TI.repack_v(v, True)
    assert main.shape == (BH, D, S) and main.dtype == torch.int8
    assert col.shape == (BH, S) and col.dtype == torch.int8
    assert main.is_contiguous() and col.is_contiguous()
    np.testing.assert_array_equal(main[:, :, :32].numpy(),
                                  v[:, list(TI.KV_PERM), :D].transpose(1, 2).numpy())
    perm = (torch.arange(0, S, 32)[:, None] + torch.tensor(TI.KV_PERM)).reshape(S)
    p8_fragments = p8[..., perm]  # what the kernel's A registers hold
    assert not torch.equal(p8_fragments, p8)
    assert torch.equal(torch.einsum("bqk,bdk->bqd", p8_fragments, main.long()),
                       want[..., :D])
    assert torch.equal(torch.einsum("bqk,bk->bq", p8_fragments, col.long()),
                       want[..., D])


def test_repacked_bf16_v_is_the_values_and_the_padded_column():
    v = _bf16((BH, S, D + 1), 11)[1]
    main, col = TI.repack_v(v, False)
    assert main.is_contiguous() and col.is_contiguous()
    assert torch.equal(main, v[..., :D])
    assert col.shape == (BH, S, 8) and torch.equal(col[..., 0], v[..., D])
    assert not col[..., 1:].any()


@pytest.mark.parametrize("i8pv", [False, True])
def test_int8_qk_attention_refuses_s_off_the_block_width(i8pv):
    """S must be a multiple of the kernel's 128-row kv stage (192 is one of
    the old 64-wide tile's, not of 128)."""
    q8 = _int8((1, 192, D), 12)[1]
    v = _int8((1, 192, D + 1), 13)[1]
    with pytest.raises(ValueError, match="multiple"):
        TI.int8_qk_attention(q8, q8, v if i8pv else v.bfloat16(), 1e-3, i8pv)
