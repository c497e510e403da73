// Flash-attention backward for Hopper (sm_90a), head_dim 64, bf16 in/out.
//
// Replaces the backward of the stock TPU kernel
// `jax.experimental.pallas.ops.tpu.flash_attention` (its dkv and dq
// kernels), which wiw_tpu/ops/attention.py reaches through
// `_flash_attention_fn` inside the custom VJP of `_custom_flash_fn`: the
// gradients dQ, dK, dV of non-causal softmax(q k^T / sqrt(D)) v, with fp32
// accumulation and no [S, S] tensor in device memory.
//
// The algorithm is FlashAttention's backward, laid out as FlashAttention-3
// lays it out for Hopper. The forward (K1 with its LSE flag) leaves the row
// log-sum-exp L, so P is recomputed tile by tile:
//   Delta = rowsum(dO o O),  P = exp(scale q k^T - L),
//   dV = bf16(P)^T dO,  dP = dO v^T,  dS = P o (dP - Delta),
//   dQ = scale bf16(dS) k,  dK = scale bf16(dS)^T q.
// P is rounded to bf16 before the dV product, where K1 rounds it before the
// PV product; dS before the dQ and dK products.
//
// What bounds it on this card: the operations. Five products of 2 S^2 64
// flops per (batch, head) against ~16 S 64 bytes of q, k, v, O, dO, dq, dk,
// dv: far above the H100's ~295 flop/byte ridge. Only wgmma reaches the
// tensor cores' bf16 rate; the exp2 and the dS arithmetic between the
// products run on the FP32 units. The first version (two mma.sync
// kernels, dQ and dK/dV, each recomputing S and dP: seven products of five,
// synchronous loads, scalar gathers) is replaced by one main pass of five
// products.
//
// Three launches on one stream, one C call:
//   * `flash_attn_bwd_preprocess_kernel`: Delta = rowsum(dO o O) and
//     L * log2(e) for every q row into a [2, B*H, Sq_pad] fp32 scratch
//     (Sq_pad = Sq rounded up to 64; the padding rows are 0).
//   * `flash_attn_bwd_sm90_kernel`, the main pass: one CTA per (batch*head,
//     128 kv rows), two warpgroups (256 threads), 64 kv rows each. Thread 0
//     loads the CTA's k and v tiles once by TMA and keeps q, dO (64-row
//     tiles) and their 64 L2 and Delta values (bulk copies) two q tiles
//     ahead through a ring of kStages = 3 stages, each guarded by a full
//     mbarrier; tile j + 2 goes into tile j - 1's stage once both
//     warpgroups have passed the barrier of tile j, so the ring needs no
//     empty barrier. (FlashAttention-3's separate producer warpgroup with
//     setmaxnreg was tried: at 384 threads ptxas holds a thread to 168
//     registers, three warps to an SM sub-partition, did not raise that for
//     the setmaxnreg roles, and serialised the wgmma for want of registers:
//     16.0 ms against 10.4-10.8 at B*H 70, S 9216 on an H100 80GB HBM3 at
//     700 W. At 256 threads a thread may have 255.) Each warpgroup loops over the q tiles:
//       S^T = k q^T and dP^T = v dO^T: wgmma.m64n64k16, both operands in
//         shared memory (K-major);
//       P^T = exp2(S^T scale log2 e - L2), dS^T = P^T o (dP^T - Delta) in
//         registers (kv rows past Skv and q rows past Sq get P = 0);
//       dV += bf16(P^T) dO and dK += bf16(dS^T) q: A from registers, B (dO,
//         q) the MN-major operand read through the transpose bit;
//       dQ = bf16(dS) k over the CTA's 128 kv rows: each warpgroup writes
//         bf16(dS^T) of its rows once to a 128-byte-swizzled shared tile
//         (two buffers, alternating by q tile), a barrier of both
//         warpgroups, then warpgroup c reads the whole tile transposed as
//         wgmma's A and takes dQ's columns 32 c .. 32 c + 31
//         (wgmma.m64n32k16, k's column half the MN-major B); it writes
//         them to a swizzled fp32 tile, and one TMA reduce-add
//         (cp.reduce.async.bulk.tensor) adds them into an fp32
//         [B*H, Sq_pad, 64] scratch in L2.
//     dK (times scale) and dV leave through their strides at the end.
//   * `flash_attn_bwd_convert_dq_kernel`: dq = bf16(scale dQ) through dq's
//     strides.
// dQ's sum over kv tiles is taken by reductions in L2 in the order the CTAs
// reach them, so its order (and dq's last bits) change from run to run; dK
// and dV are summed in a fixed order. The tolerance against the plain
// version is unchanged.
//
// Every tile is 128-byte swizzled (a 64-wide bf16 row is 128 bytes). q, k,
// v and dO are read through 4-D tensor maps (64, S, H, B) with the byte
// strides of their [B, H, S, 64] views, so head views of [B, S, H*64]
// tensors need no copy; rows past S read as zeros, never the next head.
// Sq != Skv is allowed. Shared memory: k and v 32 KB, two dS^T buffers 32
// KB, two fp32 dQ tiles 16 KB, 3 stages x (q 8 KB + dO 8 KB + 512 B) ~ 50
// KB: ~131 KB in all (dynamic). Registers of a consumer thread: dK and dV
// (32 fp32 each), S^T and dP^T (32 fp32 each), dQ's columns (16 fp32), the
// bf16 fragments of P^T and dS^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockN = 128;      // kv rows a CTA: two consumer warpgroups
constexpr int kBlockM = 64;       // q rows a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;      // 2 warpgroups
constexpr int kHalf = 64 * 128;   // bytes of a 64-row tile
// shared-memory offsets (bytes); every tile 1024-aligned
constexpr int kK = 0;                          // k: 128 rows
constexpr int kV = 2 * kHalf;                  // v: 128 rows
constexpr int kDs = 4 * kHalf;                 // dS^T, 2 buffers of 128 rows
constexpr int kDq = 8 * kHalf;                 // dQ halves: 2 x 64 rows x 32 fp32
constexpr int kQ0 = 10 * kHalf;                // q of stage s at + 2 s kHalf,
                                               // dO at + (2 s + 1) kHalf
constexpr int kRows = kQ0 + 2 * kStages * kHalf;  // L2[s][64], Delta[s][64]
constexpr int kBars = kRows + kStages * 2 * 64 * 4;
// kv_full, q_full[kStages]
constexpr int kSmem = kBars + 8 * (1 + kStages) + 1024;

struct Strides {
  int64_t b, h, s;
};

// Delta = rowsum(dO o O) and L * log2(e) of every q row, 8 threads a row,
// into rows[0][bh][:] (L2) and rows[1][bh][:] (Delta), zeros past Sq
__global__ void __launch_bounds__(256)
flash_attn_bwd_preprocess_kernel(const __nv_bfloat16* __restrict__ o,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 float* __restrict__ rows, int H, int Sq,
                                 int Sq_pad, int BH, Strides os, Strides dos) {
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * 32 + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  float acc = 0.f;
  if (row < Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * os.b + h * os.h + row * os.s + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + h * dos.h + row * dos.s + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 c = __bfloat1622float2(d2[i]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && row < Sq_pad) {
    const int64_t at = static_cast<int64_t>(bh) * Sq_pad + row;
    rows[at] = row < Sq ? lse[static_cast<int64_t>(bh) * Sq + row] * kLog2e : 0.f;
    rows[static_cast<int64_t>(BH) * Sq_pad + at] = row < Sq ? acc : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap dqmap,
                           const float* __restrict__ rows,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Sq,
                           int Skv, int Sq_pad, int BH, Strides dks,
                           Strides dvs, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* l2_s = reinterpret_cast<float*>(smem + kRows);  // [kStages][64]
  float* delta_s = l2_s + kStages * 64;                   // [kStages][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* q_full = kv_full + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.x * kBlockN;
  const int n_q = Sq_pad / kBlockM;
  const float* l2_g = rows + static_cast<int64_t>(bh) * Sq_pad;
  const float* delta_g = rows + (static_cast<int64_t>(BH) + bh) * Sq_pad;

  // q, dO, L2 and Delta of q tile j into stage j % kStages (thread 0 only)
  auto load_q_tile = [&](int j) {
    const int s = j % kStages;
    uint8_t* qt = smem + kQ0 + 2 * s * kHalf;
    sm90::mbar_expect_tx(&q_full[s], 2 * kHalf + 2 * 64 * 4);
    sm90::tma_load_4d(qt, &qmap, &q_full[s], 0, j * kBlockM, h, b);
    sm90::tma_load_4d(qt + kHalf, &domap, &q_full[s], 0, j * kBlockM, h, b);
    sm90::bulk_load(l2_s + s * 64, l2_g + j * kBlockM, 64 * 4, &q_full[s]);
    sm90::bulk_load(delta_s + s * 64, delta_g + j * kBlockM, 64 * 4, &q_full[s]);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&q_full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(kv_full, 4 * kHalf);
    sm90::tma_load_4d(smem + kK, &kmap, kv_full, 0, kv0, h, b);
    sm90::tma_load_4d(smem + kV, &vmap, kv_full, 0, kv0, h, b);
    for (int j = 0; j < kStages - 1 && j < n_q; ++j) load_q_tile(j);
  }

  {  // two warpgroups, 64 kv rows each
    const int c = threadIdx.x / 128;
    const int tid = threadIdx.x - 128 * c;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* kc = smem + kK + c * kHalf;
    const uint8_t* vc = smem + kV + c * kHalf;
    uint8_t* dqs = smem + kDq + c * kHalf;  // this warpgroup's dQ columns
    const int r0 = 16 * warp + g;  // this thread's rows of the 64-row tiles
    const int r1 = r0 + 8;
    const int kv_r0 = kv0 + 64 * c + r0;
    const int kv_r1 = kv0 + 64 * c + r1;

    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % kStages;
      const int q0 = j * kBlockM;
      const uint8_t* qt = smem + kQ0 + 2 * s * kHalf;
      const uint8_t* dot = qt + kHalf;
      uint8_t* ds = smem + kDs + (j & 1) * 2 * kHalf;  // 128 kv rows x 64 q
      sm90::mbar_wait(&q_full[s], (j / kStages) & 1);

      // S^T = k q^T, then dP^T = v dO^T, as two groups: rows kv, columns q
      float st[32], dpt[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n64k16_ss<0, 0>(st, sm90::desc_sw128(kc + 32 * kk),
                                       sm90::desc_sw128(qt + 32 * kk), kk);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n64k16_ss<0, 0>(dpt, sm90::desc_sw128(vc + 32 * kk),
                                       sm90::desc_sw128(dot + 32 * kk), kk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);

      // P^T while dP^T is computed; kv rows past Skv and q columns past Sq
      // get P = 0
      const float* l2 = l2_s + s * 64;
      const float* dl = delta_s + s * 64;
      const bool ragged = q0 + kBlockM > Sq || kv0 + kBlockN > Skv;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(l2 + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          float p = exp2f(st[i] * scale_log2 - ((e & 1) ? lv.y : lv.x));
          if (ragged && (q0 + col + (e & 1) >= Sq ||
                         ((e & 2) ? kv_r1 : kv_r0) >= Skv)) {
            p = 0.f;
          }
          st[i] = p;
        }
      }
      uint32_t pa[4][4], da[4][4];
      sm90::acc_to_a<4>(st, pa);

      // dV += bf16(P^T) dO (dO the MN-major B) while dS^T is computed
      sm90::fence_regs(dva);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n64k16_rs<1>(dva, pa[kk], sm90::desc_sw128(dot + 2048 * kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dpt);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          dpt[i] = st[i] * (dpt[i] - ((e & 1) ? dv2.y : dv2.x));
        }
      }
      sm90::acc_to_a<4>(dpt, da);

      // bf16(dS^T) to rows 64 c .. 64 c + 63 of this iteration's swizzled
      // buffer (the other buffer may still be read by the other warpgroup's
      // dQ product of the previous iteration)
      uint8_t* dsc = ds + c * kHalf;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cb = (16 * k + 2 * t) * 2;  // byte column of da[k][0]
        *reinterpret_cast<uint32_t*>(dsc + sm90::swizzle128(r0, cb)) = da[k][0];
        *reinterpret_cast<uint32_t*>(dsc + sm90::swizzle128(r1, cb)) = da[k][1];
        *reinterpret_cast<uint32_t*>(dsc + sm90::swizzle128(r0, cb + 16)) = da[k][2];
        *reinterpret_cast<uint32_t*>(dsc + sm90::swizzle128(r1, cb + 16)) = da[k][3];
      }
      // the previous dQ reduction has read this warpgroup's dQ tile
      if (tid == 0) sm90::bulk_wait_read<0>();
      sm90::fence_proxy_async();
      sm90::named_barrier(1, 256);  // both halves of dS^T are written
      // both warpgroups are done with q tile j - 1: its stage takes j + 2
      if (threadIdx.x == 0 && j + kStages - 1 < n_q) load_q_tile(j + kStages - 1);

      // dK += bf16(dS^T) q (this warpgroup's kv rows); dQ[:, 32 c .. 32 c +
      // 31] = bf16(dS) k over all 128 kv rows: dS the MN-major A (dS^T in
      // shared memory), k's column half the MN-major B
      float dq[16];
      sm90::fence_regs(dka);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n64k16_rs<1>(dka, da[kk], sm90::desc_sw128(qt + 2048 * kk));
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        sm90::wgmma_m64n32k16_ss<1, 1>(
            dq, sm90::desc_sw128(ds + 2048 * kk),
            sm90::desc_sw128(smem + kK + 2048 * kk + 64 * c), kk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
      sm90::fence_regs(dq);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);

      // the dQ columns to a swizzled fp32 tile (64 rows x 128 bytes), then
      // one TMA reduce-add into dq_acc rows q0 .. q0 + 63
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cb = (8 * jj + 2 * t) * 4;
        *reinterpret_cast<float2*>(dqs + sm90::swizzle128(r0, cb)) =
            make_float2(dq[4 * jj], dq[4 * jj + 1]);
        *reinterpret_cast<float2*>(dqs + sm90::swizzle128(r1, cb)) =
            make_float2(dq[4 * jj + 2], dq[4 * jj + 3]);
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(2 + c, 128);
      if (tid == 0) {
        sm90::tma_reduce_add_2d(&dqmap, dqs, 32 * c, bh * Sq_pad + q0);
        sm90::bulk_commit();
      }
    }
    if (tid == 0) sm90::bulk_wait<0>();

    // dK (times scale) and dV, rows past Skv not stored
    __nv_bfloat16* dkp = dk + b * dks.b + h * dks.h;
    __nv_bfloat16* dvp = dv + b * dvs.b + h * dvs.h;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (kv_r0 < Skv) {
        *reinterpret_cast<uint32_t*>(dkp + kv_r0 * dks.s + col) =
            sm90::pack_bf16(dka[4 * jj] * scale, dka[4 * jj + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + kv_r0 * dvs.s + col) =
            sm90::pack_bf16(dva[4 * jj], dva[4 * jj + 1]);
      }
      if (kv_r1 < Skv) {
        *reinterpret_cast<uint32_t*>(dkp + kv_r1 * dks.s + col) =
            sm90::pack_bf16(dka[4 * jj + 2] * scale, dka[4 * jj + 3] * scale);
        *reinterpret_cast<uint32_t*>(dvp + kv_r1 * dvs.s + col) =
            sm90::pack_bf16(dva[4 * jj + 2], dva[4 * jj + 3]);
      }
    }
  }
}

// dq = bf16(scale dQ), 8 values a thread, through dq's strides
__global__ void __launch_bounds__(256)
flash_attn_bwd_convert_dq_kernel(const float* __restrict__ dq_acc,
                                 __nv_bfloat16* __restrict__ dq, int H, int Sq,
                                 int Sq_pad, Strides dqs, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int row = idx >> 3;
  const int part = idx & 7;
  if (row >= Sq) return;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + (static_cast<int64_t>(bh) * Sq_pad + row) * 64 + part * 8);
  const float4 a = src[0];
  const float4 c = src[1];
  uint4 out;
  out.x = sm90::pack_bf16(a.x * scale, a.y * scale);
  out.y = sm90::pack_bf16(a.z * scale, a.w * scale);
  out.z = sm90::pack_bf16(c.x * scale, c.y * scale);
  out.w = sm90::pack_bf16(c.z * scale, c.w * scale);
  *reinterpret_cast<uint4*>(dq + b * dqs.b + h * dqs.h + row * dqs.s + part * 8) = out;
}

}  // namespace

// C entry, bound with ctypes. q, k, v, o, dout, dq, dk, dv are device
// pointers of bf16 tensors viewed as [B, H, S, 64] with unit stride on the
// last dim; their (batch, head, row) strides are in elements (multiples of
// 8, 16-byte aligned bases), in the order q, k, v, o, dout, dq, dk, dv. lse
// is K1's fp32 [B*H, Sq] output. `rows` is fp32 scratch of 2 * B*H * Sq_pad
// values and `dq_acc` fp32 scratch of B*H * Sq_pad * 64 values, zeroed by
// the caller, where Sq_pad is Sq rounded up to a multiple of kBlockM (64):
// the caller passes the Sq_pad it allocated for, and any other value is
// refused before a launch. Launches the pre-pass, the main pass and the dq
// pass on `stream`; returns the first error (cudaErrorInvalidValue for a
// wrong Sq_pad or a tensor map the driver refuses).
extern "C" int wiw_flash_attn_bwd_d64(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq_acc, void* dq,
    void* dk, void* dv, int B, int H, int Sq, int Skv, int Sq_pad,
    const int64_t* strides, float sm_scale, void* stream) {
  if (Sq_pad != (Sq + kBlockM - 1) / kBlockM * kBlockM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const int BH = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap qm, km, vm, dom, dqm;
  if (!sm90_f32_rows_map(&dqm, dq_acc, static_cast<int64_t>(BH) * Sq_pad,
                         kBlockM) ||
      !sm90_head_map(&qm, q, B, H, Sq, st[0].b, st[0].h, st[0].s, kBlockM) ||
      !sm90_head_map(&km, k, B, H, Skv, st[1].b, st[1].h, st[1].s, kBlockN) ||
      !sm90_head_map(&vm, v, B, H, Skv, st[2].b, st[2].h, st[2].s, kBlockN) ||
      !sm90_head_map(&dom, dout, B, H, Sq, st[4].b, st[4].h, st[4].s, kBlockM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* frows = static_cast<float*>(rows);
  float* facc = static_cast<float*>(dq_acc);
  flash_attn_bwd_preprocess_kernel<<<dim3(Sq_pad / 32, BH), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      frows, H, Sq, Sq_pad, BH, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attn_bwd_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_bwd_sm90_kernel<<<dim3((Skv + kBlockN - 1) / kBlockN, BH),
                               kThreads, kSmem, s>>>(
      qm, km, vm, dom, dqm, frows, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, Sq_pad, BH, st[6], st[7],
      sm_scale, sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_bwd_convert_dq_kernel<<<dim3((Sq * 8 + 255) / 256, BH), 256, 0, s>>>(
      facc, static_cast<__nv_bfloat16*>(dq), H, Sq, Sq_pad, st[5], sm_scale);
  return static_cast<int>(cudaGetLastError());
}
