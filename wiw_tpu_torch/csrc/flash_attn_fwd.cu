// Flash-attention forward for Hopper (sm_90a), head_dim 64, bf16 in/out.
//
// Replaces the TPU kernel `_attn_kernel_v2` in wiw_tpu/ops/pallas_attention.py
// (reached from `flash_attention_bhsd(kernel="v2")`): non-causal
// softmax(q k^T / sqrt(D)) v with fp32 accumulation and an fp32 online
// softmax, so the [S, S] logits never reach device memory.
//
// What bounds it on this card: the operations. At the UNet's shapes (S =
// 9216 ... 144, D = 64) a (batch, head) does 4 S^2 D flops on 4 S D bf16
// values of q/k/v/o: at S = 9216 that is 9216 flop/byte, far above the
// H100's ~295 flop/byte ridge. Only wgmma reaches the tensor cores' bf16
// rate, and between the two products every logit takes a scale, a max, an
// exp2 and a sum on the FP32 units, which the two consumer warpgroups
// overlap with each other's products.
//
// K1's design (`flash_attn_fwd_sm90_kernel`, a redesign of the first,
// mma.sync, version of this kernel):
//   * One CTA per (batch*head, 128 q rows): 3 warpgroups, 384 threads.
//     Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24)
//     and one thread issues every TMA copy. Warpgroups 1 and 2 are the
//     consumers (setmaxnreg 240), 64 q rows each. (ptxas still holds every
//     thread to 168 registers, three warps to an SM sub-partition; the
//     consumers fit them without spilling or serialising their wgmma.
//     Issuing S of the next tile before the softmax of this one, in a
//     256-thread variant with the registers for two S accumulators, made
//     ptxas serialise the wgmma (C7515) and was slower: 9.75 ms against this
//     design's 8.2-8.4 at B*H 140, S 9216 on an H100 80GB HBM3 at 700 W.)
//   * q is loaded once by TMA. k and v come in 128-row tiles through a ring
//     of kStages = 2 stages; each stage has a full mbarrier for k, one for
//     v (so S = q k^T starts before v lands) and an empty mbarrier that the
//     8 consumer warps release after their P v product. Every tile is
//     128-byte swizzled (a 64-wide bf16 row is 128 bytes), as TMA writes it
//     and wgmma reads it.
//   * S = q k^T: 4 x wgmma.m64n128k16, both operands in shared memory,
//     K-major. The online softmax runs in registers with the scale folded
//     into exp2 (log2 domain); one quad shuffle finishes each row max.
//   * O += P v: 8 x wgmma.m64n64k16 with bf16(P) as the register A operand
//     (the S accumulator's layout is the A fragment's) and v as the
//     MN-major B operand, read through the transpose bit: no transpose pass.
//   * q, k and v are read through 4-D tensor maps (64, S, H, B) with the
//     byte strides of the [B, H, S, 64] view, so head views of [B, S, H*64]
//     projections need no copy. Rows past S read as zeros (never the next
//     head); logits of kv columns past Skv are set to -inf, and q rows past
//     Sq are computed on zeros and not stored. The output goes out through
//     its strides, a [B, H, Sq, 64] view of a contiguous [B, Sq, H, 64].
//   * Shared memory: q 16 KB + 2 stages x (k 16 KB + v 16 KB) = 80 KB plus
//     the barriers (dynamic, above the 48 KB default). Registers: a
//     consumer thread holds S (64 fp32), O (32 fp32) and P (32 x bf16x2).
//   * The template flag kLse also stores each q row's log-sum-exp (natural
//     log of sum_j exp(scale * q.k_j), fp32, [B*H, Sq] contiguous), which the
//     backward (K3) needs. It changes only that store: the output bits are
//     the same with and without it.
//
// K2 and K9 in this file:
//   * K2's v1 (`_attn_kernel`, pallas_attention.py:40) and K9's v2
//     (`_kern_v2`, scripts/tune_attention2.py:122, q pre-scaled by the
//     caller, sm_scale 1) are K1's function and run K1's kernel above: v1's
//     arithmetic (the scale applied to the fp32 logits, P rounded to bf16
//     for the PV product, the denominator the fp32 sum of the unrounded P)
//     is what K1 does.
//   * K2's unroll2 (`_attn_kernel_unroll2`, pallas_attention.py:77) runs
//     K1's kernel too. It takes two kv blocks an iteration under one running
//     max: m_new = max(m, rowmax s0, rowmax s1), p_i = exp(s_i - m_new),
//     acc = acc exp(m - m_new) + p0 v0 + p1 v1. Two of the port's former
//     64-row tiles under one max are one 128-row stage of K1 (kBlockN), so
//     the two differ only in the order of the fp32 sums. What the unrolled
//     loop buys on the TPU (two independent q k^T products overlapping two
//     exp passes), K1's asynchronous wgmma and its two consumer warpgroups
//     already give here.
//   * K9's floor and noexp (`_kern_floor`, `_kern_noexp`,
//     tune_attention2.py:78, :95) stay on the first mma.sync kernel below
//     (`flash_attn_fwd_d64_mma_kernel`, not redesigned): ablations with no
//     model caller. floor is the two products alone: O = sum over tiles of
//     bf16(q k^T) v, logits unscaled. noexp is the loop with exp replaced by
//     the identity on unscaled logits (m_new = max(m, rowmax S), P = S -
//     m_new, the running output and denominator scaled by m - m_new, the
//     max starting at -1e30, O = acc / (denominator + 1)); its result
//     depends on the 64-wide kv tile, which its plain version takes as
//     `bkv`. That kernel loads k/v synchronously through registers and
//     gathers v's fragments with scalar shared loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ------------------------------------------------------ K1: wgmma + TMA
namespace k1 {
constexpr int kBlockM = 128;           // q rows a CTA
constexpr int kBlockN = 128;           // k/v rows a stage
constexpr int kStages = 2;
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kTile = 128 * 128;       // bytes of a 128-row tile
constexpr int kQ = 0;                  // shared-memory offsets (bytes)
constexpr int kK0 = kTile;             // k of stage s at kK0 + 2 s kTile
constexpr int kBars = kTile * (1 + 2 * kStages);
// q_full, k_full[kStages], v_full[kStages], empty[kStages]
constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment
}  // namespace k1

template <bool kLse>
__global__ void __launch_bounds__(k1::kThreads, 1)
flash_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Sq, int Skv,
                           int64_t o_sb, int64_t o_sh, int64_t o_ss,
                           float scale_log2) {
  using namespace k1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM;
  const int n_kv = (Skv + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, kTile);
      sm90::tma_load_4d(smem + kQ, &qmap, q_full, 0, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* kt = smem + kK0 + 2 * s * kTile;
        sm90::mbar_expect_tx(&k_full[s], kTile);
        sm90::tma_load_4d(kt, &kmap, &k_full[s], 0, it * kBlockN, h, b);
        sm90::mbar_expect_tx(&v_full[s], kTile);
        sm90::tma_load_4d(kt + kTile, &vmap, &v_full[s], 0, it * kBlockN, h, b);
      }
    }
  } else {  // consumers: 64 q rows each
    sm90::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* qs = smem + kQ + c * 64 * 128;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (log2 domain)
    float l_run[2] = {0.f, 0.f};              // this thread's partial sums

    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint8_t* kt = smem + kK0 + 2 * s * kTile;
      const uint8_t* vt = kt + kTile;

      // S = q k^T over this warpgroup's 64 rows x 128 kv columns
      float sc[64];
      sm90::mbar_wait(&k_full[s], parity);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n128k16_ss<0, 0>(sc, sm90::desc_sw128(qs + 32 * kk),
                                        sm90::desc_sw128(kt + 32 * kk), kk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scale into the log2 domain, mask kv columns past Skv, row max
      const int kv0 = it * kBlockN;
      float mx[2] = {m_run[0], m_run[1]};
      if (kv0 + kBlockN > Skv) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
          sc[i] = col < Skv ? sc[i] * scale_log2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds at least one unmasked column: mx is finite
        alpha[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mx[0]);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mx[0]);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mx[1]);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mx[1]);
        rs[0] += sc[4 * j] + sc[4 * j + 1];
        rs[1] += sc[4 * j + 2] + sc[4 * j + 3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[8][4];
      sm90::acc_to_a<8>(sc, pa);

      // O += bf16(P) v, v the MN-major B operand
      sm90::mbar_wait(&v_full[s], parity);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        sm90::wgmma_m64n64k16_rs<1>(acc, pa[kk], sm90::desc_sw128(vt + 2048 * kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // finish the row sums across the quad, normalise, store bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const float inv0 = 1.f / l_run[0];
    const float inv1 = 1.f / l_run[1];
    const int row0 = q0 + 64 * c + 16 * warp + g;
    const int row1 = row0 + 8;
    __nv_bfloat16* op = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < Sq) {
        *reinterpret_cast<uint32_t*>(op + row0 * o_ss + col) =
            sm90::pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<uint32_t*>(op + row1 * o_ss + col) =
            sm90::pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
    if (kLse && t == 0) {
      // m_run is in the log2 domain: lse = (m + log2 l) * ln 2
      if (row0 < Sq) {
        lse[static_cast<int64_t>(bh) * Sq + row0] =
            (m_run[0] + log2f(l_run[0])) * 0.6931471805599453f;
      }
      if (row1 < Sq) {
        lse[static_cast<int64_t>(bh) * Sq + row1] =
            (m_run[1] + log2f(l_run[1])) * 0.6931471805599453f;
      }
    }
  }
}

// ------------------------------------------- K9's floor and noexp: mma.sync
namespace mma {

constexpr int kD = 64;               // head dim (template constant of the port)
constexpr int kWarps = 4;
constexpr int kBlockM = 16 * kWarps; // q rows per block
constexpr int kBlockN = 64;          // k/v rows per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;          // padded shared-memory row (elements)

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 from shared memory -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

enum Mode { kSoftmax = 0, kFloor = 1, kNoExp = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_d64_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int H, int Sq,
                          int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                          int64_t k_sb, int64_t k_sh, int64_t k_ss,
                          int64_t v_sb, int64_t v_sh, int64_t v_ss,
                          int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM + warp * 16;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  __nv_bfloat16* op = o + b * o_sb + h * o_sh;

  // q as mma A fragments, loaded once: [k-chunk of 16][4 regs]
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + g + rr * 8;
        uint32_t val = 0u;
        if (row < Sq) {
          val = *reinterpret_cast<const uint32_t*>(
              qp + row * q_ss + kc * 16 + half * 8 + 2 * t);
        }
        qf[kc][half * 2 + rr] = val;
      }
    }
  }

  float acc[kD / 8][4];  // O: 8 column tiles of 8 over D
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // rows g and g+8; kNoExp starts at the reference's -1e30
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int kv0 = 0; kv0 < Skv; kv0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    // stage the k and v tiles: 64 rows x 8 chunks of 16 bytes each
#pragma unroll
    for (int i = 0; i < (kBlockN * kD / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 3;
      const int col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(ks + row * kLd + col) =
          *reinterpret_cast<const uint4*>(kp + (kv0 + row) * k_ss + col);
      *reinterpret_cast<uint4*>(vs + row * kLd + col) =
          *reinterpret_cast<const uint4*>(vp + (kv0 + row) * v_ss + col);
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 columns of the tile
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * kLd + kc * 16 + 2 * t;
        mma_16816(s[nt], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    if constexpr (kMode == kNoExp) {
      // identity for exp on the unscaled logits (Skv % 64 == 0: no mask)
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float sc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        sc[r] = m_run[r] - mx[r];
        m_run[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] -= mx[e >> 1];
        rs[0] += s[nt][0] + s[nt][1];
        rs[1] += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * sc[r] + rs[r];
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        acc[nt][0] *= sc[0];
        acc[nt][1] *= sc[0];
        acc[nt][2] *= sc[1];
        acc[nt][3] *= sc[1];
      }
    }  // kFloor: P is S itself

    // O += P v: the S accumulator of tiles (2kc, 2kc+1) is the A fragment
    // of k-chunk kc; v's B fragment is gathered from row-major shared memory
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = sm90::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = sm90::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = sm90::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = sm90::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        const __nv_bfloat16* vc = vs + (kc * 16 + 2 * t) * kLd + nt * 8 + g;
        mma_16816(acc[nt], pa, pack_bf16(vc[0], vc[kLd]),
                  pack_bf16(vc[8 * kLd], vc[9 * kLd]));
      }
    }
  }

  // finish the row sums across the quad, normalise, store bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // kNoExp: acc / (l + 1); kFloor: acc
  const float inv0 = kMode == kFloor ? 1.f : 1.f / (l_run[0] + 1.f);
  const float inv1 = kMode == kFloor ? 1.f : 1.f / (l_run[1] + 1.f);
  const int row0 = q0 + g;
  const int row1 = q0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(op + row0 * o_ss + col) =
          sm90::pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(op + row1 * o_ss + col) =
          sm90::pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
    }
  }
}

}  // namespace mma

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of bf16 tensors
// viewed as [B, H, S, 64] with unit stride on the last dim; strides are in
// elements (multiples of 8, 16-byte aligned bases: what TMA takes). `lse` is
// null (serving) or an fp32 [B*H, Sq] buffer (training). `mode` is kSoftmax
// (K1, K2's v1 and unroll2, K9's v2), which runs K1's wgmma kernel, or K9's
// kFloor or kNoExp (no LSE, Skv a multiple of 64), which run the mma.sync
// kernel. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it refuses, a tensor map the driver
// refuses included).
extern "C" int wiw_flash_attn_fwd_d64(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int Sq, int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int mode,
    void* stream) {
  using mma::kFloor;
  using mma::kNoExp;
  using mma::kSoftmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kSoftmax) {
    CUtensorMap qm, km, vm;
    if (!sm90_head_map(&qm, q, B, H, Sq, q_sb, q_sh, q_ss, k1::kBlockM) ||
        !sm90_head_map(&km, k, B, H, Skv, k_sb, k_sh, k_ss, k1::kBlockN) ||
        !sm90_head_map(&vm, v, B, H, Skv, v_sb, v_sh, v_ss, k1::kBlockN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = lse != nullptr ? flash_attn_fwd_sm90_kernel<true>
                                 : flash_attn_fwd_sm90_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k1::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + k1::kBlockM - 1) / k1::kBlockM, B * H);
    kernel<<<grid, k1::kThreads, k1::kSmem, st>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
        H, Sq, Skv, o_sb, o_sh, o_ss, sm_scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
  }
  if (lse != nullptr || (mode != kFloor && mode != kNoExp) ||
      Skv % mma::kBlockN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + mma::kBlockM - 1) / mma::kBlockM, B * H);
  auto kernel = mode == kFloor ? mma::flash_attn_fwd_d64_mma_kernel<kFloor>
                               : mma::flash_attn_fwd_d64_mma_kernel<kNoExp>;
  kernel<<<grid, mma::kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Sq, Skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss);
  return static_cast<int>(cudaGetLastError());
}
