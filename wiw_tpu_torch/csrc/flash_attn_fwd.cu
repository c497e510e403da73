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
// K1's design (`flash_attn_fwd_sm90_kernel`, a redesign of the port's
// first version of this kernel), which K2 and K9 run too:
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
//     tune_attention2.py:78, :95; ablations with no model caller) are the
//     template modes kFloor and kNoExp of the same kernel: the producer,
//     the TMA ring and both products are K1's, only the step between the
//     products differs. floor has none: P = bf16(q k^T) on the unscaled
//     logits, O = the sum over stages of P v, rounded once. noexp is the
//     loop with exp2 replaced by the identity on the unscaled logits:
//     m_new = max(m, rowmax S) from the reference's -1e30, P = S - m_new,
//     the output and the denominator (the fp32 sum of the unrounded P)
//     scaled by m - m_new, O = acc / (denominator + 1). Its values depend
//     on the running max at each kv block, so its plain version takes K1's
//     stage of 128 as `bkv` (the reference's probe runs at 512). Both take
//     Skv a multiple of 128: there is no ragged stage to mask.
//     What bounds them is K1's bound, the two products on the tensor cores
//     (3.08 ms at B*H 140, S 9216); floor converts each logit to bf16 and
//     noexp adds K1's max, sums and rescale without its exp2, so both sit
//     between that bound and K1's time, each warpgroup's chain (S, the step,
//     P v) overlapped by the other warpgroup's products.

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

// the step between the two products: K1's online softmax, or K9's floor
// (none) or noexp (the identity for exp)
enum Mode { kSoftmax = 0, kFloor = 1, kNoExp = 2 };

template <int kMode, bool kLse>
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
    // rows g, g + 8 (softmax: in the log2 domain); noexp starts at the
    // reference's -1e30
    constexpr float kInit = kMode == kNoExp ? -1e30f : -INFINITY;
    float m_run[2] = {kInit, kInit};
    float l_run[2] = {0.f, 0.f};  // this thread's partial sums

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

      if constexpr (kMode != kFloor) {  // kFloor: P is S itself, unscaled
        // softmax: scale into the log2 domain and mask kv columns past Skv;
        // noexp: unscaled logits (Skv % kBlockN == 0: no column to mask)
        if constexpr (kMode == kSoftmax) {
          const int kv0 = it * kBlockN;
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
        }
        // exp2, or noexp's identity in its place
        auto ex = [](float z) { return kMode == kSoftmax ? exp2f(z) : z; };
        float mx[2] = {m_run[0], m_run[1]};
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
          alpha[r] = ex(m_run[r] - mx[r]);
          m_run[r] = mx[r];
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sc[4 * j] = ex(sc[4 * j] - mx[0]);
          sc[4 * j + 1] = ex(sc[4 * j + 1] - mx[0]);
          sc[4 * j + 2] = ex(sc[4 * j + 2] - mx[1]);
          sc[4 * j + 3] = ex(sc[4 * j + 3] - mx[1]);
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

    // finish the row sums across the quad, normalise (softmax: acc / l;
    // noexp: acc / (l + 1); floor: acc), store bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    constexpr float kOne = kMode == kNoExp ? 1.f : 0.f;
    const float inv0 = kMode == kFloor ? 1.f : 1.f / (l_run[0] + kOne);
    const float inv1 = kMode == kFloor ? 1.f : 1.f / (l_run[1] + kOne);
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


}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of bf16 tensors
// viewed as [B, H, S, 64] with unit stride on the last dim; strides are in
// elements (multiples of 8, 16-byte aligned bases: what TMA takes). `lse` is
// null (serving) or an fp32 [B*H, Sq] buffer (training). `mode` is kSoftmax
// (K1, K2's v1 and unroll2, K9's v2) or K9's kFloor or kNoExp (no LSE, Skv
// a multiple of kBlockN: no ragged tile to mask); every mode runs the one
// kernel above. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it refuses, a tensor map the driver
// refuses included).
extern "C" int wiw_flash_attn_fwd_d64(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int Sq, int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int mode,
    void* stream) {
  if (mode != kSoftmax &&
      ((mode != kFloor && mode != kNoExp) || lse != nullptr || Skv % k1::kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap qm, km, vm;
  if (!sm90_head_map(&qm, q, B, H, Sq, q_sb, q_sh, q_ss, k1::kBlockM) ||
      !sm90_head_map(&km, k, B, H, Skv, k_sb, k_sh, k_ss, k1::kBlockN) ||
      !sm90_head_map(&vm, v, B, H, Skv, v_sb, v_sh, v_ss, k1::kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = mode == kFloor   ? flash_attn_fwd_sm90_kernel<kFloor, false>
                : mode == kNoExp ? flash_attn_fwd_sm90_kernel<kNoExp, false>
                : lse != nullptr ? flash_attn_fwd_sm90_kernel<kSoftmax, true>
                                 : flash_attn_fwd_sm90_kernel<kSoftmax, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k1::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + k1::kBlockM - 1) / k1::kBlockM, B * H);
  kernel<<<grid, k1::kThreads, k1::kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      H, Sq, Skv, o_sb, o_sh, o_ss, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
