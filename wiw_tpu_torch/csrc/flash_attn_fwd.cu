// Flash-attention forward for Hopper (sm_90a), head_dim 64 (and 72), bf16
// in/out.
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
// K1 at head_dim 72 (the CDiT's heads: hidden 1152 over 16 heads; a serving
// forward, no LSE and no backward) is the template instance kD = 72 of the
// same kernel. A 72-wide bf16 row is 144 bytes and fits no single swizzle
// atom, so every q, k and v tile is read in two parts: its first 64
// columns as at kD = 64 (128-byte swizzle), and a 16-column tail from
// column 64 in the 32-byte swizzle (rows of 32 bytes), through tensor maps
// whose inner extent is 72, so that columns 72-79 arrive as zeros even in a
// head view of a [B, S, H*72] projection, where they would be the next
// head's. S = q k^T takes a fifth k16 step on the q and k tails (their
// zero columns add nothing); O += P v adds an m64n16k16 product a k16 step
// on the v tail into a second accumulator of 8 floats a thread, whose
// columns 72-79 are zero and not stored. Shared memory grows to q 20 KB +
// 2 stages x 40 KB; the kD = 64 instance compiles to what it was, with the
// tail code out of it (`if constexpr`). At the CDiT's shapes (B*H 32, Sq
// 196, Skv 196 or 785) a call is a few microseconds of a short grid
// (2 x 32 CTAs): the ragged q and kv tiles (-inf logits past Skv, no store
// past Sq) are K1's as they were.
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
constexpr int kTile = 128 * 128;       // bytes of a 128-row x 64-column tile
// Shared-memory layout (bytes) of the instance for head_dim kD: q, then a
// stage after another, each k then v. At kD = 72 every q, k or v tile is
// its 64-column part (kTile, 128-byte swizzle) and then its 16-column tail
// (kTail, 32-byte swizzle: columns 64-79, of which 72-79 read as zeros).
template <int kD>
struct Layout {
  static constexpr int kTail = kD == 64 ? 0 : 128 * 32;
  static constexpr int kTileD = kTile + kTail;      // a q, k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK0 = kTileD;              // k of stage s at kK0 + 2 s kTileD
  static constexpr int kBars = kTileD * (1 + 2 * kStages);
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment
};
}  // namespace k1

// the step between the two products: K1's online softmax, or K9's floor
// (none) or noexp (the identity for exp)
enum Mode { kSoftmax = 0, kFloor = 1, kNoExp = 2 };

// kD 64, or 72 (the tail maps qt/kt/vt are read only there; kSoftmax
// without LSE: the CDiT's serving forward)
template <int kMode, bool kLse, int kD>
__global__ void __launch_bounds__(k1::kThreads, 1)
flash_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qtmap,
                           const __grid_constant__ CUtensorMap ktmap,
                           const __grid_constant__ CUtensorMap vtmap,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Sq, int Skv,
                           int64_t o_sb, int64_t o_sh, int64_t o_ss,
                           float scale_log2) {
  static_assert(kD == 64 || (kD == 72 && kMode == kSoftmax && !kLse));
  using namespace k1;
  using L = Layout<kD>;
  constexpr int kQ = L::kQ, kK0 = L::kK0, kBars = L::kBars, kTileD = L::kTileD;
  constexpr bool kTailed = kD != 64;
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
      sm90::mbar_expect_tx(q_full, kTileD);
      sm90::tma_load_4d(smem + kQ, &qmap, q_full, 0, q0, h, b);
      if constexpr (kTailed) {
        sm90::tma_load_4d(smem + kQ + kTile, &qtmap, q_full, 64, q0, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* kt = smem + kK0 + 2 * s * kTileD;
        sm90::mbar_expect_tx(&k_full[s], kTileD);
        sm90::tma_load_4d(kt, &kmap, &k_full[s], 0, it * kBlockN, h, b);
        if constexpr (kTailed) {
          sm90::tma_load_4d(kt + kTile, &ktmap, &k_full[s], 64, it * kBlockN, h, b);
        }
        sm90::mbar_expect_tx(&v_full[s], kTileD);
        sm90::tma_load_4d(kt + kTileD, &vmap, &v_full[s], 0, it * kBlockN, h, b);
        if constexpr (kTailed) {
          sm90::tma_load_4d(kt + kTileD + kTile, &vtmap, &v_full[s], 64,
                            it * kBlockN, h, b);
        }
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
    const uint8_t* qst = smem + kQ + kTile + c * 64 * 32;  // kD 72: q's tail

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float acc_t[8];  // kD 72: output columns 64-79 (72-79 stay 0, not stored)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_t[i] = 0.f;
    // rows g, g + 8 (softmax: in the log2 domain); noexp starts at the
    // reference's -1e30
    constexpr float kInit = kMode == kNoExp ? -1e30f : -INFINITY;
    float m_run[2] = {kInit, kInit};
    float l_run[2] = {0.f, 0.f};  // this thread's partial sums

    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint8_t* kt = smem + kK0 + 2 * s * kTileD;
      const uint8_t* vt = kt + kTileD;

      // S = q k^T over this warpgroup's 64 rows x 128 kv columns (kD 72:
      // a fifth k16 step on the tails)
      float sc[64];
      sm90::mbar_wait(&k_full[s], parity);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n128k16_ss<0, 0>(sc, sm90::desc_sw128(qs + 32 * kk),
                                        sm90::desc_sw128(kt + 32 * kk), kk);
      }
      if constexpr (kTailed) {
        sm90::wgmma_m64n128k16_ss<0, 0>(sc, sm90::desc_sw32(qst),
                                        sm90::desc_sw32(kt + kTile), 1);
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
        if constexpr (kTailed) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc_t[4 * j] *= alpha[0];
            acc_t[4 * j + 1] *= alpha[0];
            acc_t[4 * j + 2] *= alpha[1];
            acc_t[4 * j + 3] *= alpha[1];
          }
        }
      }
      uint32_t pa[8][4];
      sm90::acc_to_a<8>(sc, pa);

      // O += bf16(P) v, v the MN-major B operand (kD 72: and the tail's
      // 16 columns into acc_t, m64n16k16 a k16 step)
      sm90::mbar_wait(&v_full[s], parity);
      sm90::fence_regs(acc);
      if constexpr (kTailed) sm90::fence_regs(acc_t);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        sm90::wgmma_m64n64k16_rs<1>(acc, pa[kk], sm90::desc_sw128(vt + 2048 * kk));
      }
      if constexpr (kTailed) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          sm90::wgmma_m64n16k16_rs<1>(acc_t, pa[kk],
                                      sm90::desc_sw32(vt + kTile + 512 * kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if constexpr (kTailed) sm90::fence_regs(acc_t);
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
    if constexpr (kTailed) {  // columns 64-71
      const int col = 64 + 2 * t;
      if (row0 < Sq) {
        *reinterpret_cast<uint32_t*>(op + row0 * o_ss + col) =
            sm90::pack_bf16(acc_t[0] * inv0, acc_t[1] * inv0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<uint32_t*>(op + row1 * o_ss + col) =
            sm90::pack_bf16(acc_t[2] * inv1, acc_t[3] * inv1);
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

// C entries, bound with ctypes. Pointers are device pointers of bf16
// tensors viewed as [B, H, S, D] with unit stride on the last dim; strides
// are in elements (multiples of 8, 16-byte aligned bases: what TMA takes).
// `lse` is null (serving) or an fp32 [B*H, Sq] buffer (training). `mode` is
// kSoftmax (K1, K2's v1 and unroll2, K9's v2) or K9's kFloor or kNoExp (no
// LSE, Skv a multiple of kBlockN: no ragged tile to mask); every mode runs
// the one kernel above. The D = 72 entry takes kSoftmax without LSE only.
// Each launches on `stream` and returns cudaGetLastError()
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
  auto kernel = mode == kFloor   ? flash_attn_fwd_sm90_kernel<kFloor, false, 64>
                : mode == kNoExp ? flash_attn_fwd_sm90_kernel<kNoExp, false, 64>
                : lse != nullptr ? flash_attn_fwd_sm90_kernel<kSoftmax, true, 64>
                                 : flash_attn_fwd_sm90_kernel<kSoftmax, false, 64>;
  constexpr int kSmem = k1::Layout<64>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + k1::kBlockM - 1) / k1::kBlockM, B * H);
  // the tail maps are not read at D = 64
  kernel<<<grid, k1::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, qm, km, vm, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, o_sb, o_sh, o_ss,
      sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wiw_flash_attn_fwd_d72(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int Sq, int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int mode,
    void* stream) {
  if (mode != kSoftmax || lse != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 64-column parts in the 128-byte swizzle, the 16-column tails (at
  // column 64 of a map 72 wide) in the 32-byte swizzle
  constexpr auto kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr auto kSw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  constexpr int kM = k1::kBlockM, kN = k1::kBlockN;
  CUtensorMap qm, km, vm, qt, kt, vt;
  if (!sm90_head_map(&qm, q, B, H, Sq, q_sb, q_sh, q_ss, kM, 72, 64, kSw128) ||
      !sm90_head_map(&km, k, B, H, Skv, k_sb, k_sh, k_ss, kN, 72, 64, kSw128) ||
      !sm90_head_map(&vm, v, B, H, Skv, v_sb, v_sh, v_ss, kN, 72, 64, kSw128) ||
      !sm90_head_map(&qt, q, B, H, Sq, q_sb, q_sh, q_ss, kM, 72, 16, kSw32) ||
      !sm90_head_map(&kt, k, B, H, Skv, k_sb, k_sh, k_ss, kN, 72, 16, kSw32) ||
      !sm90_head_map(&vt, v, B, H, Skv, v_sb, v_sh, v_ss, kN, 72, 16, kSw32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_attn_fwd_sm90_kernel<kSoftmax, false, 72>;
  constexpr int kSmem = k1::Layout<72>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kM - 1) / kM, B * H);
  kernel<<<grid, k1::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, qt, kt, vt, static_cast<__nv_bfloat16*>(o), nullptr, H, Sq,
      Skv, o_sb, o_sh, o_ss, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
