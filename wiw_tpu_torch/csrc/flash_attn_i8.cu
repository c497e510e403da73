// K10: attention with an int8 q k^T for Hopper (sm_90a), head_dim 64.
//
// Replaces `_kernel_i8qk` of scripts/probe_int8_attention.py, the
// reference's probe of SageAttention-style int8 attention (a clone of its
// v2 flash kernel): q8 and k8 int8 [B*H, S, 64], S = q8 k8^T in int32 times
// `qk_scale` in fp32, the online softmax (running max from -1e30, the
// output and its denominator rescaled by exp(m - m_new) each kv block), and
// then either
//   * bf16 PV: P rounded to bf16 against bf16 v, fp32 sums, or
//   * int8 PV (`i8pv`): p8 = trunc(P * 127 + 0.5) against int8 v, int32
//     sums, times 1/127;
// v has Dv = 65 columns: column 64 is the reference's ones column, whose
// product is the softmax denominator. The output is acc / acc[:, 64] over
// all 65 columns, bf16 [B*H, S, 65] (column 64 is 1), the reference's
// layout. P's values (and p8's rounding) depend on the running max at each
// kv block, so the result depends on the block width: 128 here (kBlockN),
// and the plain version takes it.
//
// What bounds it on this card: like K1, the two products (~4 S^2 D
// operations a head against ~4 S D bytes) far above the ~295 op/byte
// ridge, so the tensor cores and the softmax between them. q k^T runs at
// the int8 rate (1979 TOPS, twice bf16's), and with i8pv so does PV; the
// softmax, which bounds K1 at D 64, is the same work a logit.
//
// Design, K1's (csrc/flash_attn_fwd.cu) with int8 operands:
//   * One CTA per (batch*head, 128 q rows): 3 warpgroups, 384 threads.
//     Warpgroup 0 is the producer (setmaxnreg 24; one thread issues every
//     TMA copy), warpgroups 1 and 2 the consumers, 64 q rows each.
//   * q8 is loaded once by TMA; k8 and v come in 128-row stages through a
//     ring of kStages = 2, each with a full mbarrier for k, one for v and
//     its column 64, and an empty mbarrier the 8 consumer warps release.
//     q8 and k8 rows are 64 bytes: 64-byte swizzle (sm90::desc_sw64).
//   * S = q8 k8^T: 2 x wgmma.m64n128k32.s32.s8.s8, both operands K-major in
//     shared memory. The int32 sums (|S| <= 64 * 128^2 < 2^22) become fp32
//     exactly by the 1.5 * 2^23 bit trick on the integer pipe, not I2F
//     (which issues at the rate of exp2). The scale and log2(e) are folded
//     into one multiply and exp becomes ex2.approx.ftz, as K1 does: P
//     differs from the reference's exp(s - m) in its last bits, so a bf16
//     rounding of P or a p8 rounding may land one step apart (PERF.md §6).
//   * bf16 PV: as K1, 8 x wgmma.m64n64k16 with bf16(P) as the register A
//     operand and v the MN-major B operand read through the transpose bit.
//     Column 64 rides the same products: 8 x wgmma.m64n8k16 with the same
//     A fragments against an 8-wide B whose column 0 is v's column 64
//     (columns 1-7 zero), no swizzle: the denominator is the fp32 sum of
//     bf16(P) v[:, 64], as the reference's, on the tensor cores.
//   * int8 PV: p8 (the reference's two roundings, then the floor as the
//     low byte of z + 2^23 rounded down) packed by byte permutes into the
//     s8 register A operand of 4 x wgmma.m64n64k32.s32.s8.s8. 8-bit wgmma
//     has no transpose bit, so B is K-major along kv: v8 arrives as
//     [B*H, 64, S]. The accumulator gives a thread kv 2t, 2t+1 of each
//     8-wide block, the A fragment wants k 4t..4t+3: inside each 32-wide
//     chunk logical k 4t..4t+3 is kv 2t, 2t+1, 8+2t, 9+2t (16 + 4t.. is
//     16 + the same), and v8's kv index is permuted alike, so the sum over
//     kv is unchanged and P needs no shuffle. Column 64, permuted the same
//     way, is a per-row int32 dot product of the A bytes (dp4a; exact),
//     summed across the quad. Each block's int32 PV is converted exactly
//     and added as the reference does: acc * scale + pv * (1 / 127).
//   * v's 65-element rows (130 or 65 bytes) are read by neither TMA nor
//     16-byte copies, so the wrapper repacks v once per call
//     (ops/int8_attention.repack_v): bf16 into [B*H, S, 64] and the column
//     as [B*H, S, 8]; int8 into the permuted [B*H, 64, S] and the permuted
//     column [B*H, S]. The column arrives by a bulk copy on v's barrier.
//   * Output: each consumer warpgroup writes its 64 rows of 65 bf16 into
//     shared memory and one thread stores the 8320 contiguous bytes by a
//     bulk copy.
//   * Shared memory: q8 8 KB + 2 stages x (k8 8 KB + v 16 KB (bf16) or
//     8 KB (int8) + column 2 KB) + the output 16.25 KB + barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;
constexpr int kDv = kD + 1;
constexpr int kBlockM = 128;               // q rows a CTA
constexpr int kBlockN = 128;               // kv rows a stage
constexpr int kStages = 2;
constexpr int kThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kQBytes = kBlockM * kD;      // q8 tile: 128 rows x 64 bytes
constexpr int kKBytes = kBlockN * kD;      // k8 tile
constexpr int kOutBytes = 64 * kDv * 2;    // a consumer's 64 output rows

template <bool kI8Pv>
struct Layout {
  // v's tile: bf16 [128 kv][64] or int8 [64 d][128 kv], 128-byte swizzled
  static constexpr int kV = kI8Pv ? kD * kBlockN : kBlockN * kD * 2;
  // column 64: bf16 [128 kv][8] (column 0 the values) or int8 [128 kv]
  static constexpr int kCol = kI8Pv ? kBlockN : kBlockN * 8 * 2;
  static constexpr int kStage = kKBytes + kV + 2048;  // 1024-byte multiples
  static constexpr int kS0 = kQBytes;                 // stage s at kS0 + s kStage
  static constexpr int kOut = kS0 + kStages * kStage;
  static constexpr int kBars = kOut + 2 * kOutBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// an int32 of magnitude below 2^22 as fp32, exactly, without I2F
__device__ __forceinline__ float int_to_float(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// p8 = trunc(p * 127 + 0.5) for p in [0, 1], the reference's two roundings,
// in the low byte: z + 2^23 rounded down is 2^23 + floor(z), exactly
__device__ __forceinline__ uint32_t p8_bits(float p) {
  return __float_as_uint(
      __fadd_rd(__fadd_rn(__fmul_rn(p, 127.f), 0.5f), 8388608.f));
}

// four p8 as one s8 A register, a in the lowest byte
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(p8_bits(a), p8_bits(b), 0x0040),
                     __byte_perm(p8_bits(c), p8_bits(d), 0x0040), 0x5410);
}

template <bool kI8Pv>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_i8qk_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const uint8_t* __restrict__ vcol,
                            __nv_bfloat16* __restrict__ o, int S,
                            float scale_log2) {
  using L = Layout<kI8Pv>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int row0 = bh * S;  // this head's first row in [B*H*S, ...]
  const int q0 = blockIdx.x * kBlockM;
  const int n_kv = S / kBlockN;

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
      sm90::mbar_expect_tx(q_full, kQBytes);
      sm90::tma_load_2d(smem, &qmap, q_full, 0, row0 + q0);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const int kv0 = it * kBlockN;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* st = smem + L::kS0 + s * L::kStage;
        sm90::mbar_expect_tx(&k_full[s], kKBytes);
        sm90::tma_load_2d(st, &kmap, &k_full[s], 0, row0 + kv0);
        sm90::mbar_expect_tx(&v_full[s], L::kV + L::kCol);
        if constexpr (kI8Pv) {
          sm90::tma_load_2d(st + kKBytes, &vmap, &v_full[s], kv0, bh * kD);
        } else {
          sm90::tma_load_2d(st + kKBytes, &vmap, &v_full[s], 0, row0 + kv0);
        }
        sm90::bulk_load(st + kKBytes + L::kV,
                        vcol + static_cast<int64_t>(row0 + kv0) * (L::kCol / kBlockN),
                        L::kCol, &v_full[s]);
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
    const uint8_t* qs = smem + c * 64 * kD;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // the denominator: bf16 PV, the m64n8 accumulator (column 0, lanes
    // t == 0); int8 PV, rows g and g + 8 in [0] and [1], the same in the quad
    float acc64[4] = {0.f, 0.f, 0.f, 0.f};
    float m_run[2] = {-1e30f, -1e30f};  // rows g, g + 8 (log2 domain)

    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint8_t* kt = smem + L::kS0 + s * L::kStage;
      const uint8_t* vt = kt + kKBytes;
      const uint8_t* ct = vt + L::kV;

      // S = q8 k8^T over this warpgroup's 64 rows x 128 kv columns
      int si[64];
      sm90::mbar_wait(&k_full[s], parity);
      sm90::wgmma_fence();
      sm90::wgmma_m64n128k32_s8(si, sm90::desc_sw64(qs), sm90::desc_sw64(kt), 0);
      sm90::wgmma_m64n128k32_s8(si, sm90::desc_sw64(qs + 32),
                                sm90::desc_sw64(kt + 32), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(si);

      // logits in the log2 domain, row max, P = exp2(S - m)
      float sc[64];
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = int_to_float(si[i]) * scale_log2;
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
        alpha[r] = ex2(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = ex2(sc[i] - mx[(i >> 1) & 1]);

      if constexpr (!kI8Pv) {
        uint32_t pa[8][4];
        sm90::acc_to_a<8>(sc, pa);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        acc64[0] *= alpha[0];
        acc64[1] *= alpha[0];
        acc64[2] *= alpha[1];
        acc64[3] *= alpha[1];
        // O += bf16(P) v (v MN-major), and the column: [128 kv][8] dense,
        // one 8 x 16-byte core matrix per 8 kv, 128 bytes apart
        sm90::mbar_wait(&v_full[s], parity);
        sm90::fence_regs(acc);
        sm90::fence_regs(acc64);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          sm90::wgmma_m64n64k16_rs<1>(acc, pa[kk], sm90::desc_sw128(vt + 2048 * kk));
          sm90::wgmma_m64n8k16_rs<1>(acc64, pa[kk],
                                     sm90::desc_plain(ct + 256 * kk, 128, 128));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(acc64);
        sm90::fence_regs(pa);
      } else {
        // p8 as the s8 A fragments of the four 32-wide kv chunks: logical k
        // 4t..4t+3 of chunk kc is kv 2t, 2t+1 of blocks 4kc and 4kc + 1
        // (16 + 4t..: blocks 4kc + 2, 4kc + 3)
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int b = 16 * kc;
          pa[kc][0] = pack_p8(sc[b], sc[b + 1], sc[b + 4], sc[b + 5]);
          pa[kc][1] = pack_p8(sc[b + 2], sc[b + 3], sc[b + 6], sc[b + 7]);
          pa[kc][2] = pack_p8(sc[b + 8], sc[b + 9], sc[b + 12], sc[b + 13]);
          pa[kc][3] = pack_p8(sc[b + 10], sc[b + 11], sc[b + 14], sc[b + 15]);
        }
        // column 64 (permuted as the fragments): exact int32 over this
        // thread's kv, then over the quad
        sm90::mbar_wait(&v_full[s], parity);
        const uint32_t* cw = reinterpret_cast<const uint32_t*>(ct);
        int r64[2] = {0, 0};
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int c0 = static_cast<int>(cw[8 * kc + t]);
          const int c1 = static_cast<int>(cw[8 * kc + 4 + t]);
          r64[0] = __dp4a(static_cast<int>(pa[kc][0]), c0, r64[0]);
          r64[0] = __dp4a(static_cast<int>(pa[kc][2]), c1, r64[0]);
          r64[1] = __dp4a(static_cast<int>(pa[kc][1]), c0, r64[1]);
          r64[1] = __dp4a(static_cast<int>(pa[kc][3]), c1, r64[1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          r64[r] += __shfl_xor_sync(0xffffffffu, r64[r], 1);
          r64[r] += __shfl_xor_sync(0xffffffffu, r64[r], 2);
        }
        int pv[32];
        sm90::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          sm90::wgmma_m64n64k32_s8_rs(pv, pa[kc], sm90::desc_sw128(vt + 32 * kc),
                                      kc > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(pv);
        sm90::fence_regs(pa);
        constexpr float kInv127 = 1.0f / 127.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[(i >> 1) & 1]),
                             __fmul_rn(int_to_float(pv[i]), kInv127));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc64[r] = __fadd_rn(__fmul_rn(acc64[r], alpha[r]),
                               __fmul_rn(int_to_float(r64[r]), kInv127));
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // out = acc / acc[:, 64] over all 65 columns, staged in shared memory
    float den[2];
    if constexpr (kI8Pv) {
      den[0] = acc64[0];
      den[1] = acc64[1];
    } else {
      den[0] = __shfl_sync(0xffffffffu, acc64[0], lane & ~3);
      den[1] = __shfl_sync(0xffffffffu, acc64[2], lane & ~3);
    }
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem + L::kOut + c * kOutBytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* orow = os + (16 * warp + g + 8 * r) * kDv;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        orow[col] = __float2bfloat16_rn(__fdiv_rn(acc[4 * j + 2 * r], den[r]));
        orow[col + 1] = __float2bfloat16_rn(__fdiv_rn(acc[4 * j + 2 * r + 1], den[r]));
      }
      if (t == 0) orow[kD] = __float2bfloat16_rn(__fdiv_rn(den[r], den[r]));
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + c, 128);
    if (tid == 0) {
      sm90::bulk_store(o + static_cast<int64_t>(row0 + q0 + 64 * c) * kDv, os,
                       kOutBytes);
      sm90::bulk_commit();
      sm90::bulk_wait<0>();
    }
  }
}

// the 2-D tensor map of a row-major [rows, cols] matrix of `elem`-byte
// elements, boxes of box_cols x box_rows
bool rows_map(CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
              int elem, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return sm90_tiled_map(map,
                        elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        2, base, dims, strides, box, swizzle);
}

template <bool kI8Pv>
int launch(const void* q8, const void* k8, const void* v, const void* vcol,
           void* o, int BH, int S, float qk_scale, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(BH) * S;
  CUtensorMap qm, km, vm;
  const bool ok =
      rows_map(&qm, q8, rows, kD, 1, kD, kBlockM, CU_TENSOR_MAP_SWIZZLE_64B) &&
      rows_map(&km, k8, rows, kD, 1, kD, kBlockN, CU_TENSOR_MAP_SWIZZLE_64B) &&
      (kI8Pv ? rows_map(&vm, v, static_cast<int64_t>(BH) * kD, S, 1, kBlockN, kD,
                        CU_TENSOR_MAP_SWIZZLE_128B)
             : rows_map(&vm, v, rows, kD, 2, kD, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attn_i8qk_sm90_kernel<kI8Pv>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<kI8Pv>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBlockM, BH);
  kernel<<<grid, kThreads, Layout<kI8Pv>::kSmem, st>>>(
      qm, km, vm, static_cast<const uint8_t*>(vcol),
      static_cast<__nv_bfloat16*>(o), S, qk_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes: q8, k8 int8 [BH, S, 64] contiguous; v and its
// column as ops/int8_attention.repack_v makes them: bf16 [BH, S, 64] and
// [BH, S, 8] (i8pv 0), or int8 [BH, 64, S] and [BH, S] with kv permuted
// within each 32 (i8pv 1), all contiguous and 16-byte aligned; o bf16
// [BH, S, 65] contiguous, 16-byte aligned. S a multiple of 128. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for what it
// refuses, a tensor map the driver refuses included).
extern "C" int wiw_flash_attn_i8qk(const void* q8, const void* k8,
                                   const void* v, const void* vcol, void* o,
                                   int BH, int S, float qk_scale, int i8pv,
                                   void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || S % kBlockN ||
      static_cast<int64_t>(BH) * S > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return i8pv ? launch<true>(q8, k8, v, vcol, o, BH, S, qk_scale, st)
              : launch<false>(q8, k8, v, vcol, o, BH, S, qk_scale, st);
}
