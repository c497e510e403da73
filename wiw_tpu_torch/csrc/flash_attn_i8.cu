// K10: attention with an int8 q k^T for Hopper (sm_90a), head_dim 64.
//
// Replaces `_kernel_i8qk` of scripts/probe_int8_attention.py, the
// reference's probe of SageAttention-style int8 attention (a clone of its
// v2 flash kernel): q8 and k8 int8 [B*H, S, 64], S = q8 k8^T in int32 times
// `qk_scale` in fp32, K1's online softmax (natural exp, running max from
// -1e30, the output and its denominator rescaled by exp(m - m_new) each kv
// block), and then either
//   * bf16 PV: P rounded to bf16 against bf16 v, fp32 sums, or
//   * int8 PV (`i8pv`): p8 = trunc(P * 127 + 0.5) against int8 v, int32
//     sums, times 1/127;
// v has Dv = 65 columns: column 64 is the reference's ones column, whose
// product is the softmax denominator. The output is acc / acc[:, 64] over
// all 65 columns, bf16 [B*H, S, 65] (column 64 is 1), the reference's
// layout. P's values (and p8's rounding) depend on the running max at each
// kv block, so the result depends on the block width: 64 here, and the
// plain version takes it.
//
// What bounds it on this card: like K1, the two products (~4 S^2 D flops a
// head against ~4 S D bytes) far above the ~295 flop/byte ridge, so the
// tensor cores and the softmax between them. The design is K1's: one block
// of 4 warps per 64 q rows, 64-row k/v tiles staged in shared memory, q k^T
// on mma.sync m16n8k32 s8 (int32 accumulators), the softmax in registers.
// bf16 PV reuses the S accumulator layout as the A operand of m16n8k16, as
// K1 does. int8 PV needs the A operand of m16n8k32 (4 consecutive k a
// thread) where the accumulator holds 2 consecutive columns of each 8-wide
// tile: the PV sum runs over the kv index, so the kernel permutes that index
// in both operands (logical k 4t..4t+3 is kv 2t, 2t+1, 8+2t, 9+2t of the
// 32-wide chunk), which puts P in place with no shuffle; v is staged
// transposed so that the B operand's pairs are 2-byte loads. Column 64 is a
// per-row scalar accumulator beside the 64-wide MMA tile (a thread's
// partial sums, one quad shuffle: exact in int32 for i8pv). v's 65-element
// rows are not 16-byte aligned, so v is staged element by element. Simple
// first version: no cp.async/TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kDv = kD + 1;
constexpr int kWarps = 4;
constexpr int kBlockM = 16 * kWarps;
constexpr int kBlockN = 64;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdK = kD + 16;       // k8 rows in shared memory, bytes
constexpr int kLdV = kD + 8;        // bf16 v rows, elements
constexpr int kLdVt = kBlockN + 8;  // transposed int8 v rows, bytes

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p8 = trunc(p * 127 + 0.5), the reference's two roundings
__device__ __forceinline__ int p8_of(float p) {
  return __float2int_rz(__fadd_rn(__fmul_rn(p, 127.f), 0.5f));
}

__device__ __forceinline__ uint32_t bytes4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

template <bool kI8Pv>
__global__ void __launch_bounds__(kThreads)
flash_attn_i8qk_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                       const void* __restrict__ v_, __nv_bfloat16* __restrict__ o,
                       int S, float qk_scale) {
  __shared__ __align__(16) int8_t ks[kBlockN * kLdK];
  // bf16 PV: v [64 kv][72] bf16; int8 PV: v^T [64 d][72 kv] int8
  __shared__ __align__(16) uint8_t vsm[kBlockN * kLdV * 2];
  __shared__ float v64[kBlockN];  // column 64 of the tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM + warp * 16;
  const int8_t* qp = q + bh * S * kD;
  const int8_t* kp = k + bh * S * kD;
  __nv_bfloat16* op = o + bh * S * kDv;

  // q as m16n8k32 A fragments: [k-chunk of 32][4 regs]
  uint32_t qf[kD / 32][4];
#pragma unroll
  for (int kc = 0; kc < kD / 32; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + (r & 1) * 8;
      qf[kc][r] = row < S ? *reinterpret_cast<const uint32_t*>(
                                qp + static_cast<int64_t>(row) * kD + kc * 32 +
                                (r >> 1) * 16 + 4 * t)
                          : 0u;
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float acc64[2] = {0.f, 0.f};  // this thread's partial column-64 sums
  float m_run[2] = {-1e30f, -1e30f};

  for (int kv0 = 0; kv0 < S; kv0 += kBlockN) {
    __syncthreads();
    // k tile: 64 rows x 64 bytes, 16-byte chunks
#pragma unroll
    for (int i = 0; i < (kBlockN * kD / 16) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2;
      const int col = (c & 3) * 16;
      *reinterpret_cast<uint4*>(ks + row * kLdK + col) =
          *reinterpret_cast<const uint4*>(kp + static_cast<int64_t>(kv0 + row) * kD + col);
    }
    // v tile: 64 rows x 65 elements
    for (int c = tid; c < kBlockN * kDv; c += kThreads) {
      const int row = c / kDv;
      const int col = c - row * kDv;
      const int64_t src = (bh * S + kv0 + row) * kDv + col;
      if constexpr (kI8Pv) {
        const int8_t val = static_cast<const int8_t*>(v_)[src];
        if (col < kD) {
          reinterpret_cast<int8_t*>(vsm)[col * kLdVt + row] = val;
        } else {
          v64[row] = static_cast<float>(val);
        }
      } else {
        const __nv_bfloat16 val = static_cast<const __nv_bfloat16*>(v_)[src];
        if (col < kD) {
          reinterpret_cast<__nv_bfloat16*>(vsm)[row * kLdV + col] = val;
        } else {
          v64[row] = __bfloat162float(val);
        }
      }
    }
    __syncthreads();

    // S = q8 k8^T (int32), then * qk_scale in fp32
    int si[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
    for (int kc = 0; kc < kD / 32; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const int8_t* kr = ks + (nt * 8 + g) * kLdK + kc * 32 + 4 * t;
        mma_s8(si[nt], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 16));
      }
    }
    float s[kBlockN / 8][4];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __fmul_rn(__int2float_rn(si[nt][e]), qk_scale);
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      sc[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
    }
    const int kv_c = 2 * t;  // this thread's columns in each 8-wide tile

    if constexpr (!kI8Pv) {
      // column 64 and the 64-wide product, both on bf16-rounded P
      float r64[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pb = __bfloat162float(__float2bfloat16_rn(s[nt][e]));
          r64[e >> 1] += pb * v64[nt * 8 + kv_c + (e & 1)];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) acc64[r] = acc64[r] * sc[r] + r64[r];
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        acc[nt][0] *= sc[0];
        acc[nt][1] *= sc[0];
        acc[nt][2] *= sc[1];
        acc[nt][3] *= sc[1];
      }
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(vsm);
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
        pa[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
        pa[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const __nv_bfloat16* vc = vs + (kc * 16 + 2 * t) * kLdV + nt * 8 + g;
          mma_bf16(acc[nt], pa, pack_bf16(vc[0], vc[kLdV]),
                   pack_bf16(vc[8 * kLdV], vc[9 * kLdV]));
        }
      }
    } else {
      // p8, and column 64 in exact int32 over the block (quad-reduced)
      int p8[kBlockN / 8][4];
      int r64[2] = {0, 0};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p8[nt][e] = p8_of(s[nt][e]);
          r64[e >> 1] += p8[nt][e] * static_cast<int>(v64[nt * 8 + kv_c + (e & 1)]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        r64[r] += __shfl_xor_sync(0xffffffffu, r64[r], 1);
        r64[r] += __shfl_xor_sync(0xffffffffu, r64[r], 2);
      }
      int pv[kD / 8][4];
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) pv[nt][0] = pv[nt][1] = pv[nt][2] = pv[nt][3] = 0;
      const int8_t* vt = reinterpret_cast<const int8_t*>(vsm);
#pragma unroll
      for (int kc = 0; kc < kBlockN / 32; ++kc) {
        // logical k 4t..4t+3 of this 32-wide chunk = kv 2t, 2t+1, 8+2t, 9+2t
        // (tiles 4kc, 4kc+1); 16+4t.. = tiles 4kc+2, 4kc+3
        const int b = 4 * kc;
        uint32_t pa[4];
        pa[0] = bytes4(p8[b][0], p8[b][1], p8[b + 1][0], p8[b + 1][1]);
        pa[1] = bytes4(p8[b][2], p8[b][3], p8[b + 1][2], p8[b + 1][3]);
        pa[2] = bytes4(p8[b + 2][0], p8[b + 2][1], p8[b + 3][0], p8[b + 3][1]);
        pa[3] = bytes4(p8[b + 2][2], p8[b + 2][3], p8[b + 3][2], p8[b + 3][3]);
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const int8_t* vr = vt + (nt * 8 + g) * kLdVt + kc * 32 + kv_c;
          const uint32_t b0 =
              static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vr)) |
              (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vr + 8)) << 16);
          const uint32_t b1 =
              static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vr + 16)) |
              (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vr + 24)) << 16);
          mma_s8(pv[nt], pa, b0, b1);
        }
      }
      constexpr float kInv127 = 1.0f / 127.0f;
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[nt][e] = __fadd_rn(__fmul_rn(acc[nt][e], sc[e >> 1]),
                                 __fmul_rn(__int2float_rn(pv[nt][e]), kInv127));
        }
      }
      // column 64: the quad's sum is in every lane; lane t == 0 keeps it
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float add = t == 0 ? __fmul_rn(__int2float_rn(r64[r]), kInv127) : 0.f;
        acc64[r] = __fadd_rn(__fmul_rn(acc64[r], sc[r]), add);
      }
    }
  }

  // finish column 64 across the quad, divide, store 65 bf16 columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 1);
    acc64[r] += __shfl_xor_sync(0xffffffffu, acc64[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = op + static_cast<int64_t>(row) * kDv;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      orow[col] = __float2bfloat16_rn(__fdiv_rn(acc[nt][2 * r], acc64[r]));
      orow[col + 1] = __float2bfloat16_rn(__fdiv_rn(acc[nt][2 * r + 1], acc64[r]));
    }
    if (t == 0) orow[kD] = __float2bfloat16_rn(__fdiv_rn(acc64[r], acc64[r]));
  }
}

}  // namespace

// C entry, bound with ctypes: q8, k8 int8 [BH, S, 64] contiguous; v bf16
// (i8pv 0) or int8 (i8pv 1) [BH, S, 65] contiguous; o bf16 [BH, S, 65].
// S a multiple of 64. Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for what it refuses).
extern "C" int wiw_flash_attn_i8qk(const void* q8, const void* k8,
                                   const void* v, void* o, int BH, int S,
                                   float qk_scale, int i8pv, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || S % kBlockN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(S / kBlockM, BH);
  auto kernel = i8pv ? flash_attn_i8qk_kernel<true> : flash_attn_i8qk_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v,
      static_cast<__nv_bfloat16*>(o), S, qk_scale);
  return static_cast<int>(cudaGetLastError());
}
