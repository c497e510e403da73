// Flash-attention forward for Hopper (sm_90a), head_dim 64, bf16 in/out.
//
// Replaces the TPU kernel `_attn_kernel_v2` in wiw_tpu/ops/pallas_attention.py
// (reached from `flash_attention_bhsd(kernel="v2")`): non-causal
// softmax(q k^T / sqrt(D)) v with fp32 accumulation and an fp32 online softmax,
// so the [S, S] logits never reach device memory.
//
// What bounds it on this card: at the UNet's shapes (S = 9216 and 2304, D = 64)
// the work is ~4*S*S*D flops per (batch, head) against ~4*S*D bytes of q/k/v/o,
// far above the H100's ~295 flop/byte ridge, so the kernel is bound by the
// tensor cores and by the exp/max/sum softmax work between the two products.
// The design keeps both products on the tensor cores (mma.sync m16n8k16 bf16
// with fp32 accumulators) and keeps the softmax in registers: the QK^T
// accumulator fragment of a warp is laid out exactly as the A operand of the
// PV product, so P goes from registers to the tensor cores without a trip
// through shared memory (the TPU kernel's ones column in V, which made the
// MXU sum the denominator, is not needed: each thread keeps partial row sums
// and one quad shuffle finishes them at the end).
//
// Layout: one block per (batch*head, 64-row q tile); 4 warps, 16 q rows each.
// Each block loops over 64-row k/v tiles staged in shared memory (16-byte
// loads, rows padded to 72 elements so the fragment loads are conflict-free).
// q, k, v and o are read and written through (batch, head, row) strides with a
// unit stride on D, so the projections' [B, S, H*D] layout needs no transpose
// (Hopper has no sublane constraint, which blocked the TPU's strided variant).
// Rows past S are masked: the ragged tail is zero-filled in shared memory and
// its logits set to -inf; q rows past S are computed on zeros and not stored.
// This is the simple first version: no cp.async/TMA pipelining, no wgmma, no
// warp specialisation.
//
// Training: the template flag kLse also stores each q row's log-sum-exp
// (natural log of sum_j exp(scale * q.k_j), fp32, [B*H, Sq] contiguous),
// which the backward (flash_attn_bwd.cu, K3) needs to recompute P. With the
// flag off (serving) the kernel is the same code and writes no LSE; the
// output bits are the same either way.
//
// K2: the reference's v1 kernels, `_attn_kernel` and `_attn_kernel_unroll2`
// (pallas_attention.py:40-118, `flash_attention_bhsd(kernel="v1")`). v1's
// arithmetic (the scale applied to the fp32 logits, P rounded to bf16 for
// the PV product, the denominator the fp32 sum of the unrounded P) is
// already what this kernel does for K1: the TPU's v2 moved the scale onto
// q in bf16 and the denominator into the PV product only to save VPU work.
// So v1 without unroll2 is this kernel as it stands, and `unroll2` is the
// template parameter kTiles = 2: each iteration stages two 64-row k/v tiles
// and takes one running max over both before their exponentials and PV
// products, as `_attn_kernel_unroll2` does with its two kv blocks (the
// independent products and exponentials of two tiles give the scheduler
// more to overlap). It needs Skv a multiple of 128, as the reference needs
// Skv % (2 * bkv) == 0; the wrapper takes the one-tile loop otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 from shared memory -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <bool kLse, int kTiles>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_d64_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq,
                          int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                          int64_t k_sb, int64_t k_sh, int64_t k_ss,
                          int64_t v_sb, int64_t v_sh, int64_t v_ss,
                          int64_t o_sb, int64_t o_sh, int64_t o_ss,
                          float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTiles * kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kTiles * kBlockN * kLd];

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
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8 (log2 domain)
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int kv0 = 0; kv0 < Skv; kv0 += kTiles * kBlockN) {
    __syncthreads();  // every warp is done with the previous tiles
    // stage the k and v tiles: kTiles x 64 rows x 8 chunks of 16 bytes each
#pragma unroll
    for (int i = 0; i < (kTiles * kBlockN * kD / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 3;
      const int col = (c & 7) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + row < Skv) {
        kval = *reinterpret_cast<const uint4*>(kp + (kv0 + row) * k_ss + col);
        vval = *reinterpret_cast<const uint4*>(vp + (kv0 + row) * v_ss + col);
      }
      *reinterpret_cast<uint4*>(ks + row * kLd + col) = kval;
      *reinterpret_cast<uint4*>(vs + row * kLd + col) = vval;
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 columns of each tile
    float s[kTiles][kBlockN / 8][4];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        s[u][nt][0] = s[u][nt][1] = s[u][nt][2] = s[u][nt][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
          const __nv_bfloat16* kr =
              ks + (u * kBlockN + nt * 8 + g) * kLd + kc * 16 + 2 * t;
          mma_16816(s[u][nt], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }

    // scale into the log2 domain, mask the ragged tail, one row max over
    // the iteration's tiles
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + u * kBlockN + nt * 8 + 2 * t + (e & 1);
          s[u][nt][e] = col < Skv ? s[u][nt][e] * scale_log2 : -INFINITY;
        }
        mx[0] = fmaxf(mx[0], fmaxf(s[u][nt][0], s[u][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[u][nt][2], s[u][nt][3]));
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every iteration holds at least one unmasked column, so mx is finite
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }

    // P = exp2(S - m); partial row sums; rescale the running output
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        s[u][nt][0] = exp2f(s[u][nt][0] - mx[0]);
        s[u][nt][1] = exp2f(s[u][nt][1] - mx[0]);
        s[u][nt][2] = exp2f(s[u][nt][2] - mx[1]);
        s[u][nt][3] = exp2f(s[u][nt][3] - mx[1]);
        rs[0] += s[u][nt][0] + s[u][nt][1];
        rs[1] += s[u][nt][2] + s[u][nt][3];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // O += P v: the S accumulator of tiles (2kc, 2kc+1) is the A fragment
    // of k-chunk kc; v's B fragment is gathered from row-major shared memory
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_f32(s[u][2 * kc][0], s[u][2 * kc][1]);
        pa[1] = pack_f32(s[u][2 * kc][2], s[u][2 * kc][3]);
        pa[2] = pack_f32(s[u][2 * kc + 1][0], s[u][2 * kc + 1][1]);
        pa[3] = pack_f32(s[u][2 * kc + 1][2], s[u][2 * kc + 1][3]);
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const __nv_bfloat16* vc =
              vs + (u * kBlockN + kc * 16 + 2 * t) * kLd + nt * 8 + g;
          mma_16816(acc[nt], pa, pack_bf16(vc[0], vc[kLd]),
                    pack_bf16(vc[8 * kLd], vc[9 * kLd]));
        }
      }
    }
  }

  // finish the row sums across the quad, normalise, store bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int row0 = q0 + g;
  const int row1 = q0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(op + row0 * o_ss + col) =
          pack_f32(acc[nt][0] * inv0, acc[nt][1] * inv0);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(op + row1 * o_ss + col) =
          pack_f32(acc[nt][2] * inv1, acc[nt][3] * inv1);
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

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of bf16 tensors
// viewed as [B, H, S, 64] with unit stride on the last dim; strides are in
// elements. `lse` is null (serving) or an fp32 [B*H, Sq] buffer (training).
// `tiles` is 1 (K1, K2's v1) or 2 (K2's unroll2: Skv a multiple of 128, no
// LSE). Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it refuses).
extern "C" int wiw_flash_attn_fwd_d64(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int Sq, int Skv, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int tiles,
    void* stream) {
  if (tiles != 1 && (tiles != 2 || Skv % (2 * kBlockN) || lse != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  auto kernel = tiles == 2 ? flash_attn_fwd_d64_kernel<false, 2>
                : lse != nullptr ? flash_attn_fwd_d64_kernel<true, 1>
                                 : flash_attn_fwd_d64_kernel<false, 1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
      v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
