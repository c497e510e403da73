// Flash-attention backward for Hopper (sm_90a), head_dim 64, bf16 in/out.
//
// Replaces the backward of the stock TPU kernel
// `jax.experimental.pallas.ops.tpu.flash_attention` (its dkv and dq
// kernels), which wiw_tpu/ops/attention.py reaches through
// `_flash_attention_fn` inside the custom VJP of `_custom_flash_fn`: the
// gradients dQ, dK, dV of non-causal softmax(q k^T / sqrt(D)) v, with fp32
// accumulation and no [S, S] tensor in device memory.
//
// The algorithm is FlashAttention-2's backward. The forward (K1,
// flash_attn_fwd.cu with its LSE flag) leaves the row log-sum-exp L, so
// P = exp(scale q k^T - L) is recomputed tile by tile, and
//   Delta = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Two kernels, launched in this order on one stream by one C call:
//   * dQ: one block per (batch*head, 64-row q tile), 4 warps of 16 q rows;
//     it loops over 64-row k/v tiles and accumulates dQ in registers. Its
//     prologue also computes Delta for its rows (from the dO and O it reads
//     anyway) and stores it for the second kernel: Delta is not a separate
//     launch. No atomics: every dQ row is summed by one warp, in order, so
//     the result is deterministic.
//   * dK/dV: one block per (batch*head, 64-row k/v tile), 4 warps of 16
//     k/v rows; it loops over 64-row q/dO tiles and accumulates dK and dV in
//     registers (S^T and dP^T are computed directly in the k/v-row layout).
//
// What bounds it on this card: five products of 2*S*S*64 flops per
// (batch, head) (the dK/dV kernel recomputes S^T and dP^T, the dQ kernel S
// and dP, so seven are executed) against ~16*S*D bytes of q, k, v, O, dO,
// dq, dk, dv: far above the H100's ~295 flop/byte ridge, so the tensor
// cores (and the exp between the products) bound it. The design keeps all
// products on the tensor cores (mma.sync m16n8k16 bf16, fp32 accumulators),
// and reuses K1's register trick: an accumulator fragment of a 16-row warp
// tile is laid out as the A operand of the next product, so P and dS go
// from registers to the tensor cores without shared memory. P is rounded to
// bf16 before the dV product, where K1 rounds it before the PV product; dS
// is rounded to bf16 before the dQ and dK products, like FlashAttention-2.
//
// q, k, v, O, dO are read and dq, dk, dv written through (batch, head, row)
// strides with a unit stride on D, so [B, S, H*D] projections and head views
// of contiguous [B, S, H, D] gradients need no transpose. Rows past S are
// masked: the ragged tile is zero-filled in shared memory, P is set to 0 for
// q rows past Sq and k/v columns past Skv (never exp of a stale L), and rows
// past S are not stored. Shared memory per block: two 64 x 72 bf16 tiles
// plus 64 L and 64 Delta values, ~19 KB (static).
// This is the simple first version: synchronous loads, no cp.async/TMA, no
// wgmma, two kernels instead of one fused pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                // head dim
constexpr int kWarps = 4;
constexpr int kBlockM = 16 * kWarps;  // rows a block owns
constexpr int kBlockN = 64;           // rows of each tile it loops over
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;           // padded shared-memory row (elements)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
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

// The A fragments of a warp's 16 rows (r0 .. r0+15) x 64 columns, read from
// global memory; rows past n are zero. [k-chunk of 16][4 registers].
__device__ __forceinline__ void load_a(uint32_t f[kD / 16][4],
                                       const __nv_bfloat16* base,
                                       int64_t row_stride, int r0, int n,
                                       int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + g + rr * 8;
        uint32_t val = 0u;
        if (row < n) {
          val = *reinterpret_cast<const uint32_t*>(
              base + row * row_stride + kc * 16 + half * 8 + 2 * t);
        }
        f[kc][half * 2 + rr] = val;
      }
    }
  }
}

// Stage rows r0 .. r0+63 of a [n, 64] matrix into a padded shared tile,
// 16 bytes a thread; rows past n are zero.
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src,
                                      int64_t row_stride, int r0, int n,
                                      int tid) {
#pragma unroll
  for (int i = 0; i < (kBlockN * kD / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + row) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + row * kLd + col) = val;
  }
}

// c[16 x 64] += A[16 x 64] T^T for a 64-row shared tile T: column j of the
// result is the dot product with row j of T (the q k^T pattern).
__device__ __forceinline__ void mma_a_tt(float c[kBlockN / 8][4],
                                         const uint32_t a[kD / 16][4],
                                         const __nv_bfloat16* T, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const __nv_bfloat16* r = T + (nt * 8 + g) * kLd + kc * 16 + 2 * t;
      mma_16816(c[nt], a[kc], *reinterpret_cast<const uint32_t*>(r),
                *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// c[16 x 64] += bf16(P)[16 x 64] T for fp32 accumulator fragments P (the
// P v pattern): the fragments of column tiles (2kc, 2kc+1) are the A operand
// of k-chunk kc, rounded to bf16 here.
__device__ __forceinline__ void mma_p_t(float c[kD / 8][4],
                                        const float p[kBlockN / 8][4],
                                        const __nv_bfloat16* T, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kBlockN / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_f32(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_f32(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_f32(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_f32(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const __nv_bfloat16* vc = T + (kc * 16 + 2 * t) * kLd + nt * 8 + g;
      mma_16816(c[nt], pa, pack_bf16(vc[0], vc[kLd]),
                pack_bf16(vc[8 * kLd], vc[9 * kLd]));
    }
  }
}

__device__ __forceinline__ void zero(float c[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Store a warp's 16 x 64 fp32 accumulator times `mul` as bf16 rows r0.. (< n).
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           int64_t row_stride,
                                           const float c[kD / 8][4], float mul,
                                           int r0, int n, int g, int t) {
  const int row0 = r0 + g;
  const int row1 = r0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 < n) {
      *reinterpret_cast<uint32_t*>(base + row0 * row_stride + col) =
          pack_f32(c[nt][0] * mul, c[nt][1] * mul);
    }
    if (row1 < n) {
      *reinterpret_cast<uint32_t*>(base + row1 * row_stride + col) =
          pack_f32(c[nt][2] * mul, c[nt][3] * mul);
    }
  }
}

struct Strides {
  int64_t b, h, s;
};

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int Sq,
                         int Skv, Strides qs_, Strides ks_, Strides vs_,
                         Strides os_, Strides dos_, Strides dqs_, float scale,
                         float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM + warp * 16;

  const __nv_bfloat16* qp = q + b * qs_.b + h * qs_.h;
  const __nv_bfloat16* kp = k + b * ks_.b + h * ks_.h;
  const __nv_bfloat16* vp = v + b * vs_.b + h * vs_.h;
  const __nv_bfloat16* op = o + b * os_.b + h * os_.h;
  const __nv_bfloat16* dop = dout + b * dos_.b + h * dos_.h;
  __nv_bfloat16* dqp = dq + b * dqs_.b + h * dqs_.h;

  uint32_t qf[kD / 16][4], dof[kD / 16][4];
  load_a(qf, qp, qs_.s, q0, Sq, g, t);
  load_a(dof, dop, dos_.s, q0, Sq, g, t);

  // Delta for rows g and g+8: this thread's 16 columns of each row (the
  // positions of its dO fragment), then a sum across the quad
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + g + rr * 8;
        if (row < Sq) {
          const __nv_bfloat162 ov = *reinterpret_cast<const __nv_bfloat162*>(
              op + row * os_.s + kc * 16 + half * 8 + 2 * t);
          const uint32_t d = dof[kc][half * 2 + rr];
          const __nv_bfloat162 dv =
              *reinterpret_cast<const __nv_bfloat162*>(&d);
          dl[rr] += __low2float(ov) * __low2float(dv) +
                    __high2float(ov) * __high2float(dv);
        }
      }
    }
  }
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    const int row = q0 + g + r * 8;
    // rows past Sq compute on zeros (dO = 0, so dS = 0) and are not stored
    lse2[r] = row < Sq ? lse[static_cast<int64_t>(bh) * Sq + row] * kLog2e : 0.f;
    if (t == 0 && row < Sq) delta[static_cast<int64_t>(bh) * Sq + row] = dl[r];
  }

  float acc[kD / 8][4];
  zero(acc);
  for (int kv0 = 0; kv0 < Skv; kv0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    stage(ks, kp, ks_.s, kv0, Skv, tid);
    stage(vs, vp, vs_.s, kv0, Skv, tid);
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    zero(s);
    zero(dp);
    mma_a_tt(s, qf, ks, g, t);    // S = q k^T
    mma_a_tt(dp, dof, vs, g, t);  // dP = dO v^T
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p =
            col < Skv ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[r]);  // dS
      }
    }
    mma_p_t(acc, s, ks, g, t);  // dQ += dS k
  }
  store_rows(dqp, dqs_.s, acc, scale, q0, Sq, g, t);
}

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int Sq,
                          int Skv, Strides qs_, Strides ks_, Strides vs_,
                          Strides dos_, Strides dks_, Strides dvs_,
                          float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 dos[kBlockN * kLd];
  __shared__ float lse_s[kBlockN];
  __shared__ float delta_s[kBlockN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.x * kBlockM + warp * 16;

  const __nv_bfloat16* qp = q + b * qs_.b + h * qs_.h;
  const __nv_bfloat16* kp = k + b * ks_.b + h * ks_.h;
  const __nv_bfloat16* vp = v + b * vs_.b + h * vs_.h;
  const __nv_bfloat16* dop = dout + b * dos_.b + h * dos_.h;
  const float* lsep = lse + static_cast<int64_t>(bh) * Sq;
  const float* deltap = delta + static_cast<int64_t>(bh) * Sq;

  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  load_a(kf, kp, ks_.s, kv0, Skv, g, t);
  load_a(vf, vp, vs_.s, kv0, Skv, g, t);

  float dka[kD / 8][4], dva[kD / 8][4];
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < Sq; q0 += kBlockN) {
    __syncthreads();
    stage(qs, qp, qs_.s, q0, Sq, tid);
    stage(dos, dop, dos_.s, q0, Sq, tid);
    if (tid < kBlockN) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lsep[q0 + tid] * kLog2e : 0.f;
      delta_s[tid] = in ? deltap[q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T for this warp's 16 k/v rows
    float st[kBlockN / 8][4], dpt[kBlockN / 8][4];
    zero(st);
    zero(dpt);
    mma_a_tt(st, kf, qs, g, t);
    mma_a_tt(dpt, vf, dos, g, t);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);  // q row within the tile
        const float p = q0 + col < Sq
                            ? exp2f(st[nt][e] * scale_log2 - lse_s[col])
                            : 0.f;
        st[nt][e] = p;                                 // P^T
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[col]);  // dS^T
      }
    }
    mma_p_t(dva, st, dos, g, t);  // dV += P^T dO
    mma_p_t(dka, dpt, qs, g, t);  // dK += dS^T q
  }
  store_rows(dk + b * dks_.b + h * dks_.h, dks_.s, dka, scale, kv0, Skv, g, t);
  store_rows(dv + b * dvs_.b + h * dvs_.h, dvs_.s, dva, 1.f, kv0, Skv, g, t);
}

}  // namespace

// C entry, bound with ctypes. q, k, v, o, dout, dq, dk, dv are device
// pointers of bf16 tensors viewed as [B, H, S, 64] with unit stride on the
// last dim; their (batch, head, row) strides are in elements, in the order
// q, k, v, o, dout, dq, dk, dv. lse is K1's fp32 [B*H, Sq] output; delta is
// fp32 [B*H, Sq] scratch that the dQ kernel fills. Launches the dQ kernel,
// then the dK/dV kernel, on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess.
extern "C" int wiw_flash_attn_bwd_d64(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Skv, const int64_t* strides,
    float sm_scale, void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  flash_attn_bwd_dq_kernel<<<dim3((Sq + kBlockM - 1) / kBlockM, B * H),
                             kThreads, 0, s>>>(
      bq, bk, bv, static_cast<const __nv_bfloat16*>(o), bdo, fl, fd,
      static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, st[0], st[1], st[2], st[3],
      st[4], st[5], sm_scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_bwd_dkv_kernel<<<dim3((Skv + kBlockM - 1) / kBlockM, B * H),
                              kThreads, 0, s>>>(
      bq, bk, bv, bdo, fl, fd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, st[0], st[1], st[2], st[4],
      st[6], st[7], sm_scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
