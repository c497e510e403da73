// K7: W8A8 int8 product and 3x3 conv for Hopper (sm_90a).
//
// Replaces `w8a8_dense` and `w8a8_conv` of wiw_tpu/ops/quant.py, which the
// TPU runs as XLA ops (dynamic activation quantisation, an int8 dot or conv
// with an int32 result, an fp32 dequantising epilogue). On this card each
// path quantises x in one pass that writes x8 (int8, half of bf16 x's
// bytes) and an int8 tensor-core product that reads it and dequantises in
// its epilogue; no int32 result reaches device memory.
//
// Dense, two launches:
//   1. `quant_rows`: one warp a row of x [M, K] (bf16 or fp32): amax by
//      shuffles, scale = max(amax, 1e-8) / 127, x8 = rint(x / scale) (an
//      IEEE division, round half to even, as jnp.round); writes int8 [M, K]
//      and fp32 [M].
//   2. `w8a8_gemm`: out [M, N] = ((float)(x8 . w8^T) * s_a[row]) * s_w[col]
//      + bias[col], rounded once to the output dtype. w8 is [N, K]
//      K-contiguous, the `col` operand of mma.sync m16n8k32 s8.s8.s32.
// Conv (NHWC x [Nb, H, W, I], w8 [O, kh, kw, I] = [O, K] with K = kh*kw*I),
// three launches:
//   1. `amax_abs`: amax(|x|) over the whole call, an atomicMax on the bits
//      of non-negative floats (order-free, so deterministic); no host sync.
//   2. `quant_tensor`: s_a = max(amax, 1e-8) / 127 and x8 = rint(x / s_a),
//      int8 NHWC, once per element.
//   3. the same product as an implicit GEMM over x8: each block gathers its
//      A tile of 16-byte channel chunks straight from x8 with cp.async
//      (padded taps zero-filled by the copy itself); epilogue
//      (float)acc * (s_a * s_w[col]) + bias[col].
//   Why x8 is written: quantising x inside the conv's tile loads instead
//   divides every element again for each of the kh*kw taps and each N tile
//   (9 x N/128 IEEE divisions an element, on a synchronous load path); that
//   form measured 27-93 TOPS on an H100 at 700 W. Writing x8 once costs one
//   int8 write of x (82 MB at level 0).
// The operation order is the reference's and no contraction into FMAs is
// allowed there (explicit __fmul_rn/__fadd_rn/__fdiv_rn), so the epilogue
// rounds as XLA's does; the int32 sums are exact either way.
//
// What bounds it on this card: the UNet's products are large (the level-0
// GEGLU in-projection M = 258,048, K = 320, N = 2560; its 3x3 convs
// K = 9 * 320 .. 9 * 1280): the conv is bound by the int8 tensor cores
// (1979 TOPS dense), the in-projection with its small K by writing its bf16
// output (1.3 GB at level 0). The design keeps the product on the tensor
// cores (mma.sync m16n8k32, int32 accumulators in registers), stages 128 x 64
// byte tiles of A and B in shared memory with a two-stage cp.async ring, and
// walks the N tiles of one M tile in neighbouring blocks so that A is read
// from device memory about once. Simple first version: no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int BM = 128;          // rows of a block tile
constexpr int BN = 128;          // output channels of a block tile
constexpr int BK = 64;           // K bytes a stage
constexpr int LDS = BK + 16;     // padded shared-memory row, bytes
constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;           // warp tile rows
constexpr int WN = 32;           // warp tile columns

// 8 consecutive elements (16-byte aligned for bf16, 32 for fp32) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ uint32_t quant4(const float* f, float scale) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = __float2int_rn(__fdiv_rn(f[i], scale));
    r |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                  float* __restrict__ scale_out, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<int64_t>(row) * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = __fdiv_rn(fmaxf(amax, kEps), 127.f);
  if (lane == 0) scale_out[row] = scale;
  int8_t* qr = x8 + static_cast<int64_t>(row) * K;
  for (int c = lane * 8; c < K; c += 256) {
    float f[8];
    load8(xr + c, f);
    uint2 v;
    v.x = quant4(f, scale);
    v.y = quant4(f + 4, scale);
    *reinterpret_cast<uint2*>(qr + c) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
amax_abs_kernel(const T* __restrict__ x, int64_t n8, float* __restrict__ amax) {
  float m = 0.f;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n8; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float f[8];
    load8(x + i * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmaxf(m, part[w]);
    // non-negative floats order as their bit patterns
    atomicMax(reinterpret_cast<unsigned int*>(amax), __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
quant_tensor_kernel(const T* __restrict__ x, int64_t n8,
                    const float* __restrict__ amax, int8_t* __restrict__ x8) {
  const float scale = __fdiv_rn(fmaxf(*amax, kEps), 127.f);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n8; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float f[8];
    load8(x + i * 8, f);
    uint2 v;
    v.x = quant4(f, scale);
    v.y = quant4(f + 4, scale);
    *reinterpret_cast<uint2*>(x8 + i * 8) = v;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

constexpr int kChunks = (BM * BK / 16) / kThreads;  // A chunks a thread a stage

// A operand of the dense product: x8 [M, K] int8, loaded by cp.async
struct DenseA {
  const int8_t* x8;
  int M, K;
  struct State {};
  __device__ void init(State&, int, int) const {}
  __device__ void load(int8_t* As, State&, int m0, int k0, int tid) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2;
      const int kk = (c & 3) * 16;
      const bool ok = m0 + r < M && k0 + kk < K;
      cp_async16(As + r * LDS + kk,
                 ok ? x8 + static_cast<int64_t>(m0 + r) * K + k0 + kk : x8, ok);
    }
  }
};

// A operand of the conv: the im2col rows of x8 (NHWC int8), gathered in
// 16-byte chunks of 16 input channels (C % 16 == 0, so a chunk never spans
// two taps); a tap outside the image is a zero-filled copy. Each thread's
// two chunks keep their output pixel for the whole K loop and step their
// (ky, kx, ci) by BK a stage, so the loop does no division.
struct ConvA {
  const int8_t* x8;
  int H, W, C, kh, kw, stride, pad, OH, OW, M;
  struct State {
    int64_t base[kChunks];  // element offset of (n, ih0, iw0, 0)
    int ih0[kChunks], iw0[kChunks], ci[kChunks], ky[kChunks], kx[kChunks];
    bool row_ok[kChunks];
  };
  __device__ void init(State& st, int m0, int tid) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int m = m0 + (c >> 2);
      st.row_ok[i] = m < M;
      const int mm = st.row_ok[i] ? m : 0;
      const int ow = mm % OW;
      const int t = mm / OW;
      const int oh = t % OH;
      const int n = t / OH;
      st.ih0[i] = oh * stride - pad;
      st.iw0[i] = ow * stride - pad;
      st.base[i] = static_cast<int64_t>(n) * H * W * C;
      const int kk = (c & 3) * 16;
      const int tap = kk / C;
      st.ci[i] = kk - tap * C;
      st.ky[i] = tap / kw;
      st.kx[i] = tap - st.ky[i] * kw;
    }
  }
  __device__ void load(int8_t* As, State& st, int, int, int tid) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int ih = st.ih0[i] + st.ky[i];
      const int iw = st.iw0[i] + st.kx[i];
      const bool ok = st.row_ok[i] && st.ky[i] < kh && ih >= 0 && ih < H &&
                      iw >= 0 && iw < W;
      const int8_t* src =
          ok ? x8 + st.base[i] + (static_cast<int64_t>(ih) * W + iw) * C + st.ci[i] : x8;
      cp_async16(As + (c >> 2) * LDS + (c & 3) * 16, src, ok);
      // advance this chunk by BK along K: (ky, kx, ci)
      st.ci[i] += BK;
      while (st.ci[i] >= C) {
        st.ci[i] -= C;
        if (++st.kx[i] == kw) {
          st.kx[i] = 0;
          ++st.ky[i];
        }
      }
    }
  }
};

__device__ __forceinline__ void load_b(int8_t* Bs, const int8_t* w8, int N,
                                       int K, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < (BN * BK / 16) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2;
    const int kk = (c & 3) * 16;
    const bool ok = n0 + r < N && k0 + kk < K;
    cp_async16(Bs + r * LDS + kk,
               ok ? w8 + static_cast<int64_t>(n0 + r) * K + k0 + kk : w8, ok);
  }
}

// kConv: the epilogue multiplies acc by (s_a * s_w) (the conv's order);
// otherwise by s_a[row], then by s_w (the dense order)
template <class A, typename TO, bool kConv>
__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(A a, const float* __restrict__ sa_rows,
                 const float* __restrict__ amax, const int8_t* __restrict__ w8,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * WM;  // warp's rows in the tile
  const int wn = (warp & 3) * WN;   // warp's columns in the tile
  const int n_tiles = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const float sa_conv = kConv ? __fdiv_rn(fmaxf(*amax, kEps), 127.f) : 0.f;

  int acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  typename A::State st;
  a.init(st, m0, tid);
  const int nk = (K + BK - 1) / BK;
  a.load(As[0], st, m0, 0, tid);
  load_b(Bs[0], w8, N, K, n0, 0, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      a.load(As[cur ^ 1], st, m0, (kt + 1) * BK, tid);
      load_b(Bs[cur ^ 1], w8, N, K, n0, (kt + 1) * BK, tid);
    }
    cp_async_commit();

    const int8_t* as = As[cur];
    const int8_t* bs = Bs[cur];
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      uint32_t af[WM / 16][4];
      uint32_t bf[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * LDS + kc * 32 + 4 * t;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int8_t* p = bs + (wn + j * 8 + g) * LDS + kc * 32 + 4 * t;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: dequantise in the reference's order, round once
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + 8 * h;
      if (row >= M) continue;
      const float sr = kConv ? 0.f : sa_rows[row];
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = __int2float_rn(acc[i][j][2 * h + e]);
          float y = kConv ? __fmul_rn(f, __fmul_rn(sa_conv, sw[col + e]))
                          : __fmul_rn(__fmul_rn(f, sr), sw[col + e]);
          if (bias != nullptr) y = __fadd_rn(y, bias[col + e]);
          v[e] = y;
        }
        store2(out + static_cast<int64_t>(row) * N + col, v[0], v[1]);
      }
    }
  }
}

template <class A, typename TO, bool kConv>
int launch_gemm(const A& a, const float* sa_rows, const float* amax,
                const int8_t* w8, const float* sw, const float* bias, void* out,
                int M, int N, int K, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  w8a8_gemm_kernel<A, TO, kConv><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, sa_rows, amax, w8, sw, bias, static_cast<TO*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. x_dtype / out_dtype: 0 bf16, 1 fp32. All
// tensors contiguous; K (dense) and C (conv) multiples of 16, N multiples
// of 8. `bias` may be null. Launch on `stream`, return cudaGetLastError()
// (cudaErrorInvalidValue for what they refuse).

extern "C" int wiw_w8a8_dense(const void* x, void* x8, void* sa,
                              const void* w8, const void* sw, const void* bias,
                              void* out, int M, int N, int K, int x_dtype,
                              int out_dtype, void* stream_) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const unsigned qblocks = static_cast<unsigned>((M + 7) / 8);
  if (x_dtype == 0) {
    quant_rows_kernel<__nv_bfloat16><<<qblocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8),
        static_cast<float*>(sa), M, K);
  } else {
    quant_rows_kernel<float><<<qblocks, 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(x8),
        static_cast<float*>(sa), M, K);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  DenseA a{static_cast<const int8_t*>(x8), M, K};
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(sw);
  const float* b = static_cast<const float*>(bias);
  const float* rows = static_cast<const float*>(sa);
  return out_dtype == 0
             ? launch_gemm<DenseA, __nv_bfloat16, false>(a, rows, nullptr, w, s, b,
                                                        out, M, N, K, stream)
             : launch_gemm<DenseA, float, false>(a, rows, nullptr, w, s, b, out,
                                                M, N, K, stream);
}

// dtypes: bit 0 x (0 bf16, 1 fp32), bit 1 out (0 bf16, 1 fp32). `x8` is an
// int8 scratch of x's shape, `amax` one fp32.
extern "C" int wiw_w8a8_conv(const void* x, void* x8, void* amax, const void* w8,
                             const void* sw, const void* bias, void* out,
                             int Nb, int H, int W, int C, int O, int kh, int kw,
                             int stride, int pad, int OH, int OW, int dtypes,
                             void* stream_) {
  const int64_t M64 = static_cast<int64_t>(Nb) * OH * OW;
  const int64_t K64 = static_cast<int64_t>(kh) * kw * C;
  if (Nb <= 0 || OH <= 0 || OW <= 0 || C <= 0 || C % 16 || O <= 0 || O % 8 ||
      kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 || M64 > 0x7fffffff ||
      K64 > 0x7fffffff ||
      static_cast<int64_t>(Nb) * H * W * C > (static_cast<int64_t>(1) << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = static_cast<int>(M64), K = static_cast<int>(K64);
  const int64_t n8 = static_cast<int64_t>(Nb) * H * W * C / 8;
  float* am = static_cast<float*>(amax);
  int8_t* q = static_cast<int8_t*>(x8);
  cudaError_t e = cudaMemsetAsync(am, 0, sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool xf32 = dtypes & 1;
  const bool of32 = (dtypes >> 1) & 1;
  const unsigned blocks = static_cast<unsigned>(
      n8 / 256 + 1 < 132 * 16 ? n8 / 256 + 1 : 132 * 16);
  if (xf32) {
    const float* xf = static_cast<const float*>(x);
    amax_abs_kernel<float><<<blocks, 256, 0, stream>>>(xf, n8, am);
    quant_tensor_kernel<float><<<blocks, 256, 0, stream>>>(xf, n8, am, q);
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    amax_abs_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(xb, n8, am);
    quant_tensor_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(xb, n8, am, q);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const ConvA a{q, H, W, C, kh, kw, stride, pad, OH, OW, M};
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(sw);
  const float* b = static_cast<const float*>(bias);
  return of32 ? launch_gemm<ConvA, float, true>(a, nullptr, am, w, s, b, out, M,
                                                O, K, stream)
              : launch_gemm<ConvA, __nv_bfloat16, true>(a, nullptr, am, w, s, b,
                                                        out, M, O, K, stream);
}
