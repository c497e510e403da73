// GroupNorm (+ SiLU) over the channel axis for Hopper (sm_90a), bf16 or fp32
// in and out, and a bf16 copy kernel that measures the card's copy ceiling.
//
// Replaces the TPU kernels of the K8 probe (scripts/tune_temporal3.py):
// `_stats_kernel` (per-channel partial statistics of a row tile),
// `_affine_silu_kernel` (y = x*scale + offset, then SiLU) and the jnp glue
// between them (merge of the partials, per-channel scale and offset), and
// `_copy_kernel` (x + 1 in bf16). The function is the port's GroupNorm
// (wiw_tpu_torch/ops/group_norm.py, `group_norm_plain`): x viewed as
// [N, L, C] (every axis between the first and the last flattened), groups
// of C/G contiguous channels, statistics per (row n, group) over L x C/G
// values, in fp32; y rounded to x's dtype; with the SiLU flag, SiLU of that
// rounded value computed in fp32 and rounded again (the order of
// `F.silu(norm(x))`).
//
// What bounds it on this card: bytes. A call does ~10 flops an element
// against 2-4 bytes an element moved, far below the H100's ~295 flop/byte
// ridge. The statistics of a batch row need a full pass over that row
// before any of its elements can be normalised. Where one row of x fits in
// the 50 MB L2 (a spatial level-0 row, [9216, 320] bf16, is 5.9 MB), a
// kernel could normalise it while it is still there: the floor is one read
// of x and one write of y. Where a row does not fit (a temporal level-0
// row, [14 * 9216, 320] bf16, 82.6 MB, or the VAE's large rows), the floor
// is two reads and one write. At 3.35 TB/s a level-0 tensor ([28, 9216,
// 320] bf16, 165 MB) has a floor of 0.099 ms.
//
// This design reads x twice from HBM at every shape: its statistics pass
// covers every row before its apply pass starts, so where the whole tensor
// exceeds the L2 (165 MB at level 0) the second read misses it. At the
// shapes whose rows fit in L2 it so moves 1.5x its floor; taking the rows
// in L2-sized groups, statistics then apply, would close that gap.
//
// Design, three launches on one stream, no host synchronisation:
//  1. stats: one block per (256-row tile, 64-channel chunk, row n). Each
//     thread loads 8 rows x 8 channels once (16-byte loads, neighbouring
//     threads on neighbouring addresses) and keeps them in registers. The
//     block takes the tile's per-channel mean from them, then the sum of
//     squared deviations around that mean (M2) from the same registers,
//     with the rounding correction of the corrected two-pass algorithm. So
//     the partials are (mean, M2) of the tile, not raw (sum, sum of
//     squares), which cancel when |mean| >> std.
//  2. finalize: one block per (group, row n) merges the tiles' and the
//     group's channels' partials with Chan's formula in double, in a fixed
//     order, into per-(n, channel) fp32 scale = rstd*gamma and offset =
//     beta - mean*rstd*gamma. Its variance has the quality of an exact
//     two-pass, with no data-dependent second pass and no host round trip.
//  3. apply: a grid-stride pass, 8 channels a thread, y = fma(x, scale,
//     offset) rounded to x's dtype, then (template flag) SiLU.
// No atomics; every sum has a fixed order; rows are independent (row n's
// statistics read only row n), so a co-batched row never changes another
// row's bits. Offsets are 64-bit: a VAE tensor of 14 frames at 576x1024
// ([14, 589824, 128] bf16) passes 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;                         // channels a thread
constexpr int kColThreads = 8;                  // threads across a chunk
constexpr int kChunk = kVec * kColThreads;      // 64 channels a block
constexpr int kRowThreads = 32;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kRowThreads * kRowsPerThread;  // 256 rows a block
constexpr int kStatThreads = kColThreads * kRowThreads;
constexpr int kFinThreads = 256;
constexpr int kApplyThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// v rounded to T and back (the identity for fp32)
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

template <typename T>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                float* __restrict__ part_m2, int64_t L, int C, int n_tiles) {
  __shared__ float red[kRowThreads][kChunk + 1];
  __shared__ float red2[kRowThreads][kChunk + 1];
  __shared__ float tmean[kChunk];

  const int tx = threadIdx.x;  // 8-channel group of the chunk
  const int ty = threadIdx.y;  // row thread
  const int tile = blockIdx.x;
  const int cc = tx * kVec;    // channel in the chunk
  const int c0 = blockIdx.y * kChunk + cc;
  const int64_t n = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(tile) * kTile;
  const int rows = L - r0 < kTile ? static_cast<int>(L - r0) : kTile;
  const bool active = c0 < C;  // C % 8 == 0: a group is all in or all out

  float v[kRowsPerThread][kVec];
  float s[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = 0.f;
  const T* base = x + (n * L + r0) * C + c0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kRowThreads;
    if (active && r < rows) {
      load8(base + static_cast<int64_t>(r) * C, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] += v[i][j];
  }

  // pass 1: the tile's mean per channel (column sums in row order)
#pragma unroll
  for (int j = 0; j < kVec; ++j) red[ty][cc + j] = s[j];
  __syncthreads();
  const int lin = ty * kColThreads + tx;
  if (lin < kChunk) {
    float acc = 0.f;
    for (int r = 0; r < kRowThreads; ++r) acc += red[r][lin];
    tmean[lin] = acc / rows;
  }
  __syncthreads();

  // pass 2, from the registers: sum of d and of d^2, d = x - tile mean
  float sd[kVec], sd2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) sd[j] = sd2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (ty + i * kRowThreads < rows) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[i][j] - tmean[cc + j];
        sd[j] += d;
        sd2[j] += d * d;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[ty][cc + j] = sd[j];
    red2[ty][cc + j] = sd2[j];
  }
  __syncthreads();
  if (lin < kChunk) {
    const int c = blockIdx.y * kChunk + lin;
    if (c < C) {
      float a = 0.f, a2 = 0.f;
      for (int r = 0; r < kRowThreads; ++r) {
        a += red[r][lin];
        a2 += red2[r][lin];
      }
      // corrected two-pass: the tile mean's rounding moved into the mean,
      // and taken out of M2
      const int64_t at = (n * n_tiles + tile) * C + c;
      part_mean[at] = tmean[lin] + a / rows;
      part_m2[at] = fmaxf(a2 - a * a / rows, 0.f);
    }
  }
}

struct Moments {
  double n, mean, m2;
};

// Chan et al.'s pairwise merge
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double n = a.n + b.n;
  const double delta = b.mean - a.mean;
  const double f = b.n / n;
  return {n, a.mean + delta * f, a.m2 + b.m2 + delta * delta * a.n * f};
}

__global__ void __launch_bounds__(kFinThreads)
gn_finalize_kernel(const float* __restrict__ part_mean,
                   const float* __restrict__ part_m2,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ scale,
                   float* __restrict__ offset, int64_t L, int C, int groups,
                   int n_tiles, float eps) {
  __shared__ double sn[kFinThreads], smean[kFinThreads], sm2[kFinThreads];
  __shared__ float s_mean, s_rstd;
  const int grp = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int cg = C / groups;
  const int64_t items = static_cast<int64_t>(n_tiles) * cg;
  const double last_rows = static_cast<double>(L - static_cast<int64_t>(n_tiles - 1) * kTile);

  Moments m = {0.0, 0.0, 0.0};
  for (int64_t i = threadIdx.x; i < items; i += kFinThreads) {
    const int tile = static_cast<int>(i / cg);
    const int c = grp * cg + static_cast<int>(i - static_cast<int64_t>(tile) * cg);
    const int64_t at = (n * n_tiles + tile) * C + c;
    m = merge(m, {tile == n_tiles - 1 ? last_rows : static_cast<double>(kTile),
                  static_cast<double>(part_mean[at]),
                  static_cast<double>(part_m2[at])});
  }
  sn[threadIdx.x] = m.n;
  smean[threadIdx.x] = m.mean;
  sm2[threadIdx.x] = m.m2;
  __syncthreads();
  for (int stride = kFinThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int o = threadIdx.x + stride;
      const Moments r = merge({sn[threadIdx.x], smean[threadIdx.x], sm2[threadIdx.x]},
                              {sn[o], smean[o], sm2[o]});
      sn[threadIdx.x] = r.n;
      smean[threadIdx.x] = r.mean;
      sm2[threadIdx.x] = r.m2;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s_mean = static_cast<float>(smean[0]);
    s_rstd = static_cast<float>(1.0 / sqrt(sm2[0] / sn[0] + static_cast<double>(eps)));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cg; j += kFinThreads) {
    const int c = grp * cg + j;
    const float sc = s_rstd * gamma[c];
    scale[n * C + c] = sc;
    offset[n * C + c] = static_cast<float>(
        static_cast<double>(beta[c]) - static_cast<double>(s_mean) * sc);
  }
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y,
                int64_t L, int C) {
  const int64_t n = blockIdx.y;
  const int cv = C / kVec;
  const int64_t vecs = L * cv;  // 8-channel vectors of row n
  const T* xn = x + n * L * C;
  T* yn = y + n * L * C;
  const float* sc_n = scale + n * C;
  const float* of_n = offset + n * C;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kApplyThreads + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kApplyThreads) {
    const int c = static_cast<int>(i % cv) * kVec;
    float v[kVec], sc[kVec], of[kVec];
    load8(xn + i * kVec, v);
    load8(sc_n + c, sc);
    load8(of_n + c, of);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float o = round_to(fmaf(v[j], sc[j], of[j]), xn);
      if (kSilu) o = round_to(o / (1.f + expf(-o)), xn);
      v[j] = o;
    }
    store8(yn + i * kVec, v);
  }
}

__global__ void __launch_bounds__(kApplyThreads)
copy_plus_one_kernel(const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ y, int64_t vecs) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kApplyThreads + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kApplyThreads) {
    float v[kVec];
    load8(x + i * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] += 1.f;
    store8(y + i * kVec, v);
  }
}

int n_tiles_of(int64_t L) { return static_cast<int>((L + kTile - 1) / kTile); }

// blocks of a grid-stride pass over `vecs` vectors, at most ~16 waves of
// 132 SMs x 8 blocks
int stride_blocks(int64_t vecs) {
  const int64_t want = (vecs + kApplyThreads - 1) / kApplyThreads;
  return static_cast<int>(want < 16896 ? want : 16896);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           void* work, int64_t N, int64_t L, int C, int groups, float eps,
           bool silu, cudaStream_t stream) {
  const int n_tiles = n_tiles_of(L);
  float* part_mean = static_cast<float*>(work);
  float* part_m2 = part_mean + N * n_tiles * C;
  float* scale = part_m2 + N * n_tiles * C;
  float* offset = scale + N * C;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);

  gn_stats_kernel<T><<<dim3(n_tiles, (C + kChunk - 1) / kChunk, N),
                       dim3(kColThreads, kRowThreads), 0, stream>>>(
      xt, part_mean, part_m2, L, C, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finalize_kernel<<<dim3(groups, N), kFinThreads, 0, stream>>>(
      part_mean, part_m2, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), scale, offset, L, C, groups, n_tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(stride_blocks(L * (C / kVec)), N);
  if (silu) {
    gn_apply_kernel<T, true><<<grid, kApplyThreads, 0, stream>>>(
        xt, scale, offset, yt, L, C);
  } else {
    gn_apply_kernel<T, false><<<grid, kApplyThreads, 0, stream>>>(
        xt, scale, offset, yt, L, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 scratch the wrapper allocates for one call: the tiles' (mean, M2)
// partials and the per-(n, channel) scale and offset
extern "C" int64_t wiw_group_norm_work_floats(int64_t N, int64_t L, int C) {
  return 2 * N * n_tiles_of(L) * C + 2 * N * C;
}

// C entries, bound with ctypes. x, y: contiguous [N, L, C] device arrays of
// bf16 (is_bf16 = 1) or fp32, 16-byte aligned, C a multiple of 8 and of
// `groups`; gamma, beta: fp32 [C]; work: wiw_group_norm_work_floats fp32.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for shapes it refuses).
extern "C" int wiw_group_norm(const void* x, const void* gamma, const void* beta,
                              void* y, void* work, int64_t N, int64_t L, int C,
                              int groups, float eps, int is_bf16, int silu,
                              void* stream) {
  if (N <= 0 || N > 65535 || L <= 0 || C <= 0 || C % kVec || groups <= 0 ||
      C % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, gamma, beta, y, work, N, L, C,
                                         groups, eps, silu != 0, s)
                 : launch<float>(x, gamma, beta, y, work, N, L, C, groups, eps,
                                 silu != 0, s);
}

// y = x + 1 in bf16 over n elements (n a multiple of 8, 16-byte aligned):
// the probe's copy kernel, one read and one write of x
extern "C" int wiw_copy_plus_one_bf16(const void* x, void* y, int64_t n,
                                      void* stream) {
  if (n <= 0 || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vecs = n / kVec;
  copy_plus_one_kernel<<<stride_blocks(vecs), kApplyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), vecs);
  return static_cast<int>(cudaGetLastError());
}
