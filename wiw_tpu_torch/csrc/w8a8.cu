// K7: W8A8 int8 product and conv for Hopper (sm_90a).
//
// Replaces `w8a8_dense` and `w8a8_conv` of wiw_tpu/ops/quant.py, which the
// TPU runs as XLA ops (dynamic activation quantisation, an int8 dot or conv
// with an int32 result, an fp32 dequantising epilogue). On this card each
// path quantises x in a pass that writes x8 (int8, half of bf16 x's bytes)
// and runs one int8 wgmma core that reads it and dequantises in its
// epilogue; no int32 result reaches device memory.
//
// Dense, two launches:
//   1. `quant_rows`: one warp a row of x [M, K] (bf16 or fp32): amax by
//      shuffles, scale = max(amax, 1e-8) / 127, x8 = rint(x / scale) (an
//      IEEE division, round half to even, as jnp.round); writes int8 [M, K]
//      and fp32 [M].
//   2. `w8a8_wgmma` (kDense): out [M, N] = ((float)(x8 . w8^T) * s_a[row])
//      * s_w[col] + bias[col], rounded once to the output dtype.
// Conv (NHWC x [Nb, H, W, I], w8 [O, kh, kw, I] = [O, K], K = kh*kw*I),
// three launches:
//   1. `amax_abs`: amax(|x|) over the whole call, an atomicMax on the bits
//      of non-negative floats (order-free, so deterministic); no host sync.
//   2. `quant_tensor`: s_a = max(amax, 1e-8) / 127 and x8 = rint(x / s_a),
//      int8 NHWC, once per element.
//   3. `w8a8_wgmma` (kConvTma or kConvGather): the same product as an
//      implicit GEMM over x8; epilogue (float)acc * (s_a * s_w[col]) +
//      bias[col].
//   The scale is one per call (as the reference's), so it is known only
//   after a pass over all of x: quantising inside the product's loads
//   divides every element again at each of the kh*kw taps and N tiles
//   (that form of this kernel measured 27-93 TOPS on an H100 at 700 W).
//   The two passes stay.
// The operation order is the reference's and no contraction into FMAs is
// allowed there (explicit __fmul_rn/__fadd_rn/__fdiv_rn), so the epilogue
// rounds as XLA's does; the int32 sums are exact in any order, so K7's
// output bits equal its plain version's.
//
// What bounds it on this card (H100: 1979 dense int8 TOPS, 3.35 TB/s): the
// UNet's 3x3 convs (K = 9 * 320 .. 9 * 2560) are bound by the int8 tensor
// cores; the GEGLU in-projection at level 0 (M 258,048, K 320, N 2560) by
// writing its bf16 output (1.32 GB a call), at levels 1-2 by both. The
// design, one core for all three A producers (`w8a8_wgmma_kernel`):
//   * Products: wgmma.m64nNk32.s32.s8.s8, A and B K-major in shared memory
//     (x8 [M, K] and w8 [N, K] already are), rows of one 64-byte K chunk (a
//     "box") in the 64-byte swizzle (sm90.cuh, desc_sw64): two k32
//     products a box.
//   * Block: one per SM, persistent: two consumer warpgroups, 64 rows each
//     of a 128 x BN output tile, then the producer. The tile walk is
//     raster along N inside an M panel, so the blocks in flight share A
//     (read from device memory about once) and the weights (at most 13 MB)
//     stay in the 50 MB L2.
//   * Loads: a ring of stages with full/empty mbarriers; the producer runs
//     ahead across tiles, so the next tile's loads are in flight while this
//     tile's epilogue runs; the consumers keep one wgmma group in flight
//     and release a stage when the products that read it are done. No wait
//     drains the ring. A conv stage holds two boxes (4 products a wait: at
//     one box a stage the waits and releases held the convs near 1000
//     TOPS), and the two CTAs of a cluster take neighbouring M tiles of one
//     N tile, each loading half of the B boxes multicast to both (half the
//     L2 traffic of B; without it two-box stages ran no faster). The dense
//     products keep one box a stage and no cluster: both changes measured
//     slower there.
//   * A, three producers feeding the same consumers:
//       kDense: TMA boxes of 128 rows x 64 bytes from a 2-D map over x8.
//       kConvTma (stride 1, C a multiple of 64: 47 of the UNet's 50 convs
//         a forward and every VAE conv): implicit GEMM by shifted boxes. The
//         output tile is a rectangle of one image, BW x BH = 128 pixels
//         (BW = the next power of two of OW, at most 128); for tap (ky, kx)
//         and channel chunk c0 the A box is (c0, ow0 + kx - pad, oh0 + ky -
//         pad, n) of a 4-D map over x8 [Nb, H, W, C]. TMA zero-fills every
//         element outside the image, negative coordinates included: that is
//         the conv's zero padding.
//       kConvGather (stride 2: the 3 downsamplers; or C not a multiple of
//         64): a producer warpgroup, one thread a row, gathers the im2col
//         rows in 16-byte chunks with cp.async into the same swizzled
//         layout (zero-filled outside the image); each warp arrives on the
//         stage's barrier kLag stages later, once its copies have landed and
//         are fenced for the async proxy.
//     B is always TMA boxes of w8 [N, K].
//   * Width (`quant.k7_plan` picks it; none pads a UNet or VAE width): a
//     conv with TMA boxes takes BN 256 where it divides N (N 1280, the VAE's
//     256/512: 1160-1450 TOPS against BN 160's 980-1140 at N 1280), else 160
//     (N 320, 640), else 128; the gathered conv and the dense product 160
//     where it divides N, else 128 (BN 256 ran slower for both, so it is
//     built for the TMA conv alone). Measured on an H100 80GB HBM3 at 700 W
//     with each width forced in turn. A conv stage holds two boxes, so the
//     wider the tile the fewer stages fit (Layout): BN 128 6 with a bf16
//     output (5 with fp32), 160 5 (4), 256 3 (2); BN 256 won at 3 stages
//     all the same, and the VAE's fp32 convs are tested at 2.
//   * Epilogue: each consumer warpgroup dequantises its 64 x BN in
//     registers, writes it to its own staging buffer in shared memory as
//     64 x 32 boxes (64-byte swizzle for bf16, 128-byte for fp32: no bank
//     conflicts) and one thread stores them by TMA (2-D map over [M, N],
//     or 4-D over [Nb, OH, OW, O] for kConvTma), which clips the ragged
//     edge; the store drains while the next tile's products run. The
//     epilogue does not overlap the next tile's products: a second set of
//     accumulators spilled at ptxas' 168 registers a thread (and ran slower
//     with setmaxnreg at 384 threads), the consumers taking turns on 64-row
//     tiles (ping-pong) and three epilogue warps fed the sums through
//     shared memory all ran slower.
//     This is what holds the level-0 in-projection at about twice its
//     bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kEps = 1e-8f;

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
  const unsigned s = sm90::smem_u32(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

enum Mode { kDense = 0, kConvTma = 1, kConvGather = 2 };

constexpr int kBM = 128;       // rows of a tile: 64 per consumer warpgroup
constexpr int kBK = 64;        // K bytes a box (one 64-byte swizzle row)
// 2 consumer warpgroups (threads 0-255), then the producer: one warp
// (TMA) or one warpgroup (the cp.async gather). ptxas allots registers by
// whole warpgroups either way: 168 a thread.
template <int kMode>
constexpr int kThreads = kMode == kConvGather ? 384 : 288;
// The convs are bound by the operations: each stage holds two K boxes (4
// products a barrier wait) and the two CTAs of a cluster take neighbouring
// M tiles of one N tile and load half of B each, multicast to both (half
// the L2 traffic of B). The dense products run one box a stage and no
// cluster, which measured faster at K 320 .. 1280 (the header).
template <int kMode>
constexpr int kBoxes = kMode == kDense ? 1 : 2;     // K boxes a stage
template <int kMode>
constexpr int kCluster = kMode == kDense ? 1 : 2;   // CTAs of a cluster
constexpr int kLag = 1;        // kConvGather: stages between copy and arrival
constexpr int kSmemMax = 232448;

template <int BN, typename TO, int kMode>
struct Layout {
  static constexpr int kABytes = kBoxes<kMode> * kBM * kBK;
  static constexpr int kBBox = BN * kBK;
  static constexpr int kBBytes = kBoxes<kMode> * kBBox;
  static constexpr int kSub = 64 * 32 * static_cast<int>(sizeof(TO));  // a 64 x 32 box
  static constexpr int kCHalf = (BN / 32) * kSub;
  // as many stages as fit beside the staging, at most 6 (the conv's BN 256:
  // 3 with a bf16 output, 2 with fp32; the header)
  static constexpr int kFit = (kSmemMax - 1024 - 256 - 2 * kCHalf) / (kABytes + kBBytes);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kA = 0;                              // A of stage s at kA + s kABytes
  static constexpr int kB = kStages * kABytes;              // B of stage s
  static constexpr int kC = kB + kStages * kBBytes;         // staging, 2 warpgroups
  static constexpr int kBars = kC + 2 * kCHalf;             // full[kStages], empty[kStages]
  static constexpr int kSmem = kBars + 16 * kStages + 1024; // + alignment
  static_assert(kStages > kLag && kSmem <= kSmemMax, "shared memory");
  static_assert((kBBox / kCluster<kMode>) % 512 == 0, "a CTA's share of a B box starts on a swizzle atom");
};

struct Params {
  const float* sa_rows;  // kDense: the row scales
  const float* amax;     // conv: amax(|x|) of the call
  const float* sw;
  const float* bias;     // or null
  const int8_t* x8;      // kConvGather: x8 NHWC
  int M, N, K;           // M: dense rows or conv output pixels; K = kh kw C
  int m_tiles, n_tiles, nk;  // nk: stages (kBoxes K boxes each) a tile
  int H, W, C, kw, stride, pad, OH, OW;
  int bw, bh, tiles_w, tiles_h;  // kConvTma: the output rectangle of a tile
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    sm90::wgmma_m64n128k32_s8(d, da, db, scale_d);
  } else if constexpr (BN == 160) {
    sm90::wgmma_m64n160k32_s8(d, da, db, scale_d);
  } else {
    sm90::wgmma_m64n256k32_s8(d, da, db, scale_d);
  }
}

struct Tile {
  int n0, m0, img, oh0, ow0;  // m0: kDense, kConvGather; img, oh0, ow0: kConvTma
};

// The tiles of a cluster: group pt of kCluster neighbouring M tiles x one
// N tile, raster along N inside the group's M panels; CTA `rank` takes M
// tile kCluster pt + rank. An M tile past the last loads zeros and stores
// nothing, but still loads its share of B for the other CTA. Returns the
// tile's origin: n0, and m0 (kDense, kConvGather: flat rows) or the image
// and the rectangle's corner (kConvTma).
template <int BN, int kMode>
__device__ __forceinline__ Tile tile_origin(const Params& p, int pt, int rank) {
  Tile t{};
  t.n0 = (pt % p.n_tiles) * BN;
  const int mt = (pt / p.n_tiles) * kCluster<kMode> + rank;
  if constexpr (kMode == kConvTma) {
    const int r = mt / p.tiles_w;
    t.ow0 = (mt - r * p.tiles_w) * p.bw;
    t.img = r / p.tiles_h;
    t.oh0 = (r - t.img * p.tiles_h) * p.bh;
  } else {
    t.m0 = mt * kBM;
  }
  return t;
}

// A consumer warpgroup: 64 rows of each 128 x BN tile
template <int BN, typename TO, int kMode>
struct Consumer {
  using L = Layout<BN, TO, kMode>;
  static constexpr int kChunks = BN / 32;  // 64 x 32 boxes of the epilogue
  const Params& p;
  const CUtensorMap* omap;
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  uint8_t* stage_out;  // this warpgroup's staging of its 64 x BN
  int wg, tid, lane, r0, t;
  float sa_conv;

  // a stage is free again once every CTA of the cluster has read it (each
  // loads a share of the B boxes into all of them): one arrival from each
  // consumer warp on each CTA's empty barrier
  __device__ __forceinline__ void release(uint32_t it) {
    __syncwarp();
    if (lane < kCluster<kMode>) sm90::mbar_arrive_cluster(&empty[it % L::kStages], lane);
  }

  // a tile's products, its k-steps the CTA's iterations it0 .. it0 + nk - 1:
  // wait for each stage, issue its products into `acc`, keep one group
  // in flight and release the stage of the group before; then wait for the
  // last and release its stage
  __device__ __forceinline__ void products(int (&acc)[BN / 2], uint32_t it0) {
    for (int s = 0; s < p.nk; ++s) {
      const uint32_t it = it0 + s;
      const int st = it % L::kStages;
      sm90::mbar_wait(&full[st], (it / L::kStages) & 1);
      const uint8_t* a = smem + L::kA + st * L::kABytes + wg * 64 * kBK;
      const uint8_t* b = smem + L::kB + st * L::kBBytes;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < kBoxes<kMode>; ++bx) {
        const uint8_t* ab = a + bx * kBM * kBK;
        const uint8_t* bb = b + bx * L::kBBox;
        wgmma_s8<BN>(acc, sm90::desc_sw64(ab), sm90::desc_sw64(bb), s > 0 || bx > 0);
        wgmma_s8<BN>(acc, sm90::desc_sw64(ab + 32), sm90::desc_sw64(bb + 32), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc);
      if (s > 0) release(it - 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    release(it0 + p.nk - 1);
  }

  // box c (columns 32 c .. 32 c + 31) of the epilogue: dequantise in the
  // reference's order, round once, stage in shared memory
  template <int c>
  __device__ __forceinline__ void epi_box(const int (&acc)[BN / 2], const Tile& ti,
                                          const float (&sr)[2]) {
    uint8_t* sub = stage_out + c * L::kSub;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * c + jj;
      float v[2][2];  // [row r0, r0 + 8][column 2t, 2t + 1]
      // columns 2t, 2t + 1 (N is even: both inside N or both past it)
      const int col = ti.n0 + 8 * j + 2 * t;
      const bool ok = col < p.N;
      const float2 w2 = ok ? *reinterpret_cast<const float2*>(p.sw + col)
                           : make_float2(0.f, 0.f);
      const float2 b2 = ok && p.bias != nullptr
                            ? *reinterpret_cast<const float2*>(p.bias + col)
                            : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = e ? w2.y : w2.x;
        const float bcol = e ? b2.y : b2.x;
        const float cs = __fmul_rn(sa_conv, w);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float f = __int2float_rn(acc[4 * j + 2 * h + e]);
          float y = kMode == kDense ? __fmul_rn(__fmul_rn(f, sr[h]), w)
                                    : __fmul_rn(f, cs);
          if (p.bias != nullptr) y = __fadd_rn(y, bcol);
          v[h][e] = y;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if constexpr (sizeof(TO) == 2) {
          *reinterpret_cast<uint32_t*>(sub + r * 64 + ((jj ^ ((r >> 1) & 3)) << 4) +
                                       4 * t) = sm90::pack_bf16(v[h][0], v[h][1]);
        } else {
          *reinterpret_cast<float2*>(sub + r * 128 +
                                     (((2 * jj + (t >> 1)) ^ (r & 7)) << 4) +
                                     8 * (t & 1)) = make_float2(v[h][0], v[h][1]);
        }
      }
    }
    if constexpr (c + 1 < kChunks) epi_box<c + 1>(acc, ti, sr);
  }

  // the epilogue: once the last tile's stores have read the staging, stage
  // every box, then one thread stores them by TMA (drained while the next
  // tile's products run)
  __device__ __forceinline__ void epilogue(const int (&acc)[BN / 2], const Tile& ti) {
    float sr[2] = {0.f, 0.f};
    if constexpr (kMode == kDense) {
      const int row = ti.m0 + 64 * wg + r0;
      if (row < p.M) sr[0] = p.sa_rows[row];
      if (row + 8 < p.M) sr[1] = p.sa_rows[row + 8];
    }
    if (tid == 0) sm90::bulk_wait_read<0>();
    sm90::named_barrier(1 + wg, 128);
    epi_box<0>(acc, ti, sr);
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint8_t* sub = stage_out + c * L::kSub;
        if constexpr (kMode == kConvTma) {
          if (p.bh == 1) {
            sm90::tma_store_4d(omap, sub, ti.n0 + 32 * c, ti.ow0 + 64 * wg, ti.oh0,
                               ti.img);
          } else {
            sm90::tma_store_4d(omap, sub, ti.n0 + 32 * c, ti.ow0,
                               ti.oh0 + wg * (p.bh / 2), ti.img);
          }
        } else {
          sm90::tma_store_2d(omap, sub, ti.n0 + 32 * c, ti.m0 + 64 * wg);
        }
      }
      sm90::bulk_commit();
    }
  }
};

template <int BN, typename TO, int kMode>
__global__ void __cluster_dims__(kCluster<kMode>, 1, 1)
    __launch_bounds__(kThreads<kMode>, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap omap, const Params p) {
  using L = Layout<BN, TO, kMode>;
  constexpr int kStages = L::kStages;
  constexpr uint32_t kBShare = L::kBBox / kCluster<kMode>;  // of a B box, a CTA's
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int cluster = blockIdx.x / kCluster<kMode>;
  const int clusters = gridDim.x / kCluster<kMode>;
  // groups of kCluster M tiles x N tiles
  const int groups = (p.m_tiles + kCluster<kMode> - 1) / kCluster<kMode> * p.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // kConvGather: the expect_tx and one arrival per gather warp
      sm90::mbar_init(&full[s], kMode == kConvGather ? 5 : 1);
      // one arrival per consumer warp of both CTAs
      sm90::mbar_init(&empty[s], kCluster<kMode> * 8);
    }
    sm90::fence_barrier_init();
  }
  // both CTAs' barriers are ready before either loads into or arrives on
  // the other's
  sm90::cluster_sync();

  if (threadIdx.x >= 256) {  // ------------------------------ producer
    // per stage: its own A boxes and its share of the B boxes, multicast
    // to every CTA of the cluster (each expects the whole of B)
    if constexpr (kMode != kConvGather) {
      if (threadIdx.x == 256) {
        uint32_t it = 0;
        for (int pt = cluster; pt < groups; pt += clusters) {
          const Tile ti = tile_origin<BN, kMode>(p, pt, rank);
          int c0 = 0, ky = 0, kx = 0;
          for (int s = 0; s < p.nk; ++s, ++it) {
            const int st = it % kStages;
            sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(&full[st], L::kABytes + L::kBBytes);
            // box bx of the stage: K chunk kBoxes s + bx (past K on an odd
            // count of chunks: B reads zeros there, so its products add 0)
#pragma unroll
            for (int bx = 0; bx < kBoxes<kMode>; ++bx) {
              const int k = (s * kBoxes<kMode> + bx) * kBK;
              uint8_t* a = smem + L::kA + st * L::kABytes + bx * kBM * kBK;
              if constexpr (kMode == kDense) {
                sm90::tma_load_2d(a, &amap, &full[st], k, ti.m0);
              } else {
                sm90::tma_load_4d(a, &amap, &full[st], c0, ti.ow0 + kx - p.pad,
                                  ti.oh0 + ky - p.pad, ti.img);
                c0 += kBK;
                if (c0 == p.C) {
                  c0 = 0;
                  if (++kx == p.kw) {
                    kx = 0;
                    ++ky;
                  }
                }
              }
              sm90::tma_load_2d_multicast(
                  smem + L::kB + st * L::kBBytes + bx * L::kBBox + rank * kBShare,
                  &bmap, &full[st], k, ti.n0 + rank * (BN / kCluster<kMode>),
                  (1 << kCluster<kMode>) - 1);
            }
          }
        }
      }
    } else {
      // each of the 128 threads gathers its row of the tile, 4 chunks of 16
      // bytes a stage; each warp arrives once its copies have landed
      const int r = threadIdx.x - 256;
      const int lane = r & 31;
      uint32_t it = 0;
      for (int pt = cluster; pt < groups; pt += clusters) {
        const Tile ti = tile_origin<BN, kMode>(p, pt, rank);
        const int m = ti.m0 + r;
        const bool row_ok = m < p.M;
        const int mm = row_ok ? m : 0;
        const int q0 = mm / p.OW;
        const int ow = mm - q0 * p.OW;
        const int n = q0 / p.OH;
        const int oh = q0 - n * p.OH;
        const int ih0 = oh * p.stride - p.pad;
        const int iw0 = ow * p.stride - p.pad;
        const int8_t* base = p.x8 + static_cast<int64_t>(n) * p.H * p.W * p.C;
        for (int s = 0; s < p.nk; ++s, ++it) {
          const int st = it % kStages;
          sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          if (r == 0) {
            sm90::mbar_expect_tx(&full[st], L::kBBytes);
#pragma unroll
            for (int bx = 0; bx < kBoxes<kMode>; ++bx) {
              sm90::tma_load_2d_multicast(
                  smem + L::kB + st * L::kBBytes + bx * L::kBBox + rank * kBShare,
                  &bmap, &full[st], (s * kBoxes<kMode> + bx) * kBK,
                  ti.n0 + rank * (BN / kCluster<kMode>), (1 << kCluster<kMode>) - 1);
            }
          }
          uint8_t* a = smem + L::kA + st * L::kABytes + r * kBK;
#pragma unroll
          for (int q = 0; q < 4 * kBoxes<kMode>; ++q) {
            // 16 channels of one tap (C is a multiple of 16)
            const int k = s * kBoxes<kMode> * kBK + 16 * q;
            const int tap = k / p.C;
            const int ci = k - tap * p.C;
            const int ky = tap / p.kw;
            const int kx = tap - ky * p.kw;
            const int ih = ih0 + ky;
            const int iw = iw0 + kx;
            const bool ok = row_ok && k < p.K && ih >= 0 && ih < p.H && iw >= 0 &&
                            iw < p.W;
            const int8_t* src =
                ok ? base + (static_cast<int64_t>(ih) * p.W + iw) * p.C + ci : p.x8;
            cp_async16(a + (q / 4) * kBM * kBK + (((q & 3) ^ ((r >> 1) & 3)) << 4),
                       src, ok);
          }
          cp_async_commit();
          if (it >= kLag) {  // the stage kLag back has landed: hand it over
            cp_async_wait<kLag>();
            sm90::fence_proxy_async();
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&full[(it - kLag) % kStages]);
          }
        }
      }
      cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        for (uint32_t j = it >= kLag ? it - kLag : 0; j < it; ++j) {
          sm90::mbar_arrive(&full[j % kStages]);
        }
      }
    }
  } else {  // ---------------------------------- consumers: 64 rows each
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    Consumer<BN, TO, kMode> c{
        p, &omap, smem, full, empty, smem + L::kC + wg * L::kCHalf, wg, tid, lane,
        16 * (tid >> 5) + (lane >> 2), lane & 3,
        kMode == kDense ? 0.f : __fdiv_rn(fmaxf(*p.amax, kEps), 127.f)};
    int acc[BN / 2];
    uint32_t it = 0;
    for (int pt = cluster; pt < groups; pt += clusters, it += p.nk) {
      c.products(acc, it);
      c.epilogue(acc, tile_origin<BN, kMode>(p, pt, rank));
    }
    if (tid == 0) sm90::bulk_wait<0>();
  }
  // neither CTA leaves while the other may still load into or arrive on it
  __syncwarp();
  sm90::cluster_sync();
}

template <int BN, typename TO, int kMode>
int launch_kernel(const CUtensorMap& amap, const CUtensorMap& bmap,
                  const CUtensorMap& omap, const Params& p, cudaStream_t stream) {
  auto kernel = w8a8_wgmma_kernel<BN, TO, kMode>;
  constexpr int smem = Layout<BN, TO, kMode>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many clusters as can be resident at once (a GPC with an odd number
  // of free SMs holds one fewer): the walk is persistent
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / kCluster<kMode> * kCluster<kMode>);
  cfg.blockDim = dim3(kThreads<kMode>);
  cfg.dynamicSmemBytes = smem;
  static int resident = 0;  // per kernel instance; any count is correct
  if (resident == 0) {
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t groups =
      static_cast<int64_t>((p.m_tiles + kCluster<kMode> - 1) / kCluster<kMode>) * p.n_tiles;
  if (groups > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = static_cast<int>(groups < resident ? groups : resident);
  kernel<<<clusters * kCluster<kMode>, kThreads<kMode>, smem, stream>>>(amap, bmap, omap, p);
  return static_cast<int>(cudaGetLastError());
}

// the tile widths `quant.k7_plan` picks for a mode: 128 and 160, and 256
// for the conv with TMA boxes (the only ones built)
template <int kMode>
constexpr bool bn_ok(int bn) {
  return bn == 128 || bn == 160 || (kMode == kConvTma && bn == 256);
}

template <typename TO, int kMode>
int launch_bn(int bn, const CUtensorMap& amap, const CUtensorMap& bmap,
              const CUtensorMap& omap, const Params& p, cudaStream_t stream) {
  if constexpr (kMode == kConvTma) {
    if (bn == 256) return launch_kernel<256, TO, kMode>(amap, bmap, omap, p, stream);
  }
  return bn == 160 ? launch_kernel<160, TO, kMode>(amap, bmap, omap, p, stream)
                   : launch_kernel<128, TO, kMode>(amap, bmap, omap, p, stream);
}

template <int kMode>
int launch(bool out_f32, int bn, const CUtensorMap& amap,
           const CUtensorMap& bmap, const CUtensorMap& omap, const Params& p,
           cudaStream_t stream) {
  return out_f32 ? launch_bn<float, kMode>(bn, amap, bmap, omap, p, stream)
                 : launch_bn<__nv_bfloat16, kMode>(bn, amap, bmap, omap, p, stream);
}

// the int8 [rows, K] map of x8 (dense A) or w8 (B): boxes of 64 bytes x
// `box_rows`, 64-byte swizzle
bool rows_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  return sm90_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// the output's map: [rows, N] (2-D) or [Nb, OH, OW, N] (4-D, `bw` > 0), in
// boxes of 32 columns x 64 rows (bw x bh / 2 or 64 x 1 pixels), swizzled
// as the epilogue stages them
bool out_map(CUtensorMap* map, void* out, bool f32, int N, int rows, int Nb,
             int OH, int OW, int bw, int bh) {
  const cuuint64_t es = f32 ? 4 : 2;
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swz = f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t n = static_cast<cuuint64_t>(N);
  if (bw == 0) {
    const cuuint64_t dims[2] = {n, static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {n * es};
    const cuuint32_t box[2] = {32, 64};
    return sm90_tiled_map(map, type, 2, out, dims, strides, box, swz);
  }
  const cuuint64_t dims[4] = {n, static_cast<cuuint64_t>(OW),
                              static_cast<cuuint64_t>(OH), static_cast<cuuint64_t>(Nb)};
  const cuuint64_t strides[3] = {n * es, n * es * OW, n * es * OW * OH};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(bh == 1 ? 64 : bw),
                             static_cast<cuuint32_t>(bh == 1 ? 1 : bh / 2), 1};
  return sm90_tiled_map(map, type, 4, out, dims, strides, box, swz);
}

}  // namespace

// C entries, bound with ctypes. x_dtype / out_dtype: 0 bf16, 1 fp32. All
// tensors contiguous and 16-byte aligned (w_scale and bias 8-byte); K
// (dense) and C (conv) multiples of 16, N multiples of 8; `bn` the tile
// width (128 or 160; the conv with TMA boxes also 256). `bias` may be null. Launch on
// `stream`, return cudaGetLastError() (cudaErrorInvalidValue for what they
// refuse, a tensor map cuTensorMapEncodeTiled refuses included).

extern "C" int wiw_w8a8_dense(const void* x, void* x8, void* sa,
                              const void* w8, const void* sw, const void* bias,
                              void* out, int M, int N, int K, int bn,
                              int x_dtype, int out_dtype, void* stream_) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 || !bn_ok<kDense>(bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  CUtensorMap amap, bmap, omap;
  if (!rows_map(&amap, x8, M, K, kBM) || !rows_map(&bmap, w8, N, K, bn / kCluster<kDense>) ||
      !out_map(&omap, out, out_dtype == 1, N, M, 0, 0, 0, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  Params p{};
  p.sa_rows = static_cast<const float*>(sa);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.M = M;
  p.N = N;
  p.K = K;
  p.m_tiles = (M + kBM - 1) / kBM;
  p.n_tiles = (N + bn - 1) / bn;
  p.nk = (K + kBoxes<kDense> * kBK - 1) / (kBoxes<kDense> * kBK);
  return launch<kDense>(out_dtype == 1, bn, amap, bmap, omap, p, stream);
}

// dtypes: bit 0 x (0 bf16, 1 fp32), bit 1 out (0 bf16, 1 fp32). `x8` is an
// int8 scratch of x's shape, `amax` one fp32. `bw` 0 gathers A with
// cp.async (any stride, C a multiple of 16); `bw` a power of two up to 128
// takes A by TMA in output rectangles of bw x (128 / bw) pixels (stride 1,
// C a multiple of 64).
extern "C" int wiw_w8a8_conv(const void* x, void* x8, void* amax, const void* w8,
                             const void* sw, const void* bias, void* out,
                             int Nb, int H, int W, int C, int O, int kh, int kw,
                             int stride, int pad, int OH, int OW, int bn, int bw,
                             int dtypes, void* stream_) {
  const int64_t M64 = static_cast<int64_t>(Nb) * OH * OW;
  const int64_t K64 = static_cast<int64_t>(kh) * kw * C;
  static_assert(kCluster<kConvTma> == kCluster<kConvGather>, "one B map");
  const bool tma = bw > 0;
  if (Nb <= 0 || OH <= 0 || OW <= 0 || C <= 0 || C % 16 || O <= 0 || O % 8 ||
      kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 || M64 > 0x7fffffff ||
      K64 > 0x7fffffff ||
      static_cast<int64_t>(Nb) * H * W * C > (static_cast<int64_t>(1) << 40) ||
      !(tma ? bn_ok<kConvTma>(bn) : bn_ok<kConvGather>(bn)) || bw < 0 || bw > kBM ||
      (bw & (bw - 1)) || (tma && (stride != 1 || C % kBK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = static_cast<int>(M64), K = static_cast<int>(K64);
  const bool of32 = (dtypes >> 1) & 1;
  const int bh = tma ? kBM / bw : 0;
  CUtensorMap amap{}, bmap, omap;
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(Nb)};
    const cuuint64_t c = static_cast<cuuint64_t>(C);
    const cuuint64_t strides[3] = {c, c * W, c * W * H};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(bw),
                               static_cast<cuuint32_t>(bh), 1};
    if (!sm90_tiled_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, x8, dims, strides,
                        box, CU_TENSOR_MAP_SWIZZLE_64B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!rows_map(&bmap, w8, O, K, bn / kCluster<kConvTma>) ||
      !out_map(&omap, out, of32, O, M, Nb, OH, OW, bw, bh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n8 = static_cast<int64_t>(Nb) * H * W * C / 8;
  float* am = static_cast<float*>(amax);
  int8_t* q = static_cast<int8_t*>(x8);
  cudaError_t e = cudaMemsetAsync(am, 0, sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(
      n8 / 256 + 1 < 132 * 16 ? n8 / 256 + 1 : 132 * 16);
  if (dtypes & 1) {
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
  Params p{};
  p.amax = am;
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.x8 = q;
  p.M = M;
  p.N = O;
  p.K = K;
  p.n_tiles = (O + bn - 1) / bn;
  p.H = H;
  p.W = W;
  p.C = C;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.OH = OH;
  p.OW = OW;
  if (tma) {
    p.bw = bw;
    p.bh = bh;
    p.tiles_w = (OW + bw - 1) / bw;
    p.tiles_h = (OH + bh - 1) / bh;
    const int64_t mt = static_cast<int64_t>(Nb) * p.tiles_h * p.tiles_w;
    if (mt > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    p.m_tiles = static_cast<int>(mt);
    p.nk = (kh * kw * (C / kBK) + kBoxes<kConvTma> - 1) / kBoxes<kConvTma>;
    return launch<kConvTma>(of32, bn, amap, bmap, omap, p, stream);
  }
  p.m_tiles = (M + kBM - 1) / kBM;
  p.nk = (K + kBoxes<kConvGather> * kBK - 1) / (kBoxes<kConvGather> * kBK);
  return launch<kConvGather>(of32, bn, amap, bmap, omap, p, stream);
}
