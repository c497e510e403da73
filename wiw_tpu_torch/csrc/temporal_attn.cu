// Frame attention for Hopper (sm_90a): for every (batch, position, head) of
// q, k, v in [B, F, S, H*64] layout, softmax over the F frames, bf16 in/out.
//
// Replaces the TPU kernel `_kernel` in wiw_tpu/ops/temporal_attention.py
// (reached from `temporal_self_attention_pallas`), with its numerics: q scaled
// in fp32, fp32 logits, fp32 softmax weights that are NOT rounded to bf16
// before the weighted sum of v, the output rounded to bf16 once.
//
// What bounds it on this card: memory. Each (position, head) does
// 4*F*F*64 flops on 3*F*64 bf16 inputs, ~19 flops per byte at F = 14, far
// below the H100's ridge. At the UNet's level 0 ([2, 14, 9216, 320]) one
// call moves 4 x 165 MB = 661 MB (q, k, v read once, o written once): 0.20
// ms at 3.35 TB/s. The first version (one head on 8 lanes of fp32 FMAs)
// was bound by its instruction count instead: it re-unpacked every frame of k
// and v from bf16 for each query frame, finished each logit with three xor
// shuffles (588 a position and head at F = 14), divided each weight, and
// spilled.
//
// Design: the two products of a (position, head) are each one m16 tile of
// `mma.sync`, which the TPU kernel avoided on its matrix unit. A warp takes
// one (position, head): it pads the F <= 16 frames to 16 and runs
//  * QK^T as mma.sync.m16n8k16 bf16 -> fp32, 2 n-tiles (frames) x 4 k-steps
//    (channels). q * 64^-1/2 is a scale by 2^-3, exact in fp32, and bf16
//    products are exact in fp32, so the tensor cores give the fp32 FMAs'
//    logits up to the order of summation;
//  * the softmax over the frames on the accumulator fragment: a row's four
//    lanes share it, so its max and sum take two quad shuffles each, the
//    columns past F masked to -inf;
//  * PV with the fragment reused as the A operand (the FA2 register
//    layout: the accumulators of n-tiles 0 and 1 are the A fragment of the
//    16 frames), no round trip through shared memory. Each fp32 weight is
//    split into bf16 hi + lo and both run through the tensor cores with
//    fp32 accumulation, which keeps ~16 bits of the weight, far below the
//    output's one bf16 rounding; the sum is divided by the row's sum once.
// Staging: q, k and v come by TMA through a 5-D tensor map over
// [B, F, S, H, 64] (dims innermost first: 64 channels, F frames, S
// positions, H heads, B), each box {64, 16, 4, 1, 1}: one head's 64
// channels (128 bytes, the 128-byte swizzle that ldmatrix reads without
// bank conflicts) of 4 positions x 16 frames; frames past F and positions
// past S lie outside the map and arrive as zeros. A CTA of 4 warps takes
// the 4 positions of a box; the grid is persistent, a ring of 2 stages on
// mbarriers, one thread issuing each stage's three boxes once the CTA is
// done with it. The output goes through the warp's q rows in shared memory
// and out in 16-byte stores. Every byte is read once and written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kMaxF = 16;      // frames padded to one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSBlk = kWarps;  // positions a stage: one a warp
constexpr int kStages = 2;
constexpr int kBox = kSBlk * kMaxF * kD * 2;  // bytes of one tensor's box
constexpr int kStageBytes = 3 * kBox;         // q, k, v
constexpr int kSmem = kStages * kStageBytes + 1024 + 64;  // + alignment, barriers

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// byte offset of (line, byte column) in a box of 128-byte lines, 128-byte
// swizzled (the box starts 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int line, int col_bytes) {
  return static_cast<uint32_t>(line * 128 +
                               ((((col_bytes >> 4) ^ (line & 7)) << 4) | (col_bytes & 15)));
}

struct Item {
  int b, h, s0;
};

// items walk heads fastest, then blocks of positions, then the batch, so
// neighbouring CTAs read neighbouring 128-byte lines
__device__ __forceinline__ Item item_of(int64_t item, int H, int s_blocks) {
  Item it;
  it.h = static_cast<int>(item % H);
  const int64_t rest = item / H;
  it.s0 = static_cast<int>(rest % s_blocks) * kSBlk;
  it.b = static_cast<int>(rest / s_blocks);
  return it;
}

__global__ void __launch_bounds__(kThreads)
frame_attn_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int F, int S, int H,
                      int64_t items, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row
  const int t = lane & 3;   // thread in the row's quad
  const int s_blocks = (S + kSBlk - 1) / kSBlk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) sm90::mbar_init(&full[st], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  auto fetch = [&](int64_t item, int st) {
    const Item it = item_of(item, H, s_blocks);
    uint8_t* base = smem + st * kStageBytes;
    sm90::mbar_expect_tx(&full[st], kStageBytes);
    tma_load_5d(base, &qmap, &full[st], 0, 0, it.s0, it.h, it.b);
    tma_load_5d(base + kBox, &kmap, &full[st], 0, 0, it.s0, it.h, it.b);
    tma_load_5d(base + 2 * kBox, &vmap, &full[st], 0, 0, it.s0, it.h, it.b);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      const int64_t item = blockIdx.x + static_cast<int64_t>(st) * gridDim.x;
      if (item < items) fetch(item, st);
    }
  }

  // ldmatrix lanes: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  int it = 0;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int st = it % kStages;
    sm90::mbar_wait(&full[st], static_cast<uint32_t>((it / kStages) & 1));
    const Item cur = item_of(item, H, s_blocks);
    const int s = cur.s0 + warp;
    uint8_t* qs = smem + st * kStageBytes;
    const uint32_t qa = sm90::smem_u32(qs);
    const uint32_t ka = qa + kBox;
    const uint32_t va = qa + 2 * kBox;
    const int line0 = warp * kMaxF;  // this warp's position: 16 frame lines

    if (s < S) {  // warp-uniform
      // logits = q k^T over the 16 (padded) frames: 2 n-tiles x 4 k-steps
      float c[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        uint32_t a[4], b[4];
        // A: q rows (frames) mr + 8 (mi & 1), channels kc*16 + 8 (mi >> 1)
        ldmatrix_x4(a, qa + swz(line0 + mr + ((mi & 1) << 3), (kc * 2 + (mi >> 1)) * 16));
        // B: k rows (frames) mr + 8 (mi >> 1), channels kc*16 + 8 (mi & 1)
        ldmatrix_x4(b, ka + swz(line0 + mr + ((mi >> 1) << 3), (kc * 2 + (mi & 1)) * 16));
        mma_16816(c[0], a, b[0], b[1]);
        mma_16816(c[1], a, b[2], b[3]);
      }
      // softmax over the frames of rows g (c[.][0, 1]) and g + 8 (c[.][2, 3])
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          c[nt][e] = col < F ? c[nt][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], c[nt][e]);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        __nv_bfloat16 hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(c[nt][e] - mx[e >> 1]);
          sum[e >> 1] += p;
          hi[e] = __float2bfloat16_rn(p);
          lo[e] = __float2bfloat16_rn(p - __bfloat162float(hi[e]));
        }
        // accumulator blocks (0, 1) are the A fragment of the 16 frames
        ahi[2 * nt] = pack2(hi[0], hi[1]);
        ahi[2 * nt + 1] = pack2(hi[2], hi[3]);
        alo[2 * nt] = pack2(lo[0], lo[1]);
        alo[2 * nt + 1] = pack2(lo[2], lo[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      }
      // o = p v (hi, then lo), 8 n-tiles of 8 channels
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[4];
        // B^T: v rows (frames) mr + 8 (mi & 1), channels nb*16 + 8 (mi >> 1)
        ldmatrix_x4_trans(b, va + swz(line0 + mr + ((mi & 1) << 3), (nb * 2 + (mi >> 1)) * 16));
        mma_16816(acc[2 * nb], ahi, b[0], b[1]);
        mma_16816(acc[2 * nb], alo, b[0], b[1]);
        mma_16816(acc[2 * nb + 1], ahi, b[2], b[3]);
        mma_16816(acc[2 * nb + 1], alo, b[2], b[3]);
      }
      // the output, rounded once, over this warp's q lines, then out
      const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col_bytes = (nt * 8 + 2 * t) * 2;
        *reinterpret_cast<__nv_bfloat162*>(qs + swz(line0 + g, col_bytes)) =
            __floats2bfloat162_rn(acc[nt][0] * inv0, acc[nt][1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(qs + swz(line0 + g + 8, col_bytes)) =
            __floats2bfloat162_rn(acc[nt][2] * inv1, acc[nt][3] * inv1);
      }
      __syncwarp();
      const int64_t HD = static_cast<int64_t>(H) * kD;
      for (int idx = lane; idx < F * 8; idx += 32) {
        const int f = idx >> 3, chunk = idx & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(qs + swz(line0 + f, chunk * 16));
        __nv_bfloat16* dst = o + ((static_cast<int64_t>(cur.b) * F + f) * S + s) * HD +
                             static_cast<int64_t>(cur.h) * kD + chunk * 8;
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    // the stage's generic reads and writes are ordered before TMA refills it
    sm90::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t next = item + static_cast<int64_t>(kStages) * gridDim.x;
      if (next < items) fetch(next, st);
    }
  }
}

// the 5-D map of a contiguous [B, F, S, H*64] bf16 tensor as dims (64, F,
// S, H, B), boxes {64, 16, kSBlk, 1, 1}, 128-byte swizzle
bool frames_map(CUtensorMap* map, const void* base, int B, int F, int S, int H) {
  const cuuint64_t line = 128;  // one head's 64 channels
  const cuuint64_t dims[5] = {kD, static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {line * H * S, line * H, line,
                                 line * H * S * static_cast<cuuint64_t>(F)};
  const cuuint32_t box[5] = {kD, kMaxF, kSBlk, 1, 1};
  return sm90_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides,
                        box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// C entry, bound with ctypes. q, k, v, o: device pointers of contiguous,
// 16-byte aligned bf16 [B, F, S, H*64] tensors, 1 <= F <= 16. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for shapes
// it refuses or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int wiw_temporal_attn_d64(const void* q, const void* k,
                                     const void* v, void* o, int B, int F,
                                     int S, int H, float scale, void* stream) {
  if (B < 1 || F < 1 || F > kMaxF || S < 1 || H < 1 ||
      static_cast<int64_t>(B) * F * S * H * kD > (static_cast<int64_t>(1) << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap qm, km, vm;
  if (!frames_map(&qm, q, B, F, S, H) || !frames_map(&km, k, B, F, S, H) ||
      !frames_map(&vm, v, B, F, S, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      frame_attn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_attn_mma_kernel,
                                                        kThreads, kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>(B) * ((S + kSBlk - 1) / kSBlk) * H;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(items < resident ? items : resident);
  frame_attn_mma_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), F, S, H, items, scale);
  return static_cast<int>(cudaGetLastError());
}
