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
// below the H100's ridge (and fp32 CUDA-core work at 67 TFLOP/s, not tensor
// cores). At the UNet's level 0 ([2, 14, 9216, 320]) one call moves
// 4 x 165 MB = 661 MB (q, k, v read once, o written once): 0.20 ms at
// 3.35 TB/s, against ~0.07 ms of fp32 math.
//
// Design: read every byte once and keep everything else on chip. Eight
// lanes own one (position, head): each lane holds 8 of its 64 channels
// (one 16-byte load per frame), so a warp's four heads read 512 contiguous
// bytes of a frame row per load and the frame stride (S*H*64 elements) only
// separates fully coalesced segments. A lane keeps all F frames of its k
// and v channels in registers (bf16, 2 x 16 uint4), then for each query
// frame computes the F partial dot products, finishes them with three xor
// shuffles inside the 8 lanes, runs the softmax over F (<= 16, tail masked)
// redundantly in each lane, and accumulates the weighted sum of v in fp32.
// Measured (PERF.md): instruction issue (shuffles, bf16 unpacking), not the
// bytes, bounds this version; 16 lanes of 4 channels each (no register
// spills, but 4 shuffles a logit on twice the lanes) ran twice as slow as
// these 8 lanes (which spill ~250 bytes a thread).
// The TPU kernel did the same work on the VPU so as not to issue 14x64x14
// matmuls; on Hopper too the tiles are far too small for the tensor cores.
// Inactive lanes of a ragged last block run on zeros and store nothing, so
// the shuffles always see full warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kMaxF = 16;       // frames held in registers
constexpr int kVec = 8;         // channels per lane: one 16-byte load
constexpr int kLanesPerHead = kD / kVec;
constexpr int kThreads = 256;
constexpr int kGroupsPerBlock = kThreads / kLanesPerHead;

__device__ __forceinline__ void unpack(const uint4& u, float f[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return u;
}

__global__ void __launch_bounds__(kThreads)
temporal_attn_d64_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int F, int S, int H,
                         int64_t groups, float scale) {
  const int lane_h = threadIdx.x % kLanesPerHead;
  const int64_t grp =
      static_cast<int64_t>(blockIdx.x) * kGroupsPerBlock + threadIdx.x / kLanesPerHead;
  const bool active = grp < groups;
  // group = (b * S + s) * H + h; element (b, f, s, h*64 + c) lives at
  // ((b*F + f)*S + s)*H*64 + h*64 + c
  const int64_t per_b = static_cast<int64_t>(S) * H;
  const int64_t b = active ? grp / per_b : 0;
  const int64_t sh = active ? grp - b * per_b : 0;
  const int64_t frame_stride = per_b * kD;
  const int64_t base = b * F * frame_stride + sh * kD + lane_h * kVec;

  uint4 kr[kMaxF], vr[kMaxF];
#pragma unroll
  for (int g = 0; g < kMaxF; ++g) {
    kr[g] = make_uint4(0u, 0u, 0u, 0u);
    vr[g] = make_uint4(0u, 0u, 0u, 0u);
    if (active && g < F) {
      kr[g] = *reinterpret_cast<const uint4*>(k + base + g * frame_stride);
      vr[g] = *reinterpret_cast<const uint4*>(v + base + g * frame_stride);
    }
  }

#pragma unroll 1
  for (int f = 0; f < F; ++f) {
    float qf[kVec];
    uint4 qu = make_uint4(0u, 0u, 0u, 0u);
    if (active) qu = *reinterpret_cast<const uint4*>(q + base + f * frame_stride);
    unpack(qu, qf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qf[i] *= scale;

    float logit[kMaxF];
    float m = -INFINITY;
#pragma unroll
    for (int g = 0; g < kMaxF; ++g) {
      float kf[kVec];
      unpack(kr[g], kf);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) s = fmaf(qf[i], kf[i], s);
      // the lanes of one head are aligned to kLanesPerHead in the warp
#pragma unroll
      for (int off = 1; off < kLanesPerHead; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      logit[g] = g < F ? s : -INFINITY;
      m = fmaxf(m, logit[g]);
    }
    float l = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxF; ++g) {
      logit[g] = g < F ? expf(logit[g] - m) : 0.f;
      l += logit[g];
    }
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxF; ++g) {
      if (g < F) {
        const float w = logit[g] / l;
        float vf[kVec];
        unpack(vr[g], vf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(w, vf[i], acc[i]);
      }
    }
    if (active) *reinterpret_cast<uint4*>(o + base + f * frame_stride) = pack(acc);
  }
}

}  // namespace

// C entry, bound with ctypes. q, k, v, o: device pointers of contiguous,
// 16-byte aligned bf16 [B, F, S, H*64] tensors. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes it refuses).
extern "C" int wiw_temporal_attn_d64(const void* q, const void* k,
                                     const void* v, void* o, int B, int F,
                                     int S, int H, float scale, void* stream) {
  const int64_t groups = static_cast<int64_t>(B) * S * H;
  const int64_t blocks = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  if (F < 1 || F > kMaxF || groups < 1 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  temporal_attn_d64_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), F,
      S, H, groups, scale);
  return static_cast<int>(cudaGetLastError());
}
