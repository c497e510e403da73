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
// ridge. The statistics are per (row, group), so before any output is
// written only one (row, group) slab of [L, C/G] has to stay on chip, not
// the whole row: at every UNet shape that slab is far under the 50 MB L2
// (a temporal level-0 group, [14 * 9216, 10] bf16, is 2.6 MB). The floor is
// one read of x and one write of y wherever L * C/G * itemsize fits in the
// L2, and two reads and a write beyond it.
//
// Design: one launch a call (`ops/group_norm.k8_plan` picks the path, the
// slab, the cluster and the grid; the C entry refuses any other plan). The
// unit of work is a (row n, slab) pair: a slab is a channel range that is
// a whole number of groups and a multiple of 8 channels (16 bytes). Thread
// t of a block owns the 16-byte column (t mod nv) of the slab (nv vectors a
// position) at every (threads / nv)-th position.
//  * Path R (resident): the slab fits the shared memory of a cluster of at
//    most 16 CTAs (above 8 with the non-portable attribute): 92 KB a CTA,
//    two an SM, on slabs of at least 64 bytes a position, or one an SM on
//    slabs of at least 128. CTA k loads positions [k*rows, (k+1)*rows) of
//    the slab by 16-byte cp.async (four commit groups, so that the first
//    pass overlaps the loads; each thread reads back only what it loaded),
//    takes each group's (mean, M2) over them by a corrected two-pass from
//    shared memory, and after a cluster barrier every CTA reads every CTA's
//    partials through distributed shared memory (one load a CTA) and merges
//    them in the same order, so all hold the same scale and offset. Each
//    normalises its positions from shared memory and stores y with
//    streaming stores. x is read once, y written once.
//  * Path S (streamed): no slab fits (the temporal rows of levels 0-1, the
//    VAE's rows from 144x256 up, and the narrow slabs of C = 512). One
//    cooperative launch, two blocks an SM, on half-row slabs (contiguous
//    reads); block j always takes the same range of positions of the same
//    slab of every row, and a batch is as many whole rows as 80 MB holds.
//    (A) each thread streams its columns of the batch's rows from HBM under
//    an L2 evict_last policy, four vectors in flight, keeping each
//    channel's (mean, M2) by a two-pass over each four merged in order by
//    Chan's formula; the block combines them into its groups' (mean, M2);
//    the slab's last block to arrive (an arrival counter that it resets)
//    combines the slab's partials in block order. (B) after one grid
//    barrier, each thread reads its columns again, last loaded first (what
//    of the batch is still in L2), and normalises them. x is read twice,
//    less what the L2 still holds.
// Statistics: each thread's and block's (mean, M2) is a two-pass in fp32
// with the first pass's rounding folded back; CTAs, blocks and channels
// combine in double, mean = sum(n_i mean_i) / n,
// M2 = sum(M2_i + n_i (mean_i - mean)^2), summed in a fixed tree. The
// variance so has the quality of an exact two-pass, with no data-dependent
// pass. SiLU uses the fast exponential and division. No atomics on any
// sum; every sum has a fixed order (bits repeat from run to run); nothing
// that sets the arithmetic depends on N (path S's rows a batch only say
// which rows share a barrier), so a row's bits do not depend on the rows
// beside it. Offsets are 64-bit: a VAE tensor of 14 frames at 576x1024
// ([14, 589824, 128] bf16) passes 2^31 bytes.
// Measured (PERF.md): both paths run at 1.2-2 TB/s of the floor's bytes,
// the phases of a CTA or a batch (loads, statistics, the barrier, the
// apply) overlapping only in part; against the previous three-launch
// design, path R is faster at most UNet shapes and path S at the VAE's,
// slower at the UNet's temporal level-0 and level-1 rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace coop = cooperative_groups;

constexpr int kThreadsR = 256;    // path R: two CTAs an SM where they fit
constexpr int kThreadsS = 256;    // path S: kBlocksS blocks an SM
constexpr int kBlocksS = 2;
constexpr int kChunk = 4;         // path S: vectors a thread loads at a time
constexpr int kChunks = 4;        // path R: commit groups of a shard's loads
constexpr int kMaxCluster = 16;   // above 8 with the non-portable attribute
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kVec = 8;            // copy kernel: bf16 a thread
constexpr int kApplyThreads = 256;

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // channels in 16 bytes
};

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], const float*) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8], const __nv_bfloat16*) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 pack(const float (&v)[4], const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// v rounded to T and back (the identity for fp32)
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// ------------------------------------------------------------ memory access
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t policy) {
  uint4 u;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p), "l"(policy));
  return u;
}

// a streaming store: y is not read again, so it should not push x out of L2
__device__ __forceinline__ void st_stream(void* p, const uint4& u) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(u.x),
               "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the float at `p`'s offset in the shared memory of CTA `cta` of the cluster
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sm90::smem_u32(p)), "r"(cta));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---------------------------------------------------------- the slab's work
// A thread's place in a slab of w channels: column `col` of the nv 16-byte
// vectors of a position, positions row0, row0 + rs, ...
// (K8-stats also runs blocks narrower than a position, nv > threads: then
// rs = 1 and thread t takes the columns t, t + threads, ... in turn.)
struct Lanes {
  int nv, rs, col, row0;
  bool active;
  __device__ Lanes(int w, int vec) {
    nv = w / vec;
    rs = max(1, static_cast<int>(blockDim.x) / nv);
    col = threadIdx.x % nv;
    row0 = threadIdx.x / nv;
    active = row0 < rs;
  }
  // how many of the first `rows` positions are this thread's
  __device__ int mine(int rows) const {
    return active && row0 < rows ? (rows - 1 - row0) / rs + 1 : 0;
  }
};

// fp32 scratch of a path-R CTA after its shard (see `smem_extra`)
struct Scratch {
  float *red1, *red2;   // [rs * w]: per-thread channel sums
  float *seg1, *seg2;   // [max(w, threads)]: sums of row segments
  float *sc, *of;       // [w]: per-channel scale and offset
  float *gmean;         // [gs]: pass 1's group mean
  float *pmean, *pm2;   // [gs]: this CTA's (mean, M2) per group
  float *fmean, *frstd; // [gs]: the slab's mean and 1/std
};

__host__ __device__ inline int seg_floats(int w, int nt) { return w > nt ? w : nt; }

// bytes of fp32 scratch a CTA of nt threads needs beside its shard
__host__ __device__ inline int smem_extra(int w, int gs, int rs, int nt) {
  return 4 * (2 * rs * w + 2 * seg_floats(w, nt) + 2 * w + 5 * gs);
}

__device__ Scratch carve(float* p, int rs, int w, int gs) {
  const int nt = static_cast<int>(blockDim.x);
  Scratch s;
  s.red1 = p; p += rs * w;
  s.red2 = p; p += rs * w;
  s.seg1 = p; p += seg_floats(w, nt);
  s.seg2 = p; p += seg_floats(w, nt);
  s.sc = p; p += w;
  s.of = p; p += w;
  s.gmean = p; p += gs;
  s.pmean = p; p += gs;
  s.pm2 = p; p += gs;
  s.fmean = p; p += gs;
  s.frstd = p;
  return s;
}

// Sums over the block's threads of each of the slab's channels (the rs row
// threads in segments, then the segments in order), then of each group over
// its channels in order: a[g] (and b[g] when kTwo). Fixed order throughout.
template <int V, bool kTwo>
__device__ void group_sums(const float (&x)[V], const float (&y)[V], const Lanes& ln,
                           int w, int cg, int gs, const Scratch& sm, float* a,
                           float* b) {
  if (ln.active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sm.red1[ln.row0 * w + ln.col * V + e] = x[e];
      if (kTwo) sm.red2[ln.row0 * w + ln.col * V + e] = y[e];
    }
  }
  __syncthreads();
  const int nt = static_cast<int>(blockDim.x);
  const int segs = w >= nt ? 1 : nt / w;
  const int seg_len = (ln.rs + segs - 1) / segs;
  for (int t = threadIdx.x; t < w * segs; t += nt) {
    const int c = t % w, q = t / w;
    const int hi = min(ln.rs, (q + 1) * seg_len);
    float s1 = 0.f, s2 = 0.f;
    for (int r = q * seg_len; r < hi; ++r) {
      s1 += sm.red1[r * w + c];
      if (kTwo) s2 += sm.red2[r * w + c];
    }
    sm.seg1[t] = s1;
    if (kTwo) sm.seg2[t] = s2;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += nt) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < segs; ++q) {
      s1 += sm.seg1[q * w + c];
      if (kTwo) s2 += sm.seg2[q * w + c];
    }
    sm.red1[c] = s1;  // red is free again: reuse its head for the channels
    if (kTwo) sm.red2[c] = s2;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < gs; g += nt) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      s1 += sm.red1[g * cg + j];
      if (kTwo) s2 += sm.red2[g * cg + j];
    }
    a[g] = s1;
    if (kTwo) b[g] = s2;
  }
  __syncthreads();
}

// this thread's pass-1 channel sums over its vectors i0..i1 of `buf`
template <typename T>
__device__ __forceinline__ void add_rows(float (&s)[Vec<T>::n], const uint4* buf,
                                         const Lanes& ln, int i0, int i1) {
  for (int i = i0; i < i1; ++i) {
    float v[Vec<T>::n];
    unpack(buf[(ln.row0 + i * ln.rs) * ln.nv + ln.col], v, static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < Vec<T>::n; ++e) s[e] += v[e];
  }
}

// (mean, M2) per group of the `rows` positions held in `buf` (this thread's
// vectors at r * nv + col), `s` being this thread's pass-1 channel sums:
// the corrected two-pass, into sm.pmean / sm.pm2 (zeros for no rows)
template <typename T>
__device__ void buffer_stats(const float (&s)[Vec<T>::n], const uint4* buf, int rows,
                             const Lanes& ln, int w, int cg, int gs,
                             const Scratch& sm) {
  constexpr int V = Vec<T>::n;
  const float cnt = static_cast<float>(rows) * cg;
  group_sums<V, false>(s, s, ln, w, cg, gs, sm, sm.gmean, nullptr);
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    sm.gmean[g] = rows > 0 ? sm.gmean[g] / cnt : 0.f;
  }
  __syncthreads();
  float m[V], d1[V], d2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = sm.gmean[(ln.col * V + e) / cg];
    d1[e] = d2[e] = 0.f;
  }
  const int mine = ln.mine(rows);
  for (int i = 0; i < mine; ++i) {
    float v[V];
    unpack(buf[(ln.row0 + i * ln.rs) * ln.nv + ln.col], v, static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - m[e];
      d1[e] += d;
      d2[e] += d * d;
    }
  }
  group_sums<V, true>(d1, d2, ln, w, cg, gs, sm, sm.pmean, sm.pm2);
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    const float a = sm.pmean[g], a2 = sm.pm2[g];
    sm.pmean[g] = rows > 0 ? sm.gmean[g] + a / cnt : 0.f;
    sm.pm2[g] = rows > 0 ? fmaxf(a2 - a * a / cnt, 0.f) : 0.f;
  }
  __syncthreads();
}

// This thread's channels over k more of its positions (u[0..k)): their
// mean and M2 by a two-pass over the k values, merged into (cnt, mean, m2)
// by Chan's formula.
template <typename T, int K>
__device__ __forceinline__ void chunk_merge(const uint4 (&u)[K], int k, float& cnt,
                                            float (&mean)[Vec<T>::n],
                                            float (&m2)[Vec<T>::n]) {
  constexpr int V = Vec<T>::n;
  const T* tag = nullptr;
  float cm[V], c2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) cm[e] = c2[e] = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < k) {
      float v[V];
      unpack(u[c], v, tag);
#pragma unroll
      for (int e = 0; e < V; ++e) cm[e] += v[e];
    }
  }
  const float kf = static_cast<float>(k);
#pragma unroll
  for (int e = 0; e < V; ++e) cm[e] /= kf;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < k) {
      float v[V];
      unpack(u[c], v, tag);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[e] - cm[e];
        c2[e] = fmaf(d, d, c2[e]);
      }
    }
  }
  const float tot = cnt + kf;
  const float f = kf / tot;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float delta = cm[e] - mean[e];
    mean[e] = fmaf(delta, f, mean[e]);
    m2[e] += c2[e] + delta * delta * cnt * f;
  }
  cnt = tot;
}

// positions of the first `rows` that row thread r (of rs) owns
__device__ __forceinline__ int owned(int rows, int r, int rs) {
  return r < rows ? (rows - 1 - r) / rs + 1 : 0;
}

// The block's groups from its threads' channels (tmean / tm2, thread
// r * nv + col holding `owned(rows, r, rs)` positions of each of its V
// channels): mean = sum(n mean) / n, M2 = sum(M2 + n (mean_i - mean)^2) in
// double over (row thread, channel) in a fixed order, one warp a group, the
// lanes' sums in an xor tree; out(g, mean, M2) from lane 0.
template <int V, typename Out>
__device__ void block_groups(const float* tmean, const float* tm2, int rows, const Lanes& ln,
                             int cg, int gs, const Out& out) {
  const int lane = threadIdx.x & 31;
  const int items = ln.rs * cg;
  for (int g = threadIdx.x >> 5; g < gs; g += blockDim.x >> 5) {
    double n = 0.0, nm = 0.0;
    for (int it = lane; it < items; it += 32) {
      const int r = it / cg, c = g * cg + it % cg;
      const double nr = owned(rows, r, ln.rs);
      n += nr;
      nm += nr * tmean[(r * ln.nv + c / V) * V + c % V];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_xor_sync(0xffffffffu, n, off);
      nm += __shfl_xor_sync(0xffffffffu, nm, off);
    }
    const double mu = n > 0.0 ? nm / n : 0.0;
    double s2 = 0.0;
    for (int it = lane; it < items; it += 32) {
      const int r = it / cg, c = g * cg + it % cg;
      const int at = (r * ln.nv + c / V) * V + c % V;
      const double d = tmean[at] - mu;
      s2 += tm2[at] + owned(rows, r, ln.rs) * d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    if (lane == 0) out(g, mu, s2);
  }
}

// per-channel scale = rstd * gamma and offset = beta - mean * scale of the
// slab starting at channel c0
__device__ void scale_offset(const float* gamma, const float* beta, int c0, int w,
                             int cg, const Scratch& sm) {
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const int g = c / cg;
    const float sc = sm.frstd[g] * gamma[c0 + c];
    sm.sc[c] = sc;
    sm.of[c] = static_cast<float>(static_cast<double>(beta[c0 + c]) -
                                  static_cast<double>(sm.fmean[g]) * sc);
  }
}

template <typename T, bool kSilu>
__device__ __forceinline__ uint4 normalise(const uint4& u, const float (&sc)[Vec<T>::n],
                                           const float (&of)[Vec<T>::n]) {
  float v[Vec<T>::n];
  const T* tag = nullptr;
  unpack(u, v, tag);
#pragma unroll
  for (int e = 0; e < Vec<T>::n; ++e) {
    float o = round_to(fmaf(v[e], sc[e], of[e]), tag);
    // SiLU with the fast exponential and division (a few ulp of fp32, far
    // below the bf16 rounding that follows): the IEEE ones cost ~20
    // instructions a value, as many as the bytes allow for the whole call
    if (kSilu) o = round_to(__fdividef(o, 1.f + __expf(-o)), tag);
    v[e] = o;
  }
  return pack(v, tag);
}

template <typename T>
__device__ __forceinline__ void load_scale(const Lanes& ln, const Scratch& sm,
                                           float (&sc)[Vec<T>::n], float (&of)[Vec<T>::n]) {
#pragma unroll
  for (int e = 0; e < Vec<T>::n; ++e) {
    sc[e] = sm.sc[ln.col * Vec<T>::n + e];
    of[e] = sm.of[ln.col * Vec<T>::n + e];
  }
}

// ------------------------------------------------------------------ path R
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreadsR, 2)
gn_resident_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, int64_t L,
                   int C, int cg, int w, int shard_rows, float eps) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) uint4 smem[];
  const int K = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int n_slabs = C / w;
  const int gs = w / cg;
  const int64_t unit = blockIdx.x / K;
  const int64_t n = unit / n_slabs;
  const int c0 = static_cast<int>(unit % n_slabs) * w;
  const Lanes ln(w, V);
  const int64_t r0 = static_cast<int64_t>(rank) * shard_rows;
  const int rows = static_cast<int>(L - r0 < 0 ? 0 : (L - r0 < shard_rows ? L - r0 : shard_rows));
  uint4* buf = smem;
  const Scratch sm = carve(reinterpret_cast<float*>(smem + static_cast<int64_t>(shard_rows) * ln.nv),
                           ln.rs, w, gs);

  // the shard's loads in kChunks commit groups, so that the first pass
  // starts on the first quarter while the rest is in flight
  const T* src = x + (n * L + r0) * C + c0 + ln.col * V;
  const int mine = ln.mine(rows);
  const int per = (mine + kChunks - 1) / kChunks;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int hi = min(mine, (j + 1) * per);
    for (int i = j * per; i < hi; ++i) {
      const int r = ln.row0 + i * ln.rs;
      cp_async16(buf + r * ln.nv + ln.col, src + static_cast<int64_t>(r) * C);
    }
    cp_async_commit();
  }
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (j == 0) cp_async_wait<kChunks - 1>();
    if (j == 1) cp_async_wait<kChunks - 2>();
    if (j == 2) cp_async_wait<kChunks - 3>();
    if (j == 3) cp_async_wait<0>();
    add_rows<T>(s, buf, ln, j * per, min(mine, (j + 1) * per));
  }
  static_assert(kChunks == 4, "the waits above are written for four groups");
  buffer_stats<T>(s, buf, rows, ln, w, cg, gs, sm);

  // every CTA's partials, merged in CTA order by every CTA: lane q of a
  // group's warp reads CTA q's (mean, M2) once
  sm90::cluster_sync();
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < gs; g += blockDim.x >> 5) {
    double nq = 0.0, mq = 0.0, m2q = 0.0;
    if (lane < K) {
      const int64_t left = L - static_cast<int64_t>(lane) * shard_rows;
      nq = static_cast<double>(left < 0 ? 0 : (left < shard_rows ? left : shard_rows)) * cg;
      mq = ld_cluster(sm.pmean + g, static_cast<uint32_t>(lane));
      m2q = ld_cluster(sm.pm2 + g, static_cast<uint32_t>(lane));
    }
    double tot = nq, nm = nq * mq;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tot += __shfl_xor_sync(0xffffffffu, tot, off);
      nm += __shfl_xor_sync(0xffffffffu, nm, off);
    }
    const double mu = nm / tot;
    const double d = mq - mu;
    double s2 = m2q + nq * d * d;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    if (lane == 0) {
      sm.fmean[g] = static_cast<float>(mu);
      sm.frstd[g] = static_cast<float>(1.0 / sqrt(s2 / tot + static_cast<double>(eps)));
    }
  }
  cluster_arrive();  // done reading the other CTAs' shared memory
  __syncthreads();
  scale_offset(gamma, beta, c0, w, cg, sm);
  __syncthreads();

  float sc[V], of[V];
  load_scale<T>(ln, sm, sc, of);
  T* dst = y + (n * L + r0) * C + c0 + ln.col * V;
  for (int i = 0; i < mine; ++i) {
    const int r = ln.row0 + i * ln.rs;
    st_stream(dst + static_cast<int64_t>(r) * C,
              normalise<T, kSilu>(buf[r * ln.nv + ln.col], sc, of));
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// ------------------------------------------------------------------ path S
// Block j of path S's grid: slab js = j / Q of every row, positions
// [q * per, (q + 1) * per) of it (q = j mod Q, Q = P / n_slabs blocks a
// slab, fewer positions at the end). The split depends on L, the slabs
// and the grid only, so a row's bits depend on neither N nor the batch.
struct Range {
  int js, c0, Q, per;
  int64_t lo;
  int rows;  // positions in the range (0 for a block beyond n_slabs * Q)
};

__device__ Range range_of(int j, int P, int64_t L, int n_slabs, int w) {
  Range r;
  r.Q = P / n_slabs;
  r.js = j / r.Q;
  const int q = j % r.Q;
  r.c0 = r.js * w;
  r.per = static_cast<int>((L + r.Q - 1) / r.Q);
  r.lo = static_cast<int64_t>(q) * r.per;
  const int64_t left = L - r.lo;
  r.rows = r.js < n_slabs ? static_cast<int>(left < 0 ? 0 : (left < r.per ? left : r.per)) : 0;
  return r;
}

// The (count, mean, M2) of a slab's gs groups from its Q blocks' partials
// `in` ([Q][gs] (mean, M2) pairs, block q holding `per` positions, fewer at
// the end): mean = sum(n mean) / n, M2 = sum(M2 + n (mean_q - mean)^2), in
// double. Thread t takes group g = t mod gsub of each run of gsub groups
// and the partials q = t / gsub, + S, ... (S = threads / gsub), four loads
// in flight; the S sums of a group then add in order. out(g, n, mean, M2)
// once a group (path S: its mean and 1/std; K8-stats: the row's result).
template <typename Out>
__device__ void combine_slab(const double2* in, int Q, int per, int64_t L, int cg,
                             int gs, double* red_n, double* red_nm, const Out& out) {
  const int nt = static_cast<int>(blockDim.x);
  for (int g0 = 0; g0 < gs; g0 += nt) {
    const int gsub = min(nt, gs - g0);
    const int S = nt / gsub;
    const int g = g0 + static_cast<int>(threadIdx.x) % gsub;
    const int k = static_cast<int>(threadIdx.x) / gsub;
    auto count = [&](int q) {
      const int64_t left = L - static_cast<int64_t>(q) * per;
      return static_cast<double>(left < 0 ? 0 : (left < per ? left : per)) * cg;
    };
    double n = 0.0, nm = 0.0;
    if (k < S) {
#pragma unroll 4
      for (int q = k; q < Q; q += S) {
        const double nq = count(q);
        n += nq;
        nm += nq * __ldcg(&in[q * gs + g].x);
      }
    }
    red_n[threadIdx.x] = n;
    red_nm[threadIdx.x] = nm;
    __syncthreads();
    double tot = 0.0, mu = 0.0;
    if (k < S) {
      double a = 0.0, b = 0.0;
      for (int i = 0; i < S; ++i) {
        a += red_n[i * gsub + threadIdx.x % gsub];
        b += red_nm[i * gsub + threadIdx.x % gsub];
      }
      tot = a;
      mu = b / a;
    }
    __syncthreads();
    double s2 = 0.0;
    if (k < S) {
#pragma unroll 4
      for (int q = k; q < Q; q += S) {
        const double2 pq = __ldcg(&in[q * gs + g]);
        const double d = pq.x - mu;
        s2 += pq.y + count(q) * d * d;
      }
    }
    red_n[threadIdx.x] = s2;
    __syncthreads();
    if (k == 0) {
      double m2 = 0.0;
      for (int i = 0; i < S; ++i) m2 += red_n[i * gsub + threadIdx.x];
      out(g, tot, mu, m2);
    }
    __syncthreads();
  }
}

// Path S: one cooperative launch of kBlocksS blocks an SM walks the rows,
// `rb` rows a batch. Per batch: (A) for each row of the batch, each thread
// streams its column of its block's range from HBM (an L2 evict_last
// policy, kChunk vectors in flight), keeping each channel's (mean, M2) by
// a two-pass over each chunk merged in order by Chan's formula; the block
// combines its threads' channels into its groups' (mean, M2) and writes
// them; the slab's last block to arrive (an arrival counter, reset by it)
// combines the slab's Q partials in block order into its groups' mean and
// 1/std. (B) after one grid barrier, each thread reads its columns again,
// last loaded first (what is still in L2), and normalises them.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreadsS, kBlocksS)
gn_stream_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ y,
                 double2* __restrict__ part, float2* __restrict__ stats,
                 unsigned* __restrict__ arrived, int64_t N, int64_t L, int C, int cg,
                 int w, int rb, float eps) {
  constexpr int V = Vec<T>::n;
  __shared__ float tmean[kThreadsS * V], tm2[kThreadsS * V];
  __shared__ double red_n[kThreadsS], red_nm[kThreadsS];
  __shared__ unsigned ticket;
  coop::grid_group grid = coop::this_grid();
  const int j = blockIdx.x;
  const int n_slabs = C / w;
  const int gs = w / cg;
  const Lanes ln(w, V);
  const Range rg = range_of(j, gridDim.x, L, n_slabs, w);
  const int mine = ln.active ? owned(rg.rows, ln.row0, ln.rs) : 0;
  const uint64_t keep = l2_policy_evict_last();
  const uint64_t drop = l2_policy_evict_first();
  const int64_t batches = (N + rb - 1) / rb;

  for (int64_t b = 0; b < batches; ++b) {
    const int rows_b = static_cast<int>(N - b * rb < rb ? N - b * rb : rb);
    for (int i = 0; i < rows_b; ++i) {
      const int64_t n = b * rb + i;
      const int64_t base = (n * L + rg.lo) * C + rg.c0 + ln.col * V;
      // (A) this thread's channels: (mean, M2) over its positions
      float cnt = 0.f, mean[V], m2[V];
#pragma unroll
      for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.f;
      for (int i0 = 0; i0 < mine; i0 += kChunk) {
        const int k = min(kChunk, mine - i0);
        uint4 u[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c < k) {
            u[c] = ld_hint(x + base + static_cast<int64_t>(ln.row0 + (i0 + c) * ln.rs) * C,
                           keep);
          }
        }
        chunk_merge<T, kChunk>(u, k, cnt, mean, m2);
      }
      if (ln.active) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          tmean[threadIdx.x * V + e] = mean[e];
          tm2[threadIdx.x * V + e] = m2[e];
        }
      }
      __syncthreads();
      // the block's groups, in a fixed order, into the batch's partials
      const int slot = i * n_slabs + rg.js;  // (row of the batch, slab)
      block_groups<V>(tmean, tm2, rg.rows, ln, cg, gs, [&](int g, double mu, double s2) {
        if (rg.js < n_slabs) {
          part[(static_cast<int64_t>(slot) * rg.Q + j % rg.Q) * gs + g] = make_double2(mu, s2);
          __threadfence();
        }
      });
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        ticket = rg.js < n_slabs ? atomicAdd(&arrived[slot], 1u) : 0u;
      }
      __syncthreads();
      if (rg.js < n_slabs && ticket == static_cast<unsigned>(rg.Q - 1)) {
        // the slab's last block: its groups from the Q blocks' partials
        __threadfence();
        float2* st = stats + (static_cast<int64_t>(b & 1) * rb * n_slabs + slot) * gs;
        combine_slab(part + static_cast<int64_t>(slot) * rg.Q * gs, rg.Q, rg.per, L, cg, gs,
                     red_n, red_nm, [&](int g, double tot, double mu, double m2) {
                       st[g] = make_float2(static_cast<float>(mu),
                                           static_cast<float>(1.0 / sqrt(
                                               m2 / tot + static_cast<double>(eps))));
                     });
        if (threadIdx.x == 0) arrived[slot] = 0u;  // for the next batch
      }
    }
    grid.sync();
    // (B) the apply, last row and last position first
    if (mine > 0) {
      float sc[V], of[V];
      for (int i = rows_b - 1; i >= 0; --i) {
        const int64_t n = b * rb + i;
        const int64_t base = (n * L + rg.lo) * C + rg.c0 + ln.col * V;
        const float2* st = stats + (static_cast<int64_t>(b & 1) * rb * n_slabs + i * n_slabs + rg.js) * gs;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = ln.col * V + e;
          const float2 sg = __ldcg(&st[c / cg]);
          sc[e] = sg.y * gamma[rg.c0 + c];
          of[e] = static_cast<float>(static_cast<double>(beta[rg.c0 + c]) -
                                     static_cast<double>(sg.x) * sc[e]);
        }
        for (int i1 = mine; i1 > 0; i1 -= kChunk) {
          const int k = min(kChunk, i1);
          uint4 u[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            if (c < k) {
              u[c] = ld_hint(x + base + static_cast<int64_t>(ln.row0 + (i1 - 1 - c) * ln.rs) * C,
                             drop);
            }
          }
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            if (c < k) {
              st_stream(y + base + static_cast<int64_t>(ln.row0 + (i1 - 1 - c) * ln.rs) * C,
                        normalise<T, kSilu>(u[c], sc, of));
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- copy kernel
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

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
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

// blocks of a grid-stride pass over `vecs` vectors, at most ~16 waves of
// 132 SMs x 8 blocks
int stride_blocks(int64_t vecs) {
  const int64_t want = (vecs + kApplyThreads - 1) / kApplyThreads;
  return static_cast<int>(want < 16896 ? want : 16896);
}

// ------------------------------------------------- split entries (shard_clip)
// When a (row, group) has positions on several ranks, the statistics and
// the apply are entries of their own, with the ranks' combination between
// them.
//
// K8-stats (`gn_stats_kernel`), x to each row's final (count, mean, M2) per
// group in one launch. Bound by bytes: x read once (~10 operations a
// value). Block (t, n) takes tile t of row n: positions [t * tile, (t + 1)
// * tile) and every channel, as the TPU `_stats_kernel` tiles whole
// positions [TR, C]. Thread r * nv + c owns the 16-byte column c (of the
// nv of a position) at positions r, r + rs, ... of the tile (rs =
// threads / nv; where a position is wider than the block, rs = 1 and a
// thread takes its columns in turn), two chunks of kStatChunk read-only
// loads in flight that L1 does not keep (the apply reads x again, from L2
// where it fits). Each channel's (mean, M2) is path S's: a two-pass over
// each chunk merged by Chan's formula (`chunk_merge`). Then, in double
// and in a fixed order (`fold_tile`), each channel over the row threads
// and each group over its channels (at C/G 10 a vector straddles two
// groups), one (mean, M2) per (row, tile, group) into the call's
// workspace; the last block of a row to arrive (a counter a row in the
// same workspace, zeroed on the call's stream before the launch, so no two
// calls share one) combines the row's tiles in tile order
// (path S's `combine_slab`; the plan keeps it to one round of loads a
// pass) into the float64 [N, G, 3] result. Every sum has a fixed order: the
// bits repeat from run to run. (Path S's `block_groups`, one warp a group
// in turn, took longer on an H100 than a tile's loads: `fold_tile` keeps
// every thread of the block busy.)
//
// The ranks' combination (`gn_combine_kernel`): one thread a (row, group)
// takes the all-gathered [R, N, G, 3] in rank order, Chan's rule in double
// skipping parts of count 0, and writes fp32 mean and rstd = 1 / sqrt(M2 / n
// + eps) (IEEE square root and division: the CPU's rsqrt).
//
// K8-apply (`gn_apply_kernel`): y = x * sc + of per 16-byte vector, sc =
// rstd * gamma, of = beta - mean * sc (in double, as the one-launch
// kernel's), rounded to T, then SiLU: `normalise`, the one-launch kernel's
// arithmetic.
constexpr int kStatMaxThreads = 512;
constexpr int kStatChunk = 4;       // 16-byte loads a chunk, two chunks in flight
constexpr int kCombineThreads = 128;

__device__ __forceinline__ uint4 ld_nc_na(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}

// bytes of dynamic shared memory of a statistics block: scratch of the fold
// and the tiles' combination (three doubles a thread), each channel's
// (mean, M2) in double, and the threads' channel means and M2 (fp32)
__host__ __device__ inline int stats_smem(int threads, int C, int nv, int vec) {
  return 24 * threads + 16 * C + 8 * (threads > nv ? threads : nv) * vec;
}

// A tile's groups from its threads' channels (tmean, tm2: [rs][C], row
// thread r holding owned(rows, r, rs) positions), in double, in a fixed
// order: each channel over the row threads into cmean, cm2 [C] (a thread a
// channel); then each group over its cg channels (`rows` positions each),
// P = threads / G threads a group taking channels p, p + P, ... and their
// sums added in order (red: three doubles a thread). out(g, mean, M2) once
// a group.
template <typename Out>
__device__ void fold_tile(const float* tmean, const float* tm2, int rows, int rs, int C,
                          int cg, double* cmean, double* cm2, double* red, const Out& out) {
  const int nt = static_cast<int>(blockDim.x);
  const int base = rows / rs, extra = rows % rs;  // row thread r: base + (r < extra)
  const double inv = 1.0 / rows;
  for (int c = threadIdx.x; c < C; c += nt) {
    double nm = 0.0;
    for (int r = 0; r < rs; ++r) {
      nm += (base + (r < extra)) * static_cast<double>(tmean[r * C + c]);
    }
    const double mu = nm * inv;
    double m2 = 0.0;
    for (int r = 0; r < rs; ++r) {
      const double d = tmean[r * C + c] - mu;
      m2 += tm2[r * C + c] + (base + (r < extra)) * d * d;
    }
    cmean[c] = mu;
    cm2[c] = m2;
  }
  __syncthreads();
  const int G = C / cg;
  for (int g0 = 0; g0 < G; g0 += nt) {
    const int gsub = min(nt, G - g0);
    const int P = min(nt / gsub, cg);
    const int gl = static_cast<int>(threadIdx.x) % gsub;
    const int p = static_cast<int>(threadIdx.x) / gsub;
    const double* cm = cmean + (g0 + gl) * cg;
    const double* c2 = cm2 + (g0 + gl) * cg;
    double sum = 0.0;
    if (p < P) {
      for (int j = p; j < cg; j += P) sum += cm[j];
    }
    red[threadIdx.x] = sum;
    __syncthreads();
    if (p == 0) {
      double t = 0.0;
      for (int i = 0; i < P; ++i) t += red[i * gsub + gl];
      red[nt + gl] = t / cg;
    }
    __syncthreads();
    const double mu = red[nt + gl];
    double m2 = 0.0;
    if (p < P) {
      for (int j = p; j < cg; j += P) {
        const double d = cm[j] - mu;
        m2 += c2[j] + rows * d * d;
      }
    }
    red[2 * nt + threadIdx.x] = m2;
    __syncthreads();
    if (p == 0) {
      double t = 0.0;
      for (int i = 0; i < P; ++i) t += red[2 * nt + i * gsub + gl];
      out(g0 + gl, mu, t);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kStatMaxThreads, 1)
gn_stats_kernel(const T* __restrict__ x, double2* __restrict__ part,
                unsigned* __restrict__ arrived, double* __restrict__ out, int64_t L, int C,
                int cg, int tile) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) double sdyn[];
  __shared__ unsigned ticket;
  const int nt = static_cast<int>(blockDim.x);
  const int Q = static_cast<int>(gridDim.x);
  const int t = static_cast<int>(blockIdx.x);
  const int64_t n = blockIdx.y;
  const int G = C / cg;
  const Lanes ln(C, V);
  double* scratch = sdyn;
  double* cmean = sdyn + 3 * nt;
  double* cm2 = cmean + C;
  float* tmean = reinterpret_cast<float*>(cm2 + C);
  float* tm2 = tmean + (nt > ln.nv ? nt : ln.nv) * V;
  const int64_t lo = static_cast<int64_t>(t) * tile;
  const int rows = static_cast<int>(L - lo < tile ? L - lo : tile);
  const int mine = ln.active ? owned(rows, ln.row0, ln.rs) : 0;
  const int64_t step = static_cast<int64_t>(ln.rs) * C;

  for (int col = ln.col; ln.active && col < ln.nv; col += min(ln.nv, nt)) {
    const T* src = x + (n * L + lo + ln.row0) * C + col * V;
    float cnt = 0.f, mean[V], m2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.f;
    // two chunks in flight: the next chunk's loads are issued before this
    // one is merged
    uint4 u[kStatChunk], ahead[kStatChunk] = {};
#pragma unroll
    for (int c = 0; c < kStatChunk; ++c) {
      if (c < mine) ahead[c] = ld_nc_na(src + c * step);
    }
    for (int i0 = 0; i0 < mine; i0 += kStatChunk) {
      const int k = min(kStatChunk, mine - i0);
#pragma unroll
      for (int c = 0; c < kStatChunk; ++c) u[c] = ahead[c];
#pragma unroll
      for (int c = 0; c < kStatChunk; ++c) {
        const int i = i0 + kStatChunk + c;
        if (i < mine) ahead[c] = ld_nc_na(src + i * step);
      }
      chunk_merge<T, kStatChunk>(u, k, cnt, mean, m2);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      tmean[ln.row0 * C + col * V + e] = mean[e];
      tm2[ln.row0 * C + col * V + e] = m2[e];
    }
  }
  __syncthreads();
  // the tile's groups into the row's partials
  double2* row_part = part + n * Q * G;
  fold_tile(tmean, tm2, rows, ln.rs, C, cg, cmean, cm2, scratch,
            [&](int g, double mu, double m2) {
    row_part[static_cast<int64_t>(t) * G + g] = make_double2(mu, m2);
  });
  __threadfence();  // each writer's partials, before the block arrives
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(&arrived[n], 1u);
  __syncthreads();
  if (ticket == static_cast<unsigned>(Q - 1)) {
    // the row's last block: its groups from the Q tiles' partials
    __threadfence();
    double* o = out + n * G * 3;
    combine_slab(row_part, Q, tile, L, cg, G, scratch, scratch + nt,
                 [&](int g, double tot, double mu, double m2) {
                   o[g * 3] = tot;
                   o[g * 3 + 1] = mu;
                   o[g * 3 + 2] = m2;
                 });
  }
}

__global__ void __launch_bounds__(kCombineThreads)
gn_combine_kernel(const double* __restrict__ every, float* __restrict__ mean,
                  float* __restrict__ rstd, int R, int64_t NG, float eps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= NG) return;
  double n = 0.0, nm = 0.0;
  for (int r = 0; r < R; ++r) {
    const double* p = every + (r * NG + i) * 3;
    if (p[0] > 0.0) {
      n += p[0];
      nm += p[0] * p[1];
    }
  }
  const double mu = nm / (n > 1.0 ? n : 1.0);
  double m2 = 0.0;
  for (int r = 0; r < R; ++r) {
    const double* p = every + (r * NG + i) * 3;
    if (p[0] > 0.0) {
      const double d = p[1] - mu;
      m2 += p[2] + p[0] * d * d;
    }
  }
  mean[i] = static_cast<float>(mu);
  const float var = static_cast<float>(m2 / n);
  rstd[i] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y, int64_t vecs,
                int64_t row_vecs, int C, int cg, int G) {
  constexpr int V = Vec<T>::n;
  const int cv = C / V;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kApplyThreads + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kApplyThreads) {
    const int64_t n = i / row_vecs;
    const int c0 = static_cast<int>(i % cv) * V;
    float sc[V], of[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = c0 + e;
      const int64_t ng = n * G + c / cg;
      sc[e] = rstd[ng] * gamma[c];
      of[e] = static_cast<float>(static_cast<double>(beta[c]) -
                                 static_cast<double>(mean[ng]) * sc[e]);
    }
    const uint4 u = reinterpret_cast<const uint4*>(x)[i];
    reinterpret_cast<uint4*>(y)[i] = normalise<T, kSilu>(u, sc, of);
  }
}

// ------------------------------------------------------------------- host
template <typename T, bool kSilu>
int launch_resident(const T* x, const float* gamma, const float* beta, T* y,
                    int64_t N, int64_t L, int C, int cg, int w, int cluster,
                    int shard_rows, float eps, int smem, cudaStream_t stream) {
  auto kernel = gn_resident_kernel<T, kSilu>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N * (C / w) * cluster));
  cfg.blockDim = dim3(kThreadsR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, y, L, C, cg, w, shard_rows, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSilu>
int launch_stream(const T* x, const float* gamma, const float* beta, T* y, void* work,
                  int64_t N, int64_t L, int C, int cg, int w, int blocks, int rb,
                  float eps, cudaStream_t stream) {
  auto kernel = gn_stream_kernel<T, kSilu>;
  // a cooperative launch: every block resident at once, or it is refused
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreadsS, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // the scratch (ops/group_norm.k8_work_bytes): the partials of a batch's
  // slabs, their statistics twice (by batch parity), their arrival counters
  const int gs = w / cg;
  const int slots = rb * (C / w);
  const int Q = blocks / (C / w);
  double2* part = static_cast<double2*>(work);
  float2* stats = reinterpret_cast<float2*>(part + static_cast<int64_t>(slots) * Q * gs);
  unsigned* arrived = reinterpret_cast<unsigned*>(stats + 2 * slots * gs);
  err = cudaMemsetAsync(arrived, 0, slots * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreadsS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, y, part, stats, arrived, N, L, C,
                           cg, w, rb, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* work,
           int64_t N, int64_t L, int C, int groups, float eps, bool silu, int path,
           int w, int cluster, int rows, int blocks, int spb, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int cg = C / groups;
  const int nt = path == 0 ? kThreadsR : kThreadsS;
  // the plan's rules (ops/group_norm.k8_plan): whole groups of whole 16-byte
  // vectors, at most one vector column a thread
  if (w <= 0 || C % w || w % cg || w % 8 || w / V > nt || (path == 0 && rows <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nv = w / V, rs = nt / nv;
  const int gs = w / cg;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (path == 0) {
    const int smem = rows * nv * 16 + smem_extra(w, gs, rs, nt);
    if (cluster < 1 || cluster > kMaxCluster || static_cast<int64_t>(rows) * cluster < L ||
        static_cast<int64_t>(rows) * (cluster - 1) >= L || smem > kSmemMax ||
        N * (C / w) * cluster > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return silu ? launch_resident<T, true>(xt, g, b, yt, N, L, C, cg, w, cluster, rows,
                                           eps, smem, stream)
                : launch_resident<T, false>(xt, g, b, yt, N, L, C, cg, w, cluster, rows,
                                            eps, smem, stream);
  }
  // spb: the slabs of rb whole rows
  if (path != 1 || blocks < C / w || spb < C / w || spb % (C / w) || gs > nt ||
      work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rb = spb / (C / w);
  return silu ? launch_stream<T, true>(xt, g, b, yt, work, N, L, C, cg, w, blocks, rb, eps,
                                       stream)
              : launch_stream<T, false>(xt, g, b, yt, work, N, L, C, cg, w, blocks, rb, eps,
                                        stream);
}

}  // namespace

// C entries, bound with ctypes. x, y: contiguous [N, L, C] device arrays of
// bf16 (is_bf16 = 1) or fp32, 16-byte aligned, C a multiple of 8 and of
// `groups`; gamma, beta: fp32 [C]. The plan (`ops/group_norm.k8_plan`):
// path 0 (R) with slab width w, cluster size (up to 16) and the positions a
// CTA holds (rows); path 1 (S) with w, the grid (blocks, all resident at
// once) and the slabs a batch (spb), and work: `ops/group_norm.k8_work_bytes`
// of scratch (the blocks' partials, the batch's statistics twice, and spb
// arrival counters, zeroed here on the stream before the launch).
// Launches once on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape or plan it refuses).
extern "C" int wiw_group_norm(const void* x, const void* gamma, const void* beta,
                              void* y, void* work, int64_t N, int64_t L, int C,
                              int groups, float eps, int is_bf16, int silu, int path,
                              int w, int cluster, int rows, int blocks, int spb,
                              void* stream) {
  if (N <= 0 || N > 65535 || L <= 0 || C <= 0 || C % 8 || groups <= 0 || C % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, gamma, beta, y, work, N, L, C, groups, eps,
                                         silu != 0, path, w, cluster, rows, blocks, spb, s)
                 : launch<float>(x, gamma, beta, y, work, N, L, C, groups, eps, silu != 0,
                                 path, w, cluster, rows, blocks, spb, s);
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

namespace {

template <typename T>
int launch_stats(const void* x, void* work, void* out, int64_t N, int64_t L, int C,
                 int groups, int threads, int tile, cudaStream_t s) {
  const int smem = stats_smem(threads, C, C / Vec<T>::n, Vec<T>::n);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t Q = (L + tile - 1) / tile;
  double2* part = static_cast<double2*>(work);
  unsigned* arrived = reinterpret_cast<unsigned*>(part + N * Q * groups);
  const cudaError_t err = cudaMemsetAsync(arrived, 0, N * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_stats_kernel<T><<<dim3(static_cast<unsigned>(Q), static_cast<unsigned>(N)), threads,
                       smem, s>>>(
      static_cast<const T*>(x), part, arrived, static_cast<double*>(out), L, C, C / groups,
      tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split entries (shard_clip). x: contiguous [N, L, C] (bf16 with
// is_bf16, else fp32), 16-byte aligned, C a multiple of 8 and of `groups`.
// wiw_group_norm_stats: out, double [N, groups, 3]: (count, mean, M2) of
// each (row, group) over its L positions. The plan
// (`ops/group_norm.stats_plan`): blocks of `threads` (a multiple of 32, at
// most 512), `tile` positions a block, Q = ceil(L / tile) blocks a row;
// work: `ops/group_norm.stats_work_bytes` (double2 [N, Q, groups] partials,
// then N arrival counters, zeroed here on the stream). One launch.
extern "C" int wiw_group_norm_stats(const void* x, void* work, void* out, int64_t N,
                                    int64_t L, int C, int groups, int threads, int64_t tile,
                                    int is_bf16, void* stream) {
  if (N <= 0 || N > 65535 || L <= 0 || C <= 0 || C % 8 || groups <= 0 || C % groups ||
      threads < 32 || threads > kStatMaxThreads || threads % 32 || tile <= 0 ||
      tile > 0x7fffffff || (L + tile - 1) / tile > 0x7fffffff || work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tl = static_cast<int>(tile);
  return is_bf16 ? launch_stats<__nv_bfloat16>(x, work, out, N, L, C, groups, threads, tl, s)
                 : launch_stats<float>(x, work, out, N, L, C, groups, threads, tl, s);
}

// wiw_group_norm_combine: every, double [R, N * groups, 3], the parts'
// (count, mean, M2) in rank order, to fp32 mean and rstd [N * groups] (ng =
// N * groups). One launch.
extern "C" int wiw_group_norm_combine(const void* every, void* mean, void* rstd, int R,
                                      int64_t ng, float eps, void* stream) {
  if (R <= 0 || ng <= 0 || (ng + kCombineThreads - 1) / kCombineThreads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gn_combine_kernel<<<static_cast<unsigned>((ng + kCombineThreads - 1) / kCombineThreads),
                      kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(every), static_cast<float*>(mean),
      static_cast<float*>(rstd), R, ng, eps);
  return static_cast<int>(cudaGetLastError());
}

// wiw_group_norm_apply: y [N, L, C] (x's dtype, 16-byte aligned) from fp32
// mean and rstd [N, groups] and gamma, beta [C]; SiLU after with `silu`.
extern "C" int wiw_group_norm_apply(const void* x, const void* mean, const void* rstd,
                                    const void* gamma, const void* beta, void* y,
                                    int64_t N, int64_t L, int C, int groups,
                                    int is_bf16, int silu, void* stream) {
  if (N <= 0 || L <= 0 || C <= 0 || C % 8 || groups <= 0 || C % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = is_bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  const int64_t row_vecs = L * C / V, vecs = N * row_vecs;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int cg = C / groups;
#define WIW_GN_APPLY(T, S)                                                          \
  gn_apply_kernel<T, S><<<stride_blocks(vecs), kApplyThreads, 0, s>>>(             \
      static_cast<const T*>(x), m, r, g, b, static_cast<T*>(y), vecs, row_vecs, C, \
      cg, groups)
  if (is_bf16) {
    if (silu) WIW_GN_APPLY(__nv_bfloat16, true); else WIW_GN_APPLY(__nv_bfloat16, false);
  } else {
    if (silu) WIW_GN_APPLY(float, true); else WIW_GN_APPLY(float, false);
  }
#undef WIW_GN_APPLY
  return static_cast<int>(cudaGetLastError());
}
