// Shared device helpers of the zoo_tpu_torch kernels.
//
// Every kernel library exposes a plain C interface: each entry point
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. zt_error_string() turns that code into text.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace zt {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch and XLA narrow f32 to bf16
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------
// Paged attention pieces shared by paged_decode.cu and paged_prefill.cu.
//
// A block of kThreads threads serves one (sequence, kv head). It copies
// one cache block (block_size rows x D) of K and V into shared memory,
// widened to f32 (int8 rows times their absmax scale, right after the
// load), then each warp advances the online softmax of its query rows
// over those rows. A lane owns one cache row for the scores (so
// block_size <= 32) and the columns lane, lane+32, ... of the output
// (so D <= 32 * kMaxSlices).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxSlices = 4;

// Copy cache block `blk` of kv head `h` (bs rows x D) of K and V into
// shared memory (ks with row stride D+1, vs with row stride D), widened
// to f32. Each thread issues kLoadBatch K and V loads before it stores
// any, so a block's loads are in flight together instead of paying the
// device-memory latency once per element.
constexpr int kLoadBatch = 8;

template <typename TC>
__device__ __forceinline__ void load_kv_block(
    const TC* __restrict__ kc, const TC* __restrict__ vc,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int blk,
    int h, int n_kv, int bs, int D, float* ks, float* vs) {
  const int n = bs * D;
  const size_t base = static_cast<size_t>(blk) * bs;
  for (int i0 = threadIdx.x; i0 < n; i0 += blockDim.x * kLoadBatch) {
    TC kx[kLoadBatch], vx[kLoadBatch];
    float kscale[kLoadBatch], vscale[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int c = i / D, d = i - c * D;
        const size_t row = (base + c) * n_kv + h;
        kx[u] = kc[row * D + d];
        vx[u] = vc[row * D + d];
        kscale[u] = ksc != nullptr ? ksc[row] : 1.f;
        vscale[u] = vsc != nullptr ? vsc[row] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int c = i / D, d = i - c * D;
        // int8 rows are widened by their scale right after the load
        ks[c * (D + 1) + d] =
            ksc != nullptr ? to_f32(kx[u]) * kscale[u] : to_f32(kx[u]);
        vs[c * D + d] =
            vsc != nullptr ? to_f32(vx[u]) * vscale[u] : to_f32(vx[u]);
      }
    }
  }
}

// One query row (q, f32 in shared memory) against the cache rows
// start .. start+bs-1 held in ks (ld D+1) and vs (ld D); columns past
// pos are masked. Updates the row's running max m, denominator l and
// unnormalised output acc (this lane's D-slices).
__device__ __forceinline__ void attend_rows(const float* q, const float* ks,
                                            const float* vs, int bs, int D,
                                            int start, int pos, float scale,
                                            float& m, float& l,
                                            float (&acc)[kMaxSlices]) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  float s = -INFINITY;
  if (lane < bs && start + lane <= pos) {
    const float* k = ks + lane * (D + 1);
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q[d], k[d], dot);
    s = dot * scale;
    live = true;
  }
  const float m_new = fmaxf(m, warp_max(s));
  const float safe = (m_new == -INFINITY) ? 0.f : m_new;
  const float p = live ? expf(s - safe) : 0.f;
  const float corr = (m == -INFINITY) ? 0.f : expf(m - safe);
  l = corr * l + warp_sum(p);
#pragma unroll
  for (int i = 0; i < kMaxSlices; ++i) acc[i] *= corr;
  for (int c = 0; c < bs; ++c) {
    const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
    for (int i = 0; i < kMaxSlices; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(pc, vs[c * D + d], acc[i]);
    }
  }
  m = m_new;
}

}  // namespace zt

extern "C" const char* zt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
