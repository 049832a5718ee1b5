// Fused optimizer updates: one elementwise pass that reads a parameter,
// its gradient and its optimizer state and writes the new parameter and
// state in place.
//
// Replaces: zoo_tpu/ops/pallas/fused_optim.py, _adam_kernel (:87) as
// launched by fused_apply_adam (:144), and _sgd_kernel (:49) as launched
// by fused_apply_sgd (:60).
//
// Semantics as the Pallas kernels, in f32:
// - AdamW: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
//   p -= lr * (m bc1 / (sqrt(v bc2) + eps) + wd p), with the bias
//   corrections bc1 = 1 / (1 - b1^t), bc2 = 1 / (1 - b2^t) computed by
//   the caller for the 1-based step t. Every scalar is a runtime
//   argument, so a new step or learning rate never rebuilds anything.
// - SGD: g' = g + wd p; buf = momentum buf + g'; p -= lr buf.
//
// What bounds it on an H100: bytes. AdamW reads p, g, m, v and writes
// p, m, v: 28 bytes and ~15 flops per element; SGD 20 bytes. At the
// training config's 124.7 M parameters one AdamW step moves 3.49 GB,
// ~1.04 ms at 3.35 TB/s.
//
// What the design does about it: the Pallas kernels view every leaf as
// padded (rows, 128) tiles, which is TPU layout. Here a grid-stride loop
// walks the flat contiguous leaf with 16-byte vector loads and stores
// (when all pointers are 16-byte aligned) and a scalar loop takes the
// ragged tail, so nothing is padded or copied; the update is in place,
// so each byte crosses the memory bus once each way.
#include "zt_common.cuh"

namespace zt {

constexpr int kOptimThreads = 256;
constexpr int kOptimMaxBlocks = 132 * 8;   // 8 blocks per SM, grid-stride

struct AdamArgs {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

struct SgdArgs {
  float lr, momentum, wd;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamArgs& a) {
  m = a.b1 * m + (1.f - a.b1) * g;
  v = a.b2 * v + (1.f - a.b2) * g * g;
  const float update = (m * a.bc1) / (sqrtf(v * a.bc2) + a.eps) + a.wd * p;
  p = p - a.lr * update;
}

__device__ __forceinline__ void sgd_one(float& p, float g, float& buf,
                                        const SgdArgs& a) {
  g = g + a.wd * p;
  buf = a.momentum * buf + g;
  p = p - a.lr * buf;
}

__global__ void __launch_bounds__(kOptimThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v, int64_t n,
                int64_t n_vec, AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (int64_t i = t; i < n_vec; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, a);
    adam_one(pp.y, gg.y, mm.y, vv.y, a);
    adam_one(pp.z, gg.z, mm.z, vv.z, a);
    adam_one(pp.w, gg.w, mm.w, vv.w, a);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (int64_t i = 4 * n_vec + t; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, a);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void __launch_bounds__(kOptimThreads)
    sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ buf, int64_t n, int64_t n_vec,
               SgdArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int64_t i = t; i < n_vec; i += stride) {
    float4 pp = p4[i], bb = b4[i];
    const float4 gg = g4[i];
    sgd_one(pp.x, gg.x, bb.x, a);
    sgd_one(pp.y, gg.y, bb.y, a);
    sgd_one(pp.z, gg.z, bb.z, a);
    sgd_one(pp.w, gg.w, bb.w, a);
    p4[i] = pp;
    b4[i] = bb;
  }
  for (int64_t i = 4 * n_vec + t; i < n; i += stride) {
    float pp = p[i], bb = buf[i];
    sgd_one(pp, g[i], bb, a);
    p[i] = pp;
    buf[i] = bb;
  }
}

// float4 part of an n-element pass (0 unless every pointer is 16-byte
// aligned) and the grid that covers it
inline int64_t vec_len(int64_t n, int aligned) { return aligned ? n / 4 : 0; }

inline int grid_for(int64_t n, int64_t n_vec) {
  const int64_t work = n_vec > 0 ? n_vec : n;
  const int64_t blocks = (work + kOptimThreads - 1) / kOptimThreads;
  return static_cast<int>(blocks < 1 ? 1
                          : blocks > kOptimMaxBlocks ? kOptimMaxBlocks
                                                     : blocks);
}

}  // namespace zt

// In-place AdamW over n contiguous f32 elements of p, m, v with gradient
// g. aligned = 1 when all four pointers are 16-byte aligned.
extern "C" int zt_fused_adam(void* p, const void* g, void* m, void* v,
                             long long n, float lr, float b1, float b2,
                             float eps, float wd, float bc1, float bc2,
                             int aligned, void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t n_vec = vec_len(n, aligned);
  adam_kernel<<<grid_for(n, n_vec), kOptimThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, n_vec,
      AdamArgs{lr, b1, b2, eps, wd, bc1, bc2});
  return cudaGetLastError();
}

// In-place SGD with momentum and L2 decay over n contiguous f32 elements.
extern "C" int zt_fused_sgd(void* p, const void* g, void* buf, long long n,
                            float lr, float momentum, float wd, int aligned,
                            void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t n_vec = vec_len(n, aligned);
  sgd_kernel<<<grid_for(n, n_vec), kOptimThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(buf), n, n_vec, SgdArgs{lr, momentum, wd});
  return cudaGetLastError();
}
