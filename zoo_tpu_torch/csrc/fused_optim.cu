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
//   corrections bc1 = 1 / (1 - b1^t), bc2 = 1 / (1 - b2^t) for the
//   1-based step t.
// - SGD: g' = g + wd p; buf = momentum buf + g'; p -= lr buf.
//
// The per-step scalars live in device memory, where the training step
// keeps them: the step t (int32) and, when the learning rate is
// scheduled or decayed, lr (f32; a null pointer means the launch
// argument lr). The constant hyperparameters (b1, b2, eps, wd,
// momentum) are launch arguments. So the host never reads a count to
// launch a step, and a new step or learning rate rebuilds nothing. The
// bias corrections come from t on the device: beta^t taken in double
// and rounded once to f32 (bias_correction below), which is what
// ops/kernels/fused_optim.py's bias_corrections computes on the host,
// bit for bit. A nullable predicate ok (one byte) is the training
// guard's skip: when it reads 0 no block writes p, m, v or buf, the
// identity branch of the JAX step's lax.cond.
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
// so each byte crosses the memory bus once each way. Each thread reads
// the device step, lr and ok once before its loop and takes the double
// power once: a few cached scalar loads and a pow a thread, nothing per
// element.
#include "zt_common.cuh"

namespace zt {

constexpr int kOptimThreads = 256;
constexpr int kOptimMaxBlocks = 132 * 8;   // 8 blocks per SM, grid-stride

struct AdamArgs {
  float lr, b1, b2, eps, wd;
};

struct SgdArgs {
  float lr, momentum, wd;
};

// 1 / (1 - beta^t) in f32: the power in double from the f32 beta,
// rounded once to f32 (the correctly rounded f32 power, where powf may
// be off by an ulp or two), then the f32 subtraction and division
__device__ __forceinline__ float bias_correction(float beta, int t) {
  const float pw = static_cast<float>(
      pow(static_cast<double>(beta), static_cast<double>(t)));
  return 1.f / (1.f - pw);
}

// the learning rate of this step: the device scalar when there is one
__device__ __forceinline__ float step_lr(const float* lr_ptr, float lr) {
  return lr_ptr != nullptr ? *lr_ptr : lr;
}

// whether the guard let this step through (no predicate: always)
__device__ __forceinline__ bool step_ok(const uint8_t* ok) {
  return ok == nullptr || *ok != 0;
}

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamArgs& a,
                                         float lr, float bc1, float bc2) {
  m = a.b1 * m + (1.f - a.b1) * g;
  v = a.b2 * v + (1.f - a.b2) * g * g;
  const float update = (m * bc1) / (sqrtf(v * bc2) + a.eps) + a.wd * p;
  p = p - lr * update;
}

__device__ __forceinline__ void sgd_one(float& p, float g, float& buf,
                                        const SgdArgs& a, float lr) {
  g = g + a.wd * p;
  buf = a.momentum * buf + g;
  p = p - lr * buf;
}

__global__ void __launch_bounds__(kOptimThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v, int64_t n,
                int64_t n_vec, AdamArgs a, const int* __restrict__ step,
                const float* __restrict__ lr_ptr,
                const uint8_t* __restrict__ ok) {
  if (!step_ok(ok)) return;
  const float lr = step_lr(lr_ptr, a.lr);
  const int t_step = *step;
  const float bc1 = bias_correction(a.b1, t_step);
  const float bc2 = bias_correction(a.b2, t_step);
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
    adam_one(pp.x, gg.x, mm.x, vv.x, a, lr, bc1, bc2);
    adam_one(pp.y, gg.y, mm.y, vv.y, a, lr, bc1, bc2);
    adam_one(pp.z, gg.z, mm.z, vv.z, a, lr, bc1, bc2);
    adam_one(pp.w, gg.w, mm.w, vv.w, a, lr, bc1, bc2);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (int64_t i = 4 * n_vec + t; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, a, lr, bc1, bc2);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void __launch_bounds__(kOptimThreads)
    sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ buf, int64_t n, int64_t n_vec,
               SgdArgs a, const float* __restrict__ lr_ptr,
               const uint8_t* __restrict__ ok) {
  if (!step_ok(ok)) return;
  const float lr = step_lr(lr_ptr, a.lr);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int64_t i = t; i < n_vec; i += stride) {
    float4 pp = p4[i], bb = b4[i];
    const float4 gg = g4[i];
    sgd_one(pp.x, gg.x, bb.x, a, lr);
    sgd_one(pp.y, gg.y, bb.y, a, lr);
    sgd_one(pp.z, gg.z, bb.z, a, lr);
    sgd_one(pp.w, gg.w, bb.w, a, lr);
    p4[i] = pp;
    b4[i] = bb;
  }
  for (int64_t i = 4 * n_vec + t; i < n; i += stride) {
    float pp = p[i], bb = buf[i];
    sgd_one(pp, g[i], bb, a, lr);
    p[i] = pp;
    buf[i] = bb;
  }
}

// the bias corrections of the 1-based steps steps[0..n) as the AdamW
// kernel computes them: out[2i] = bc1, out[2i + 1] = bc2
__global__ void adam_bias_corrections_kernel(const int* __restrict__ steps,
                                             int n, float b1, float b2,
                                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[2 * i] = bias_correction(b1, steps[i]);
    out[2 * i + 1] = bias_correction(b2, steps[i]);
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
// g. step: the device int32 1-based step; lr_ptr: the device f32
// learning rate, or null for the argument lr; ok: the device guard
// predicate (one byte), or null. aligned = 1 when all four tensor
// pointers are 16-byte aligned.
extern "C" int zt_fused_adam(void* p, const void* g, void* m, void* v,
                             long long n, const void* step,
                             const void* lr_ptr, float lr, float b1,
                             float b2, float eps, float wd, const void* ok,
                             int aligned, void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t n_vec = vec_len(n, aligned);
  adam_kernel<<<grid_for(n, n_vec), kOptimThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, n_vec,
      AdamArgs{lr, b1, b2, eps, wd}, static_cast<const int*>(step),
      static_cast<const float*>(lr_ptr), static_cast<const uint8_t*>(ok));
  return cudaGetLastError();
}

// In-place SGD with momentum and L2 decay over n contiguous f32 elements;
// lr_ptr and ok as for zt_fused_adam.
extern "C" int zt_fused_sgd(void* p, const void* g, void* buf, long long n,
                            const void* lr_ptr, float lr, float momentum,
                            float wd, const void* ok, int aligned,
                            void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t n_vec = vec_len(n, aligned);
  sgd_kernel<<<grid_for(n, n_vec), kOptimThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(buf), n, n_vec, SgdArgs{lr, momentum, wd},
      static_cast<const float*>(lr_ptr), static_cast<const uint8_t*>(ok));
  return cudaGetLastError();
}

// adam_bias_corrections_kernel over n device steps into out (2n floats)
extern "C" int zt_adam_bias_corrections(const void* steps, int n, float b1,
                                        float b2, void* out, void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  adam_bias_corrections_kernel<<<(n + kOptimThreads - 1) / kOptimThreads,
                                 kOptimThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(steps), n, b1, b2, static_cast<float*>(out));
  return cudaGetLastError();
}
