// Int8 GEMMs with a fused dequant epilogue: (M, K) int8 activations x
// (K, N) int8 weights -> int32 -> f32(acc) * x_scale[row] * w_scale[col]
// in the output type (f32 or bf16).
//
// Replaces: zoo_tpu/ops/pallas/quant.py, _qmm_kernel (:42) launched by
// quantized_matmul (:61, pallas_call :93), and _fqmm_kernel (:122)
// launched by fused_quantized_matmul (:160, pallas_call :200).
//
// - quantized_matmul: the activations arrive quantized, with their
//   per-row scales.
// - fused_quantized_matmul: the activations arrive as f32 or bf16 (bf16
//   widened to f32 first, as quant.py:136). Each block first takes the
//   absmax of each of its rows over the full K, scale = amax == 0 ? 1 :
//   amax / 127, then quantizes every K slice into shared memory on the
//   fly, q = clamp(rint(x / scale), -127, 127) with IEEE division (no
//   fast-math: rint is half-to-even, as jnp.round and torch.round are).
//   No int8 copy of the activations goes to device memory, which is the
//   Pallas kernel's point (quant.py:167-170). Each column block reads
//   its rows twice (absmax, then the slices), from L2 after the first.
//
// What bounds them on an H100, against the 1979 TOPS int8 tensor cores:
// bytes, at the ResNet-50 head (M=128, K=2048, N=1000: 2 MB of int8
// weights against 0.52 GOP) and at M=512, K=N=1024 (3.5 MB against 1.07
// GOP) alike. This first version multiplies on the SIMT units
// with __dp4a (4 int8 products into an int32 per instruction) from
// 64 x 64 tiles staged in shared memory; tensor-core tiles are the later
// speed work. int32 sums are exact while K * 127 * 127 < 2^31.
#include "zt_gemm.cuh"

namespace zt {

using namespace gemm;

// The B slice: rows k0 .. k0+kBK-1 of w (K, N), columns n0 .. n0+kBN-1,
// stored k-contiguous per column; zero past K and N.
__device__ __forceinline__ void load_w_slice(const int8_t* __restrict__ w,
                                             int K, int N, int k0, int n0,
                                             int bn, int bk, Int8Tile& t) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int k = bk + kBRowStep * i, kk = k0 + k, n = n0 + bn;
    t.b[bn][k] = (kk < K && n < N)
                     ? w[static_cast<long long>(kk) * N + n] : int8_t(0);
  }
}

template <typename TOut>
__device__ __forceinline__ void store_dequant(
    TOut* __restrict__ y, const float* __restrict__ ws, int M, int N,
    int m0, int n0, int tx, int ty, const int (&acc)[4][4],
    const float (&row_scale)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        y[static_cast<long long>(m) * N + n] =
            from_f32<TOut>(dequant(acc[i][j], row_scale[i], ws[n]));
    }
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
    qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               TOut* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) Int8Tile t;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ak = tid % kBK, ar = tid / kBK;
  const int bn = tid % kBN, bk = tid / kBN;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = ar + kARowStep * i, m = m0 + r, k = k0 + ak;
      t.a[r][ak] = (m < M && k < K)
                       ? x[static_cast<long long>(m) * K + k] : int8_t(0);
    }
    load_w_slice(w, K, N, k0, n0, bn, bk, t);
    __syncthreads();
    dp4a_slice(t, tx, ty, acc);
    __syncthreads();
  }
  float row_scale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    row_scale[i] = m < M ? xs[m] : 0.f;
  }
  store_dequant(y, ws, M, N, m0, n0, tx, ty, acc, row_scale);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
    fqmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ ws, TOut* __restrict__ y, int M,
                int K, int N) {
  __shared__ __align__(16) Int8Tile t;
  __shared__ float scale[kBM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ak = tid % kBK, ar = tid / kBK;
  const int bn = tid % kBN, bk = tid / kBN;

  // per-row absmax over the full K: warp wp takes rows wp, wp + 8, ...
  const int lane = tid & 31, wp = tid >> 5;
  for (int r = wp; r < kBM; r += kGemmThreads / 32) {
    const int m = m0 + r;
    float amax = 0.f;
    if (m < M) {
      const TIn* row = x + static_cast<long long>(m) * K;
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(to_f32(row[k])));
    }
    amax = warp_max(amax);
    if (lane == 0) scale[r] = amax == 0.f ? 1.f : amax / 127.f;
  }
  __syncthreads();

  float load_scale[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
    load_scale[i] = scale[ar + kARowStep * i];
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = ar + kARowStep * i, m = m0 + r, k = k0 + ak;
      int8_t q = 0;
      if (m < M && k < K) {
        const float v = to_f32(x[static_cast<long long>(m) * K + k]) /
                        load_scale[i];
        q = static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
      }
      t.a[r][ak] = q;
    }
    load_w_slice(w, K, N, k0, n0, bn, bk, t);
    __syncthreads();
    dp4a_slice(t, tx, ty, acc);
    __syncthreads();
  }
  float row_scale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_scale[i] = scale[ty + 16 * i];
  store_dequant(y, ws, M, N, m0, n0, tx, ty, acc, row_scale);
}

template <typename TIn>
int launch_fqmm(const void* x, const void* w, const void* ws, void* y,
                int out_dtype, int M, int K, int N, cudaStream_t s) {
  const dim3 grid = grid_for(M, N);
  const auto* xp = static_cast<const TIn*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(ws);
  if (out_dtype == kF32)
    fqmm_kernel<TIn, float><<<grid, kGemmThreads, 0, s>>>(
        xp, wp, sp, static_cast<float*>(y), M, K, N);
  else if (out_dtype == kBF16)
    fqmm_kernel<TIn, __nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        xp, wp, sp, static_cast<__nv_bfloat16*>(y), M, K, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace zt

// x (M, K) int8, w (K, N) int8, xs (M,) and ws (N,) f32 scales, y (M, N)
// of out_dtype (0 = f32, 1 = bf16); all contiguous.
extern "C" int zt_quantized_matmul(const void* x, const void* w,
                                   const void* xs, const void* ws, void* y,
                                   int out_dtype, int M, int K, int N,
                                   void* stream) {
  using namespace zt;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const dim3 grid = grid_for(M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  if (out_dtype == kF32)
    qmm_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        xp, wp, xsp, wsp, static_cast<float*>(y), M, K, N);
  else if (out_dtype == kBF16)
    qmm_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        xp, wp, xsp, wsp, static_cast<__nv_bfloat16*>(y), M, K, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x (M, K) of in_dtype (0 = f32, 1 = bf16), w (K, N) int8, ws (N,) f32,
// y (M, N) of out_dtype; all contiguous.
extern "C" int zt_fused_quantized_matmul(const void* x, int in_dtype,
                                         const void* w, const void* ws,
                                         void* y, int out_dtype, int M, int K,
                                         int N, void* stream) {
  using namespace zt;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return launch_fqmm<float>(x, w, ws, y, out_dtype, M, K, N, s);
  if (in_dtype == kBF16)
    return launch_fqmm<__nv_bfloat16>(x, w, ws, y, out_dtype, M, K, N, s);
  return cudaErrorInvalidValue;
}
