// Paged flash-prefill: a chunk of query rows per sequence against the
// resident K/V, read in place through the block table.
//
// Replaces: zoo_tpu/ops/pallas/paged_prefill.py, _kernel (:54), called by
// paged_flash_prefill (:117).
//
// Each query row carries its own cache position and attends every
// resident column <= that position: causal within the chunk plus all
// that earlier chunks wrote (the chunk's own K/V are in the cache before
// the kernel runs).
//
// What bounds it on an H100: at the serving shapes (a 64-token chunk of
// one sequence, 32 query heads over 8 kv heads, f32) each K/V element
// loaded serves C x G = 256 query rows, about 1000 flops per element
// read, so the least time is set by the f32 rate (67 TFLOP/s, the
// published H100 SXM peak at 700 W) rather
// than by the bytes; the bound this repository reports counts both and
// takes the larger.
//
// What the design does about it:
// - The Pallas kernel runs one program per (sequence, kv head) because
//   a TPU core walks its grid in order. Here that would leave 8 blocks
//   for 132 SMs, so a second grid axis cuts the C x G query rows of a kv
//   head into tiles of kWarps x kMaxRowsPerWarp = 16 rows (16 tiles x 8
//   kv heads = 128 blocks at chunk 64).
// - K/V blocks are loaded once per tile into shared memory (int8 widened
//   by the row scale right after the load) and read there by every row
//   of the tile; no gathered copy is written.
// - A tile stops at the last block its highest position reaches.
// - The online softmax of each row lives in registers of one warp.
#include "zt_common.cuh"

namespace zt {

constexpr int kRowsPerBlock = kWarps * kMaxRowsPerWarp;

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc,
                         const float* __restrict__ ksc,
                         const float* __restrict__ vsc,
                         const int* __restrict__ bt,
                         const int* __restrict__ pos, TQ* __restrict__ out,
                         int C, int n_kv, int G, int D, int bs, int W,
                         float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // bs x (D + 1)
  float* vs = ks + bs * (D + 1);    // bs x D
  float* qs = vs + bs * D;          // kRowsPerBlock x D
  __shared__ int pmax_s;
  const int s = blockIdx.x / n_kv, h = blockIdx.x % n_kv;
  const int H = n_kv * G;
  const int rows = C * G;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // tile rows r0 .. r0+15: row r is chunk position r / G, head h*G + r % G
  for (int i = threadIdx.x; i < kRowsPerBlock * D; i += blockDim.x) {
    const int r = r0 + i / D, d = i % D;
    float x = 0.f;
    if (r < rows) {
      const int ci = r / G, g = r - ci * G;
      x = to_f32(q[((static_cast<size_t>(s) * C + ci) * H + h * G + g) * D + d]);
    }
    qs[i] = x;
  }
  if (threadIdx.x == 0) {
    int mx = 0;
    const int last = min(rows, r0 + kRowsPerBlock) - 1;
    for (int ci = r0 / G; ci <= last / G; ++ci)
      mx = max(mx, pos[s * C + ci]);
    pmax_s = mx;
  }
  __syncthreads();
  const int pmax = pmax_s;

  int rpos[kMaxRowsPerWarp];
  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kMaxSlices];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = r0 + warp * kMaxRowsPerWarp + i;
    rpos[i] = r < rows ? pos[s * C + r / G] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) acc[i][j] = 0.f;
  }

  for (int j = 0; j < W && j * bs <= pmax; ++j) {
    const int start = j * bs;
    const int blk = bt[s * W + j];
    __syncthreads();                // last block consumed
    load_kv_block(kc, vc, ksc, vsc, blk, h, n_kv, bs, D, ks, vs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      if (rpos[i] < start) continue;  // padding row, or all masked here
      attend_rows(qs + (warp * kMaxRowsPerWarp + i) * D, ks, vs, bs, D,
                  start, rpos[i], scale, m[i], l[i], acc[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = r0 + warp * kMaxRowsPerWarp + i;
    if (r >= rows) continue;
    const int ci = r / G, g = r - ci * G;
    TQ* o = out + ((static_cast<size_t>(s) * C + ci) * H + h * G + g) * D;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int k = 0; k < kMaxSlices; ++k) {
      const int d = lane + 32 * k;
      if (d < D) o[d] = from_f32<TQ>(acc[i][k] / den);
    }
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, void* out, int S, int C, int n_kv, int G,
                   int D, int bs, int W, float scale, cudaStream_t stream) {
  const dim3 grid(S * n_kv, (C * G + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem =
      sizeof(float) * (bs * (D + 1) + bs * D + kRowsPerBlock * D);
  paged_prefill_kernel<TQ, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, bt, pos, static_cast<TQ*>(out), C,
      n_kv, G, D, bs, W, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(int cache_dtype, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     const int* bt, const int* pos, void* out, int S, int C,
                     int n_kv, int G, int D, int bs, int W, float scale,
                     cudaStream_t st) {
  switch (cache_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, ks, vs, bt, pos, out, S, C, n_kv, G,
                               D, bs, W, scale, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, ks, vs, bt, pos, out, S, C,
                                       n_kv, G, D, bs, W, scale, st);
    case kI8:
      return launch<TQ, int8_t>(q, k, v, ks, vs, bt, pos, out, S, C, n_kv, G,
                                D, bs, W, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace zt

// q and out (S, C, H, D); k/v cache (NB, bs, n_kv, D); scales
// (NB, bs, n_kv) f32 or null; tables (S, W) int32; positions (S, C)
// int32, the cache index of each row.
extern "C" int zt_paged_prefill(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                const int* tables, const int* positions,
                                void* out, int S, int C, int n_kv, int G,
                                int D, int bs, int W, float scale,
                                int q_dtype, int cache_dtype, void* stream) {
  using namespace zt;
  if (bs < 1 || bs > 32 || D < 1 || D > 32 * kMaxSlices || G < 1 || C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_q<float>(cache_dtype, q, k, v, k_scale, v_scale, tables,
                           positions, out, S, C, n_kv, G, D, bs, W, scale,
                           st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(cache_dtype, q, k, v, k_scale, v_scale,
                                   tables, positions, out, S, C, n_kv, G, D,
                                   bs, W, scale, st);
  return cudaErrorInvalidValue;
}
