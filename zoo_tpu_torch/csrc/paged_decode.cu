// Paged flash-decode: one query per slot against its K/V, read in place
// through the block table.
//
// Replaces: zoo_tpu/ops/pallas/paged_decode.py, _kernel (:55), called by
// paged_flash_decode (:132).
//
// What bounds it on an H100: memory. Each decode tick must read every
// live K/V row of every slot once (plus q and the tables) and does only
// ~4 flops per cache element, far below the ~20 flops/byte at which the
// f32 units would become the limit. The least time is the live cache
// bytes over 3.35 TB/s (the published H100 SXM bandwidth at 700 W).
//
// What the design does about it:
// - The cache is read where it lives, through the table: no gathered
//   per-sequence copy is ever written (the plain version materialises
//   one).
// - Blocks past the slot's position are never loaded, and a block's K
//   and V rows are loaded in one batched pass (load_kv_block: kLoadBatch
//   loads in flight per thread before any is used).
// - The G = H / H_kv query heads of a group share each K/V block pass,
//   so a block is read once per kv head, not once per query head.
// - int8 rows are widened by their scale right after the load, so the
//   device memory moves 1 byte per element.
// - Split-KV: grid (slots x kv heads, splits); each block walks W/splits
//   table entries with the online softmax in registers and writes a
//   partial (acc, m, l). One query per slot leaves only slots x kv heads
//   blocks otherwise (64 at Llama-3-8B widths for 132 SMs); the
//   log-sum-exp merge of the partials runs in torch, as the JAX package
//   keeps it outside its kernel.
#include "zt_common.cuh"

namespace zt {

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                        const TC* __restrict__ vc,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ bt,
                        const int* __restrict__ pos, float* __restrict__ acc_out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int n_kv, int G, int D, int bs, int W, int bps,
                        float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // bs x (D + 1)
  float* vs = ks + bs * (D + 1);    // bs x D
  float* qs = vs + bs * D;          // G x D
  const int s = blockIdx.x / n_kv, h = blockIdx.x % n_kv;
  const int split = blockIdx.y, splits = gridDim.y;
  const int H = n_kv * G;
  const int warp = threadIdx.x >> 5;
  const int p = pos[s];

  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_f32(q[(static_cast<size_t>(s) * H + h * G) * D + i]);

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kMaxSlices];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlices; ++i) acc[r][i] = 0.f;
  }

  for (int jj = 0; jj < bps; ++jj) {
    const int j = split * bps + jj;
    const int start = j * bs;
    if (start > p) break;           // uniform across the block
    const int blk = bt[s * W + j];
    __syncthreads();                // q loaded / last block consumed
    load_kv_block(kc, vc, ksc, vsc, blk, h, n_kv, bs, D, ks, vs);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRowsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g < G)
        attend_rows(qs + g * D, ks, vs, bs, D, start, p, scale, m[r], l[r],
                    acc[r]);
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    const int g = warp + kWarps * r;
    if (g >= G) continue;
    const size_t base =
        ((static_cast<size_t>(s) * n_kv + h) * splits + split) * G + g;
#pragma unroll
    for (int i = 0; i < kMaxSlices; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc_out[base * D + d] = acc[r][i];
    }
    if (lane == 0) {
      m_out[base] = m[r];
      l_out[base] = l[r];
    }
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, float* acc, float* m, float* l, int S,
                   int n_kv, int G, int D, int bs, int W, int splits,
                   float scale, cudaStream_t stream) {
  const dim3 grid(S * n_kv, splits);
  const size_t smem = sizeof(float) * (bs * (D + 1) + bs * D + G * D);
  paged_decode_kernel<TQ, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, bt, pos, acc, m, l, n_kv, G, D, bs,
      W, W / splits, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(int cache_dtype, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     const int* bt, const int* pos, float* acc, float* m,
                     float* l, int S, int n_kv, int G, int D, int bs, int W,
                     int splits, float scale, cudaStream_t st) {
  switch (cache_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, ks, vs, bt, pos, acc, m, l, S, n_kv,
                               G, D, bs, W, splits, scale, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, ks, vs, bt, pos, acc, m, l,
                                       S, n_kv, G, D, bs, W, splits, scale,
                                       st);
    case kI8:
      return launch<TQ, int8_t>(q, k, v, ks, vs, bt, pos, acc, m, l, S, n_kv,
                                G, D, bs, W, splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace zt

// q (S, H, D); k/v cache (NB, bs, n_kv, D); scales (NB, bs, n_kv) f32 or
// null; tables (S, W) int32; positions (S,) int32; partials
// acc (S, n_kv, splits, G, D), m and l (S, n_kv, splits, G), all f32.
extern "C" int zt_paged_decode(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* positions,
                               float* acc, float* m, float* l, int S,
                               int n_kv, int G, int D, int bs, int W,
                               int splits, float scale, int q_dtype,
                               int cache_dtype, void* stream) {
  using namespace zt;
  if (bs < 1 || bs > 32 || D < 1 || D > 32 * kMaxSlices || G < 1 ||
      G > kWarps * kMaxRowsPerWarp || splits < 1 || W % splits != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_q<float>(cache_dtype, q, k, v, k_scale, v_scale, tables,
                           positions, acc, m, l, S, n_kv, G, D, bs, W,
                           splits, scale, st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(cache_dtype, q, k, v, k_scale, v_scale,
                                   tables, positions, acc, m, l, S, n_kv, G,
                                   D, bs, W, splits, scale, st);
  return cudaErrorInvalidValue;
}
