// Flash-attention forward: blockwise online-softmax attention that never
// writes the (Tq, Tk) score matrix to device memory.
//
// Replaces: zoo_tpu/ops/pallas/flash_attention.py, _fwd_kernel (:35) as
// launched by _fwd (:109) for flash_attention (:377). The backward
// kernels (_dkdv_kernel, _dq_kernel) belong to the training slice; this
// kernel already writes the logsumexp they recompute from.
//
// Semantics as the Pallas kernel: causal masking is end-aligned
// (column <= row + Tk - Tq, as the dense path's tril(k=tk-tq)); a query
// head h of batch b reads kv head b*Hkv + h/(H/Hkv), so GQA never
// repeats K/V; a row with no live column gets o = 0, lse = -inf.
//
// What bounds it on an H100: operations. At the bucket prefill of
// Llama-3-8B (B=1, H=32, T=512, D=128, f32) it does ~2 GFLOP against
// ~17 MB of q/k/v/o, about 120 flops per byte, above the f32 machine
// balance (67 TFLOP/s over 3.35 TB/s = 20, the published H100 SXM peaks
// at its 700 W limit). This first version runs on the f32 SIMT units,
// not the tensor cores (wgmma, TMA and a bf16/TF32 path are later
// work), so its ceiling is the 67 TFLOP/s f32 rate.
//
// What the design does about it:
// - One block per (batch*head, 64-row q tile); the loop over 32-row
//   k tiles inside the block replaces the TPU's sequential grid axis.
// - The q tile and each k/v tile sit in shared memory (rows padded by
//   one float, so the strided reads of the score product do not
//   conflict on banks); each thread owns a 4x4 block of scores and a
//   4 x D/8 block of the output in registers.
// - Tiles wholly in the causal future of the q tile are never loaded.
// - bf16 inputs are widened to f32 on load; the probabilities are
//   rounded to bf16 before the P.V product, as the Pallas kernel casts
//   p to v's type.
#include "zt_common.cuh"

namespace zt {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // key rows per tile (= warp width: lane = column)
constexpr int kFlashThreads = 128;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDP = kBK + 1, OC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x LDQ
  float* ks = qs + kBQ * LDQ;        // kBK x LDK
  float* vs = ks + kBK * LDK;        // kBK x D
  float* ps = vs + kBK * D;          // kBQ x LDP: scores, then probs
  float* row_m = ps + kBQ * LDP;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const T* qb = q + static_cast<size_t>(bh) * Tq * D;
  const T* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const T* vb = v + static_cast<size_t>(kvh) * Tk * D;
  const int off = Tk - Tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = tid >> 3, tc = tid & 7;   // rows tr+16i, cols tc+8j

  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D, d = i % D;
    qs[r * LDQ + d] = q0 + r < Tq ? to_f32(qb[(q0 + r) * D + d]) : 0.f;
  }
  for (int i = tid; i < kBQ; i += kFlashThreads) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }

  float oacc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) oacc[i][j] = 0.f;

  int n_k = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + off;   // highest live column here
    n_k = last < 0 ? 0 : min(n_k, last / kBK + 1);
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile fully consumed (and q loaded)
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Tk;
      ks[r * LDK + d] = in ? to_f32(kb[(k0 + r) * D + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores S = q k^T * scale, masked to -inf
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(tr + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tc + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(a[i], bb[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 8 * j, col = k0 + c;
        const bool live = col < Tk && (!causal || col <= row + off);
        ps[r * LDP + c] = live ? sacc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 16w .. 16w+15, lane = column
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float s = ps[r * LDP + lane];
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = s == -INFINITY ? 0.f : expf(s - safe);
      const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - safe);
      const float psum = warp_sum(p);
      ps[r * LDP + lane] = to_f32(from_f32<T>(p));
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = corr * row_l[r] + psum;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // o = o * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_c[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < OC; ++j) oacc[i][j] *= c;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float vv = vs[c * D + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[i][j] = fmaf(pv[i], vv, oacc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, row = q0 + r;
    if (row >= Tq) continue;
    const float l = row_l[r], m = row_m[r];
    const float den = l == 0.f ? 1.f : l;
    T* orow = o + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < OC; ++j) orow[tc + 8 * j] = from_f32<T>(oacc[i][j] / den);
    if (tc == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          m == -INFINITY ? -INFINITY : m + logf(den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Tq, Tk,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int H, int Hkv, int Tq,
                     int Tk, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace zt

// q and o (B*H, Tq, D); k and v (B*Hkv, Tk, D); lse (B*H, Tq) f32.
// D in {16, 32, 64, 128}; dtype 0 = f32, 1 = bf16 (all of q, k, v, o).
extern "C" int zt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int H, int Hkv, int Tq, int Tk,
                                      int D, float scale, int causal,
                                      int dtype, void* stream) {
  using namespace zt;
  if (Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_d<float>(D, q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale,
                           causal, st);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, Tq, Tk,
                                   scale, causal, st);
  return cudaErrorInvalidValue;
}
