// Flash-attention forward: blockwise online-softmax attention that never
// writes the (Tq, Tk) score matrix to device memory.
//
// Replaces: zoo_tpu/ops/pallas/flash_attention.py, _fwd_kernel (:35) as
// launched by _fwd (:109, the pallas_call at :120) for flash_attention
// (:377). It writes the logsumexp the backward kernels
// (flash_attention_bwd.cu) recompute from.
//
// Semantics as the Pallas kernel: causal masking is end-aligned
// (column <= row + Tk - Tq, as the dense path's tril(k=tk-tq)), and key
// tiles wholly in the causal future are never loaded; a query head h of
// batch b reads kv head b*Hkv + h/(H/Hkv), so GQA never repeats K/V; a
// row with no live column gets o = 0, lse = -inf; the scale multiplies
// the f32 scores; p is rounded to v's type before P.V (flash_attention.py
// :85) while the row sums add the unrounded f32 p.
//
// Two kernels, one per dtype:
//
// bf16: flash_fwd_tc_kernel, FlashAttention-2 on the tensor cores. What
// bounds it on an H100: at the Llama training shape (B=64, H=12,
// Hkv=4, T=512, D=64, causal) it does 25.8 GFLOP against 136 MB, about
// 190 flop per byte, under the bf16 balance (989 TFLOP/s over 3.35 TB/s
// = 295): bytes, at the tensor cores' full rate. mma.sync and the
// softmax between the two products (expf, quad shuffles) keep it well
// under that rate. The design:
// - one block of 4 warps per (batch*head, 64-row q tile), heaviest
//   causal tiles first; each warp owns 16 query rows, whose Q fragments
//   it loads once by ldmatrix and keeps in registers;
// - 64-row K and V tiles stay bf16 in a 2-stage cp.async ring (rows
//   past Tk zero-filled), stored with a 16-byte XOR swizzle;
// - S = Q K^T by mma.sync.m16n8k16 (bf16 -> f32) into registers; the
//   online softmax runs there (row max and sum over the four lanes of a
//   quad, expf); P is rounded to bf16 in registers and is, as it lies,
//   the A operand of P.V (the C layout of m16n8k16 is its A layout), with
//   V fragments from ldmatrix.trans; O accumulates in registers;
// - a warp skips a K tile that lies wholly in the causal future of its
//   16 rows; masks are applied only on edge tiles.
// The tiles are fixed (64-row q and kv tiles, 4 warps, 2 stages); the
// shared memory they take, 2*D*(64 + 2*2*64) bytes, is counted by
// flash_plan() in ops/kernels/flash_attention.py and passed here, checked
// only against the block limit.
//
// f32: flash_fwd_kernel, on the SIMT units (f32 FMAs; tensor cores would
// mean TF32, and the serving streams must stay token-identical to the
// plain path). At the 8B serving shape (B=1, H=32, T=512, D=128) it does
// ~2 GFLOP against ~17 MB, above the f32 balance (67 TFLOP/s over
// 3.35 TB/s = 20): operations bound it.
// - One block per (batch*head, 64-row q tile); the loop over 32-row
//   k tiles inside the block replaces the TPU's sequential grid axis.
// - The q tile and each k/v tile sit in shared memory (rows padded by
//   one float, so the strided reads of the score product do not
//   conflict on banks); each thread owns a 4x4 block of scores and a
//   4 x D/8 block of the output in registers.
#include "zt_mma.cuh"

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Hkv, int Tq, int Tk,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<float, D><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Tq,
      Tk, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16, tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64, kBKV = 64, kWarps = 4, kThreads = 32 * kWarps;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int H, int Hkv, int Tq,
                        int Tk, float scale, int causal) {
  using namespace mma;
  constexpr int U = D / 8;       // 16-byte units in a row
  constexpr int RB = D * 2;      // bytes in a row
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int ND = D / 8;      // n-tiles of O
  constexpr int NS = kBKV / 8;   // n-tiles of S
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;               // kBQ rows
  unsigned char* kvs = tc_smem + kBQ * RB;      // per stage: K rows, V rows

  const int n_q = (Tq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const bf16* qb = q + static_cast<size_t>(bh) * Tq * D;
  const bf16* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Tk * D;
  const int off = Tk - Tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < kBQ * U; e += kThreads) {
    const int r = e / U, u = e % U;
    const bool ok = q0 + r < Tq;
    cp_async<16>(smem_addr(qs + r * RB + swizzle<U>(r, u) * 16),
                 ok ? qb + static_cast<size_t>(q0 + r) * D + u * 8 : qb, ok);
  }
  auto load_kv = [&](int kt, int slot) {
    const int k0 = kt * kBKV;
    unsigned char* ks = kvs + slot * 2 * kBKV * RB;
    unsigned char* vs = ks + kBKV * RB;
    for (int e = tid; e < kBKV * U; e += kThreads) {
      const int r = e / U, u = e % U;
      const bool ok = k0 + r < Tk;
      const size_t g = static_cast<size_t>(k0 + r) * D + u * 8;
      const int at = r * RB + swizzle<U>(r, u) * 16;
      cp_async<16>(smem_addr(ks + at), ok ? kb + g : kb, ok);
      cp_async<16>(smem_addr(vs + at), ok ? vb + g : vb, ok);
    }
  };

  int n_k = (Tk + kBKV - 1) / kBKV;
  if (causal) {
    const int last = q0 + kBQ - 1 + off;   // highest live column here
    n_k = last < 0 ? 0 : min(n_k, last / kBKV + 1);
  }
  if (n_k > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int dk = 0; dk < KD; ++dk) {
    const int r = warp * 16 + (lane & 15), u = dk * 2 + (lane >> 4);
    ldmatrix_x4(qf[dk], smem_addr(qs + r * RB + swizzle<U>(r, u) * 16));
  }

  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  // this thread's two rows (g and g+8 of the warp's 16): running max and
  // the part of the row sum over this thread's columns
  float row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f};
  const int wq0 = q0 + warp * 16;
  const int row0 = wq0 + (lane >> 2);

  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kBKV;
    if (!causal || k0 <= wq0 + 15 + off) {
      const uint32_t ka = smem_addr(kvs + (kt & 1) * 2 * kBKV * RB);
      const uint32_t va = ka + kBKV * RB;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int dk = 0; dk < KD; ++dk)
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          const int key = p * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int u = dk * 2 + ((lane >> 3) & 1);
          uint32_t kf[4];
          ldmatrix_x4(kf, ka + key * RB + swizzle<U>(key, u) * 16);
          mma_bf16(s[2 * p], qf[dk], kf[0], kf[1]);
          mma_bf16(s[2 * p + 1], qf[dk], kf[2], kf[3]);
        }
      const bool edge = k0 + kBKV > Tk || (causal && k0 + kBKV - 1 > wq0 + off);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale;
          if (edge) {
            const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (col >= Tk || (causal && col > row + off)) s[j][e] = -INFINITY;
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(row_m[i], mx);
        // all-masked rows keep m = -inf; exp(-inf - -inf) would be NaN
        const float safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr =
            row_m[i] == -INFINITY ? 0.f : expf(row_m[i] - safe);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = expf(s[j][2 * i] - safe);
          const float p1 = expf(s[j][2 * i + 1] - safe);
          s[j][2 * i] = p0;
          s[j][2 * i + 1] = p1;
          sum += p0 + p1;
        }
        row_l[i] = corr * row_l[i] + sum;
        row_m[i] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          oacc[j][2 * i] *= corr;
          oacc[j][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int u = p * 2 + (lane >> 4);
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, va + key * RB + swizzle<U>(key, u) * 16);
          mma_bf16(oacc[2 * p], pa, vf[0], vf[1]);
          mma_bf16(oacc[2 * p + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // the slot is consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = row_l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + i * 8;
    if (row >= Tq) continue;
    const float den = l == 0.f ? 1.f : l;
    bf16* orow = o + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + (lane & 3) * 2) =
          pack_bf16(oacc[j][2 * i] / den, oacc[j][2 * i + 1] / den);
    if ((lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          row_m[i] == -INFINITY ? -INFINITY : row_m[i] + logf(den);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Tq, int Tk,
                   float scale, int causal, int smem, cudaStream_t stream) {
  if (smem <= 0 || smem > mma::kMaxSmem) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Hkv, Tq,
      Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

#define ZT_FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace zt

// q and o (B*H, Tq, D); k and v (B*Hkv, Tk, D); lse (B*H, Tq) f32.
// D in {16, 32, 64, 128}; dtype 0 = f32 (SIMT kernel), 1 = bf16 (tensor
// cores, with the shared-memory bytes flash_plan() gives; f32 ignores
// them). q, k, v, o 16-byte aligned for bf16.
extern "C" int zt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int H, int Hkv, int Tq, int Tk,
                                      int D, float scale, int causal,
                                      int dtype, int smem,
                                      void* stream) {
  using namespace zt;
  if (Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_CASE(d)                                                          \
  if (D == d)                                                               \
    return dtype == kF32                                                    \
               ? launch_f32<d>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale,   \
                               causal, st)                                  \
               : tc::launch<d>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale,   \
                               causal, smem, st);
  if (dtype == kF32 || dtype == kBF16) {
    ZT_FLASH_HEAD_DIMS(ZT_CASE)
  }
#undef ZT_CASE
  return cudaErrorInvalidValue;
}
