// Flash-attention backward: dK/dV and dQ recomputed from the forward's
// logsumexp, never writing the (Tq, Tk) probability matrix to device
// memory.
//
// Replaces: zoo_tpu/ops/pallas/flash_attention.py, _dkdv_kernel (:151)
// and _dq_kernel (:213), as launched by _bwd (:263) for the custom-vjp
// flash_attention (:377).
//
// Semantics as the Pallas kernels: p = exp(q.k * scale - lse) on live
// (row, column) pairs (column < Tk, and column <= row + Tk - Tq when
// causal), 0 elsewhere and on rows whose lse is -inf (the forward's
// empty rows); ds = p * (dO.v - delta) * scale with delta = rowsum(dO*O)
// computed by the caller; dV = sum p^T dO, dK = sum ds^T q over the q
// rows and over the rep = H/Hkv query heads of each kv head (GQA, K/V
// never repeated); dQ = ds k. f32 math throughout; bf16 inputs are
// widened on load, and p and ds are rounded to the input type before
// the products that consume them, as the Pallas kernels cast p to dO's
// type and ds to q's/k's. Outputs are written once, in the input type.
//
// What bounds it on an H100: operations. At the training shapes (B=64,
// H=12, Hkv=4, T=512, D=64, bf16, causal) dK/dV does 8*D flops per live
// (row, column) pair of every q head (four products), 51.6 GFLOP, and
// dQ 6*D (three), 38.7 GFLOP, against ~0.17 GB of q/k/v/dO/lse/delta
// and gradients: hundreds of flops per byte, far above the machine
// balance. This first version runs on the f32 SIMT units, not the tensor
// cores (wgmma and TMA are later work), so its ceiling is the 67 TFLOP/s
// f32 rate.
//
// What the design does about it:
// - The TPU grid carries dK/dV in scratch across its sequential (rep,
//   q block) axes. Here one block owns one (batch, kv head, k tile) and
//   loops over the rep query heads and, inside, over the q tiles from
//   the first one that can see the k tile; dK/dV stay in registers and
//   are written once: no atomics, so the result is deterministic.
// - One dQ block owns one (batch, q head, 64-row q tile) and loops over
//   the k tiles up to the causal limit, dQ in registers.
// - Each 128-thread block holds its tiles in shared memory (rows padded
//   by one float, so the strided reads stay off bank conflicts); a
//   thread owns an 8 x (BK/16) block of scores and of the gradient tile
//   it accumulates. S and dP share one pass over D.
#include "zt_common.cuh"

namespace zt {

constexpr int kBwdThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kBwdBQ = 64;         // query rows per tile

// key rows per tile: 64, or 32 at D = 128 to keep the accumulators in
// registers
template <int D>
__host__ __device__ constexpr int bwd_bk() {
  return D > 64 ? 32 : 64;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int BK = bwd_bk<D>();
  return sizeof(float) * (2 * BK * (D + 1) + 2 * kBwdBQ * (D + 1) +
                          2 * kBwdBQ * (BK + 1) + 2 * kBwdBQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BK = bwd_bk<D>();
  return sizeof(float) * (2 * BK * (D + 1) + 2 * kBwdBQ * (D + 1) +
                          kBwdBQ * (BK + 1) + 2 * kBwdBQ);
}

// Rows [r0, r0 + rows) of a (T, D) matrix into shared memory (row stride
// D + 1), widened to f32; rows at or past T read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int rows, int T_len, float* dst) {
  for (int i = threadIdx.x; i < rows * D; i += kBwdThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < T_len ? to_f32(src[static_cast<size_t>(r0 + r) * D + d])
                       : 0.f;
  }
}

// lse and delta of q rows [q0, q0 + kBwdBQ): rows past Tq get lse = -inf,
// which masks them.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int q0, int Tq, float* lse_s,
                                               float* delta_s) {
  for (int i = threadIdx.x; i < kBwdBQ; i += kBwdThreads) {
    const bool in = q0 + i < Tq;
    lse_s[i] = in ? lse[q0 + i] : -INFINITY;
    delta_s[i] = in ? delta[q0 + i] : 0.f;
  }
}

// One (kBwdBQ x BK) tile: this thread's scores at rows tr + 8i, columns
// tc + 16j; writes p (if kWriteP) and ds, rounded to T, into ps / dss
// (row stride BK + 1).
template <typename T, int D, int BK, bool kWriteP>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss, int q0,
    int k0, int Tk, int off, int causal, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, NI = kBwdBQ / 8, NJ = BK / 16;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[NI][NJ], dp[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[NI], o[NI], kk[NJ], vv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      a[i] = qs[(tr + 8 * i) * LD + d];
      o[i] = dos[(tr + 8 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kk[j] = ks[(tc + 16 * j) * LD + d];
      vv[j] = vs[(tc + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = tr + 8 * i, row = q0 + r;
    const float lse = lse_s[r], delta = delta_s[r];
    const bool row_live = lse != -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + 16 * j, col = k0 + c;
      const bool live =
          row_live && col < Tk && (!causal || col <= row + off);
      const float p = live ? expf(s[i][j] * scale - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta) * scale;
      if (kWriteP) ps[r * LP + c] = to_f32(from_f32<T>(p));
      dss[r * LP + c] = to_f32(from_f32<T>(ds));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Hkv, int Tq, int Tk, float scale, int causal) {
  constexpr int BK = bwd_bk<D>(), LD = D + 1, LP = BK + 1;
  constexpr int NR = BK / 8, NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                    // BK x LD
  float* vs = ks + BK * LD;            // BK x LD
  float* qs = vs + BK * LD;            // kBwdBQ x LD
  float* dos = qs + kBwdBQ * LD;       // kBwdBQ x LD
  float* ps = dos + kBwdBQ * LD;       // kBwdBQ x LP
  float* dss = ps + kBwdBQ * LP;       // kBwdBQ x LP
  float* lse_s = dss + kBwdBQ * LP;
  float* delta_s = lse_s + kBwdBQ;

  const int bkv = blockIdx.y, k0 = blockIdx.x * BK;
  const int b = bkv / Hkv, g = bkv % Hkv, rep = H / Hkv;
  const int off = Tk - Tq;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const size_t kv_base = static_cast<size_t>(bkv) * Tk * D;

  load_rows<T, D>(k + kv_base, k0, BK, Tk, ks);
  load_rows<T, D>(v + kv_base, k0, BK, Tk, vs);

  float dka[NR][NC], dva[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[i][j] = dva[i][j] = 0.f;

  // first q tile holding a row that sees a column of this k tile
  const int first_row = causal ? k0 - off : 0;
  const int qt0 = first_row <= 0 ? 0 : first_row / kBwdBQ;
  const int n_q = (Tq + kBwdBQ - 1) / kBwdBQ;

  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const size_t q_base = static_cast<size_t>(bh) * Tq * D;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * kBwdBQ;
      __syncthreads();   // the previous tile is consumed (k/v loaded)
      load_rows<T, D>(q + q_base, q0, kBwdBQ, Tq, qs);
      load_rows<T, D>(dout + q_base, q0, kBwdBQ, Tq, dos);
      load_row_stats(lse + static_cast<size_t>(bh) * Tq,
                     delta + static_cast<size_t>(bh) * Tq, q0, Tq, lse_s,
                     delta_s);
      __syncthreads();
      tile_p_ds<T, D, BK, true>(qs, dos, ks, vs, lse_s, delta_s, ps, dss,
                                q0, k0, Tk, off, causal, scale);
      __syncthreads();
      // dV += p^T dO and dK += ds^T q over the tile's rows
#pragma unroll 2
      for (int qr = 0; qr < kBwdBQ; ++qr) {
        float pv[NR], dsv[NR], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          pv[i] = ps[qr * LP + tr + 8 * i];
          dsv[i] = dss[qr * LP + tr + 8 * i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dov[j] = dos[qr * LD + tc + 16 * j];
          qv[j] = qs[qr * LD + tc + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            dva[i][j] = fmaf(pv[i], dov[j], dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = k0 + tr + 8 * i;
    if (row >= Tk) continue;
    const size_t o = kv_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[o + tc + 16 * j] = from_f32<T>(dka[i][j]);
      dv[o + tc + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int Tq, int Tk, float scale,
                        int causal) {
  constexpr int BK = bwd_bk<D>(), LD = D + 1, LP = BK + 1;
  constexpr int NI = kBwdBQ / 8, NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                    // kBwdBQ x LD
  float* dos = qs + kBwdBQ * LD;       // kBwdBQ x LD
  float* ks = dos + kBwdBQ * LD;       // BK x LD
  float* vs = ks + BK * LD;            // BK x LD
  float* dss = vs + BK * LD;           // kBwdBQ x LP
  float* lse_s = dss + kBwdBQ * LP;
  float* delta_s = lse_s + kBwdBQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBwdBQ;
  const int b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const int off = Tk - Tq;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const size_t q_base = static_cast<size_t>(bh) * Tq * D;
  const size_t kv_base = static_cast<size_t>(kvh) * Tk * D;

  load_rows<T, D>(q + q_base, q0, kBwdBQ, Tq, qs);
  load_rows<T, D>(dout + q_base, q0, kBwdBQ, Tq, dos);
  load_row_stats(lse + static_cast<size_t>(bh) * Tq,
                 delta + static_cast<size_t>(bh) * Tq, q0, Tq, lse_s,
                 delta_s);

  float dqa[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dqa[i][j] = 0.f;

  int n_k = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + kBwdBQ - 1 + off;   // highest live column here
    n_k = last < 0 ? 0 : min(n_k, last / BK + 1);
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile is consumed (q/dO loaded)
    load_rows<T, D>(k + kv_base, k0, BK, Tk, ks);
    load_rows<T, D>(v + kv_base, k0, BK, Tk, vs);
    __syncthreads();
    tile_p_ds<T, D, BK, false>(qs, dos, ks, vs, lse_s, delta_s, nullptr,
                               dss, q0, k0, Tk, off, causal, scale);
    __syncthreads();
    // dQ += ds k over the tile's columns
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dsv[NI], kv[NC];
#pragma unroll
      for (int i = 0; i < NI; ++i) dsv[i] = dss[(tr + 8 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = ks[c * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dqa[i][j] = fmaf(dsv[i], kv[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = q0 + tr + 8 * i;
    if (row >= Tq) continue;
    const size_t o = q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[o + tc + 16 * j] = from_f32<T>(dqa[i][j]);
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Hkv, Tq, Tk;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dkdv(const BwdArgs& a, void* dk, void* dv,
                        cudaStream_t st) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int BK = bwd_bk<D>();
  const dim3 grid((a.Tk + BK - 1) / BK, a.B * a.Hkv);
  flash_bwd_dkdv_kernel<T, D><<<grid, kBwdThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Hkv, a.Tq,
      a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, void* dq, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBwdBQ - 1) / kBwdBQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.H, a.Hkv, a.Tq, a.Tk, a.scale,
      a.causal);
  return cudaGetLastError();
}

// which = 0: dK/dV into out0/out1; which = 1: dQ into out0
template <typename T, int D>
cudaError_t launch_one(int which, const BwdArgs& a, void* out0, void* out1,
                       cudaStream_t st) {
  return which == 0 ? launch_dkdv<T, D>(a, out0, out1, st)
                    : launch_dq<T, D>(a, out0, st);
}

template <typename T>
cudaError_t launch_d(int D, int which, const BwdArgs& a, void* out0,
                     void* out1, cudaStream_t st) {
  switch (D) {
    case 16: return launch_one<T, 16>(which, a, out0, out1, st);
    case 32: return launch_one<T, 32>(which, a, out0, out1, st);
    case 64: return launch_one<T, 64>(which, a, out0, out1, st);
    case 128: return launch_one<T, 128>(which, a, out0, out1, st);
  }
  return cudaErrorInvalidValue;
}

int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* out0, void* out1, int B, int H, int Hkv, int Tq, int Tk,
               int D, float scale, int causal, int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1 || B < 1)
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Hkv, Tq, Tk, scale,
                  causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_d<float>(D, which, a, out0, out1, st);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, which, a, out0, out1, st);
  return cudaErrorInvalidValue;
}

}  // namespace zt

// q, dout (B*H, Tq, D); k, v, dk, dv (B*Hkv, Tk, D); lse, delta (B*H, Tq)
// f32. D in {16, 32, 64, 128}; dtype 0 = f32, 1 = bf16 (all of q, k, v,
// dout and the gradients).
extern "C" int zt_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int B, int H, int Hkv, int Tq, int Tk, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  return zt::launch_bwd(0, q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tq,
                        Tk, D, scale, causal, dtype, stream);
}

// dq (B*H, Tq, D); the other operands as for zt_flash_bwd_dkdv.
extern "C" int zt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Hkv, int Tq, int Tk, int D, float scale,
                               int causal, int dtype, void* stream) {
  return zt::launch_bwd(1, q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv,
                        Tq, Tk, D, scale, causal, dtype, stream);
}
