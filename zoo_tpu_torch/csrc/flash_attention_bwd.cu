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
// never repeated); dQ = ds k. Products accumulate in f32; p and ds are
// rounded to the input type before the products that consume them, as
// the Pallas kernels cast p to dO's type and ds to q's/k's. Outputs are
// written once, in the input type. Two kernels, no atomics: the result
// is deterministic.
//
// What bounds it on an H100, at the training shape (B=64, H=12, Hkv=4,
// T=512, D=64, bf16, causal): dK/dV does 8*D flops per live (row,
// column) pair of every q head (four products), 51.6 GFLOP against
// 0.171 GB of q/k/v/dO/lse/delta read and dK/dV written, ~300 flops a
// byte: operations, just above the bf16 balance of the tensor cores
// (989 TFLOP/s over 3.35 TB/s = 295). dQ does 6*D (three products),
// 38.7 GFLOP against 0.188 GB, ~206 flops a byte: bytes, at the tensor
// cores' full rate.
//
// Two routes, one per dtype:
//
// bf16: flash_bwd_dkdv_tc_kernel and flash_bwd_dq_tc_kernel (namespace
// tc), FlashAttention-2's backward on the tensor cores with
// mma.sync.m16n8k16 (bf16 -> f32) fed by ldmatrix from swizzled shared
// memory (zt_mma.cuh):
// - dK/dV: one block of 4 warps per (batch, kv head, 64-row key tile),
//   16 key rows a warp. The K and V tiles are loaded once; at D <= 64
//   their A fragments stay in registers, at D = 128 they are read from
//   shared memory again for each q step, to leave the registers to the
//   dK and dV accumulators. The block loops over the rep query heads
//   and, inside, over the q tiles from the first one that can see the
//   key tile; each q tile, its dO tile and their lse and delta stream
//   through a cp.async ring. Per warp: S^T = K Q^T and dP^T = V dO^T
//   (B = Q and dO rows by ldmatrix) into registers; lse and delta are
//   indexed by the accumulator's columns; P^T and dS^T are rounded to
//   bf16 in registers and are, as they lie, the A operands of
//   dV += P^T dO and dK += dS^T Q (B by ldmatrix.trans). dK and dV stay
//   in registers and are written once.
// - dQ: one block of 4 warps per (batch*head, 64-row q tile), 16 q rows
//   a warp, heaviest causal tiles first; the Q and dO fragments are
//   loaded once and kept in registers; K and V tiles stream through a
//   cp.async ring up to the causal limit. S = Q K^T and dP = dO V^T
//   into registers; dS, rounded to bf16, is the A operand of
//   dQ += dS K (B = K by ldmatrix.trans).
// - A warp skips a tile that lies wholly in the causal future of its
//   rows; masks are applied only on edge tiles.
// - p is taken as 2^(s * scale * log2 e - lse * log2 e) on the
//   special-function unit (ex2.approx, about 2 ulp of f32), not by
//   expf: with expf the elementwise work between the products, not
//   the tensor cores, bounded both kernels (PERF.md has the times).
// The tiles (the q step of dK/dV, the key step of dQ, the ring's slots)
// are counted by flash_bwd_plan() in ops/kernels/flash_attention.py and
// passed here; an entry launches the instance compiled for them and
// checks the shared memory only against the block limit.
//
// f32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, on the SIMT units
// (f32 FMAs; the tensor cores would mean TF32, outside the f32
// tolerance):
// - The TPU grid carries dK/dV in scratch across its sequential (rep,
//   q block) axes. Here one block owns one (batch, kv head, k tile) and
//   loops over the rep query heads and, inside, over the q tiles from
//   the first one that can see the k tile; dK/dV stay in registers and
//   are written once.
// - One dQ block owns one (batch, q head, 64-row q tile) and loops over
//   the k tiles up to the causal limit, dQ in registers.
// - Each 128-thread block holds its tiles in shared memory (rows padded
//   by one float, so the strided reads stay off bank conflicts); a
//   thread owns an 8 x (BK/16) block of scores and of the gradient tile
//   it accumulates. S and dP share one pass over D.
#include "zt_mma.cuh"

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

// ------------------------------------------------ bf16, tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kBK = 64;   // key rows of a dK/dV block (16 a warp)
constexpr int kBQ = 64;   // q rows of a dQ block (16 a warp)

// The tiles of each head dim; flash_bwd_plan() counts the same. STEP:
// the q rows a dK/dV step takes, and the key rows a dQ step takes.
template <int D>
struct Tiles {
  static constexpr int STEP = D > 64 ? 32 : 64;
  static constexpr int STAGES = 2;
  // the K/V A fragments stay in registers between q steps
  static constexpr bool KV_REGS = D <= 64;
};

// 16 rows x 16 columns starting at (row0, column 16 * dk) of a swizzled
// tile with U 16-byte units a row, as an mma A fragment
template <int U>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], uint32_t base,
                                       int row0, int dk, int lane) {
  const int row = row0 + (lane & 15), u = dk * 2 + (lane >> 4);
  mma::ldmatrix_x4(r, base + row * U * 16 + mma::swizzle<U>(row, u) * 16);
}

// B fragments of two neighbouring n-tiles (rows n0 .. n0+15 of a
// swizzled tile whose rows are the n index, k = columns 16 dk ..
// 16 dk + 15): r[0], r[1] for n-tile n0 / 8, r[2], r[3] for the next
template <int U>
__device__ __forceinline__ void b_frag(uint32_t (&r)[4], uint32_t base,
                                       int n0, int dk, int lane) {
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int u = dk * 2 + ((lane >> 3) & 1);
  mma::ldmatrix_x4(r, base + row * U * 16 + mma::swizzle<U>(row, u) * 16);
}

// B fragments from a swizzled tile whose rows are the k index (rows
// k0 .. k0+15, n = columns 16 p .. 16 p + 15), transposed on load:
// r[0], r[1] for n-tile 2 p, r[2], r[3] for n-tile 2 p + 1
template <int U>
__device__ __forceinline__ void b_frag_trans(uint32_t (&r)[4], uint32_t base,
                                             int k0, int p, int lane) {
  const int row = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int u = p * 2 + (lane >> 4);
  mma::ldmatrix_x4_trans(r,
                         base + row * U * 16 + mma::swizzle<U>(row, u) * 16);
}

// two neighbouring 8-column accumulator tiles, rounded to bf16: the A
// fragment of a product over those 16 columns
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = mma::pack_bf16(c0[0], c0[1]);
  a[1] = mma::pack_bf16(c0[2], c0[3]);
  a[2] = mma::pack_bf16(c1[0], c1[1]);
  a[3] = mma::pack_bf16(c1[2], c1[3]);
}

// 2^x on the special-function unit (-inf gives 0): p = exp(s * scale -
// lse) is taken as 2^(s * scale * log2 e - lse * log2 e), one FFMA and
// one MUFU.EX2 in place of expf's range reduction
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// rows [r0, r0 + rows) of a (T, D) bf16 matrix into a swizzled tile;
// rows at or past T are zero-filled
template <int D>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const bf16* src, int r0, int rows,
                                          int T) {
  constexpr int U = D / 8;
  for (int e = threadIdx.x; e < rows * U; e += kThreads) {
    const int r = e / U, u = e % U;
    const bool ok = r0 + r < T;
    mma::cp_async<16>(
        mma::smem_addr(dst + r * D * 2 + mma::swizzle<U>(r, u) * 16),
        ok ? src + static_cast<size_t>(r0 + r) * D + u * 8 : src, ok);
  }
}

template <int D, int BQ, int STAGES, bool KV_REGS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int H, int Hkv, int Tq, int Tk, float scale,
                             int causal) {
  using namespace mma;
  constexpr int U = D / 8;       // 16-byte units in a row
  constexpr int RB = D * 2;      // bytes in a row
  constexpr int KD = D / 16;     // k-steps over D
  constexpr int ND = D / 8;      // n-tiles of dK, dV
  constexpr int NS = BQ / 8;     // n-tiles of S^T, dP^T
  constexpr int TILE = BQ * RB;  // bytes of a Q or dO tile
  constexpr int SLOT = 2 * TILE + 2 * BQ * 4;   // Q, dO, lse, delta
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* ks = tc_smem;               // kBK rows
  unsigned char* vs = ks + kBK * RB;         // kBK rows
  unsigned char* ring = vs + kBK * RB;       // STAGES slots

  const int bkv = blockIdx.y, k0 = blockIdx.x * kBK;
  const int b = bkv / Hkv, g = bkv % Hkv, rep = H / Hkv;
  const int off = Tk - Tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t kv_base = static_cast<size_t>(bkv) * Tk * D;
  const int kw0 = k0 + warp * 16;            // this warp's first key

  copy_rows<D>(ks, k + kv_base, k0, kBK, Tk);
  copy_rows<D>(vs, v + kv_base, k0, kBK, Tk);

  // first q tile holding a row that sees a key of this tile; every key
  // (< Tk) is seen by the last row, so each head has a step
  const int first_row = causal ? k0 - off : 0;
  const int qt0 = first_row <= 0 ? 0 : first_row / BQ;
  const int n_q = (Tq + BQ - 1) / BQ;
  const int per_head = n_q - qt0;
  const int n_it = rep * per_head;

  auto load_q = [&](int it, int slot) {
    const int bh = b * H + g * rep + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    const size_t base = static_cast<size_t>(bh) * Tq;
    unsigned char* qs = ring + slot * SLOT;
    copy_rows<D>(qs, q + base * D, q0, BQ, Tq);
    copy_rows<D>(qs + TILE, dout + base * D, q0, BQ, Tq);
    float* ls = reinterpret_cast<float*>(qs + 2 * TILE);
    for (int e = tid; e < 2 * BQ; e += kThreads) {
      const int r = e % BQ;
      const bool ok = q0 + r < Tq;
      const float* src = e < BQ ? lse : delta;
      cp_async<4>(smem_addr(ls + e), ok ? src + base + q0 + r : src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_q(s, s);
    cp_async_commit();   // the first group also holds the K and V tiles
  }

  const uint32_t ka = smem_addr(ks), va = smem_addr(vs);
  uint32_t kf[KV_REGS ? KD : 1][4], vf[KV_REGS ? KD : 1][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int nx = it + STAGES - 1;
    if (nx < n_it) load_q(nx, nx % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if constexpr (KV_REGS) {
      if (it == 0) {
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          a_frag<U>(kf[d], ka, warp * 16, d, lane);
          a_frag<U>(vf[d], va, warp * 16, d, lane);
        }
      }
    }
    const int q0 = (qt0 + it % per_head) * BQ;
    if (!causal || q0 + BQ - 1 + off >= kw0) {
      unsigned char* slot = ring + (it % STAGES) * SLOT;
      const uint32_t qa = smem_addr(slot), oa = qa + TILE;
      const float* ls = reinterpret_cast<const float*>(slot + 2 * TILE);
      const float* dl = ls + BQ;

      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        uint32_t kd[4], vd[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kd[e] = kf[d][e];
            vd[e] = vf[d][e];
          }
        } else {
          a_frag<U>(kd, ka, warp * 16, d, lane);
          a_frag<U>(vd, va, warp * 16, d, lane);
        }
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t bq[4], bo[4];
          b_frag<U>(bq, qa, p * 16, d, lane);
          mma_bf16(s[2 * p], kd, bq[0], bq[1]);
          mma_bf16(s[2 * p + 1], kd, bq[2], bq[3]);
          b_frag<U>(bo, oa, p * 16, d, lane);
          mma_bf16(dp[2 * p], vd, bo[0], bo[1]);
          mma_bf16(dp[2 * p + 1], vd, bo[2], bo[3]);
        }
      }

      // P^T and dS^T: rows are this warp's keys, columns q rows
      const bool edge = q0 + BQ > Tq || kw0 + 16 > Tk ||
                        (causal && kw0 + 15 > q0 + off);
      const float scale2 = scale * kLog2e;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x;
          const float dd = (e & 1) ? d2.y : d2.x;
          float p = l == -INFINITY
                        ? 0.f
                        : exp2_approx(s[j][e] * scale2 - l * kLog2e);
          if (edge) {
            const int key = kw0 + (lane >> 2) + (e >> 1) * 8;
            const int row = q0 + c + (e & 1);
            if (row >= Tq || key >= Tk || (causal && key > row + off))
              p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dd) * scale;
        }
      }

      // dV += P^T dO, dK += dS^T Q over the step's q rows
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          uint32_t bo[4], bq[4];
          b_frag_trans<U>(bo, oa, kk * 16, p, lane);
          mma_bf16(dva[2 * p], pa, bo[0], bo[1]);
          mma_bf16(dva[2 * p + 1], pa, bo[2], bo[3]);
          b_frag_trans<U>(bq, qa, kk * 16, p, lane);
          mma_bf16(dka[2 * p], da, bq[0], bq[1]);
          mma_bf16(dka[2 * p + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // the slot is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kw0 + (lane >> 2) + i * 8;
    if (row >= Tk) continue;
    const size_t o = kv_base + static_cast<size_t>(row) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dk + o + j * 8) =
          pack_bf16(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + j * 8) =
          pack_bf16(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <int D, int BKS, int STAGES>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int H, int Hkv, int Tq,
                           int Tk, float scale, int causal) {
  using namespace mma;
  constexpr int U = D / 8;        // 16-byte units in a row
  constexpr int RB = D * 2;       // bytes in a row
  constexpr int KD = D / 16;      // k-steps over D
  constexpr int ND = D / 8;       // n-tiles of dQ
  constexpr int NS = BKS / 8;     // n-tiles of S, dP
  constexpr int SLOT = 2 * BKS * RB;   // K rows, V rows
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;               // kBQ rows
  unsigned char* os = qs + kBQ * RB;         // kBQ rows
  unsigned char* ring = os + kBQ * RB;       // STAGES slots

  const int n_q = (Tq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const size_t q_base = static_cast<size_t>(bh) * Tq * D;
  const bf16* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Tk * D;
  const int off = Tk - Tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq0 = q0 + warp * 16;
  const int row0 = wq0 + (lane >> 2);

  copy_rows<D>(qs, q + q_base, q0, kBQ, Tq);
  copy_rows<D>(os, dout + q_base, q0, kBQ, Tq);

  int n_k = (Tk + BKS - 1) / BKS;
  if (causal) {
    const int last = q0 + kBQ - 1 + off;   // highest live column here
    n_k = last < 0 ? 0 : min(n_k, last / BKS + 1);
  }
  auto load_kv = [&](int kt, int slot) {
    unsigned char* dst = ring + slot * SLOT;
    copy_rows<D>(dst, kb, kt * BKS, BKS, Tk);
    copy_rows<D>(dst + BKS * RB, vb, kt * BKS, BKS, Tk);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_kv(s, s);
    cp_async_commit();   // the first group also holds the Q and dO tiles
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) {
    a_frag<U>(qf[d], smem_addr(qs), warp * 16, d, lane);
    a_frag<U>(of[d], smem_addr(os), warp * 16, d, lane);
  }
  // this thread's two rows (g and g+8 of the warp's 16); rows past Tq
  // take lse = -inf, which zeroes them
  float row_lse[2], row_lse2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const bool in = row < Tq;
    row_lse[i] = in ? lse[static_cast<size_t>(bh) * Tq + row] : -INFINITY;
    row_lse2[i] = row_lse[i] * kLog2e;
    row_delta[i] = in ? delta[static_cast<size_t>(bh) * Tq + row] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int nx = kt + STAGES - 1;
    if (nx < n_k) load_kv(nx, nx % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = kt * BKS;
    if (!causal || k0 <= wq0 + 15 + off) {
      const uint32_t ka = smem_addr(ring + (kt % STAGES) * SLOT);
      const uint32_t va = ka + BKS * RB;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d)
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t bk[4], bv[4];
          b_frag<U>(bk, ka, p * 16, d, lane);
          mma_bf16(s[2 * p], qf[d], bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], qf[d], bk[2], bk[3]);
          b_frag<U>(bv, va, p * 16, d, lane);
          mma_bf16(dp[2 * p], of[d], bv[0], bv[1]);
          mma_bf16(dp[2 * p + 1], of[d], bv[2], bv[3]);
        }
      const bool edge =
          k0 + BKS > Tk || (causal && k0 + BKS - 1 > wq0 + off);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = row_lse[i] == -INFINITY
                        ? 0.f
                        : exp2_approx(s[j][e] * scale2 - row_lse2[i]);
          if (edge) {
            const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int row = row0 + i * 8;
            if (col >= Tk || (causal && col > row + off)) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - row_delta[i]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          uint32_t bk[4];
          b_frag_trans<U>(bk, ka, kk * 16, p, lane);
          mma_bf16(dqa[2 * p], da, bk[0], bk[1]);
          mma_bf16(dqa[2 * p + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // the slot is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= Tq) continue;
    bf16* out = dq + q_base + static_cast<size_t>(row) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(dqa[j][2 * i], dqa[j][2 * i + 1]);
  }
}

// The plan's tiles must be the ones this head dim's instance was
// compiled for; its shared memory is checked against the block limit.
template <int D>
cudaError_t check_plan(const BwdArgs& a, int step, int stages, int smem) {
  if (smem <= 0 || smem > mma::kMaxSmem) return cudaErrorInvalidValue;
  if (step != Tiles<D>::STEP || stages != Tiles<D>::STAGES)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.dout)) % 16)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkdv(const BwdArgs& a, void* dk, void* dv, int step,
                        int stages, int smem, cudaStream_t st) {
  using Ti = Tiles<D>;
  cudaError_t err = check_plan<D>(a, step, stages, smem);
  if (err != cudaSuccess) return err;
  auto kernel =
      flash_bwd_dkdv_tc_kernel<D, Ti::STEP, Ti::STAGES, Ti::KV_REGS>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kBK - 1) / kBK, a.B * a.Hkv);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Hkv,
      a.Tq, a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, void* dq, int step, int stages,
                      int smem, cudaStream_t st) {
  using Ti = Tiles<D>;
  cudaError_t err = check_plan<D>(a, step, stages, smem);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_tc_kernel<D, Ti::STEP, Ti::STAGES>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(dq), a.H, a.Hkv, a.Tq, a.Tk, a.scale,
      a.causal);
  return cudaGetLastError();
}

}  // namespace tc

// which = 0: dK/dV into out0/out1; which = 1: dQ into out0. The bf16
// route takes the plan (step, stages, smem); the f32 route none.
template <int D>
cudaError_t launch_one(int which, int dtype, const BwdArgs& a, void* out0,
                       void* out1, int step, int stages, int smem,
                       cudaStream_t st) {
  if (dtype == kF32)
    return which == 0 ? launch_dkdv<float, D>(a, out0, out1, st)
                      : launch_dq<float, D>(a, out0, st);
  if (dtype == kBF16)
    return which == 0
               ? tc::launch_dkdv<D>(a, out0, out1, step, stages, smem, st)
               : tc::launch_dq<D>(a, out0, step, stages, smem, st);
  return cudaErrorInvalidValue;
}

int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* out0, void* out1, int B, int H, int Hkv, int Tq, int Tk,
               int D, float scale, int causal, int dtype, int step,
               int stages, int smem, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1 || B < 1)
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Hkv, Tq, Tk, scale,
                  causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_one<16>(which, dtype, a, out0, out1, step, stages, smem,
                            st);
    case 32:
      return launch_one<32>(which, dtype, a, out0, out1, step, stages, smem,
                            st);
    case 64:
      return launch_one<64>(which, dtype, a, out0, out1, step, stages, smem,
                            st);
    case 128:
      return launch_one<128>(which, dtype, a, out0, out1, step, stages,
                             smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace zt

// q, dout (B*H, Tq, D); k, v, dk, dv (B*Hkv, Tk, D); lse, delta (B*H, Tq)
// f32. D in {16, 32, 64, 128}; dtype 0 = f32 (SIMT kernel; step, stages
// and smem 0), 1 = bf16 (tensor cores, with the q step, ring slots and
// shared-memory bytes flash_bwd_plan() gives; q, k, v, dout 16-byte
// aligned).
extern "C" int zt_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int B, int H, int Hkv, int Tq, int Tk, int D,
                                 float scale, int causal, int dtype, int step,
                                 int stages, int smem, void* stream) {
  return zt::launch_bwd(0, q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tq,
                        Tk, D, scale, causal, dtype, step, stages, smem,
                        stream);
}

// dq (B*H, Tq, D); the other operands and the plan as for
// zt_flash_bwd_dkdv (the step counts key rows here).
extern "C" int zt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Hkv, int Tq, int Tk, int D, float scale,
                               int causal, int dtype, int step, int stages,
                               int smem, void* stream) {
  return zt::launch_bwd(1, q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv,
                        Tq, Tk, D, scale, causal, dtype, step, stages, smem,
                        stream);
}
