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
// f32: f32::flash_bwd_dkdv_kernel and f32::flash_bwd_dq_kernel, on the
// SIMT units (f32 FMAs; one TF32 product keeps ~3 decimal digits, outside
// the f32 tolerance). At the training shape in f32 the two do 14*D flops
// a live pair, 90.4 GFLOP against ~0.44 GB, ~200 flops a byte:
// operations, far above the f32 balance (67 TFLOP/s over 3.35 TB/s =
// 20). The design is the f32 forward's
// (flash_attention_fwd.cu, f32::flash_fwd_kernel), which keeps the FMA
// pipes fed:
// - dK/dV: one block of 8 warps per (batch, kv head, 64-key tile); warp
//   w owns keys 8w .. 8w+7 of the tile in both of its products. The K
//   and V tiles are loaded once; the block loops over the rep query
//   heads and, inside, over the q tiles from the first one that can see
//   the key tile; each 64-row q tile, its dO tile and their lse and delta
//   stream through a 2-slot 16-byte cp.async ring (one block barrier a
//   tile). S^T and dP^T for the warp's keys over the tile's 64 rows come
//   out of one pass over D: a thread owns 4 rows x 4 keys of each and
//   reads Q, dO, K and V as float4 along d. P^T goes to a buffer of the
//   warp's own (64 rows x 8 keys) behind __syncwarp for dV += P^T dO,
//   then dS^T takes its place for dK += dS^T Q; a thread owns 4 keys x
//   D/16 columns of dK and dV, in registers until the key tile ends.
// - dQ: one block of 8 warps per (batch*head, 64-row q tile); warp w
//   owns q rows 8w .. 8w+7. The Q and dO tiles and their lse and delta
//   are loaded once; K and V tiles stream through the ring up to the
//   causal limit. S and dP for the warp's rows over the tile's 64 keys
//   in one pass over D (4 rows x 4 keys a thread); dS goes to the warp's
//   buffer (64 keys x 8 rows) behind __syncwarp for dQ += dS K.
// - Q, K, V and dO rows are padded by 16 bytes, so float4 reads of 8
//   neighbouring rows at one column fall in 8 different bank groups.
// - A warp whose rows and keys are wholly apart by the causal mask
//   skips the tile, through a vote (no shuffle sits under a branch the
//   compiler cannot prove uniform); masks are applied only on edge
//   tiles.
// - Causal work is balanced: a block takes two tiles, the heaviest and
//   the lightest left (key tiles x and n-1-x for dK/dV, q tiles n-1-x
//   and x for dQ), so every block walks n+1 tiles of the other side.
// - p is taken as 2^(s * scale * log2 e - lse * log2 e) by ex2.approx,
//   as the bf16 route takes it.
// The plan (tile rows, threads, slots, shared memory, the pairing) is
// counted by flash_bwd_f32_plan() in ops/kernels/flash_attention.py; the
// tile rows, slots and bytes are passed here, the pairing follows from
// causal. An entry refuses other tiles and checks the bytes only against
// the block limit.
#include "zt_mma.cuh"

namespace zt {

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Hkv, Tq, Tk;
  float scale;
  int causal;
};

// 2^x on the special-function unit (-inf gives 0): p = exp(s * scale -
// lse) is taken as 2^(s * scale * log2 e - lse * log2 e), one FFMA and
// one MUFU.EX2 in place of expf's range reduction
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------ f32, SIMT

namespace f32 {

constexpr int kBQ = 64, kBK = 64, kWarps = 8, kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kWK = kBK / kWarps;   // keys a dK/dV warp owns
constexpr int kWQ = kBQ / kWarps;   // q rows a dQ warp owns

template <int D>
struct Layout {
  static constexpr int LD = D + 4;        // floats a Q, K, V or dO row takes
  static constexpr int U = D / 4;         // 16-byte units of a row
  static constexpr int TILE = 64 * LD;    // floats of a 64-row tile
  static constexpr int OC = D / 16;       // dK, dV or dQ columns of a thread
  static constexpr int VW = OC < 4 ? OC : 4;   // ... read as vectors of VW
  static constexpr int NV = OC / VW;
};

// rows [r0, r0 + 64) of a (T, D) f32 matrix into rows of D + 4 floats;
// rows at or past T are zero-filled
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int T) {
  using Lt = Layout<D>;
  for (int e = threadIdx.x; e < 64 * Lt::U; e += kThreads) {
    const int r = e / Lt::U, u = e % Lt::U;
    const bool ok = r0 + r < T;
    mma::cp_async<16>(
        mma::smem_addr(dst + r * Lt::LD + 4 * u),
        ok ? src + static_cast<size_t>(r0 + r) * D + 4 * u : src, ok);
  }
}

// lse and delta of q rows [q0, q0 + 64) of the head at `base` into
// dst[0 .. 64) and dst[64 .. 128); rows past Tq read 0 (masked by row)
__device__ __forceinline__ void copy_stats(float* dst, const float* lse,
                                           const float* delta, size_t base,
                                           int q0, int Tq) {
  for (int e = threadIdx.x; e < 2 * kBQ; e += kThreads) {
    const int r = e % kBQ;
    const bool ok = q0 + r < Tq;
    const float* src = e < kBQ ? lse : delta;
    mma::cp_async<4>(mma::smem_addr(dst + e), ok ? src + base + q0 + r : src,
                     ok);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// acc[c] += s * (VW floats at p), c over one vector of a thread's columns
template <int VW>
__device__ __forceinline__ void axpy(float* acc, float s, const float* p) {
  if constexpr (VW == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    acc[0] = fmaf(s, w.x, acc[0]);
    acc[1] = fmaf(s, w.y, acc[1]);
    acc[2] = fmaf(s, w.z, acc[2]);
    acc[3] = fmaf(s, w.w, acc[3]);
  } else if constexpr (VW == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    acc[0] = fmaf(s, w.x, acc[0]);
    acc[1] = fmaf(s, w.y, acc[1]);
  } else {
    acc[0] = fmaf(s, p[0], acc[0]);
  }
}

template <int VW>
__device__ __forceinline__ void store(float* dst, const float* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// s[i][j] = a_i . b_j and t[i][j] = c_i . d_j over D, for rows a_i, c_i
// at a + i * sa (c + i * sa) and b_j, d_j at b + j * sb (d + j * sb):
// the score and dP tiles of a thread in one pass over D
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* c,
                                             int sa, const float* b,
                                             const float* d, int sb,
                                             float (&s)[4][4],
                                             float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int u = 0; u < D / 4; ++u) {
    float4 x[4], y[4], z[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + i * sa + 4 * u);
      y[i] = *reinterpret_cast<const float4*>(c + i * sa + 4 * u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      z[j] = *reinterpret_cast<const float4*>(b + j * sb + 4 * u);
      w[j] = *reinterpret_cast<const float4*>(d + j * sb + 4 * u);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(x[i], z[j], s[i][j]);
        t[i][j] = dot4(y[i], w[j], t[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Hkv, int Tq, int Tk, float scale,
                          int causal) {
  using Lt = Layout<D>;
  constexpr int LD = Lt::LD, TILE = Lt::TILE, OC = Lt::OC, VW = Lt::VW;
  constexpr int SLOT = 2 * TILE + 2 * kBQ;   // Q, dO, lse, delta
  extern __shared__ __align__(16) float bsmem[];
  float* ks = bsmem;
  float* vs = ks + TILE;
  float* ring = vs + TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's P^T, then dS^T: its 8 keys for each of the tile's rows
  float* pb = ring + kStages * SLOT + warp * kBQ * kWK;
  // scores: rows rg + 16 i, keys 4 kh + j of the warp's; dK/dV: keys
  // 4 kh + j, columns t * 16 VW + rg * VW + e
  const int kh = lane & 1, rg = lane >> 1;

  const int bkv = blockIdx.y, b = bkv / Hkv, g = bkv % Hkv, rep = H / Hkv;
  const int off = Tk - Tq;
  const size_t kv_base = static_cast<size_t>(bkv) * Tk * D;
  const int n_q = (Tq + kBQ - 1) / kBQ, n_kt = (Tk + kBK - 1) / kBK;
  const int x = blockIdx.x;
  const int n_tiles = causal && x != n_kt - 1 - x ? 2 : 1;
  const float scale2 = scale * kLog2e;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int k0 = (ti == 0 ? x : n_kt - 1 - x) * kBK;
    const int wk0 = k0 + warp * kWK;   // the warp's first key
    // first q tile holding a row that sees a key of this tile; every key
    // (< Tk) is seen by the last row, so each head has a step
    const int first_row = causal ? k0 - off : 0;
    const int qt0 = first_row <= 0 ? 0 : first_row / kBQ;
    const int per_head = n_q - qt0;
    const int n_it = rep * per_head;

    auto load_q = [&](int it, int slot) {
      const size_t base =
          static_cast<size_t>(b * H + g * rep + it / per_head) * Tq;
      const int q0 = (qt0 + it % per_head) * kBQ;
      float* qs = ring + slot * SLOT;
      copy_rows<D>(qs, q + base * D, q0, Tq);
      copy_rows<D>(qs + TILE, dout + base * D, q0, Tq);
      copy_stats(qs + 2 * TILE, lse, delta, base, q0, Tq);
    };
    copy_rows<D>(ks, k + kv_base, k0, Tk);
    copy_rows<D>(vs, v + kv_base, k0, Tk);
    load_q(0, 0);
    mma::cp_async_commit();   // the first group also holds the K and V tiles

    float dka[4][OC], dva[4][OC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < OC; ++c) dka[j][c] = dva[j][c] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      mma::cp_async_wait<0>();
      __syncthreads();   // step it landed; every warp is done with it - 1
      if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
      mma::cp_async_commit();
      const int q0 = (qt0 + it % per_head) * kBQ;
      const float* qs = ring + (it & 1) * SLOT;
      const float* dos = qs + TILE;
      const float* ls = qs + 2 * TILE;
      // the warp's keys wholly in the causal future of the tile's rows
      if (!__any_sync(0xffffffffu, !causal || wk0 <= q0 + kBQ - 1 + off))
        continue;
      float s[4][4], dp[4][4];
      two_products<D>(qs + rg * LD, dos + rg * LD, 16 * LD,
                      ks + (warp * kWK + 4 * kh) * LD,
                      vs + (warp * kWK + 4 * kh) * LD, LD, s, dp);
      const bool edge = q0 + kBQ > Tq || wk0 + kWK > Tk ||
                        (causal && wk0 + kWK - 1 > q0 + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i, row = q0 + r;
        const float l2 = ls[r] * kLog2e, dl = ls[kBQ + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wk0 + 4 * kh + j;
          float p = exp2_approx(s[i][j] * scale2 - l2);
          if (edge && (row >= Tq || col >= Tk || (causal && col > row + off)))
            p = 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dl) * scale;
        }
      }
      // dV += P^T dO, then dK += dS^T Q, over the tile's rows
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(pb + (rg + 16 * i) * kWK + 4 * kh) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      __syncwarp();
#pragma unroll 8
      for (int r = 0; r < kBQ; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pb + r * kWK +
                                                          4 * kh);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int t = 0; t < Lt::NV; ++t) {
          const float* src = dos + r * LD + t * 16 * VW + rg * VW;
#pragma unroll
          for (int j = 0; j < 4; ++j) axpy<VW>(dva[j] + t * VW, pr[j], src);
        }
      }
      __syncwarp();   // P^T read before dS^T takes its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(pb + (rg + 16 * i) * kWK + 4 * kh) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      __syncwarp();
#pragma unroll 8
      for (int r = 0; r < kBQ; ++r) {
        const float4 d4 = *reinterpret_cast<const float4*>(pb + r * kWK +
                                                           4 * kh);
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int t = 0; t < Lt::NV; ++t) {
          const float* src = qs + r * LD + t * 16 * VW + rg * VW;
#pragma unroll
          for (int j = 0; j < 4; ++j) axpy<VW>(dka[j] + t * VW, dr[j], src);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = wk0 + 4 * kh + j;
      if (key >= Tk) continue;
      const size_t o = kv_base + static_cast<size_t>(key) * D + rg * VW;
#pragma unroll
      for (int t = 0; t < Lt::NV; ++t) {
        store<VW>(dk + o + t * 16 * VW, dka[j] + t * VW);
        store<VW>(dv + o + t * 16 * VW, dva[j] + t * VW);
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();   // the K/V tiles and the ring are free for the next
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Hkv, int Tq,
                        int Tk, float scale, int causal) {
  using Lt = Layout<D>;
  constexpr int LD = Lt::LD, TILE = Lt::TILE, OC = Lt::OC, VW = Lt::VW;
  extern __shared__ __align__(16) float bsmem[];
  float* qs = bsmem;
  float* dos = qs + TILE;
  float* ls = dos + TILE;             // lse, then delta
  float* ring = ls + 2 * kBQ;         // per slot: K, V tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's dS: its 8 rows for each of the tile's keys
  float* sb = ring + kStages * 2 * TILE + warp * kBK * kWQ;
  // scores: rows 4 rh + i of the warp's, keys kg + 16 j; dQ: rows
  // 4 rh + i, columns t * 16 VW + kg * VW + e
  const int rh = lane & 1, kg = lane >> 1;

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const size_t q_base = static_cast<size_t>(bh) * Tq;
  const float* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const float* vb = v + static_cast<size_t>(kvh) * Tk * D;
  const int off = Tk - Tq;
  const int n_q = (Tq + kBQ - 1) / kBQ, n_kt = (Tk + kBK - 1) / kBK;
  const int x = blockIdx.x;
  const int n_tiles = causal && x != n_q - 1 - x ? 2 : 1;
  const float scale2 = scale * kLog2e;
  const int wr = warp * kWQ + 4 * rh;   // the thread's first row of the tile

  auto load_kv = [&](int kt, int slot) {
    float* kvs = ring + slot * 2 * TILE;
    copy_rows<D>(kvs, kb, kt * kBK, Tk);
    copy_rows<D>(kvs + TILE, vb, kt * kBK, Tk);
  };

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int q0 = (ti == 0 ? n_q - 1 - x : x) * kBQ;
    const int wq0 = q0 + warp * kWQ;   // the warp's first row
    int n_k = n_kt;
    if (causal) {
      const int last = q0 + kBQ - 1 + off;   // highest live column here
      n_k = last < 0 ? 0 : min(n_k, last / kBK + 1);
    }
    copy_rows<D>(qs, q + q_base * D, q0, Tq);
    copy_rows<D>(dos, dout + q_base * D, q0, Tq);
    copy_stats(ls, lse, delta, q_base, q0, Tq);
    if (n_k > 0) load_kv(0, 0);
    mma::cp_async_commit();

    float dqa[4][OC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) dqa[i][c] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      mma::cp_async_wait<0>();
      __syncthreads();   // tile kt landed; every warp is done with kt - 1
      if (kt + 1 < n_k) load_kv(kt + 1, (kt + 1) & 1);
      mma::cp_async_commit();
      const int k0 = kt * kBK;
      const float* kts = ring + (kt & 1) * 2 * TILE;
      const float* vts = kts + TILE;
      // the tile wholly in the causal future of the warp's rows
      if (!__any_sync(0xffffffffu, !causal || k0 <= wq0 + kWQ - 1 + off))
        continue;
      float s[4][4], dp[4][4];
      two_products<D>(qs + wr * LD, dos + wr * LD, LD, kts + kg * LD,
                      vts + kg * LD, 16 * LD, s, dp);
      const bool edge = wq0 + kWQ > Tq || k0 + kBK > Tk ||
                        (causal && k0 + kBK - 1 > wq0 + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + wr + i;
        const float l2 = ls[wr + i] * kLog2e, dl = ls[kBQ + wr + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + kg + 16 * j;
          float p = exp2_approx(s[i][j] * scale2 - l2);
          if (edge && (row >= Tq || col >= Tk || (causal && col > row + off)))
            p = 0.f;
          dp[i][j] = p * (dp[i][j] - dl) * scale;
        }
      }
      // dQ += dS K over the tile's keys
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(sb + (kg + 16 * j) * kWQ + 4 * rh) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      __syncwarp();
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) {
        const float4 d4 = *reinterpret_cast<const float4*>(sb + c * kWQ +
                                                           4 * rh);
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int t = 0; t < Lt::NV; ++t) {
          const float* src = kts + c * LD + t * 16 * VW + kg * VW;
#pragma unroll
          for (int i = 0; i < 4; ++i) axpy<VW>(dqa[i] + t * VW, dr[i], src);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + wr + i;
      if (row >= Tq) continue;
      float* o = dq + (q_base + row) * D + kg * VW;
#pragma unroll
      for (int t = 0; t < Lt::NV; ++t)
        store<VW>(o + t * 16 * VW, dqa[i] + t * VW);
    }
    mma::cp_async_wait<0>();
    __syncthreads();   // the Q/dO tiles and the ring are free for the next
  }
}

// The plan's tiles must be the ones compiled: 64-row tiles, 2 slots;
// its shared memory is checked against the block limit.
inline cudaError_t check_plan(const BwdArgs& a, int step, int stages,
                              int smem) {
  if (smem <= 0 || smem > mma::kMaxSmem || step != kBQ ||
      stages != kStages)
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
  cudaError_t err = check_plan(a, step, stages, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.Tk + kBK - 1) / kBK;
  const dim3 grid(a.causal ? (n_kt + 1) / 2 : n_kt, a.B * a.Hkv);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.H,
      a.Hkv, a.Tq, a.Tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, void* dq, int step, int stages,
                      int smem, cudaStream_t st) {
  cudaError_t err = check_plan(a, step, stages, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_q = (a.Tq + kBQ - 1) / kBQ;
  const dim3 grid(a.causal ? (n_q + 1) / 2 : n_q, a.B * a.H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.H, a.Hkv, a.Tq, a.Tk,
      a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace f32

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

// which = 0: dK/dV into out0/out1; which = 1: dQ into out0. Each route
// takes its plan (step, stages, smem).
template <int D>
cudaError_t launch_one(int which, int dtype, const BwdArgs& a, void* out0,
                       void* out1, int step, int stages, int smem,
                       cudaStream_t st) {
  if (dtype == kF32)
    return which == 0
               ? f32::launch_dkdv<D>(a, out0, out1, step, stages, smem, st)
               : f32::launch_dq<D>(a, out0, step, stages, smem, st);
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
// f32; q, k, v, dout 16-byte aligned. D in {16, 32, 64, 128}; dtype 0 =
// f32 (the SIMT kernels, with the tile rows, ring slots and shared-memory
// bytes flash_bwd_f32_plan() gives; causal tiles are paired), 1 = bf16
// (the tensor cores, with the q step, ring slots and shared-memory bytes
// flash_bwd_plan() gives).
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
// zt_flash_bwd_dkdv (the bf16 step counts key rows here).
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
