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
// f32: f32::flash_fwd_kernel, on the SIMT units (f32 FMAs; tensor cores
// would mean TF32, and the serving streams must stay token-identical to
// the plain path). At the 8B serving shape (B=1, H=32, Hkv=8, T=512,
// D=128, causal) it does 2.15 GFLOP against ~17 MB, above the f32
// balance (67 TFLOP/s over 3.35 TB/s = 20): the FMA pipes bound it. The
// design keeps them fed:
// - a block of 8 warps per 64-row q tile: warp w owns rows 16 (w % 4) ..
//   +15 and one half (32 keys) of every 64-key K/V tile, so the two
//   halves of the block run the online softmax side by side and are
//   merged once, through shared memory, at the end of the q tile;
// - K/V tiles arrive by 16-byte cp.async into a 2-slot ring (tile t+1
//   loads while tile t computes; one block barrier a tile); Q, K and V
//   rows are padded by 16 bytes, so 8 neighbouring rows at one 16-byte
//   column are 8 different bank groups;
// - a thread owns a 4 x 4 tile of S (rows r + 4i, keys c + 8j of its
//   warp) and 4 rows x D/8 columns of O: the score product reads Q and K
//   as float4 along d (8 LDS.128 for 64 FMAs), P.V reads P as a float4
//   of its 4 rows and V as float4 rows (5 LDS.128 for 64 FMAs at D=128);
// - the softmax stays in registers: the row max over the 8 lanes of a
//   row by xor shuffles, the row sum per thread until the end; P goes to
//   a buffer of the warp's own (its 16 rows x 32 keys), behind
//   __syncwarp, never a block barrier; the causal skip of a warp's half
//   goes through a vote, so no shuffle sits under a branch the compiler
//   cannot prove uniform;
// - causal work is balanced: a block takes the heaviest q tile and the
//   lightest (n-1-x and x), so every block walks n+1 key tiles.
// The plan (tile rows, threads, slots, shared memory, the pairing) is
// counted by flash_f32_plan() in ops/kernels/flash_attention.py and
// passed here; the entry checks the bytes only against the block limit.
#include "zt_mma.cuh"

namespace zt {

namespace f32 {

constexpr int kBQ = 64, kBK = 64, kWarps = 8, kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kHalf = kBK / 2;   // keys of a warp's half of a K/V tile
constexpr int kPLd = 16 + 4;     // a warp's P buffer: its 16 rows, padded

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal, int pair) {
  using namespace mma;
  constexpr int LD = D + 4;              // floats a Q, K or V row takes
  constexpr int U = D / 4;               // 16-byte units of a row
  constexpr int OC = D / 8;              // output columns of a thread
  constexpr int VW = OC < 4 ? OC : 4;    // ... read as vectors of VW
  constexpr int NV = OC / VW;
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                             // kBQ rows
  float* ring = qs + kBQ * LD;                   // per slot: K, V kBK rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows0 = (warp & 3) * 16;             // the warp's 16 rows
  const int half = warp >> 2;                    // ... and key half
  const int rg = lane >> 3, cg = lane & 7;       // rows rg + 4i, keys cg + 8j
  float* ps = ring + kStages * 2 * kBK * LD + warp * kHalf * kPLd;

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int kvh = b * Hkv + hh / (H / Hkv);
  const float* qb = q + static_cast<size_t>(bh) * Tq * D;
  const float* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const float* vb = v + static_cast<size_t>(kvh) * Tk * D;
  const int off = Tk - Tq;
  const int n_q = (Tq + kBQ - 1) / kBQ, n_kt = (Tk + kBK - 1) / kBK;
  const int x = blockIdx.x;
  const int n_tiles = pair && x != n_q - 1 - x ? 2 : 1;

  auto load_kv = [&](int kt, int slot) {
    const int k0 = kt * kBK;
    float* ks = ring + slot * 2 * kBK * LD;
    float* vs = ks + kBK * LD;
    for (int e = tid; e < kBK * U; e += kThreads) {
      const int r = e / U, u = e % U;
      const bool ok = k0 + r < Tk;
      const size_t g = static_cast<size_t>(k0 + r) * D + u * 4;
      cp_async<16>(smem_addr(ks + r * LD + u * 4), ok ? kb + g : kb, ok);
      cp_async<16>(smem_addr(vs + r * LD + u * 4), ok ? vb + g : vb, ok);
    }
  };

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int q0 = (ti == 0 ? n_q - 1 - x : x) * kBQ;
    int n_k = n_kt;
    if (causal) {
      const int last = q0 + kBQ - 1 + off;   // highest live column here
      n_k = last < 0 ? 0 : min(n_k, last / kBK + 1);
    }
    for (int e = tid; e < kBQ * U; e += kThreads) {
      const int r = e / U, u = e % U;
      const bool ok = q0 + r < Tq;
      cp_async<16>(smem_addr(qs + r * LD + u * 4),
                   ok ? qb + static_cast<size_t>(q0 + r) * D + u * 4 : qb,
                   ok);
    }
    if (n_k > 0) load_kv(0, 0);
    cp_async_commit();

    float oacc[4][OC], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < OC; ++c) oacc[i][c] = 0.f;
    }
    const int wrow0 = q0 + rows0;   // the warp's first row

    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<0>();
      __syncthreads();   // tile kt landed; every warp is done with kt - 1
      if (kt + 1 < n_k) load_kv(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      const int k0 = kt * kBK + half * kHalf;   // the warp's first key
      const float* ks = ring + (kt & 1) * 2 * kBK * LD + half * kHalf * LD;
      const float* vs = ks + kBK * LD;
      // a half wholly in the causal future of the warp's rows is skipped
      if (__any_sync(0xffffffffu, !causal || k0 <= wrow0 + 15 + off)) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int u = 0; u < U; ++u) {
          float4 a[4], kk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                qs + (rows0 + rg + 4 * i) * LD + 4 * u);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kk[j] = *reinterpret_cast<const float4*>(
                ks + (cg + 8 * j) * LD + 4 * u);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
              s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
              s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
              s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
            }
        }
        const bool edge =
            k0 + kHalf > Tk || (causal && k0 + kHalf - 1 > wrow0 + off);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] *= scale;
            if (edge) {
              const int col = k0 + cg + 8 * j, row = wrow0 + rg + 4 * i;
              if (col >= Tk || (causal && col > row + off))
                s[i][j] = -INFINITY;
            }
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float m_new = fmaxf(m[i], mx);
          // all-masked rows keep m = -inf; exp(-inf - -inf) would be NaN
          const float safe = m_new == -INFINITY ? 0.f : m_new;
          const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = expf(s[i][j] - safe);
            sum += s[i][j];
          }
          l[i] = corr * l[i] + sum;
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < OC; ++c) oacc[i][c] *= corr;
        }
        // P key-major in the warp's buffer: a thread's 4 rows side by side
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(ps + (cg + 8 * j) * kPLd + 4 * rg) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncwarp();
#pragma unroll 8
        for (int c = 0; c < kHalf; ++c) {
          const float4 p = *reinterpret_cast<const float4*>(
              ps + c * kPLd + 4 * rg);
          const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            float vv[VW];
            const float* vp = vs + c * LD + t * 8 * VW + cg * VW;
            if constexpr (VW == 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(vp);
              vv[0] = w4.x, vv[1] = w4.y, vv[2] = w4.z, vv[3] = w4.w;
            } else if constexpr (VW == 2) {
              const float2 w2 = *reinterpret_cast<const float2*>(vp);
              vv[0] = w2.x, vv[1] = w2.y;
            } else {
              vv[0] = vp[0];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                oacc[i][t * VW + e] = fmaf(pr[i], vv[e], oacc[i][t * VW + e]);
          }
        }
        __syncwarp();   // P read before the next tile overwrites it
      }
    }

    // the row sums over the 8 lanes of a row; then half 1 hands its
    // partials (m, l, O) to half 0 through the drained ring
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    }
    cp_async_wait<0>();
    __syncthreads();
    float* part = ring;   // (4 OC + 8) x 128 floats, thread-interleaved
    const int t128 = tid & 127;
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < OC; ++c)
          part[(i * OC + c) * 128 + t128] = oacc[i][c];
        part[(4 * OC + i) * 128 + t128] = m[i];
        part[(4 * OC + 4 + i) * 128 + t128] = l[i];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m1 = part[(4 * OC + i) * 128 + t128];
        const float l1 = part[(4 * OC + 4 + i) * 128 + t128];
        const float mx = fmaxf(m[i], m1);
        const float safe = mx == -INFINITY ? 0.f : mx;
        const float c0 = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
        const float c1 = m1 == -INFINITY ? 0.f : expf(m1 - safe);
        const float ll = c0 * l[i] + c1 * l1;
        const float den = ll == 0.f ? 1.f : ll;
        const int row = wrow0 + rg + 4 * i;
        if (row >= Tq) continue;
        float* orow = o + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          float r[VW];
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const int c = t * VW + e;
            r[e] = (c0 * oacc[i][c] + c1 * part[(i * OC + c) * 128 + t128]) /
                   den;
          }
          float* op = orow + t * 8 * VW + cg * VW;
          if constexpr (VW == 4) {
            *reinterpret_cast<float4*>(op) =
                make_float4(r[0], r[1], r[2], r[3]);
          } else if constexpr (VW == 2) {
            *reinterpret_cast<float2*>(op) = make_float2(r[0], r[1]);
          } else {
            op[0] = r[0];
          }
        }
        if (cg == 0)
          lse[static_cast<size_t>(bh) * Tq + row] =
              mx == -INFINITY ? -INFINITY : mx + logf(den);
      }
    }
    __syncthreads();   // the Q tile and the ring are free for the next tile
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Tq, int Tk,
                   float scale, int causal, int smem, int pair,
                   cudaStream_t stream) {
  if (smem <= 0 || smem > mma::kMaxSmem) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_q = (Tq + kBQ - 1) / kBQ;
  const dim3 grid(pair ? (n_q + 1) / 2 : n_q, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Tq,
      Tk, scale, causal, pair);
  return cudaGetLastError();
}

}  // namespace f32

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
// D in {16, 32, 64, 128}; dtype 0 = f32 (SIMT kernel, with the bytes and
// the q-tile pairing flash_f32_plan() gives), 1 = bf16 (tensor cores,
// with the bytes flash_plan() gives; pair is ignored). q, k, v, o
// 16-byte aligned.
extern "C" int zt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int H, int Hkv, int Tq, int Tk,
                                      int D, float scale, int causal,
                                      int dtype, int smem, int pair,
                                      void* stream) {
  using namespace zt;
  if (Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_CASE(d)                                                          \
  if (D == d)                                                               \
    return dtype == kF32                                                    \
               ? f32::launch<d>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale,  \
                                causal, smem, pair, st)                     \
               : tc::launch<d>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale,   \
                               causal, smem, st);
  if (dtype == kF32 || dtype == kBF16) {
    ZT_FLASH_HEAD_DIMS(ZT_CASE)
  }
#undef ZT_CASE
  return cudaErrorInvalidValue;
}
