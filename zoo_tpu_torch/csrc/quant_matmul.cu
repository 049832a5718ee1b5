// Int8 GEMMs with a fused dequant epilogue: (M, K) int8 activations x
// (K, N) int8 weights -> int32 -> f32(acc) * x_scale[row] * w_scale[col]
// in the output type (f32 or bf16).
//
// Replaces: zoo_tpu/ops/pallas/quant.py, _qmm_kernel (:42) launched by
// quantized_matmul (:61, pallas_call :93), and _fqmm_kernel (:122)
// launched by fused_quantized_matmul (:160, pallas_call :200).
//
// What bounds them on an H100, against the 1979 TOPS int8 tensor cores:
// bytes, at the ResNet-50 head (M=128, K=2048, N=1000: 2 MB of int8
// weights against 0.52 GOP) and at M=512, K=N=1024 (3.5 MB against 1.07
// GOP) alike. int32 sums are exact while K * 127 * 127 < 2^31.
//
// - quantized_matmul (qmm_kernel): the activations arrive quantized,
//   with their per-row scales. It multiplies on the SIMT units with
//   __dp4a (4 int8 products into an int32 an instruction) from 64 x 64
//   tiles staged in shared memory.
// - fused_quantized_matmul (fq::fqmm_kernel): the activations arrive as
//   f32 or bf16 (bf16 widened to f32, as quant.py:136), are quantized
//   per row inside the kernel, scale = amax == 0 ? 1 : amax / 127 with
//   amax over the full K and q = clamp(rint(x / scale), -127, 127), as
//   IEEE division rounds them (scale divided; the quotient as
//   rint(x * (1 / scale)) wherever that provably rounds alike, see
//   near_tie; rint is half-to-even, as jnp.round and torch.round are),
//   and multiplied on the int8 tensor cores. No int8 copy of the
//   activations goes to device memory, which is the Pallas kernel's
//   point (quant.py:167-170); one launch a call, no memset. The design:
//   - a thread-block cluster of `ctas` CTAs (at most 8) splits K for each
//     64 x 128 output tile, so the head's 16 tiles fill 128 SMs;
//   - each CTA takes the absmax of the tile's rows over its K slice from
//     device memory, and the cluster's CTAs exchange them through
//     distributed shared memory: every CTA quantizes its own slice with
//     the same full-row scale (a max is exact in any order);
//   - x and w chunks (64 deep) arrive by cp.async (16 bytes where rows
//     and pointers allow) into a 5-slot ring, filled while the absmax
//     runs (the head's whole 256-deep slice is in flight before it
//     starts); a chunk of x is quantized into a swizzled int8 tile
//     that ldmatrix reads as the A operand of mma.sync.m16n8k32
//     (s8 x s8 -> s32); the w chunk stays (k, n) row-major, its 16-byte
//     units swizzled by row, and each lane turns four 4-byte rows into
//     the k-contiguous B registers of four n-tiles with prmt (a 4 x 4
//     byte transpose), so neither the wrapper nor a weight copy
//     transposes w;
//   - the int32 tiles of the cluster's CTAs are added through
//     distributed shared memory (exact in any order), each CTA for its
//     share of the rows, and dequantized in dequant()'s order.
//   The plan (K split, K slice, ring slots, copy widths, shared memory)
//   is counted by fqmm_plan() in ops/kernels/quant.py and passed here.
// The absmax's shuffles run where every lane arrives (loops with uniform
// trip counts, no branch around them): none takes the slow
// WARPSYNC.COLLECTIVE path.
#include <cooperative_groups.h>

#include "zt_gemm.cuh"
#include "zt_mma.cuh"

namespace cg = cooperative_groups;

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

namespace fq {

using namespace mma;

constexpr int kBM = 64, kBN = 128, kBK = 64, kThreads = 256, kStages = 5;
constexpr int kMaxCtas = 8;     // the portable cluster size
constexpr int kCLd = kBN + 4;   // int32 row stride of the C tile (padded)

struct Args {
  int M, K, N;
  int ctas;      // CTAs of a cluster: the K split
  int k_slice;   // K a CTA takes, a multiple of kBK
  int x_vec;     // bytes a copy of x (16, 8, 4; 0: element copies)
  int w_vec;     // bytes a copy of w (16, 8, 4; 0: byte copies)
};

// Physical 16-byte unit of unit u in row k of a w chunk (128-byte rows):
// the 4-byte words a warp reads for its B registers (rows 4t + i, bytes
// 4g of a 32-byte column block) then fall in 32 different banks.
__device__ __forceinline__ int w_unit(int k, int u) {
  return u ^ (((k >> 2) & 3) << 1);
}

// out[j] = byte j of w[0], w[1], w[2], w[3] (w[0]'s lowest): four rows of
// 4 bytes turned into four columns of 4 k-contiguous bytes
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// x rows m0 .. m0+kBM-1, columns k0 .. k0+kBK-1 (zero past M and K),
// row-major in the chunk: VEC-byte cp.async copies, or (VEC == 0)
// element copies
template <typename TIn, int VEC>
__device__ __forceinline__ void load_x(unsigned char* xs,
                                       const TIn* __restrict__ x,
                                       const Args& a, int m0, int k0) {
  constexpr int RB = kBK * sizeof(TIn);
  if constexpr (VEC > 0) {
    constexpr int PER = RB / VEC, VE = VEC / sizeof(TIn);
    static_assert(kBM * PER % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < kBM * PER / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / PER, c = e % PER;
      const int kk = k0 + c * VE;
      const bool ok = m0 + r < a.M && kk < a.K;
      cp_async<VEC>(smem_addr(xs + r * RB + c * VEC),
                    ok ? x + static_cast<size_t>(m0 + r) * a.K + kk : x,
                    ok);
    }
  } else {
    TIn* xe = reinterpret_cast<TIn*>(xs);
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / kBK;
      const int kk = k0 + e % kBK;
      xe[e] = m0 + r < a.M && kk < a.K
                  ? x[static_cast<size_t>(m0 + r) * a.K + kk]
                  : from_f32<TIn>(0.f);
    }
  }
}

// w rows k0 .. k0+kBK-1, columns n0 .. n0+kBN-1 (zero past K and N),
// row-major in the chunk with its 16-byte units placed by w_unit:
// VEC-byte cp.async copies, or (VEC == 0) byte copies
template <int VEC>
__device__ __forceinline__ void load_w(int8_t* wsm,
                                       const int8_t* __restrict__ w,
                                       const Args& a, int n0, int k0) {
  if constexpr (VEC > 0) {
    constexpr int PER = kBN / VEC;
    static_assert(kBK * PER % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < kBK * PER / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / PER;
      const int byte = e % PER * VEC, kk = k0 + r, nn = n0 + byte;
      const bool ok = kk < a.K && nn < a.N;
      cp_async<VEC>(
          smem_addr(wsm + r * kBN + w_unit(r, byte >> 4) * 16 + (byte & 15)),
          ok ? w + static_cast<size_t>(kk) * a.N + nn : w, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / kBN, byte = e % kBN;
      const int kk = k0 + r, nn = n0 + byte;
      wsm[r * kBN + w_unit(r, byte >> 4) * 16 + (byte & 15)] =
          kk < a.K && nn < a.N ? w[static_cast<size_t>(kk) * a.N + nn]
                               : int8_t(0);
    }
  }
}

// four neighbouring elements of x from shared memory, widened to f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// rint(v / s) as IEEE division then rint round it, for |v / s| <= 127.5:
// t = v * (1 / s) (rs, correctly rounded) is within 2.3e-5 of the rounded
// quotient there, so rint(t) is the same unless t lies within 1e-4 of a
// tie; near_tie() says when (and when t is not finite, s subnormal), and
// those take the division
__device__ __forceinline__ bool near_tie(float t) {
  return !(fabsf(t - rintf(t)) < 0.4999f);
}

// the largest |value| of 16 bytes of x, widened to f32 (exact)
__device__ __forceinline__ float max_abs16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float max_abs16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    mx = fmaxf(mx, fmaxf(fabsf(__uint_as_float(u[i] << 16)),
                         fabsf(__uint_as_float(u[i] & 0xffff0000u))));
  return mx;
}

// The absmax of the tile's rows over columns kb .. ke-1, from device
// memory: warp wp takes rows 8 wp .. 8 wp + 7, its lanes neighbouring
// loads of VE elements (16 bytes, or one element). Every lane runs the
// same number of iterations.
template <typename TIn, int VE>
__device__ void slice_absmax(const TIn* __restrict__ x, const Args& a,
                             int m0, int kb, int ke, float (&amax)[8]) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int n_it = (ke - kb + 32 * VE - 1) / (32 * VE);
  for (int it = 0; it < n_it; ++it) {
    const int kk = kb + (it * 32 + lane) * VE;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + 8 * wp + i;
      if (m < a.M && kk < ke) {
        const TIn* p = x + static_cast<size_t>(m) * a.K + kk;
        if constexpr (VE == 1)
          amax[i] = fmaxf(amax[i], fabsf(to_f32(*p)));
        else
          amax[i] = fmaxf(amax[i], max_abs16(p));
      }
    }
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    fqmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ ws, TOut* __restrict__ y,
                Args a) {
  constexpr int XB = kBM * kBK * sizeof(TIn), WB = kBK * kBN;
  constexpr int CB = kBM * kCLd * 4;
  constexpr int RING = kStages * (XB + WB) > CB ? kStages * (XB + WB) : CB;
  extern __shared__ __align__(128) unsigned char fq_smem[];
  unsigned char* ring = fq_smem;                 // per slot: x, w chunks
  int* cs = reinterpret_cast<int*>(fq_smem);     // the C tile, at the end
  unsigned char* as = fq_smem + RING;            // the quantized x chunk
  float* part = reinterpret_cast<float*>(as + kBM * kBK);  // slice absmax
  float* scale = part + kBM;                     // the rows' scales
  float* rscale = scale + kBM;                   // ... and 1 / scale

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % a.ctas;   // = cluster.block_rank()
  const int n0 = blockIdx.x / a.ctas * kBN, m0 = blockIdx.y * kBM;
  const int kb = rank * a.k_slice, ke = min(a.K, kb + a.k_slice);
  const int n_chunks = a.k_slice / kBK;

  auto load = [&](int c) {
    unsigned char* st = ring + c % kStages * (XB + WB);
    int8_t* wst = reinterpret_cast<int8_t*>(st + XB);
    const int k0 = kb + c * kBK;
    switch (a.x_vec) {
      case 16: load_x<TIn, 16>(st, x, a, m0, k0); break;
      case 8: load_x<TIn, 8>(st, x, a, m0, k0); break;
      case 4: load_x<TIn, 4>(st, x, a, m0, k0); break;
      default: load_x<TIn, 0>(st, x, a, m0, k0);
    }
    switch (a.w_vec) {
      case 16: load_w<16>(wst, w, a, n0, k0); break;
      case 8: load_w<8>(wst, w, a, n0, k0); break;
      case 4: load_w<4>(wst, w, a, n0, k0); break;
      default: load_w<0>(wst, w, a, n0, k0);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }

  // 1. the rows' absmax over the full K: this CTA's slice while the ring
  // fills, then the cluster's slices through distributed shared memory
  float amax[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) amax[i] = 0.f;
  if (a.x_vec == 16)
    slice_absmax<TIn, 16 / sizeof(TIn)>(x, a, m0, kb, ke, amax);
  else
    slice_absmax<TIn, 1>(x, a, m0, kb, ke, amax);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = warp_max(amax[i]);
    if (lane == 0) part[8 * warp + i] = v;
  }
  cluster.sync();
  if (tid < kBM) {
    float mx = 0.f;
    for (int r = 0; r < a.ctas; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(part, r)[tid]);
    const float sc = mx == 0.f ? 1.f : __fdiv_rn(mx, 127.f);
    scale[tid] = sc;
    rscale[tid] = __frcp_rn(sc);
  }

  // 2. the slice's product, a chunk at a time: warp (wm, wn) takes rows
  // 32 wm .. +31 and columns 32 wn .. +31 of the tile; lane (g, t) holds
  // n-tile j's column g as the tile's column 32 wn + 4 g + j
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed (and the scales); chunk c-1 done
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
    cp_async_commit();
    const unsigned char* st = ring + c % kStages * (XB + WB);
    // x chunk -> int8: a thread takes 4 words of 4 neighbouring k, all
    // 16 rounded by the product first (no branch between them), then
    // near ties by the division
    constexpr int kWords = kBM * kBK / 4 / kThreads;
    float v[kWords][4], q[kWords][4];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int e = tid + j * kThreads, r = e >> 4;
      load4(reinterpret_cast<const TIn*>(st) + r * kBK + 4 * (e & 15), v[j]);
      const float rs = rscale[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = v[j][i] * rs;
        q[j][i] = rintf(t);
        slow |= near_tie(t);
      }
    }
    if (slow) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int r = (tid + j * kThreads) >> 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (near_tie(v[j][i] * rscale[r]))
            q[j][i] = rintf(__fdiv_rn(v[j][i], scale[r]));
      }
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int e = tid + j * kThreads, r = e >> 4, k4 = e & 15;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = fminf(fmaxf(q[j][i], -127.f), 127.f);
        word |= (static_cast<uint32_t>(__float2int_rn(qv)) & 0xffu)
                << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(as + r * kBK +
                                   swizzle<4>(r, k4 >> 2) * 16 +
                                   (k4 & 3) * 4) = word;
    }
    __syncthreads();
    const int8_t* wsm = reinterpret_cast<const int8_t*>(st + XB);
    const int byte = wn * 32 + 4 * g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane & 15);
        const int u = kk / 16 + (lane >> 4);
        ldmatrix_x4(af[mt], smem_addr(as + r * kBK + swizzle<4>(r, u) * 16));
      }
      uint32_t lo[4], hi[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = kk + 4 * t + i, r1 = r0 + 16;
        lo[i] = *reinterpret_cast<const uint32_t*>(
            wsm + r0 * kBN + w_unit(r0, byte >> 4) * 16 + (byte & 15));
        hi[i] = *reinterpret_cast<const uint32_t*>(
            wsm + r1 * kBN + w_unit(r1, byte >> 4) * 16 + (byte & 15));
      }
      transpose4(lo, b0);
      transpose4(hi, b1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af[mt], b0[j], b1[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: the C tile goes over it

  // lane (g, t) of n-tiles 0..3 holds the tile's columns 32 wn + 8t .. +7
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int* row = cs + (wm * 32 + mt * 16 + g + 8 * h) * kCLd + wn * 32 + 8 * t;
      *reinterpret_cast<int4*>(row) =
          make_int4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                    acc[mt][3][2 * h]);
      *reinterpret_cast<int4*>(row + 4) =
          make_int4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                    acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
    }
  cluster.sync();

  // 3. this CTA's share of the rows: the cluster's int32 tiles added
  // (exact), then f32(acc) * x scale * w scale, 4 columns a thread
  const int rows = kBM / a.ctas;
  const bool vec = (a.N & 3) == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TOut)) == 0;
  for (int e = tid; e < rows * (kBN / 4); e += kThreads) {
    const int r = rank * rows + e / (kBN / 4), c4 = e % (kBN / 4) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (m >= a.M || n >= a.N) continue;
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int src = 0; src < kMaxCtas; ++src) {
      if (src < a.ctas) {   // all the cluster's loads in flight at once
        const int4 p = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(cs, src) + r * kCLd + c4);
        sum[0] += p.x, sum[1] += p.y, sum[2] += p.z, sum[3] += p.w;
      }
    }
    const float xs = scale[r];
    TOut out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = from_f32<TOut>(
          n + i < a.N ? gemm::dequant(sum[i], xs, ws[n + i]) : 0.f);
    TOut* yp = y + static_cast<size_t>(m) * a.N + n;
    if (vec) {
      if constexpr (sizeof(TOut) == 4)
        *reinterpret_cast<float4*>(yp) =
            make_float4(out[0], out[1], out[2], out[3]);
      else
        *reinterpret_cast<uint2*>(yp) =
            make_uint2(mma::pack_bf16(to_f32(out[0]), to_f32(out[1])),
                       mma::pack_bf16(to_f32(out[2]), to_f32(out[3])));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < a.N) yp[i] = out[i];
    }
  }
  cluster.sync();   // no CTA leaves while another reads its C tile
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, const void* ws, void* y,
                   const Args& a, int smem, cudaStream_t stream) {
  auto kernel = fqmm_kernel<TIn, TOut>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN * a.ctas, (a.M + kBM - 1) / kBM, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TIn*>(x),
                          static_cast<const int8_t*>(w),
                          static_cast<const float*>(ws),
                          static_cast<TOut*>(y), a);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_out(const void* x, const void* w, const void* ws, void* y,
                       int out_dtype, const Args& a, int smem,
                       cudaStream_t s) {
  if (out_dtype == kF32) return launch<TIn, float>(x, w, ws, y, a, smem, s);
  if (out_dtype == kBF16)
    return launch<TIn, __nv_bfloat16>(x, w, ws, y, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace fq

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
// y (M, N) of out_dtype; all contiguous. The plan of fqmm_plan(): ctas
// (1, 2, 4 or 8) CTAs of a cluster split K into k_slice-deep slices
// (a multiple of 64, ctas * k_slice >= K); stages must be the compiled
// ring's; x_vec and w_vec the copy widths (16, 8, 4 bytes, or 0), which
// must divide the rows and the pointers; smem the bytes of shared memory.
extern "C" int zt_fused_quantized_matmul(const void* x, int in_dtype,
                                         const void* w, const void* ws,
                                         void* y, int out_dtype, int M, int K,
                                         int N, int ctas, int k_slice,
                                         int stages, int x_vec, int w_vec,
                                         int smem, void* stream) {
  using namespace zt;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const int item = in_dtype == kF32 ? 4 : in_dtype == kBF16 ? 2 : 0;
  if (item == 0 || stages != fq::kStages || smem <= 0 ||
      smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  if (ctas < 1 || ctas > fq::kMaxCtas || (ctas & (ctas - 1)) ||
      k_slice <= 0 || k_slice % fq::kBK ||
      static_cast<long long>(ctas) * k_slice < K)
    return cudaErrorInvalidValue;
  auto bad_vec = [](int vec, long long row_bytes, const void* p) {
    return vec != 0 && ((vec != 4 && vec != 8 && vec != 16) ||
                        row_bytes % vec ||
                        reinterpret_cast<uintptr_t>(p) % vec);
  };
  if (bad_vec(x_vec, static_cast<long long>(K) * item, x) ||
      bad_vec(w_vec, N, w))
    return cudaErrorInvalidValue;
  const fq::Args a{M, K, N, ctas, k_slice, x_vec, w_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return fq::launch_out<float>(x, w, ws, y, out_dtype, a, smem, s);
  return fq::launch_out<__nv_bfloat16>(x, w, ws, y, out_dtype, a, smem, s);
}
