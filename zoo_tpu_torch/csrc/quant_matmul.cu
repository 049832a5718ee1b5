// Int8 GEMMs on the int8 tensor cores with a fused dequant epilogue:
// (M, K) activations x (K, N) int8 weights -> int32 -> f32(acc) *
// x_scale[row] * w_scale[col] in the output type (f32 or bf16).
//
// Replaces: zoo_tpu/ops/pallas/quant.py, _qmm_kernel (:42) launched by
// quantized_matmul (:61, pallas_call :93), and _fqmm_kernel (:122)
// launched by fused_quantized_matmul (:160, pallas_call :200).
//
// What bounds them on an H100, against the 1979 TOP/s int8 tensor cores:
// bytes. The weights are read once and do 2 M operations a byte (256 at
// M = 128), under the ~590 the card does a byte it reads: at the
// ResNet-50 head (M=128, K=2048, N=1000) 2 MB of weights against 0.52
// GOP, at VGG-16's fc6 (M=128, K=25088, N=4096; the two-pass path every
// Dense past K = 8192 takes) 103 MB against 26 GOP. The s32 sums
// (mma and wgmma without .satfinite, and the cluster's adds) are exact
// for any int8 data while K * 128 * 128 < 2^31, past that wherever the
// data keep them in range; beyond it they wrap, as the int32 sums of the
// JAX kernel do. No K is refused.
//
// Both kernels (namespace i8 holds what they share):
// - a thread-block cluster of `ctas` CTAs (at most 8) splits K for each
//   output tile, so a few output tiles still fill the SMs; the int32
//   tiles of the cluster's CTAs are added through distributed shared
//   memory (exact in any order), each CTA for its share of the rows,
//   and dequantized in dequant()'s order;
// - x and w chunks arrive by cp.async (16 bytes where rows and pointers
//   allow, else 8, 4 or element copies) into a ring of slots, a chunk's
//   ragged K and M edges filled with zeros by the copies' source size;
// - w is read (K, N) as it lies: neither the wrapper nor a weight copy
//   transposes it.
// The plans (tile, K split, K slice, copy widths; for the fused kernel
// also its ring slots and shared memory) are counted by qmm_plan() and
// fqmm_plan() in ops/kernels/quant.py and passed here; the two-pass
// kernel derives its ring slots and shared memory from its tile rows.
//
// - quantized_matmul (qm::qmm_kernel): x arrives quantized, with its
//   per-row scales, and is copied straight into the A tile wgmma reads
//   (K-major, 128-byte swizzle). 8-bit wgmma reads B K-major only, so
//   each 128 x 128 w chunk is turned K-major in shared memory (turn_w:
//   prmt 4 x 4 byte transposes), a chunk ahead, while the tensor cores
//   multiply the current one (wgmma m64n128k32 or m64n64k32, s8 x s8 ->
//   s32): one block barrier a chunk. Tiles of 128 rows (64 where M <=
//   64) x 128 columns, 128-deep chunks; at fc6 (M = 128) one row tile
//   covers M, so the weights stream from device memory once. The K
//   split is sized so every cluster of the grid is resident at once: an
//   H100 runs 39 clusters of 3 but only 30 of 4 (its GPCs' SM counts),
//   so fc6's 32 tiles take clusters of 3 (96 CTAs) and no second wave.
// - fused_quantized_matmul (fq::fqmm_kernel): x arrives as f32 or bf16
//   (bf16 widened to f32, as quant.py:136) and is quantized per row
//   inside the kernel, scale = amax == 0 ? 1 : amax / 127 with amax over
//   the full K and q = clamp(rint(x / scale), -127, 127), as IEEE
//   division rounds them (scale divided; the quotient as rint(x * (1 /
//   scale)) wherever that provably rounds alike, see near_tie; rint is
//   half-to-even, as jnp.round and torch.round are). No int8 copy of the
//   activations goes to device memory, which is the Pallas kernel's
//   point (quant.py:167-170). Tiles of 64 x 128, 64-deep chunks in a
//   5-slot ring filled while each CTA takes the absmax of the tile's
//   rows over its K slice from device memory; the cluster's CTAs
//   exchange those through distributed shared memory, so every CTA
//   quantizes its own slice with the same full-row scale (a max is
//   exact in any order), a chunk at a time into an int8 A tile that 8
//   warps multiply with mma.sync.m16n8k32 (s8 x s8 -> s32): A by
//   ldmatrix, B turned into k-contiguous registers by prmt (w_unit).
// One launch a call, no memset. The absmax's shuffles run where every
// lane arrives (loops with uniform trip counts, no branch around them):
// none takes the slow WARPSYNC.COLLECTIVE path.
#include <cooperative_groups.h>

#include "zt_gemm.cuh"
#include "zt_mma.cuh"

namespace cg = cooperative_groups;

namespace zt {

// The int8 tensor-core pieces of both kernels.
namespace i8 {

using namespace mma;

constexpr int kBN = 128, kThreads = 256;
constexpr int kMaxCtas = 8;     // the portable cluster size
constexpr int kCLd = kBN + 4;   // int32 row stride of the C tile (padded)

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

// w rows k0 .. k0+ROWS-1, columns n0 .. n0+kBN-1 (zero past K and N),
// row-major in the chunk with its 16-byte units placed by Place::at:
// VEC-byte cp.async copies, or (VEC == 0) byte copies
template <int VEC, int ROWS, typename Place>
__device__ __forceinline__ void load_w(int8_t* wsm,
                                       const int8_t* __restrict__ w, int K,
                                       int N, int n0, int k0) {
  if constexpr (VEC > 0) {
    constexpr int PER = kBN / VEC;
    static_assert(ROWS * PER % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < ROWS * PER / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / PER;
      const int byte = e % PER * VEC, kk = k0 + r, nn = n0 + byte;
      const bool ok = kk < K && nn < N;
      cp_async<VEC>(
          smem_addr(wsm + r * kBN + Place::at(r, byte >> 4) * 16 +
                    (byte & 15)),
          ok ? w + static_cast<size_t>(kk) * N + nn : w, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * kBN / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / kBN, byte = e % kBN;
      const int kk = k0 + r, nn = n0 + byte;
      wsm[r * kBN + Place::at(r, byte >> 4) * 16 + (byte & 15)] =
          kk < K && nn < N ? w[static_cast<size_t>(kk) * N + nn] : int8_t(0);
    }
  }
}

// This CTA's share of the tile's BM rows: the cluster's int32 C tiles
// added (exact), then f32(acc) * row_scale[r] * ws[n] (row_scale indexed
// by the tile's row), 4 columns a thread, stored as 16 or 8 bytes where
// N and y allow. The caller syncs the cluster before and after.
template <typename TOut>
__device__ __forceinline__ void reduce_dequant(
    int* cs, cg::cluster_group& cluster, int rank, int ctas, int bm,
    int m0, int n0, int M, int N, const float* row_scale,
    const float* __restrict__ ws, TOut* __restrict__ y) {
  const int rows = (bm + ctas - 1) / ctas;
  const bool vec = (N & 3) == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TOut)) == 0;
  for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
    const int r = rank * rows + e / (kBN / 4), c4 = e % (kBN / 4) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (r >= bm || m >= M || n >= N) continue;
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int src = 0; src < kMaxCtas; ++src) {
      if (src < ctas) {   // all the cluster's loads in flight at once
        const int4 p = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(cs, src) + r * kCLd + c4);
        sum[0] += p.x, sum[1] += p.y, sum[2] += p.z, sum[3] += p.w;
      }
    }
    const float xs = row_scale[r];
    TOut out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = from_f32<TOut>(
          n + i < N ? gemm::dequant(sum[i], xs, ws[n + i]) : 0.f);
    TOut* yp = y + static_cast<size_t>(m) * N + n;
    if (vec) {
      if constexpr (sizeof(TOut) == 4)
        *reinterpret_cast<float4*>(yp) =
            make_float4(out[0], out[1], out[2], out[3]);
      else
        *reinterpret_cast<uint2*>(yp) =
            make_uint2(pack_bf16(to_f32(out[0]), to_f32(out[1])),
                       pack_bf16(to_f32(out[2]), to_f32(out[3])));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N) yp[i] = out[i];
    }
  }
}

// Launch `kernel` on a grid of clusters of `ctas` CTAs along x.
template <typename Kernel, typename... A>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int ctas, int smem,
                           cudaStream_t stream, A... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// The launch plan a C entry was given, checked against the kernel:
// ctas 1 to 8, k_slice a multiple of the chunk depth bk covering K,
// each copy width 0 or one dividing its rows and pointer.
inline bool bad_plan(int K, int ctas, int k_slice, int bk, int smem) {
  return ctas < 1 || ctas > kMaxCtas ||
         k_slice <= 0 || k_slice % bk ||
         static_cast<long long>(ctas) * k_slice < K || smem <= 0 ||
         smem > kMaxSmem;
}
inline bool bad_vec(int vec, long long row_bytes, const void* p) {
  return vec != 0 && ((vec != 4 && vec != 8 && vec != 16) ||
                      row_bytes % vec ||
                      reinterpret_cast<uintptr_t>(p) % vec);
}

struct Args {
  int M, K, N;
  int ctas;      // CTAs of a cluster: the K split
  int k_slice;   // K a CTA takes, a multiple of the chunk depth
  int x_vec;     // bytes a copy of x (16, 8, 4; 0: element copies)
  int w_vec;     // bytes a copy of w (16, 8, 4; 0: byte copies)
};

}  // namespace i8

namespace qm {

using namespace i8;

constexpr int kBK = 128;          // K bytes of a chunk: 128-byte rows
constexpr int kWB = kBK * kBN;    // a w chunk, as it lies or turned

// ring slots of a bm-row tile, and its shared memory: the ring (per slot
// a bm x 128 x chunk and a w chunk as it lies), the two turned w chunks
// and 1 KB to align the ring, 193 KB at bm = 128 (32 KB a slot), 201 KB
// at 64 (qmm_smem() in ops/kernels/quant.py counts the same)
__host__ __device__ constexpr int stages(int bm) { return bm == 128 ? 5 : 7; }
constexpr int smem_bytes(int bm) {
  return 1024 + stages(bm) * (bm * kBK + kWB) + 2 * kWB;
}
static_assert(smem_bytes(64) <= kMaxSmem && smem_bytes(128) <= kMaxSmem,
              "the ring fits in shared memory");

// Unit u of row k of a w chunk as it lies (128 rows of 128 bytes): the
// 4-byte words turn_w's warps read then fall in 32 different banks
struct RawUnit {
  __device__ static int at(int k, int u) { return u ^ ((k >> 4) & 7); }
};

// x rows m0 .. m0+BM-1, columns k0 .. k0+kBK-1 (zero past M and K)
// straight into the A tile: K-major rows of 128 bytes, row r's 16-byte
// unit u at u ^ (r % 8), the 128-byte swizzle wgmma reads (the ring's
// slots start on 1024-byte boundaries). VEC-byte cp.async copies, or
// (VEC == 0) byte copies
template <int BM, int VEC>
__device__ __forceinline__ void load_x(unsigned char* xs,
                                       const int8_t* __restrict__ x,
                                       const Args& a, int m0, int k0) {
  if constexpr (VEC > 0) {
    constexpr int PER = kBK / VEC;
    static_assert(BM * PER % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < BM * PER / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / PER;
      const int byte = e % PER * VEC, kk = k0 + byte;
      const bool ok = m0 + r < a.M && kk < a.K;
      cp_async<VEC>(
          smem_addr(xs + r * kBK + swizzle<8>(r, byte >> 4) * 16 +
                    (byte & 15)),
          ok ? x + static_cast<size_t>(m0 + r) * a.K + kk : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * kBK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / kBK, byte = e % kBK;
      const int kk = k0 + byte;
      xs[r * kBK + swizzle<8>(r, byte >> 4) * 16 + (byte & 15)] =
          m0 + r < a.M && kk < a.K
              ? static_cast<unsigned char>(
                    x[static_cast<size_t>(m0 + r) * a.K + kk])
              : 0;
    }
  }
}

// A w chunk as it lies (k rows, RawUnit) turned K-major for wgmma: row n
// of bt holds the chunk's column n over its 128 k, unit j of the row at
// j ^ (n % 8) (the 128-byte swizzle). Thread (kg, ng) = (lane % 8, 4 warp
// + lane / 8) reads the 4 bytes at 4 ng of rows 16 kg .. +15 (32 banks a
// warp), turns them with transpose4 and writes 16 k-contiguous bytes of
// columns 4 ng .. +3 (4 wavefronts a warp, the least for 512 bytes).
__device__ __forceinline__ void turn_w(unsigned char* bt,
                                       const unsigned char* raw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane & 7, word = lane >> 3, ng = 4 * warp + word;
  uint32_t v[4][4], t[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * kg + 4 * q + i;
      v[q][i] = *reinterpret_cast<const uint32_t*>(
          raw + k * kBN + RawUnit::at(k, warp) * 16 + word * 4);
    }
    transpose4(v[q], t[q]);   // t[q][j]: column 4 ng + j, k 16 kg + 4 q ..
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * ng + j;
    *reinterpret_cast<uint4*>(bt + n * kBK + swizzle<8>(n, kg) * 16) =
        make_uint4(t[0][j], t[1][j], t[2][j], t[3][j]);
  }
}

// Two warpgroups: at bm = 128 each multiplies 64 rows by the tile's 128
// columns (wgmma m64n128k32), at bm = 64 the tile's 64 rows by 64 of the
// columns (m64n64k32); the int32 sums stay in registers.
template <typename TOut, int BM>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               TOut* __restrict__ y, Args a) {
  constexpr int S = stages(BM), XB = BM * kBK, SLOT = XB + kWB;
  constexpr int WN = BM == 128 ? kBN : kBN / 2;   // columns a warpgroup
  static_assert(BM * kCLd * 4 <= S * SLOT, "the C tile over the ring");
  extern __shared__ __align__(1024) unsigned char qm_smem_raw[];
  unsigned char* smem =
      qm_smem_raw + ((1024 - (smem_addr(qm_smem_raw) & 1023)) & 1023);
  unsigned char* bt = smem + S * SLOT;       // two turned w chunks
  int* cs = reinterpret_cast<int*>(smem);    // the C tile, at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int rank = blockIdx.x % a.ctas;   // = cluster.block_rank()
  const int n0 = blockIdx.x / a.ctas * kBN, m0 = blockIdx.y * BM;
  const int kb = rank * a.k_slice, n_chunks = a.k_slice / kBK;

  // slot: the x chunk (the A tile), then the w chunk as it lies
  auto load = [&](int c) {
    unsigned char* st = smem + c % S * SLOT;
    int8_t* wst = reinterpret_cast<int8_t*>(st + XB);
    const int k0 = kb + c * kBK;
    switch (a.x_vec) {
      case 16: load_x<BM, 16>(st, x, a, m0, k0); break;
      case 8: load_x<BM, 8>(st, x, a, m0, k0); break;
      case 4: load_x<BM, 4>(st, x, a, m0, k0); break;
      default: load_x<BM, 0>(st, x, a, m0, k0);
    }
    switch (a.w_vec) {
      case 16: load_w<16, kBK, RawUnit>(wst, w, a.K, a.N, n0, k0); break;
      case 8: load_w<8, kBK, RawUnit>(wst, w, a.K, a.N, n0, k0); break;
      case 4: load_w<4, kBK, RawUnit>(wst, w, a.K, a.N, n0, k0); break;
      default: load_w<0, kBK, RawUnit>(wst, w, a.K, a.N, n0, k0);
    }
  };
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();   // chunk 0 landed
  turn_w(bt, smem + XB);

  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<S - 3>();   // chunk c + 1 landed (this thread's copies)
    fence_proxy_async();      // ... they and chunk c turned, for wgmma
    __syncthreads();          // everyone's; the products of c - 1 retired
    if (c + S - 1 < n_chunks) load(c + S - 1);
    cp_async_commit();
    const uint32_t a_base =
        smem_addr(smem + c % S * SLOT) + (BM == 128 ? wg * 64 * kBK : 0);
    const uint32_t b_base =
        smem_addr(bt + (c & 1) * kWB) + (BM == 128 ? 0 : wg * 64 * kBK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8<WN>(acc, desc(a_base + 32 * kk, 0, 1024),
                   desc(b_base + 32 * kk, 0, 1024));
    wgmma_commit();
    // the next chunk turned while the tensor cores multiply this one
    if (c + 1 < n_chunks)
      turn_w(bt + ((c + 1) & 1) * kWB, smem + (c + 1) % S * SLOT + XB);
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: the C tile goes over it

  // wgmma's fragment: warp w % 4 of a warpgroup holds rows 16 (w % 4) +
  // lane / 4 and + 8 of its 64; for each 8 columns j, columns 8 j + 2
  // (lane % 4) and + 1
  const int r = (BM == 128 ? wg * 64 : 0) + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = (BM == 128 ? 0 : wg * 64) + 8 * j + 2 * (lane & 3);
    *reinterpret_cast<int2*>(cs + r * kCLd + col) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(cs + (r + 8) * kCLd + col) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  cluster.sync();
  reduce_dequant<TOut>(cs, cluster, rank, a.ctas, BM, m0, n0, a.M, a.N,
                       xs + m0, ws, y);
  cluster.sync();   // no CTA leaves while another reads its C tile
}

template <typename TOut, int BM>
cudaError_t launch(const void* x, const void* w, const void* xs,
                   const void* ws, void* y, const Args& a,
                   cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN * a.ctas, (a.M + BM - 1) / BM, 1);
  return launch_cluster(
      qmm_kernel<TOut, BM>, grid, a.ctas, smem_bytes(BM), stream,
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<TOut*>(y), a);
}

template <int BM>
cudaError_t launch_out(const void* x, const void* w, const void* xs,
                       const void* ws, void* y, int out_dtype, const Args& a,
                       cudaStream_t s) {
  if (out_dtype == kF32) return launch<float, BM>(x, w, xs, ws, y, a, s);
  if (out_dtype == kBF16)
    return launch<__nv_bfloat16, BM>(x, w, xs, ws, y, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace qm

namespace fq {

using namespace i8;

constexpr int kBM = 64, kBK = 64, kStages = 5;

// Physical 16-byte unit of unit u in row k of a w chunk (128-byte rows):
// the 4-byte words a warp reads for its B registers (rows 4t + i, bytes
// 4g of a 32-byte column block) then fall in 32 different banks.
__device__ __forceinline__ int w_unit(int k, int u) {
  return u ^ (((k >> 2) & 3) << 1);
}

// w_unit as load_w places units
struct WUnit {
  __device__ static int at(int k, int u) { return w_unit(k, u); }
};


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
      case 16: load_w<16, kBK, WUnit>(wst, w, a.K, a.N, n0, k0); break;
      case 8: load_w<8, kBK, WUnit>(wst, w, a.K, a.N, n0, k0); break;
      case 4: load_w<4, kBK, WUnit>(wst, w, a.K, a.N, n0, k0); break;
      default: load_w<0, kBK, WUnit>(wst, w, a.K, a.N, n0, k0);
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

  // 3. this CTA's share of the rows, with the rows' scales
  reduce_dequant<TOut>(cs, cluster, rank, a.ctas, kBM, m0, n0, a.M, a.N,
                       scale, ws, y);
  cluster.sync();   // no CTA leaves while another reads its C tile
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, const void* ws, void* y,
                   const Args& a, int smem, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN * a.ctas, (a.M + kBM - 1) / kBM, 1);
  return launch_cluster(fqmm_kernel<TIn, TOut>, grid, a.ctas, smem, stream,
                        static_cast<const TIn*>(x),
                        static_cast<const int8_t*>(w),
                        static_cast<const float*>(ws), static_cast<TOut*>(y),
                        a);
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
// of out_dtype (0 = f32, 1 = bf16); all contiguous. The plan of
// qmm_plan(): bm (64 or 128) rows a tile; ctas (1 to 8) CTAs of a
// cluster split K into k_slice-deep slices (a multiple of 128, ctas *
// k_slice >= K); x_vec and w_vec the copy widths (16, 8, 4 bytes, or 0),
// which must divide the rows and the pointers. The ring slots and the
// shared memory follow from bm (qm::smem_bytes).
extern "C" int zt_quantized_matmul(const void* x, const void* w,
                                   const void* xs, const void* ws, void* y,
                                   int out_dtype, int M, int K, int N, int bm,
                                   int ctas, int k_slice, int x_vec,
                                   int w_vec, void* stream) {
  using namespace zt;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  if ((bm != 64 && bm != 128) ||
      i8::bad_plan(K, ctas, k_slice, qm::kBK, qm::smem_bytes(bm)) ||
      i8::bad_vec(x_vec, K, x) || i8::bad_vec(w_vec, N, w))
    return cudaErrorInvalidValue;
  const i8::Args a{M, K, N, ctas, k_slice, x_vec, w_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128) return qm::launch_out<128>(x, w, xs, ws, y, out_dtype, a, s);
  return qm::launch_out<64>(x, w, xs, ws, y, out_dtype, a, s);
}

// How many clusters of `ctas` CTAs of the bm-row kernel the card runs at
// once (cudaOccupancy...; a negative cudaError_t where the query fails).
extern "C" int zt_quantized_matmul_clusters(int bm, int ctas) {
  using namespace zt;
  const int smem = qm::smem_bytes(bm == 128 ? 128 : 64);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(i8::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = bm == 128 ? qm::qmm_kernel<__nv_bfloat16, 128>
                          : qm::qmm_kernel<__nv_bfloat16, 64>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
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
  if (item == 0 || stages != fq::kStages ||
      i8::bad_plan(K, ctas, k_slice, fq::kBK, smem) ||
      i8::bad_vec(x_vec, static_cast<long long>(K) * item, x) ||
      i8::bad_vec(w_vec, N, w))
    return cudaErrorInvalidValue;
  const i8::Args a{M, K, N, ctas, k_slice, x_vec, w_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return fq::launch_out<float>(x, w, ws, y, out_dtype, a, smem, s);
  return fq::launch_out<__nv_bfloat16>(x, w, ws, y, out_dtype, a, smem, s);
}
