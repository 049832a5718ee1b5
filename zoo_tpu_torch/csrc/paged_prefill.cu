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
// one sequence, 32 query heads over 8 kv heads, D=128, f32) each K/V
// element loaded serves C x G = 256 query rows, about 1000 flops per
// element read, so the least time is set by the f32 rate (67 TFLOP/s,
// the published H100 SXM peak at 700 W) rather than by the bytes. The
// serving path runs f32, and the tensor cores would mean TF32, which
// breaks the f32 tolerance and greedy token identity; so this body stays
// on f32 FMAs (bf16 q and caches are widened to f32) and works on
// parallelism and reuse instead:
// - Tiles. A block of 256 threads takes kRows = 64 query rows of one
//   (sequence, kv head): chunk positions x the G query heads that share
//   the kv head, as the Pallas kernel shares them. It walks the keys in
//   tiles of kKeys = 32 cache rows, gathered through the block table.
// - An asynchronous ring of two K/V tiles in shared memory, filled by
//   cp.async (16-byte copies where a row allows; f32, bf16 and int8 rows
//   are copied raw): the next tile is in flight while this one is used.
//   Int8 rows are widened with their row scale as they are read, one f32
//   multiply, as the plain version widens them; keys past a tile's
//   highest position are zero-filled, not read.
// - Register micro-tiles. Thread (ty, tx) of 16 x 16 owns rows 4 ty ..
//   4 ty + 3: for S = Q K^T keys tx and tx + 16 (4 x 2 scores from
//   float4 reads of a padded, conflict-free layout), for O += P V columns
//   4 tx .. 4 tx + 3 of each 64-column half (4 x 8 sums). p goes through
//   a small shared tile; no per-key shuffle and no 128-deep serial chain
//   per score.
// - Online softmax. A row's max and sum are reduced across the 16 lanes
//   that share it (a half-warp); the masking is per row position, and a
//   block stops at the last key tile its highest position reaches.
// - Occupancy. A block runs its key tiles one after another, and with
//   few warps an SM its time is latency, not issue: the time per call
//   follows the key tiles per block. Rows alone give S x n_kv x
//   ceil(C G / 64) blocks (32 at the serving shape); prefill_plan()
//   (ops/kernels/paged_prefill.py) splits the key axis until the grid
//   gives each of the 132 SMs two blocks (at most 8 splits; two blocks,
//   16 warps, share an SM at D = 128 f32). A block of split sp takes its
//   share of the key tiles its rows reach, writes an unnormalised
//   partial and its (m, l), and a second kernel merges the splits by
//   their lse in split order, so the result is deterministic. With one
//   split the first kernel writes the output.
#include "zt_common.cuh"
#include "zt_mma.cuh"

namespace zt {
namespace prefill {

constexpr int kRows = 64;          // query rows of a block
constexpr int kKeys = 32;          // keys of a tile
constexpr int kThreads = 256;      // 16 row groups x 16 lanes
constexpr int kStages = 2;         // K/V tiles in the ring
constexpr int kMaxD = 128;
constexpr int kChunks = kMaxD / 64;   // 64-column halves of a row
constexpr int kPStride = kKeys + 4;

// Shared memory (bytes), as prefill_plan() counts it:
//   q: kRows rows of D + 4 floats; p: kRows rows of kKeys + 4 floats;
//   the ring: kStages x (a K tile, a V tile) of kKeys rows of
//   D * sizeof(TC) + 16 bytes; int8: kStages x 2 x kKeys f32 scales.
template <typename TC>
__host__ __device__ constexpr int row_bytes(int D) {
  return D * static_cast<int>(sizeof(TC)) + 16;
}

template <typename TC>
__host__ __device__ constexpr int smem_bytes(int D) {
  return 4 * kRows * (D + 4) + 4 * kRows * kPStride +
         kStages * 2 * kKeys * row_bytes<TC>(D) +
         (sizeof(TC) == 1 ? kStages * 2 * kKeys * 4 : 0);
}

// four neighbouring cache elements of a row in shared memory, widened
// (int8 times the row's scale)
__device__ __forceinline__ float4 load4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, float) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ float4 load4(const int8_t* p, float s) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
                     static_cast<float>(c.z) * s, static_cast<float>(c.w) * s);
}

__device__ __forceinline__ void copy_async(uint32_t dst, const void* src,
                                           bool ok, int bytes) {
  if (bytes == 16) {
    mma::cp_async<16>(dst, src, ok);
  } else if (bytes == 8) {
    mma::cp_async<8>(dst, src, ok);
  } else {
    mma::cp_async<4>(dst, src, ok);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int S, C, n_kv, G, D, bs, W, row_tiles, splits;
  float scale;
};

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads, 2)
    paged_prefill_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc,
                         const float* __restrict__ ksc,
                         const float* __restrict__ vsc,
                         const int* __restrict__ bt,
                         const int* __restrict__ pos, TQ* __restrict__ out,
                         float* __restrict__ part_o,
                         float* __restrict__ part_ml, Args a) {
  extern __shared__ __align__(16) unsigned char prefill_smem[];
  constexpr bool kInt8 = sizeof(TC) == 1;
  const int D = a.D;
  float* qs = reinterpret_cast<float*>(prefill_smem);        // kRows x (D+4)
  float* ps = qs + kRows * (D + 4);                          // kRows x kPStride
  unsigned char* ring = reinterpret_cast<unsigned char*>(ps + kRows * kPStride);
  const int rb = row_bytes<TC>(D);
  const int tile_bytes = kKeys * rb;
  float* scales = reinterpret_cast<float*>(ring + kStages * 2 * tile_bytes);
  __shared__ int pmax_s;

  const int rt = blockIdx.x % a.row_tiles;
  const int sh = blockIdx.x / a.row_tiles;
  const int h = sh % a.n_kv, s = sh / a.n_kv;
  const int sp = blockIdx.y;
  const int H = a.n_kv * a.G;
  const int rows = a.C * a.G;
  const int r0 = rt * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  if (tid == 0) pmax_s = 0;
  // the tile's rows in f32, 4 elements a copy: row r is chunk position
  // r / G, head h G + r % G; rows past the chunk read as zero. f32 rows
  // are copied asynchronously (waited for with the first K/V tile), bf16
  // ones loaded 8 bytes at a time and widened.
  const int q_per_row = D / 4;
  for (int i = tid; i < kRows * q_per_row; i += kThreads) {
    const int rr = i / q_per_row, d = (i - rr * q_per_row) * 4;
    const int r = r0 + rr;
    const bool ok = r < rows;
    const int ci = ok ? r / a.G : 0, g = ok ? r - ci * a.G : 0;
    const TQ* src =
        q + ((static_cast<size_t>(s) * a.C + ci) * H + h * a.G + g) * D + d;
    float* dst = qs + rr * (D + 4) + d;
    if constexpr (sizeof(TQ) == 4) {
      mma::cp_async<16>(mma::smem_addr(dst), src, ok);
    } else {
      *reinterpret_cast<float4*>(dst) =
          ok ? load4(src, 1.f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  int rpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    rpos[i] = r < rows ? pos[s * a.C + r / a.G] : -1;
  }
  __syncthreads();   // pmax_s initialised
  atomicMax(&pmax_s, max(max(rpos[0], rpos[1]), max(rpos[2], rpos[3])));
  __syncthreads();
  const int pmax = min(pmax_s, a.W * a.bs - 1);

  // this split's share of the key tiles the rows reach
  const int n_tiles = pmax / kKeys + 1;
  const int t_begin = sp * n_tiles / a.splits;
  const int t_end = (sp + 1) * n_tiles / a.splits;

  const int data_bytes = D * static_cast<int>(sizeof(TC));
  const int cb = data_bytes % 16 == 0 ? 16 : data_bytes % 8 == 0 ? 8 : 4;
  const int per_row = data_bytes / cb;
  const uint32_t ring_addr = mma::smem_addr(ring);
  const uint32_t scale_addr = mma::smem_addr(scales);

  // issue the copies of key tile t into ring slot `slot`
  auto load = [&](int t, int slot) {
    const int k0 = t * kKeys;
    for (int e = tid; e < 2 * kKeys * per_row; e += kThreads) {
      const int which = e / (kKeys * per_row);
      const int rem = e - which * kKeys * per_row;
      const int key = rem / per_row, ch = rem - key * per_row;
      const int k = k0 + key;
      const bool ok = k <= pmax;
      const int blk = ok ? bt[s * a.W + k / a.bs] : 0;
      const size_t row =
          (static_cast<size_t>(blk) * a.bs + k % a.bs) * a.n_kv + h;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(which ? vc : kc) +
          row * data_bytes + ch * cb;
      copy_async(ring_addr + (slot * 2 + which) * tile_bytes + key * rb +
                     ch * cb,
                 ok ? src : reinterpret_cast<const unsigned char*>(kc), ok,
                 cb);
    }
    if constexpr (kInt8) {
      for (int e = tid; e < 2 * kKeys; e += kThreads) {
        const int which = e / kKeys, key = e - which * kKeys;
        const int k = k0 + key;
        const bool ok = k <= pmax;
        const int blk = ok ? bt[s * a.W + k / a.bs] : 0;
        const size_t row =
            (static_cast<size_t>(blk) * a.bs + k % a.bs) * a.n_kv + h;
        mma::cp_async<4>(scale_addr + ((slot * 2 + which) * kKeys + key) * 4,
                         (which ? vsc : ksc) + (ok ? row : 0), ok);
      }
    }
  };

  float m[4], l[4], o[4][4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kChunks; ++j) o[i][j] = 0.f;
  }

  if (t_begin < t_end) load(t_begin, 0);
  mma::cp_async_commit();   // with the f32 q rows
  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) & 1;
    if (t + 1 < t_end) load(t + 1, slot ^ 1);   // slot ^ 1 was freed
    mma::cp_async_commit();
    mma::cp_async_wait<1>();   // tile t has landed (this thread's copies)
    __syncthreads();           // ... everyone's
    const TC* kt = reinterpret_cast<const TC*>(ring + slot * 2 * tile_bytes);
    const TC* vt =
        reinterpret_cast<const TC*>(ring + (slot * 2 + 1) * tile_bytes);
    const float* kscale = scales + slot * 2 * kKeys;
    const float* vscale = kscale + kKeys;
    const int row_elems = rb / static_cast<int>(sizeof(TC));

    // S = Q K^T for rows 4 ty + i and keys tx, tx + 16
    float sc[4][2] = {};
    const float ks0 = kInt8 ? kscale[tx] : 1.f;
    const float ks1 = kInt8 ? kscale[tx + 16] : 1.f;
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = load4(kt + tx * row_elems + d, ks0);
      const float4 k1 = load4(kt + (tx + 16) * row_elems + d, ks1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (4 * ty + i) * (D + 4) + d);
        sc[i][0] = fmaf(qv.x, k0.x, sc[i][0]);
        sc[i][0] = fmaf(qv.y, k0.y, sc[i][0]);
        sc[i][0] = fmaf(qv.z, k0.z, sc[i][0]);
        sc[i][0] = fmaf(qv.w, k0.w, sc[i][0]);
        sc[i][1] = fmaf(qv.x, k1.x, sc[i][1]);
        sc[i][1] = fmaf(qv.y, k1.y, sc[i][1]);
        sc[i][1] = fmaf(qv.z, k1.z, sc[i][1]);
        sc[i][1] = fmaf(qv.w, k1.w, sc[i][1]);
      }
    }

    // online softmax of each row across its half-warp; p to shared memory
    const int k0 = t * kKeys;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live0 = k0 + tx <= rpos[i];
      const bool live1 = k0 + tx + 16 <= rpos[i];
      const float s0 = live0 ? sc[i][0] * a.scale : -INFINITY;
      const float s1 = live1 ? sc[i][1] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(s0, s1)));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = live0 ? expf(s0 - safe) : 0.f;
      const float p1 = live1 ? expf(s1 - safe) : 0.f;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      l[i] = corr * l[i] + half_warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * kChunks; ++j) o[i][j] *= corr;
      ps[(4 * ty + i) * kPStride + tx] = p0;
      ps[(4 * ty + i) * kPStride + tx + 16] = p1;
    }
    __syncthreads();

    // O += P V for rows 4 ty + i and columns 64 c + 4 tx .. + 3
    for (int j = 0; j < kKeys; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPStride + j);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float vsj = kInt8 ? vscale[j + jj] : 1.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = 64 * c + 4 * tx;
          if (col >= D) continue;
          const float4 v = load4(vt + (j + jj) * row_elems + col, vsj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][4 * c + 0] = fmaf(pr[i][jj], v.x, o[i][4 * c + 0]);
            o[i][4 * c + 1] = fmaf(pr[i][jj], v.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(pr[i][jj], v.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(pr[i][jj], v.w, o[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();   // slot and p consumed
  }
  mma::cp_async_wait<0>();   // a split with no key tile: the q copies

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
    const int ci = r / a.G, g = r - ci * a.G;
    const size_t orow = (static_cast<size_t>(s) * a.C + ci) * H + h * a.G + g;
    if (a.splits == 1) {
      const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col >= D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[orow * D + col + e] = from_f32<TQ>(o[i][4 * c + e] / den);
      }
    } else {
      const size_t prow = static_cast<size_t>(sp) * a.S * a.C * H + orow;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col >= D) continue;
        *reinterpret_cast<float4*>(part_o + prow * D + col) = make_float4(
            o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2], o[i][4 * c + 3]);
      }
      if (tx == 0) {
        part_ml[2 * prow] = m[i];
        part_ml[2 * prow + 1] = l[i];
      }
    }
  }
}

// One output row (blockIdx.x of S*C*H) from the splits' partials, merged
// by their lse in split order.
template <typename TQ>
__global__ void __launch_bounds__(kMaxD)
    paged_prefill_merge_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_ml,
                               TQ* __restrict__ out, int n_rows, int D,
                               int splits) {
  const int row = blockIdx.x, d = threadIdx.x;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, part_ml[2 * (static_cast<size_t>(sp) * n_rows + row)]);
  const float safe = mx == -INFINITY ? 0.f : mx;
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t prow = static_cast<size_t>(sp) * n_rows + row;
    const float m = part_ml[2 * prow];
    if (m == -INFINITY) continue;   // this split saw no live key
    const float w = expf(m - safe);
    den = fmaf(w, part_ml[2 * prow + 1], den);
    if (d < D) num = fmaf(w, part_o[prow * D + d], num);
  }
  if (d < D)
    out[static_cast<size_t>(row) * D + d] =
        from_f32<TQ>(num / (den == 0.f ? 1.f : den));
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, void* out, float* part_o, float* part_ml,
                   const Args& a, int smem, cudaStream_t stream) {
  if (smem != smem_bytes<TC>(a.D) || smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel<TQ, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S * a.n_kv * a.row_tiles, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, bt, pos, static_cast<TQ*>(out),
      part_o, part_ml, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int n_rows = a.S * a.C * a.n_kv * a.G;
  paged_prefill_merge_kernel<TQ><<<n_rows, kMaxD, 0, stream>>>(
      part_o, part_ml, static_cast<TQ*>(out), n_rows, a.D, a.splits);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(int cache_dtype, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     const int* bt, const int* pos, void* out, float* po,
                     float* pml, const Args& a, int smem, cudaStream_t st) {
  switch (cache_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, ks, vs, bt, pos, out, po, pml, a,
                               smem, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, ks, vs, bt, pos, out, po,
                                       pml, a, smem, st);
    case kI8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(q, k, v, ks, vs, bt, pos, out, po, pml, a,
                                smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace prefill
}  // namespace zt

// q and out (S, C, H, D); k/v cache (NB, bs, n_kv, D); scales
// (NB, bs, n_kv) f32 or null; tables (S, W) int32; positions (S, C)
// int32, the cache index of each row. The plan (rows and keys of a
// tile, which must be the compiled kRows and kKeys, the splits and the
// shared-memory bytes) is prefill_plan()'s; with splits > 1, part_o
// (splits, S, C, H, D) and part_ml (splits, S, C, H, 2) f32 hold the
// partials, else they may be null.
extern "C" int zt_paged_prefill(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                const int* tables, const int* positions,
                                void* out, void* part_o, void* part_ml,
                                int S, int C, int n_kv, int G, int D, int bs,
                                int W, float scale, int q_dtype,
                                int cache_dtype, int row_tile, int key_tile,
                                int splits, int smem, void* stream) {
  using namespace zt;
  using namespace zt::prefill;
  if (bs < 1 || D < 4 || D > kMaxD || D % 4 || G < 1 || C < 1 || S < 1 ||
      n_kv < 1 || W < 1 || row_tile != kRows || key_tile != kKeys ||
      splits < 1 || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  // the copies: q rows 16 bytes (f32) or 8 (bf16) at a time, cache rows
  // 16, 8 or 4 as D * itemsize allows
  const int item = cache_dtype == kF32 ? 4 : cache_dtype == kBF16 ? 2 : 1;
  const int row = D * item;
  const uintptr_t cb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
  if (reinterpret_cast<uintptr_t>(q) % (q_dtype == kF32 ? 16 : 8) ||
      reinterpret_cast<uintptr_t>(k) % cb ||
      reinterpret_cast<uintptr_t>(v) % cb)
    return cudaErrorInvalidValue;
  const Args a{S, C, n_kv, G, D, bs, W, (C * G + kRows - 1) / kRows, splits,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (q_dtype == kF32)
    return launch_q<float>(cache_dtype, q, k, v, k_scale, v_scale, tables,
                           positions, out, po, pml, a, smem, st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(cache_dtype, q, k, v, k_scale, v_scale,
                                   tables, positions, out, po, pml, a, smem,
                                   st);
  return cudaErrorInvalidValue;
}
