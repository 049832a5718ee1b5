// Paged flash-decode: one query per slot against its K/V, read in place
// through the block table, in one launch.
//
// Replaces: zoo_tpu/ops/pallas/paged_decode.py, _kernel (:55), called by
// paged_flash_decode (:132, the pallas_call at :242), and its split-KV
// epilogue (:258-268), which here runs inside the kernel.
//
// What bounds it on an H100: memory. A decode tick must read every live
// K/V row of every slot once (plus q and the tables) and does about 4
// flops per cache element, far below the ~20 flops/byte at which the
// f32 units would become the limit. The least time is the live cache
// bytes over 3.35 TB/s (the published H100 SXM bandwidth at 700 W): a
// few microseconds at the serving shapes, so launches, the split merge
// and load latency are what a call loses time to.
//
// What the design does about it:
// - One launch. The CTAs of one (slot, kv head) form a thread-block
//   cluster of `ctas` CTAs (at most 8, the portable cluster size). Each
//   warp leaves its partial softmax (acc, m, l) in its CTA's shared
//   memory, and the CTA merges its warps' partials into one. After
//   cluster.sync() every CTA merges a share of the G x D outputs from the
//   cluster's CTA partials through distributed shared memory (the loads
//   of all of them issued together), in rank order, with the JAX
//   epilogue's rule (a dead partial carries m = -inf, l = 0 and drops
//   out; l_tot = 0 divides by 1), and writes the output in q's dtype. No
//   scratch in device memory, no merge kernels.
// - Splits over the live length. The slot's live rows (positions[s] + 1,
//   read on the device) are cut into chunks of `chunk_rows` rows of one
//   cache block; the cluster's CTAs take equal runs of chunks and the
//   warps of a CTA take every `warps`-th chunk of the run, each warp with
//   its own online softmax. No CTA idles on table entries past the
//   position while another walks the whole table.
// - Loads in flight while computing. Each warp streams its chunks through
//   a ring of kStages slots in shared memory, filled by cp.async in
//   16-byte units where the rows allow it (8 or 4 bytes otherwise; an
//   element copy for rows that are not whole 4-byte units). Rows past the
//   position are zero-filled, not read. bf16 and int8 rows stay narrow in
//   shared memory and are widened at use; int8 rows are multiplied by
//   their f32 row scale (copied beside them) as the plain version widens
//   them, so device memory moves 1 byte per element. No TMA: a chunk is a
//   few rows at a stride of H_kv x D, and cp.async keeps the copy in the
//   warp that uses it, with no barrier shared between warps.
// - Scores without a serial chain. Lane l holds q[g][l + 32 i] of every
//   query head g of the group in registers; the dot products of four key
//   rows are reduced over the warp with shuffles side by side, so all 32
//   lanes work on every row, and the G heads of the group share each K/V
//   row read. p goes through a small per-warp buffer to the P.V loop.
//   SIMT FMAs: at ~4 flops an element the tensor cores would buy nothing,
//   and in f32 they would mean TF32.
// - Shuffles on the fast path. A shuffle the compiler cannot prove
//   converged (under a branch on G, or in a loop whose trip count comes
//   from loaded data) compiles to WARPSYNC.COLLECTIVE around the SHFL,
//   a slow path, which a clock64() timeline of one warp showed dominating the chunk
//   loop: the loop's condition goes through a vote and the reductions run
//   over every head of the register layout, so the SASS holds none
//   (chip_smoke.py checks it).
// The plan (CTAs per cluster, warps, ring stages, chunk rows, copy width,
// shared memory) is counted by decode_plan() in ops/kernels/paged_decode.py
// and passed here; the entry checks the shared memory against the layout
// below and a block's limit.
#include <cooperative_groups.h>

#include "zt_common.cuh"
#include "zt_mma.cuh"

namespace zt {
namespace decode {

namespace cg = cooperative_groups;

constexpr int kMaxSlices = 4;   // D <= 128: lane l owns columns l + 32 i
constexpr int kStages = 2;      // ring slots per warp
constexpr int kMaxCtas = 8;     // the portable cluster size
constexpr int kMaxWarps = 4;

struct Args {
  int n_kv, G, D, bs, W;
  int chunk_rows, cpb;    // rows of a chunk, chunks per cache block
  int row_stride;         // bytes of a cache row in a slot (16-aligned)
  int slot_bytes;         // K rows, V rows, then (int8) K and V scales
  int copy_bytes;         // 16, 8, 4, or 0 for an element copy
  int pbuf_off;           // byte offset of the per-warp p buffers
  float scale;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory (bytes), as decode_plan() counts it: the warps' rings
// (warps x kStages slots), which the partials (acc [warps][G][D], m and l
// [warps][G], then the CTA's m and l [G], f32) overwrite once every warp
// is done, then the p buffers (warps x chunk_rows x kG f32).
__host__ inline int layout_bytes(int warps, int G, int D, int chunk_rows,
                                 int slot_bytes, int kG, int* pbuf_off) {
  const int ring = warps * kStages * slot_bytes;
  const int partials = (warps * G * (D + 2) + 2 * G) * 4;
  *pbuf_off = round16(ring > partials ? ring : partials);
  return *pbuf_off + warps * chunk_rows * kG * 4;
}

// K (then V) rows of a slot, B bytes a copy: lane l copies unit l % per
// of row l / per of every 32 / per rows when per = row_bytes / B divides
// 32 (the cache rows of the serving shapes), else the units in turn.
template <int B>
__device__ __forceinline__ void copy_rows(unsigned char* slot,
                                          unsigned char* vdst,
                                          const unsigned char* kc,
                                          const unsigned char* vc,
                                          size_t first, int n, int nr, int h,
                                          int row_bytes, const Args& a,
                                          int lane) {
  const int per = row_bytes / B;
  auto copy = [&](int kv, int r, int c) {
    const size_t row = (first + r) * a.n_kv + h;
    mma::cp_async<B>(
        mma::smem_addr((kv ? vdst : slot) + r * a.row_stride + c * B),
        (kv ? vc : kc) + row * row_bytes + c * B, r < nr);
  };
  if (32 % per == 0) {
    const int step = 32 / per, c = lane % per;
    for (int rr = lane / per; rr < 2 * n; rr += step) {
      const int kv = rr >= n;
      copy(kv, rr - kv * n, c);
    }
  } else {
    for (int i = lane; i < 2 * n * per; i += 32) {
      const int kv = i >= n * per;
      const int rem = i - kv * n * per;
      const int r = rem / per;
      copy(kv, r, rem - r * per);
    }
  }
}

// Fill `slot` with rows row0 .. row0+n-1 of cache block `blk`, kv head h
// (nr of them live; the rest zero-filled), for K and V, and their scales.
template <typename TC>
__device__ __forceinline__ void fill_slot(
    unsigned char* slot, const TC* __restrict__ kc, const TC* __restrict__ vc,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int blk,
    int row0, int n, int nr, int h, const Args& a, int lane) {
  const int row_bytes = a.D * static_cast<int>(sizeof(TC));
  unsigned char* vdst = slot + a.chunk_rows * a.row_stride;
  const size_t first = static_cast<size_t>(blk) * a.bs + row0;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(kc);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vc);
  if (a.copy_bytes == 16) {
    copy_rows<16>(slot, vdst, kb, vb, first, n, nr, h, row_bytes, a, lane);
  } else if (a.copy_bytes == 8) {
    copy_rows<8>(slot, vdst, kb, vb, first, n, nr, h, row_bytes, a, lane);
  } else if (a.copy_bytes == 4) {
    copy_rows<4>(slot, vdst, kb, vb, first, n, nr, h, row_bytes, a, lane);
  } else {
    for (int i = lane; i < 2 * nr * a.D; i += 32) {
      const int kv = i >= nr * a.D;
      const int rem = i - kv * nr * a.D;
      const int r = rem / a.D, d = rem - r * a.D;
      const size_t row = (first + r) * a.n_kv + h;
      TC* dst = reinterpret_cast<TC*>((kv ? vdst : slot) + r * a.row_stride);
      dst[d] = (kv ? vc : kc)[row * a.D + d];
    }
  }
  if (ksc != nullptr && lane < n) {
    const size_t row = (first + lane) * a.n_kv + h;
    float* ks = reinterpret_cast<float*>(slot + 2 * a.chunk_rows * a.row_stride);
    mma::cp_async<4>(mma::smem_addr(ks + lane), ksc + row, lane < nr);
    mma::cp_async<4>(mma::smem_addr(ks + a.chunk_rows + lane), vsc + row,
                     lane < nr);
  }
}

// kG: the query heads of a group the registers are laid out for (>= G)
template <typename TQ, typename TC, int kG>
__global__ void __launch_bounds__(32 * kMaxWarps)
    paged_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                        const TC* __restrict__ vc,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ bt,
                        const int* __restrict__ pos, TQ* __restrict__ out,
                        Args a) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  constexpr bool kInt8 = sizeof(TC) == 1;
  constexpr int kR = kG <= 4 ? 4 : 1;   // key rows reduced together
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y / a.n_kv, h = blockIdx.y % a.n_kv;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.G, D = a.D, H = a.n_kv * G;
  const size_t qbase = (static_cast<size_t>(s) * H + h * G) * D;

  float qr[kG][kMaxSlices], acc[kG][kMaxSlices], m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlices; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < D) ? to_f32(q[qbase + g * D + d]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  // the slot's live chunks: unit u is chunk u % cpb of table entry u / cpb
  const int p = pos[s];
  const int last = min(p, a.W * a.bs - 1);
  const int n_units =
      p < 0 ? 0 : (last / a.bs) * a.cpb + (last % a.bs) / a.chunk_rows + 1;
  const int u0 = rank * n_units / ctas, u1 = (rank + 1) * n_units / ctas;
  const int mine = u1 - u0 > warp ? (u1 - u0 - warp + warps - 1) / warps : 0;
  unsigned char* ring = dec_smem + warp * kStages * a.slot_bytes;
  float* pb = reinterpret_cast<float*>(dec_smem + a.pbuf_off) +
              warp * a.chunk_rows * kG;

  auto geometry = [&](int k, int& j, int& row0, int& n, int& nr) {
    const int u = u0 + warp + k * warps;
    j = u / a.cpb;
    row0 = (u - j * a.cpb) * a.chunk_rows;
    n = min(a.chunk_rows, a.bs - row0);
    nr = min(n, p - j * a.bs - row0 + 1);
  };
  // the table entry of chunk k (past the warp's chunks: unused)
  auto entry = [&](int k) {
    return k < mine ? bt[s * a.W + (u0 + warp + k * warps) / a.cpb] : 0;
  };
  auto fill = [&](int k, int blk) {
    int j, row0, n, nr;
    geometry(k, j, row0, n, nr);
    fill_slot(ring + (k % kStages) * a.slot_bytes, kc, vc, ksc, vsc, blk,
              row0, n, nr, h, a, lane);
  };

#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (k < mine) fill(k, entry(k));
    mma::cp_async_commit();
  }
  // `mine` is the same on every lane; taken through a vote, the loop's
  // condition is one the compiler can see is uniform, so the shuffles
  // inside take the fast path
  for (int k = 0; __any_sync(0xffffffffu, k < mine); ++k) {
    // the next fill's table entry, loaded while this chunk is used
    const int blk_next = entry(k + kStages);
    mma::cp_async_wait<kStages - 1>();
    __syncwarp();
    int j, row0, n, nr;
    geometry(k, j, row0, n, nr);
    const unsigned char* slot = ring + (k % kStages) * a.slot_bytes;
    const unsigned char* vrows = slot + a.chunk_rows * a.row_stride;
    const float* kscl =
        reinterpret_cast<const float*>(slot + 2 * a.chunk_rows * a.row_stride);
    const float* vscl = kscl + a.chunk_rows;

    // scores: lane r keeps row r's score of every head. kR rows at a
    // time, so their kR x kG shuffle reductions run side by side. The
    // shuffles stay out of branches on G or on the data (heads past G
    // hold zeros): a shuffle the compiler cannot prove converged takes a
    // slow path (WARPSYNC.COLLECTIVE) in the SASS.
    float sc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) sc[g] = -INFINITY;
    for (int r0 = 0; r0 < a.chunk_rows; r0 += kR) {
      float part[kR][kG];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int r = r0 + rr < nr ? r0 + rr : r0;
        const TC* krow = reinterpret_cast<const TC*>(slot + r * a.row_stride);
        const float ks = kInt8 ? kscl[r] : 1.f;
        float kv[kMaxSlices];
#pragma unroll
        for (int i = 0; i < kMaxSlices; ++i) {
          const int d = lane + 32 * i;
          kv[i] = d < D ? (kInt8 ? to_f32(krow[d]) * ks : to_f32(krow[d]))
                        : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          part[rr][g] = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxSlices; ++i)
            part[rr][g] = fmaf(qr[g][i], kv[i], part[rr][g]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            part[rr][g] += __shfl_xor_sync(0xffffffffu, part[rr][g], o);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (lane == r0 + rr) sc[g] = part[rr][g] * a.scale;
    }
    // online softmax over the chunk's live rows, per head (every head of
    // the layout: see the scores)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float sv = lane < nr ? sc[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sv));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float pe = lane < nr ? expf(sv - safe) : 0.f;
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - safe);
      l[g] = corr * l[g] + warp_sum(pe);
#pragma unroll
      for (int i = 0; i < kMaxSlices; ++i) acc[g][i] *= corr;
      m[g] = m_new;
      if (lane < nr) pb[lane * kG + g] = pe;
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {
      const TC* vrow = reinterpret_cast<const TC*>(vrows + r * a.row_stride);
      const float vs = kInt8 ? vscl[r] : 1.f;
      float vv[kMaxSlices];
#pragma unroll
      for (int i = 0; i < kMaxSlices; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? (kInt8 ? to_f32(vrow[d]) * vs : to_f32(vrow[d]))
                      : 0.f;
      }
#pragma unroll
      for (int g4 = 0; g4 < kG / 4; ++g4) {
        const float4 p4 = reinterpret_cast<const float4*>(pb + r * kG)[g4];
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 4 * g4 + e;
          if (g < G) {
#pragma unroll
            for (int i = 0; i < kMaxSlices; ++i)
              acc[g][i] = fmaf(pv[e], vv[i], acc[g][i]);
          }
        }
      }
    }
    __syncwarp();   // the slot and the p buffer are read before reuse
    if (k + kStages < mine) fill(k + kStages, blk_next);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<0>();

  // every warp's partial, over the rings
  __syncthreads();
  float* pacc = reinterpret_cast<float*>(dec_smem);
  float* pm = pacc + warps * G * D;
  float* pl = pm + warps * G;
  float* cm = pl + warps * G;   // the CTA's partial: m and l (acc in pacc[0])
  float* cl = cm + G;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < kMaxSlices; ++i) {
        const int d = lane + 32 * i;
        if (d < D) pacc[(warp * G + g) * D + d] = acc[g][i];
      }
      if (lane == 0) {
        pm[warp * G + g] = m[g];
        pl[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the CTA's partial: its warps' merged in warp order, acc into warp 0's
  // slot (each output reads and writes its own column only)
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    float mx = -INFINITY;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, pm[w * G + g]);
    const float safe = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, o = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float mw = pm[w * G + g];
      const float al = mw == -INFINITY ? 0.f : expf(mw - safe);
      lt += al * pl[w * G + g];
      o += al * pacc[w * G * D + e];
    }
    pacc[e] = o;
    if (e - g * D == 0) {
      cm[g] = mx;
      cl[g] = lt;
    }
  }
  cluster.sync();

  // this CTA's share of the outputs, merged over the cluster's CTA
  // partials in rank order through distributed shared memory, the JAX
  // epilogue's rule: a dead partial (m = -inf, l = 0) drops out, and
  // l_tot = 0 divides by 1
  for (int e = rank * blockDim.x + threadIdx.x; e < G * D;
       e += ctas * blockDim.x) {
    const int g = e / D;
    float mc[kMaxCtas], lc[kMaxCtas], oc[kMaxCtas];
#pragma unroll
    for (int c = 0; c < kMaxCtas; ++c) {
      if (c < ctas) {
        mc[c] = cluster.map_shared_rank(cm, c)[g];
        lc[c] = cluster.map_shared_rank(cl, c)[g];
        oc[c] = cluster.map_shared_rank(pacc, c)[e];
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCtas; ++c)
      if (c < ctas) mx = fmaxf(mx, mc[c]);
    const float safe = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCtas; ++c) {
      if (c < ctas) {
        const float al = mc[c] == -INFINITY ? 0.f : expf(mc[c] - safe);
        lt += al * lc[c];
        o += al * oc[c];
      }
    }
    out[qbase + e] = from_f32<TQ>(o / (lt == 0.f ? 1.f : lt));
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

template <typename TQ, typename TC, int kG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, void* out, int S, const Args& a, int ctas,
                   int warps, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TC, kG>;
  static int opted = 0;   // bytes this instance was opted in to
  if (smem > opted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, S * a.n_kv, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, bt, pos, static_cast<TQ*>(out), a);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* bt,
                     const int* pos, void* out, int S, const Args& a,
                     int ctas, int warps, int smem, cudaStream_t st) {
  if (a.G <= 4)
    return launch<TQ, TC, 4>(q, k, v, ks, vs, bt, pos, out, S, a, ctas, warps,
                             smem, st);
  return launch<TQ, TC, 16>(q, k, v, ks, vs, bt, pos, out, S, a, ctas, warps,
                            smem, st);
}

template <typename TQ>
cudaError_t launch_q(int cache_dtype, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     const int* bt, const int* pos, void* out, int S,
                     const Args& a, int ctas, int warps, int smem,
                     cudaStream_t st) {
  switch (cache_dtype) {
    case kF32:
      return launch_g<TQ, float>(q, k, v, ks, vs, bt, pos, out, S, a, ctas,
                                 warps, smem, st);
    case kBF16:
      return launch_g<TQ, __nv_bfloat16>(q, k, v, ks, vs, bt, pos, out, S, a,
                                         ctas, warps, smem, st);
    case kI8:
      return launch_g<TQ, int8_t>(q, k, v, ks, vs, bt, pos, out, S, a, ctas,
                                  warps, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace zt

// q (S, H, D) of q_dtype; k/v cache (NB, bs, n_kv, D) of cache_dtype;
// scales (NB, bs, n_kv) f32, given exactly for an int8 cache; tables
// (S, W) int32; positions (S,) int32; out (S, H, D) of q_dtype. The plan
// (ctas, warps, stages, chunk_rows, copy_bytes, smem) is decode_plan()'s.
extern "C" int zt_paged_decode(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* positions,
                               void* out, int S, int n_kv, int G, int D,
                               int bs, int W, float scale, int q_dtype,
                               int cache_dtype, int ctas, int warps,
                               int stages, int chunk_rows, int copy_bytes,
                               int smem, void* stream) {
  using namespace zt;
  using namespace zt::decode;
  const int item = cache_dtype == kF32 ? 4 : cache_dtype == kBF16 ? 2 : 1;
  const bool int8 = cache_dtype == kI8;
  if (S < 1 || n_kv < 1 || bs < 1 || bs > 32 || D < 1 ||
      D > 32 * kMaxSlices || G < 1 || G > 16 || W < 1 || ctas < 1 ||
      ctas > kMaxCtas || warps < 1 || warps > kMaxWarps ||
      stages != kStages || chunk_rows < 1 || chunk_rows > bs ||
      (int8 != (k_scale != nullptr)) || (int8 != (v_scale != nullptr)) ||
      !(copy_bytes == 0 || copy_bytes == 4 || copy_bytes == 8 ||
        copy_bytes == 16) ||
      (copy_bytes > 0 && (D * item) % copy_bytes != 0) ||
      S * n_kv > 65535)
    return cudaErrorInvalidValue;
  Args a{n_kv, G, D, bs, W, chunk_rows, (bs + chunk_rows - 1) / chunk_rows,
         round16(D * item),
         0, copy_bytes, 0, scale};
  a.slot_bytes =
      round16(2 * chunk_rows * a.row_stride + (int8 ? 8 * chunk_rows : 0));
  const int need = layout_bytes(warps, G, D, chunk_rows, a.slot_bytes,
                                G <= 4 ? 4 : 16, &a.pbuf_off);
  if (need > smem || smem > mma::kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_q<float>(cache_dtype, q, k, v, k_scale, v_scale, tables,
                           positions, out, S, a, ctas, warps, smem, st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(cache_dtype, q, k, v, k_scale, v_scale,
                                   tables, positions, out, S, a, ctas, warps,
                                   smem, st);
  return cudaErrorInvalidValue;
}
