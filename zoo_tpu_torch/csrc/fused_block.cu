// The whole identity bottleneck of a ResNet in one kernel:
//   y = relu(x + bf16(relu(conv3x3(relu(x @ w1))) @ w3))
// with x (B, H, W, Cin) f32 or bf16, w1 (Cin, Cmid), w2 (3, 3, Cmid,
// Cmid) HWIO and w3 (Cmid, Cin) in bf16; y in x's dtype.
//
// Replaces: zoo_tpu/ops/pallas/fused_block.py, _kernel (:80), launched
// by _fused_bottleneck_impl (the pallas_call at :164) for
// fused_bottleneck (:102).
//
// Rounding points, those of _kernel: x rounded to bf16;
// t1 = bf16(relu(x @ w1)) with an f32 sum; t1 zero-padded by one pixel
// (the 3x3's SAME halo, on t1); acc = the f32 sum over the nine taps;
// t2 = bf16(relu(acc)); z3 = bf16(t2 @ w3) with an f32 sum;
// y = bf16(relu(z3 + bf16(x))), widened to f32 for an f32 x.
//
// What bounds it on an H100, against the bf16 tensor cores (~295 flop
// per byte of memory traffic): a stage of ResNet-50 at B=128 does 55.9
// GFLOP and must move x in and y out once, so bytes bound conv2_x
// (56x56, 256 -> 64: 411 MB, 0.123 ms) and conv3_x (28x28, 512 -> 128),
// operations conv4_x and conv5_x (0.0565 ms). The fusion exists to keep
// t1 and t2 out of device memory: only x, the weights and y cross it.
//
// Design. The TPU kernel keeps whole images and a padded t1 plane in
// VMEM; an H100 block has at most 227 KB of shared memory, and a 56x56
// plane of t1 alone is 430,592 B. So the kernel tiles over space: one
// block of 256 threads per (image, TH x TW output tile).
//  1. t1 on the (TH+2) x (TW+2) halo tile, from x: a GEMM of the halo
//     pixels by w1. Pixels outside the image read as zero, so their t1
//     rows come out relu(0) = 0: the SAME halo, with no extra pass.
//  2. t2 on the TH x TW tile: the nine taps as one GEMM whose A rows are
//     gathered from t1 in shared memory (implicit GEMM, K = 9 x Cmid).
//  3. The output channels in 64-wide slices through the third GEMM,
//     each slice adding the residual read from x and writing y once.
// t1 and t2 (bf16) never leave shared memory. The halo is recomputed
// by neighbouring tiles: (TH+2)(TW+2)/(TH*TW) of the reduce GEMM.
// Each GEMM runs on zt_gemm.cuh's 64x64x32 SIMT tile loop (f32 FMAs on
// bf16 values, 4x4 outputs per thread). Tensor cores (mma/wgmma) and
// TMA are the later speed work.
//
// Plan at the four ResNet-50 identity geometries (the wrapper picks the
// tile: 8 where the side is a multiple of 8, else 7 where it is one of
// 7; shared memory = the 16,512-byte staging tile + t1 + t2):
//   conv2_x 56x56, 256 -> 64:  8x8 tiles, 49 per image; t1 100 x 64 x 2
//           = 12,800 B, t2 64 x 64 x 2 = 8,192 B; 37,504 B in all.
//   conv3_x 28x28, 512 -> 128: 7x7 tiles, 16 per image; t1 81 x 128 x 2
//           = 20,736 B, t2 49 x 128 x 2 = 12,544 B; 49,792 B.
//   conv4_x 14x14, 1024 -> 256: 7x7 tiles, 4 per image; t1 41,472 B,
//           t2 25,088 B; 83,072 B.
//   conv5_x 7x7, 2048 -> 512: the whole image is one tile; t1 81 x 512
//           x 2 = 82,944 B, t2 49 x 512 x 2 = 50,176 B; 149,632 B, one
//           block per SM (the TPU plan sends this geometry to XLA).
// Above 48 KB the kernel opts in with
// cudaFuncAttributeMaxDynamicSharedMemorySize; a plan above 232,448 B
// (227 KB) is refused.
#include "zt_gemm.cuh"

namespace zt {

using namespace gemm;
using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;

struct BlockArgs {
  int b, h, w, cin, cmid;
  int th, tw;      // output tile
  int tiles_x;     // tiles across W
  int p, p1;       // pixels of the tile and of its halo tile
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One block computes rows x cols of a GEMM whose operands `op` supplies:
// op.rows(r) names this thread's A rows r + kARowStep * i of an M tile,
// op.slice(k0) the next kBK-deep slice, op.a(i, k) and op.b(k, n) the
// operands (zero outside), op.store(r, n, acc) the epilogue.
template <class Op>
__device__ __forceinline__ void block_gemm(FloatTile& t, Op& op, int rows,
                                           int cols, int depth) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ak = tid % kBK, ar = tid / kBK;
  const int bn = tid % kBN, bk = tid / kBN;
  for (int m0 = 0; m0 < rows; m0 += kBM) {
    op.rows(m0 + ar);
    for (int n0 = 0; n0 < cols; n0 += kBN) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < depth; k0 += kBK) {
        op.slice(k0);
#pragma unroll
        for (int i = 0; i < kLoads; ++i)
          t.a[ak][ar + kARowStep * i] = op.a(i, k0 + ak);
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int k = bk + kBRowStep * i;
          t.b[k][bn] = op.b(k0 + k, n0 + bn);
        }
        __syncthreads();
        fma_slice(t, tx, ty, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < cols) op.store(r, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();   // the next stage reads what this one stored
}

// Stage 1: t1[halo pixel][c] = bf16(relu(bf16(x[pixel]) @ w1)).
template <typename T>
struct Reduce {
  const T* x;
  const bf16* w1;
  bf16* t1;
  BlockArgs g;   // by value: kept in registers
  int img, y0, x0;
  long long base[kLoads];   // offset of the row's pixel in x, -1 outside

  __device__ void rows(int r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = r0 + kARowStep * i;
      base[i] = -1;
      if (r < g.p1) {
        const int hy = r / (g.tw + 2), hx = r - hy * (g.tw + 2);
        const int iy = y0 - 1 + hy, ix = x0 - 1 + hx;
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
          base[i] = ((static_cast<long long>(img) * g.h + iy) * g.w + ix) *
                    g.cin;
      }
    }
  }
  __device__ void slice(int) {}
  __device__ float a(int i, int k) const {
    return (base[i] < 0 || k >= g.cin) ? 0.f
                                       : round_bf16(to_f32(x[base[i] + k]));
  }
  __device__ float b(int k, int n) const {
    return (k < g.cin && n < g.cmid)
               ? to_f32(w1[static_cast<long long>(k) * g.cmid + n])
               : 0.f;
  }
  // rows outside the image summed zeros: their t1 is relu(0) = 0
  __device__ void store(int r, int n, float v) {
    t1[r * g.cmid + n] = __float2bfloat16_rn(fmaxf(v, 0.f));
  }
};

// Stage 2: t2[pixel][c] = bf16(relu(sum over taps of t1 window @ w2)).
// K runs over (tap, channel) with the channels of a tap padded to a
// multiple of kBK, so no slice spans two taps.
struct Spatial {
  const bf16* t1;
  const bf16* w2;
  bf16* t2;
  BlockArgs g;   // by value: kept in registers
  int cpad;
  int base[kLoads];   // halo index of the row's top-left tap, -1 past p
  int tap, kbase, shift;

  __device__ void rows(int r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = r0 + kARowStep * i;
      base[i] = -1;
      if (r < g.p) {
        const int py = r / g.tw, px = r - py * g.tw;
        base[i] = py * (g.tw + 2) + px;
      }
    }
  }
  __device__ void slice(int k0) {
    tap = k0 / cpad;
    kbase = tap * cpad;
    shift = (tap / 3) * (g.tw + 2) + tap % 3;
  }
  __device__ float a(int i, int k) const {
    const int c = k - kbase;
    return (base[i] < 0 || c >= g.cmid)
               ? 0.f
               : to_f32(t1[(base[i] + shift) * g.cmid + c]);
  }
  __device__ float b(int k, int n) const {
    const int c = k - kbase;
    return (c < g.cmid && n < g.cmid)
               ? to_f32(w2[(static_cast<long long>(tap) * g.cmid + c) *
                               g.cmid + n])
               : 0.f;
  }
  __device__ void store(int r, int n, float v) {
    t2[r * g.cmid + n] = __float2bfloat16_rn(fmaxf(v, 0.f));
  }
};

// Stage 3: y = bf16(relu(bf16(t2 @ w3) + bf16(x))), one pass over y.
template <typename T>
struct Expand {
  const bf16* t2;
  const bf16* w3;
  const T* x;
  T* y;
  BlockArgs g;   // by value: kept in registers
  int img, y0, x0;
  int row[kLoads];   // the row, -1 past p

  __device__ void rows(int r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = r0 + kARowStep * i;
      row[i] = r < g.p ? r : -1;
    }
  }
  __device__ void slice(int) {}
  __device__ float a(int i, int k) const {
    return (row[i] < 0 || k >= g.cmid) ? 0.f
                                       : to_f32(t2[row[i] * g.cmid + k]);
  }
  __device__ float b(int k, int n) const {
    return (k < g.cmid && n < g.cin)
               ? to_f32(w3[static_cast<long long>(k) * g.cin + n])
               : 0.f;
  }
  // pixels of a ragged tile past the image's edge are not written
  __device__ void store(int r, int n, float v) {
    const int py = r / g.tw, px = r - py * g.tw;
    const int iy = y0 + py, ix = x0 + px;
    if (iy >= g.h || ix >= g.w) return;
    const long long off =
        ((static_cast<long long>(img) * g.h + iy) * g.w + ix) * g.cin + n;
    const float z3 = round_bf16(v);
    const float xb = round_bf16(to_f32(x[off]));
    y[off] = from_f32<T>(round_bf16(fmaxf(z3 + xb, 0.f)));
  }
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    fused_bottleneck_kernel(const T* __restrict__ x,
                            const bf16* __restrict__ w1,
                            const bf16* __restrict__ w2,
                            const bf16* __restrict__ w3, T* __restrict__ y,
                            BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  FloatTile& t = *reinterpret_cast<FloatTile*>(smem);
  bf16* t1 = reinterpret_cast<bf16*>(smem + sizeof(FloatTile));
  bf16* t2 = t1 + a.p1 * a.cmid;
  const int img = blockIdx.y;
  const int tile_y = blockIdx.x / a.tiles_x;
  const int tile_x = blockIdx.x - tile_y * a.tiles_x;
  const int y0 = tile_y * a.th, x0 = tile_x * a.tw;

  Reduce<T> reduce{x, w1, t1, a, img, y0, x0, {}};
  block_gemm(t, reduce, a.p1, a.cmid, a.cin);
  Spatial spatial{t1, w2, t2, a, round_up(a.cmid, kBK), {}, 0, 0, 0};
  block_gemm(t, spatial, a.p, a.cmid, 9 * spatial.cpad);
  Expand<T> expand{t2, w3, x, y, a, img, y0, x0, {}};
  block_gemm(t, expand, a.p, a.cin, a.cmid);
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           void* y, const BlockArgs& a, int smem, cudaStream_t s) {
  auto kernel = fused_bottleneck_kernel<T>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(static_cast<unsigned>(
                      ((a.h + a.th - 1) / a.th) * a.tiles_x),
                  static_cast<unsigned>(a.b));
  kernel<<<grid, kGemmThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<T*>(y), a);
  return cudaGetLastError();
}

}  // namespace zt

// x (b, h, w, cin) of dtype (0 = f32, 1 = bf16) and y the same; w1
// (cin, cmid), w2 (3, 3, cmid, cmid), w3 (cmid, cin) bf16; all
// contiguous. (th, tw) is the output tile and smem the plan's shared
// memory in bytes, as the wrapper's plan() counts it: the FloatTile, then
// t1 ((th + 2)(tw + 2) x cmid bf16), then t2 (th tw x cmid bf16).
extern "C" int zt_fused_bottleneck(const void* x, const void* w1,
                                   const void* w2, const void* w3, void* y,
                                   int dtype, int b, int h, int w, int cin,
                                   int cmid, int th, int tw, int smem,
                                   void* stream) {
  using namespace zt;
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 ||
      th <= 0 || tw <= 0 || smem <= 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const BlockArgs a{b,  h,  w,  cin, cmid, th, tw, (w + tw - 1) / tw,
                    th * tw, (th + 2) * (tw + 2)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, w1, w2, w3, y, a, smem, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w1, w2, w3, y, a, smem, s);
  return cudaErrorInvalidValue;
}
