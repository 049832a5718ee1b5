// Implicit-GEMM 2-D convolution, NHWC input, HWIO weights, in float
// (f32 or bf16 in, f32 accumulation, output in the input type) and in
// int8 (int8 x int8 -> int32, dequantized in the epilogue to f32).
//
// Replaces: zoo_tpu/ops/pallas/conv.py, _conv_kernel (:114) and
// _conv_kernel_q (:128), both launched by _conv2d_pallas (:143, the
// pallas_call at :199) for conv2d (:221) and conv2d_int8 (:238).
//
// The product: rows are the N*OH*OW output pixels, columns the O output
// channels, and the reduction runs over taps x C, tap (dy, dx) of
// output pixel (oy, ox) reading input pixel (oy*sh - ph + dy,
// ox*sw - pw + dx). Pixels outside the image read as zero, which is
// SAME padding with leading pads (ph, pw) and any trailing pad, so no
// padded copy of the input exists; a 1x1 conv at stride s reads
// (oy*s, ox*s), the strided slice the Pallas wrapper makes before its
// GEMM. No im2col buffer exists either: the A slice of each step is
// gathered from the image straight into shared memory.
//
// Three kernels:
// - bf16: conv_tc::conv_tc_kernel (conv2d_tc.cuh), on the tensor cores
//   (wgmma, a cp.async ring); its header says what bounds it.
// - f32: conv2d_kernel below, on the SIMT units (f32 FMAs). Tensor cores
//   would mean TF32, which keeps ~3 decimal digits where the f32 path is
//   held to 1e-5; so it stays a SIMT kernel: 64 x 64 output tiles,
//   32-deep slices staged in shared memory, a 4 x 4 register micro-tile
//   per thread (zt_gemm.cuh).
// - int8: conv_i8::conv_i8_tc_kernel (conv2d_int8_tc.cuh), on the int8
//   tensor cores (wgmma s8) over a K-major copy of the weights; its
//   header says what bounds it. Epilogue: f32(acc) * xs[image] * ws[o],
//   in that order, as _conv_kernel_q applies it (conv.py:139).
#include "conv2d_int8_tc.cuh"
#include "conv2d_tc.cuh"
#include "zt_gemm.cuh"

namespace zt {

using namespace gemm;

// The A rows this thread loads: per row its image (-1 past the last
// row) and the top-left input pixel of its window, which may lie in the
// halo.
struct RowOrigins {
  int img[kLoads], iy[kLoads], ix[kLoads];
};

__device__ __forceinline__ void row_origins(const ConvArgs& a, long long m0,
                                            int r0, RowOrigins& ro) {
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int hw = a.oh * a.ow;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const long long m = m0 + r0 + kARowStep * i;
    if (m < rows) {
      const int img = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - static_cast<long long>(img) * hw);
      const int oy = rem / a.ow, ox = rem - oy * a.ow;
      ro.img[i] = img;
      ro.iy[i] = oy * a.sh - a.ph;
      ro.ix[i] = ox * a.sw - a.pw;
    } else {
      ro.img[i] = -1;
      ro.iy[i] = ro.ix[i] = 0;
    }
  }
}

// Offset of input element (row origin i, tap (dy, dx), channel c), or
// -1 where it lies in the halo, past the last row or past C.
__device__ __forceinline__ long long x_offset(const ConvArgs& a,
                                              const RowOrigins& ro, int i,
                                              int dy, int dx, int c) {
  const int iy = ro.iy[i] + dy, ix = ro.ix[i] + dx;
  if (ro.img[i] < 0 || c >= a.c || iy < 0 || iy >= a.h || ix < 0 ||
      ix >= a.w)
    return -1;
  return ((static_cast<long long>(ro.img[i]) * a.h + iy) * a.w + ix) * a.c +
         c;
}

// Offset of weight element (tap, channel c, output o), or -1 outside.
__device__ __forceinline__ long long w_offset(const ConvArgs& a, int tap,
                                              int c, int o) {
  if (c >= a.c || o >= a.o) return -1;
  return (static_cast<long long>(tap) * a.c + c) * a.o + o;
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, ConvArgs a) {   // T = float only
  __shared__ FloatTile t;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ak = tid % kBK, ar = tid / kBK;
  const int bn = tid % kBN, bk = tid / kBN;
  RowOrigins ro;
  row_origins(a, m0, ar, ro);
  float acc[4][4] = {};
  for (int tap = 0; tap < a.kh * a.kw; ++tap) {
    const int dy = tap / a.kw, dx = tap - (tap / a.kw) * a.kw;
    for (int c0 = 0; c0 < a.c; c0 += kBK) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const long long off = x_offset(a, ro, i, dy, dx, c0 + ak);
        t.a[ak][ar + kARowStep * i] = off < 0 ? 0.f : to_f32(x[off]);
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = bk + kBRowStep * i;
        const long long off = w_offset(a, tap, c0 + k, n0 + bn);
        t.b[k][bn] = off < 0 ? 0.f : to_f32(w[off]);
      }
      __syncthreads();
      fma_slice(t, tx, ty, acc);
      __syncthreads();
    }
  }
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx + 16 * j;
      if (o < a.o) y[m * a.o + o] = from_f32<T>(acc[i][j]);
    }
  }
}

inline bool valid(const ConvArgs& a) {
  return a.n > 0 && a.h > 0 && a.w > 0 && a.c > 0 && a.kh > 0 && a.kw > 0 &&
         a.o > 0 && a.sh > 0 && a.sw > 0 && a.ph >= 0 && a.pw >= 0 &&
         a.oh > 0 && a.ow > 0;
}

}  // namespace zt

// Float conv: x (n, h, w, c) and wt (kh, kw, c, o) of dtype (0 = f32,
// 1 = bf16), y (n, oh, ow, o) of the same dtype; all contiguous. bf16
// takes the tensor-core kernel with the plan (bn, stages, vec, smem)
// that conv_plan() gives; f32 takes the SIMT kernel and ignores the plan.
extern "C" int zt_conv2d(const void* x, const void* wt, void* y, int dtype,
                         int n, int h, int w, int c, int kh, int kw, int o,
                         int sh, int sw, int ph, int pw, int oh, int ow,
                         int bn, int stages, int vec, int smem,
                         void* stream) {
  using namespace zt;
  const ConvArgs a{n, h, w, c, kh, kw, o, sh, sw, ph, pw, oh, ow};
  if (!valid(a)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return conv_tc::conv2d_bf16(x, wt, y, a, bn, stages, vec, smem, s);
  if (dtype != kF32) return cudaErrorInvalidValue;
  const dim3 grid = grid_for(static_cast<long long>(n) * oh * ow, o);
  conv2d_kernel<float><<<grid, kGemmThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<float*>(y), a);
  return cudaGetLastError();
}

// Int8 conv: x (n, h, w, c) int8, wk (o, kh * kw * c) int8, the K-major
// copy of the HWIO weights, xs (n,) and ws (o,) f32 scales, y (n, oh, ow,
// o) f32; all contiguous. The plan (bn, bk, stages, vec, out_vec, smem)
// is conv_int8_plan()'s.
extern "C" int zt_conv2d_int8(const void* x, const void* wk, const void* xs,
                              const void* ws, void* y, int n, int h, int w,
                              int c, int kh, int kw, int o, int sh, int sw,
                              int ph, int pw, int oh, int ow, int bn, int bk,
                              int stages, int vec, int out_vec, int smem,
                              void* stream) {
  using namespace zt;
  const ConvArgs a{n, h, w, c, kh, kw, o, sh, sw, ph, pw, oh, ow};
  if (!valid(a)) return cudaErrorInvalidValue;
  return conv_i8::conv2d_int8(x, wk, xs, ws, y, a, bn, bk, stages, vec,
                              out_vec, smem,
                              static_cast<cudaStream_t>(stream));
}
