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
// - f32: conv_f32::conv_f32_tc_kernel (conv2d_f32_tc.cuh), on the tensor
//   cores as 3xTF32 (wgmma on the transposed product y^T = w^T x^T, each
//   f32 operand split into two TF32 numbers, short chains added in f32);
//   its header says why that holds the f32 tolerance and what bounds it.
// - int8: conv_i8::conv_i8_tc_kernel (conv2d_int8_tc.cuh), on the int8
//   tensor cores (wgmma s8) over a K-major copy of the weights; its
//   header says what bounds it. Epilogue: f32(acc) * xs[image] * ws[o],
//   in that order, as _conv_kernel_q applies it (conv.py:139).
#include "conv2d_f32_tc.cuh"
#include "conv2d_int8_tc.cuh"
#include "conv2d_tc.cuh"

namespace zt {

inline bool valid(const ConvArgs& a) {
  return a.n > 0 && a.h > 0 && a.w > 0 && a.c > 0 && a.kh > 0 && a.kw > 0 &&
         a.o > 0 && a.sh > 0 && a.sw > 0 && a.ph >= 0 && a.pw >= 0 &&
         a.oh > 0 && a.ow > 0;
}

}  // namespace zt

// Float conv: x (n, h, w, c) and wt (kh, kw, c, o) of dtype (0 = f32,
// 1 = bf16), y (n, oh, ow, o) of the same dtype; all contiguous. The
// plan (bn, stages, vec, smem) is conv_plan()'s for bf16 and
// conv_f32_plan()'s for f32.
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
  if (dtype == kF32)
    return conv_f32::conv2d_f32(x, wt, y, a, bn, stages, vec, smem, s);
  return cudaErrorInvalidValue;
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
