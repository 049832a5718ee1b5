// The dequant epilogue every int8 kernel shares (quant_matmul.cu's two
// GEMMs, conv2d_int8_tc.cuh's conv).
#pragma once

#include "zt_common.cuh"

namespace zt {
namespace gemm {

// The dequant epilogue of the int8 kernels, in the order the Pallas
// kernels apply it: f32(acc) * row scale, then * column scale. Two
// rounded f32 products (nothing to contract into an FMA), so the plain
// versions reproduce it bit for bit.
__device__ __forceinline__ float dequant(int acc, float row_scale,
                                         float col_scale) {
  const float v = static_cast<float>(acc) * row_scale;
  return v * col_scale;
}

}  // namespace gemm
}  // namespace zt
