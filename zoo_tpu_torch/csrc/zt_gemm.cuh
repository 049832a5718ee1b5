// Tile machinery of the SIMT int8 GEMM (quant_matmul.cu, qmm_kernel) and
// the dequant epilogue every int8 kernel shares (quant_matmul.cu,
// conv2d_int8_tc.cuh).
//
// One block of kGemmThreads threads computes a kBM x kBN tile of the output
// (rows x columns). The reduction walks kBK-deep slices: every thread
// loads kLoads elements of the A slice (kBM x kBK) and kLoads of the B
// slice (kBK x kBN) into shared memory, the block synchronises, and each
// thread accumulates a 4 x 4 micro-tile at rows ty + 16 i and columns
// tx + 16 j (tx = tid % 16, ty = tid / 16), so the 16 threads of a
// half-warp store 16 neighbouring columns.
//
// Loads: thread tid takes A row (tid / kBK) + kARowStep * i, reduction
// lane tid % kBK, so a warp reads 32 neighbouring elements of one row;
// B reduction row (tid / kBN) + kBRowStep * i, column tid % kBN, so a
// warp reads 32 neighbouring columns of one row.
#pragma once

#include "zt_common.cuh"

namespace zt {
namespace gemm {

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 256;
constexpr int kLoads = kBM * kBK / kGemmThreads;   // per thread, A and B
constexpr int kARowStep = kGemmThreads / kBK;      // 8
constexpr int kBRowStep = kGemmThreads / kBN;      // 4
static_assert(kLoads * kARowStep == kBM, "A slice covered once");
static_assert(kLoads * kBRowStep == kBK, "B slice covered once");

// Int8 slices with k contiguous per row of A and per column of B, so 4
// consecutive k read as one 32-bit word for __dp4a. Rows are padded to
// 36 bytes (9 words): the 16 columns a half-warp reads then fall in 16
// different banks.
constexpr int kI8Stride = kBK + 4;
struct Int8Tile {
  int8_t a[kBM][kI8Stride];
  int8_t b[kBN][kI8Stride];
};

// int8 x int8 -> int32, four products per __dp4a. Exact: the caller
// keeps the reduction short enough that no sum passes 2^31.
__device__ __forceinline__ void dp4a_slice(const Int8Tile& t, int tx, int ty,
                                           int (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < kBK; k += 4) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const int*>(&t.a[ty + 16 * i][k]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const int*>(&t.b[tx + 16 * j][k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// The dequant epilogue of the int8 kernels, in the order the Pallas
// kernels apply it: f32(acc) * row scale, then * column scale. Two
// rounded f32 products (nothing to contract into an FMA), so the plain
// versions reproduce it bit for bit.
__device__ __forceinline__ float dequant(int acc, float row_scale,
                                         float col_scale) {
  const float v = static_cast<float>(acc) * row_scale;
  return v * col_scale;
}

inline dim3 grid_for(long long rows, int cols) {
  return dim3(static_cast<unsigned>((rows + kBM - 1) / kBM),
              static_cast<unsigned>((cols + kBN - 1) / kBN));
}

}  // namespace gemm
}  // namespace zt
