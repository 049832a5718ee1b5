// Tensor-core building blocks of the bf16 and int8 kernels: asynchronous
// copies into shared memory with zero fill and the 16-byte swizzle their
// tiles are stored in (conv2d_tc.cuh, flash_attention_fwd.cu,
// quant_matmul.cu); ldmatrix, mma.sync.m16n8k16, bf16 x bf16 -> f32
// (flash_attention_fwd.cu), and mma.sync.m16n8k32, s8 x s8 -> s32
// (quant_matmul.cu).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row-major): reg 0 = (row g, cols 2t, 2t+1), reg 1 = (row
//   g+8, same cols), reg 2 = (row g, cols 2t+8, 2t+9), reg 3 = (row g+8,
//   cols 2t+8, 2t+9); two bf16 per 32-bit register, low half first.
// - B (16 x 8, k by n): reg 0 = (k 2t, 2t+1; n g), reg 1 = (k 2t+8, 2t+9;
//   n g).
// - C/D (16 x 8, f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8,
//   same cols). The C layout of two neighbouring n-tiles, rounded to bf16,
//   is the A layout of the next product over those 16 columns.
//
// Fragment layouts of mma.m16n8k32 with s8 operands (four int8 a 32-bit
// register, the lowest k in the lowest byte):
// - A (16 x 32, row-major): reg 0 = (row g, k 4t..4t+3), reg 1 = (row
//   g+8, same k), reg 2 = (row g, k 16+4t..), reg 3 = (row g+8, k
//   16+4t..): the same registers ldmatrix.x4 gives for a 16 x 32-byte
//   tile read as b16.
// - B (32 x 8, k by n): reg 0 = (k 4t..4t+3; n g), reg 1 = (k 16+4t..;
//   n g).
// - C/D (16 x 8, s32): as m16n8k16's.
#pragma once

#include "zt_common.cuh"

namespace zt {
namespace mma {

// Dynamic shared memory one H100 block may opt in to (227 KB). The
// launch plans are counted in Python; an entry checks them against this.
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (16, 8 or 4) from global src to shared dst; when !full the
// destination is filled with zeros and nothing is read (src-size 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool full) {
  const int n = full ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else {
    static_assert(BYTES == 8 || BYTES == 4, "cp.async copies 4, 8 or 16 B");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Physical 16-byte unit of logical unit u in row `row` of a tile whose
// rows hold U units (U a power of two). The eight rows one ldmatrix
// phase reads at the same logical unit land on eight different 16-byte
// bank groups, so neither ldmatrix nor the row-wise copies conflict.
// With U = 8 (128-byte rows) in a tile on a 1024-byte boundary it is the
// 128-byte swizzle wgmma's matrix descriptors name.
template <int U>
__device__ __forceinline__ int swizzle(int row, int u) {
  static_assert(U >= 2 && (U & (U - 1)) == 0, "U: a power of two >= 2");
  if constexpr (U >= 8) {
    return u ^ (row & 7);
  } else {
    return u ^ ((row / (8 / U)) & (U - 1));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores, s8 operands, exact s32 accumulation
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
}  // namespace zt
