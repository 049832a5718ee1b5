// The int8 implicit-GEMM convolution on the tensor cores (wgmma s8).
//
// Replaces: zoo_tpu/ops/pallas/conv.py, _conv_kernel_q (:128), launched
// by _conv2d_pallas (the pallas_call at :199) for conv2d_int8 (:238).
// Both multiply int8 by int8 into exact int32 sums and apply the
// dequant epilogue f32(acc) * xs[image] * ws[o] in that order, f32 out.
// The sums are exact, so this kernel equals its plain version bit for
// bit.
//
// The product: rows are the N*OH*OW output pixels, columns the O output
// channels, the reduction runs over taps x C (tap-major, BK channels a
// step), as in the bf16 kernel (conv2d_tc.cuh), whose swizzle and
// row-origin helpers this one uses, with zt_mma.cuh's descriptor,
// wgmma-group and s8 wgmma helpers.
//
// What bounds it on an H100 (1979 TOP/s int8, 3.35 TB/s): bytes for
// ResNet-50's 1x1 convs at 56x56 (about 100 int8 operations per byte),
// operations for its 3x3 ones at 7x7. The design:
// - wgmma.mma_async m64nNk32 s32.s8.s8: one warpgroup (4 warps) per 64
//   rows of the block's 128 x BN tile (BN = 64 or 128), the sums in
//   registers (BN / 2 int32 a thread).
// - 8-bit wgmma reads both operands K-major from shared memory (only
//   16-bit types may be MN-major). The activations are K-major already
//   (NHWC: channels contiguous). The HWIO weights are not, so the
//   kernel takes them as an (O, KH*KW*C) K-major copy, made once per
//   layer when the model is quantized (ops/kernels/conv.py).
// - BK = 64 channels in 64-byte rows with the 64-byte swizzle (chunk c
//   of row r at c ^ ((r / 2) % 4)), or, where C % 128 == 0, 128
//   channels in 128-byte rows with the 128-byte swizzle (c ^ (r % 8)).
//   ResNet-50's C = 64 convs would waste half of a 128-channel step.
// - A ring of STAGES slots filled by cp.async: six 64-channel slots with
//   one wgmma group left in flight across steps (four steps of copies
//   ahead), or three 128-channel slots with the group drained each
//   step (two ahead). A halo pixel, a row past M, a channel past C or
//   a column past O is zero-filled through the copy's source size: no
//   padded copy and no im2col buffer exist.
// - Copies of VEC bytes (16 where C % 16 == 0 and the pointers allow
//   it, else 8 or 4 by cp.async, 2 or 1 by a plain load and store).
// - The epilogue stages the int32 tile through the drained ring, then
//   each thread dequantizes 4 neighbouring outputs of a row and stores
//   them as one 16-byte f32 write (element by element where O % 4 != 0).
// - At most 128 registers a thread, about 99 KB of shared memory, so
//   two blocks share an SM, as in the bf16 kernel.
#pragma once

#include "conv2d_tc.cuh"
#include "zt_gemm.cuh"

namespace zt {
namespace conv_i8 {

using conv_tc::desc;

constexpr int kBM = 128;                 // output rows of a block
constexpr int kThreads = 2 * kBM;        // a warpgroup per 64 rows

// BK channels (bytes) a step; (BK, STAGES) is (64, 6) or (128, 3)
template <int BN, int BK, int STAGES>
struct Tile {
  static_assert((BK == 64 && STAGES == 6) || (BK == 128 && STAGES == 3),
                "(BK, STAGES): (64, 6) or (128, 3)");
  static constexpr int kABytes = kBM * BK;
  static constexpr int kBBytes = BN * BK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  // wgmma groups left in flight across steps; copies run ahead by the
  // remaining STAGES - 1 - kInflight steps
  static constexpr int kInflight = BK == 64 ? 1 : 0;
  static constexpr int kAhead = STAGES - 1 - kInflight;
  static constexpr int kCStride = BN + 8;  // epilogue row, int32 elements
  static constexpr int kCBytes = kBM * kCStride * 4;
  static constexpr int kOriginOffset =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static constexpr uint64_t kMode =
      BK == 64 ? conv_tc::kSwizzle64 : conv_tc::kSwizzle128;
  static constexpr int kGroupBytes = 8 * BK;   // 8 rows: the SBO
};

// byte offset of byte `col` of row `row` in a slot of BK-byte rows
template <int BK>
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * BK + mma::swizzle<BK / 16>(row, col / 16) * 16 + col % 16;
}

// Copy VEC bytes from src to shared dst (zeros where !ok).
template <int VEC>
__device__ __forceinline__ void copy(unsigned char* dst, const int8_t* src,
                                     bool ok) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<int8_t*>(dst) = ok ? *src : int8_t(0);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<int16_t*>(dst) =
        ok ? *reinterpret_cast<const int16_t*>(src) : int16_t(0);
  } else {
    mma::cp_async<VEC>(mma::smem_addr(dst), src, ok);
  }
}

template <int BN, int BK, int STAGES, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    conv_i8_tc_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ wk,
                      const float* __restrict__ xs,
                      const float* __restrict__ ws, float* __restrict__ y,
                      ConvArgs a, int out_vec) {
  using T = Tile<BN, BK, STAGES>;
  using namespace mma;
  extern __shared__ __align__(1024) unsigned char conv_i8_smem_raw[];
  unsigned char* smem =
      conv_i8_smem_raw +
      ((1024 - (smem_addr(conv_i8_smem_raw) & 1023)) & 1023);
  int4* origin = reinterpret_cast<int4*>(smem + T::kOriginOffset);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int n_tiles = (a.o + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long k_row = static_cast<long long>(a.kh) * a.kw * a.c;

  conv_tc::block_origins<kBM, kThreads>(a, m0, origin);
  __syncthreads();

  const int c_steps = (a.c + BK - 1) / BK;
  const int k_steps = a.kh * a.kw * c_steps;

  // issue the copies of reduction step ks into ring slot `slot`
  auto load = [&](int ks, int slot) {
    if (ks >= k_steps) return;
    const int tap = ks / c_steps;
    const int c0 = (ks - tap * c_steps) * BK;
    const int dy = tap / a.kw, dx = tap - (tap / a.kw) * a.kw;
    unsigned char* as = smem + slot * T::kStageBytes;
    unsigned char* bs = as + T::kABytes;
    constexpr int kPerRow = BK / VEC;
#pragma unroll 4
    for (int e = tid; e < kBM * kPerRow; e += kThreads) {
      const int r = e / kPerRow, col = (e % kPerRow) * VEC;
      const int c = c0 + col;
      const int4 og = origin[r];
      const int iy = og.y + dy, ix = og.z + dx;
      const bool ok = og.x >= 0 && c < a.c && iy >= 0 && iy < a.h &&
                      ix >= 0 && ix < a.w;
      const int8_t* src =
          ok ? x + ((static_cast<long long>(og.x) * a.h + iy) * a.w + ix) *
                           a.c + c
             : x;
      copy<VEC>(as + swizzled<BK>(r, col), src, ok);
    }
#pragma unroll 4
    for (int e = tid; e < BN * kPerRow; e += kThreads) {
      const int r = e / kPerRow, col = (e % kPerRow) * VEC;
      const int c = c0 + col, n = n0 + r;
      const bool ok = c < a.c && n < a.o;
      const int8_t* src =
          ok ? wk + n * k_row + static_cast<long long>(tap) * a.c + c : wk;
      copy<VEC>(bs + swizzled<BK>(r, col), src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < T::kAhead; ++s) {
    load(s, s);
    cp_async_commit();
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int wg = warp / 4;   // this thread's warpgroup: rows 64 wg ..
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<T::kAhead - 1>();   // step ks has landed (this thread's)
    conv_tc::fence_proxy_async();
    // ... everyone's; and every warpgroup's wgmma of step
    // ks - 1 - kInflight retired, so its slot may be refilled
    __syncthreads();
    load(ks + T::kAhead, (ks + T::kAhead) % STAGES);
    cp_async_commit();
    const uint32_t a_base = smem_addr(smem + (ks % STAGES) * T::kStageBytes);
    const uint32_t b_base = a_base + T::kABytes;
    conv_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      // A: this warpgroup's 64 rows, B: BN rows; both K-major, 8-row
      // groups kGroupBytes apart, k32 steps 32 bytes along the row
      mma::wgmma_s8<BN>(acc,
                        desc(a_base + wg * 64 * BK + kk * 32, 0,
                             T::kGroupBytes, T::kMode),
                        desc(b_base + kk * 32, 0, T::kGroupBytes, T::kMode));
    conv_tc::wgmma_commit();
    conv_tc::wgmma_wait<T::kInflight>();
  }
  conv_tc::wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: stage the sums there

  // wgmma's fragment: warp w of the warpgroup holds rows 16 w + lane / 4
  // and + 8; for each 8 columns j, cols 8 j + 2 (lane % 4) and + 1
  int* cs = reinterpret_cast<int*>(smem);
  const int r = wg * 64 + (warp % 4) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<int2*>(cs + r * T::kCStride + col) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(cs + (r + 8) * T::kCStride + col) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int e = tid; e < kBM * (BN / 4); e += kThreads) {
    const int rr = e / (BN / 4), col = (e % (BN / 4)) * 4;
    const long long m = m0 + rr;
    const int n = n0 + col;
    if (m >= rows || n >= a.o) continue;
    const float row_scale = xs[origin[rr].x];
    const int4 s = *reinterpret_cast<const int4*>(cs + rr * T::kCStride +
                                                  col);
    float* dst = y + m * a.o + n;
    if (out_vec == 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(ws + n);
      *reinterpret_cast<float4*>(dst) = make_float4(
          gemm::dequant(s.x, row_scale, w4.x),
          gemm::dequant(s.y, row_scale, w4.y),
          gemm::dequant(s.z, row_scale, w4.z),
          gemm::dequant(s.w, row_scale, w4.w));
    } else {
      const int v[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && n + j < a.o; ++j)
        dst[j] = gemm::dequant(v[j], row_scale, ws[n + j]);
    }
  }
}

template <int BN, int BK, int STAGES, int VEC>
cudaError_t launch(const void* x, const void* wk, const void* xs,
                   const void* ws, void* y, const ConvArgs& a,
                   int out_vec, int smem, cudaStream_t s) {
  auto kernel = conv_i8_tc_kernel<BN, BK, STAGES, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const long long blocks = (rows + kBM - 1) / kBM * ((a.o + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(y), a, out_vec);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bk(const void* x, const void* wk, const void* xs,
                      const void* ws, void* y, const ConvArgs& a,
                      int bk, int stages, int vec, int out_vec, int smem,
                      cudaStream_t s) {
  // 128-channel steps only with 16-byte copies (C % 128 == 0)
  if (bk == 128 && stages == 3 && vec == 16)
    return launch<BN, 128, 3, 16>(x, wk, xs, ws, y, a, out_vec, smem, s);
  if (bk != 64 || stages != 6) return cudaErrorInvalidValue;
  switch (vec) {
    case 16: return launch<BN, 64, 6, 16>(x, wk, xs, ws, y, a, out_vec, smem, s);
    case 8: return launch<BN, 64, 6, 8>(x, wk, xs, ws, y, a, out_vec, smem, s);
    case 4: return launch<BN, 64, 6, 4>(x, wk, xs, ws, y, a, out_vec, smem, s);
    case 2: return launch<BN, 64, 6, 2>(x, wk, xs, ws, y, a, out_vec, smem, s);
    case 1: return launch<BN, 64, 6, 1>(x, wk, xs, ws, y, a, out_vec, smem, s);
  }
  return cudaErrorInvalidValue;
}

// The plan's instance, as conv_int8_plan() picks it: bn 64 or 128,
// (bk, stages) (64, 6) or (128, 3), vec 16, 8, 4, 2 or 1 bytes a copy,
// out_vec 4 or 1 f32 a store, smem its bytes.
inline cudaError_t conv2d_int8(const void* x, const void* wk, const void* xs,
                               const void* ws, void* y,
                               const ConvArgs& a, int bn, int bk,
                               int stages, int vec, int out_vec, int smem,
                               cudaStream_t s) {
  const uintptr_t align = static_cast<uintptr_t>(vec);
  if (vec < 1 || a.c % vec || reinterpret_cast<uintptr_t>(x) % align ||
      reinterpret_cast<uintptr_t>(wk) % align ||
      (out_vec != 1 && out_vec != 4) ||
      (out_vec == 4 && (a.o % 4 || reinterpret_cast<uintptr_t>(y) % 16 ||
                        reinterpret_cast<uintptr_t>(ws) % 16)) ||
      smem <= 0 || smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  if (bn == 64)
    return launch_bk<64>(x, wk, xs, ws, y, a, bk, stages, vec, out_vec, smem,
                         s);
  if (bn == 128)
    return launch_bk<128>(x, wk, xs, ws, y, a, bk, stages, vec, out_vec,
                          smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace conv_i8
}  // namespace zt
