// The f32 implicit-GEMM convolution on the tensor cores, as 3xTF32.
//
// Replaces, for f32: zoo_tpu/ops/pallas/conv.py, _conv_kernel (:114),
// launched by _conv2d_pallas (the pallas_call at :199) for conv2d (:221).
// The Pallas kernel multiplies f32 operands with f32 accumulation; this
// one comes within 3.0e-6 of the largest output of the plain f32 conv at
// ResNet-50's shapes (chip_smoke.py, phase 3, on an H100; the f32 gate
// is 1e-5, one TF32 product a term 2.7e-4 to 3.1e-4). The product
// is the bf16 route's implicit GEMM (conv2d_tc.cuh: rows are the N*OH*OW
// output pixels, columns the O output channels, the reduction runs over
// taps x C, tap-major, 32 channels a step), taken transposed, with each
// f32 operand split into two TF32 numbers.
//
// 3xTF32. One TF32 product keeps ~3 decimal digits, outside the f32
// route's tolerance. Each operand a is split once: hi = rna_tf32(a), lo =
// rna_tf32(a - hi), so a = hi + lo to within ~2^-22 |a|. The product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first); the dropped
// a_lo b_lo is ~2^-22 |a||b|. Each TF32 x TF32 product is exact in the
// tensor cores, but their f32 accumulation truncates; over one long
// chain (4608 terms at ResNet-50's 7x7 512 -> 512) the truncation biases
// the sum by ~4e-5 of the largest output, past the 1e-5 gate. So each
// 32-channel step's 12 products start from zero and the step's sum is
// added to an f32 accumulator by a rounding FADD: the chains are short
// and their truncation errors of either sign cancel (a model of both on
// the CPU: tests/test_torch_tc_plans.py).
//
// What bounds it on an H100: operations, at a third of the TF32 rate
// (495 TFLOP/s / 3 = 165 TFLOP/s effective; ResNet-50's 3x3 convs do
// ~570 flops a byte, its 1x1s at 56x56 ~50). The design:
// - wgmma.mma_async m64n128k8 (tf32 -> f32) on the transposed product
//   y^T = w^T x^T: the M side is 64 output channels a warpgroup, the N
//   side 128 output pixels, K 8 channels an instruction. TF32 wgmma reads
//   its shared-memory operand only K-major; the activation rows (C
//   contiguous, NHWC) are K-major as gathered, so the weights (O
//   contiguous, HWIO) take the register side (A), where the layout is
//   free: no transposed copy of either exists. (mma.sync, whose
//   fragments come from registers too, runs TF32 well below wgmma's
//   rate on Hopper; 3xTF32 on it did not reach the one cuDNN f32 call.)
// - Two warpgroups a block: 128 output channels x 128 pixels where
//   O > 64, 64 x 256 where O <= 64 (one O tile covers O, so the
//   activation is read once). The step's chains (64 floats a thread)
//   and the sums (64 more) stay in registers: one block an SM.
// - A ring of STAGES slots filled by cp.async (16-byte copies where C
//   and O are multiples of 4 and the pointers 16-byte aligned, else 4
//   bytes). Each pixel's window origin and element offset are computed
//   once a block (pixel_origins), so a copy costs an add and a bounds
//   test; the activation rows land as 128-byte rows in the 128-byte
//   swizzle wgmma reads, and a halo pixel, a row past M or a channel past
//   C is zero-filled by the copy's source size. Once a thread's copies of
//   a step have landed, it splits the activations it copied into a hi
//   tile (in place) and a lo tile beside it, 16 bytes at a time, so each
//   element is split once a block. The weight rows (BO + 8 floats: the
//   lanes' fragment loads fall in distinct banks) are split in registers
//   as each warp reads its 16 channels' fragments.
// - One block barrier a step. The step's products run while the next
//   step is split and its copies are issued (the ring runs STAGES - 2
//   steps ahead, so the slot being refilled is two steps old); then the
//   warpgroup waits for them and adds their chains to its sums.
// - The epilogue writes each thread's outputs from the fragments: 8
//   neighbouring output channels of a pixel are one 32-byte sector.
// conv_f32_plan() (ops/kernels/conv.py) counts the tile, the slots, the
// copy width and the shared memory (the ring, then 16 bytes of row
// origins a pixel, then 1024 bytes of slack to align the ring); the
// entry launches the instance compiled for them and checks the bytes
// only against the block limit.
#pragma once

#include "conv2d_tc.cuh"

namespace zt {
namespace conv_f32 {

constexpr int kBK = 32;                  // channels of one reduction step
constexpr int kThreads = 256;            // two warpgroups
constexpr int kRowBytes = kBK * 4;       // an activation row: 128 bytes
constexpr int kWgPixels = 128;           // the N side of a warpgroup

template <int BO>
struct Tile {
  static constexpr int WGO = BO / 64;            // warpgroups across O
  static constexpr int WGP = 2 / WGO;            // ... across pixels
  static constexpr int BP = kWgPixels * WGP;     // pixels
  static constexpr int LDW = BO + 8;             // floats a weight row takes
  static constexpr int X_BYTES = BP * kRowBytes; // an activation tile
  static constexpr int W_BYTES = kBK * LDW * 4;
  // activations (hi, lo), weights; a multiple of 1024 bytes
  static constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;
  static constexpr int STAGES = BO == 128 ? 4 : 3;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "slots on 1024-byte boundaries");
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds: the 13 low bits dropped after adding
// half of their unit to the magnitude
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d (+)= a * b: this warpgroup's 64 x 128 f32 fragment, A (64 x 8 TF32)
// from registers, B (8 x 128, K-major, 128-byte swizzle) from shared
// memory; accumulate = 0 starts from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Pixel r of the block's BP from p0: the input pixel (y, x) of its
// window's top-left tap (which may lie in the halo; y is -2^30 past the
// last pixel, so every tap of it reads as halo) and that pixel's element
// offset in x, 64 bits in (z, w); written to origin[r]
template <int BP>
__device__ __forceinline__ void pixel_origins(const ConvArgs& a, long long p0,
                                              int4* origin) {
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int hw = a.oh * a.ow;
  for (int r = threadIdx.x; r < BP; r += kThreads) {
    const long long m = p0 + r;
    int4 og = make_int4(-(1 << 30), 0, 0, 0);
    if (m < rows) {
      const int img = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - static_cast<long long>(img) * hw);
      const int oy = rem / a.ow, ox = rem - oy * a.ow;
      const int iy = oy * a.sh - a.ph, ix = ox * a.sw - a.pw;
      const long long off =
          ((static_cast<long long>(img) * a.h + iy) * a.w + ix) * a.c;
      og = make_int4(iy, ix, static_cast<int>(off & 0xffffffffLL),
                     static_cast<int>(off >> 32));
    }
    origin[r] = og;
  }
}

template <int BO, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    conv_f32_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       ConvArgs a) {
  using T = Tile<BO>;
  using namespace mma;
  using conv_tc::desc, conv_tc::fence_proxy_async, conv_tc::wgmma_commit,
      conv_tc::wgmma_fence, conv_tc::wgmma_wait_all;
  constexpr int BP = T::BP, LDW = T::LDW;
  constexpr int STAGES = T::STAGES;
  constexpr int kPerRow = kBK / VEC, kWPerRow = BO / VEC;
  constexpr int kXCopies = BP * kPerRow / kThreads;   // a thread's, a step
  constexpr int kWCopies = kBK * kWPerRow / kThreads;
  static_assert(kXCopies * kThreads == BP * kPerRow, "whole x copies");
  static_assert(kWCopies * kThreads == kBK * kWPerRow, "whole w copies");
  extern __shared__ __align__(1024) unsigned char f32_smem_raw[];
  unsigned char* smem =
      f32_smem_raw + ((1024 - (smem_addr(f32_smem_raw) & 1023)) & 1023);
  int4* origin = reinterpret_cast<int4*>(smem + T::RING_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int n_tiles = (a.o + BO - 1) / BO;
  const long long p0 = static_cast<long long>(blockIdx.x / n_tiles) * BP;
  const int o0 = (blockIdx.x % n_tiles) * BO;
  // this warpgroup's 64 output channels and 128 pixels of the block's
  const int wo = T::WGO == 2 ? 64 * wg : 0;
  const int wpx = T::WGP == 2 ? kWgPixels * wg : 0;

  pixel_origins<BP>(a, p0, origin);
  __syncthreads();

  const int c_steps = (a.c + kBK - 1) / kBK;
  const int k_steps = a.kh * a.kw * c_steps;

  // byte offset of channel col of activation row r in a swizzled tile
  auto x_at = [](int r, int col) {
    return r * kRowBytes + (((col >> 2) ^ (r & 7)) << 4) + (col & 3) * 4;
  };

  // issue the copies of reduction step ks into ring slot `slot`
  auto load = [&](int ks, int slot) {
    if (ks >= k_steps) return;
    const int tap = ks / c_steps;
    const int c0 = (ks - tap * c_steps) * kBK;
    const int dy = tap / a.kw, dx = tap - (tap / a.kw) * a.kw;
    const long long tap_off = static_cast<long long>(dy * a.w + dx) * a.c + c0;
    unsigned char* xs = smem + slot * T::STAGE_BYTES;
    float* ws = reinterpret_cast<float*>(xs + 2 * T::X_BYTES);
#pragma unroll 8
    for (int i = 0; i < kXCopies; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kPerRow, col = (e % kPerRow) * VEC;
      const int4 og = origin[r];
      const bool ok = static_cast<unsigned>(og.x + dy) <
                          static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(og.y + dx) <
                          static_cast<unsigned>(a.w) &&
                      c0 + col < a.c;
      const long long off =
          (static_cast<long long>(og.w) << 32 | static_cast<unsigned>(og.z)) +
          tap_off + col;
      cp_async<4 * VEC>(smem_addr(xs + x_at(r, col)), ok ? x + off : x, ok);
    }
    const float* wt = w + (static_cast<long long>(tap) * a.c + c0) * a.o + o0;
#pragma unroll 8
    for (int i = 0; i < kWCopies; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kWPerRow, col = (e % kWPerRow) * VEC;
      const bool ok = c0 + k < a.c && o0 + col < a.o;
      cp_async<4 * VEC>(smem_addr(ws + k * LDW + col),
                        ok ? wt + k * a.o + col : w, ok);
    }
  };

  // split the activations this thread copied into `slot`: TF32 hi in
  // place, lo in the tile beside it
  auto split_x = [&](int slot) {
    unsigned char* xs = smem + slot * T::STAGE_BYTES;
#pragma unroll 8
    for (int i = 0; i < kXCopies; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kPerRow, col = (e % kPerRow) * VEC;
      float* hi = reinterpret_cast<float*>(xs + x_at(r, col));
      float* lo = reinterpret_cast<float*>(xs + T::X_BYTES + x_at(r, col));
      if constexpr (VEC == 4) {   // a whole 16-byte unit: conflict-free
        const float4 v = *reinterpret_cast<const float4*>(hi);
        uint4 h, l;
        split(v.x, h.x, l.x);
        split(v.y, h.y, l.y);
        split(v.z, h.z, l.z);
        split(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi) = h;
        *reinterpret_cast<uint4*>(lo) = l;
      } else {
        uint32_t h, l;
        split(hi[0], h, l);
        hi[0] = __uint_as_float(h);
        lo[0] = __uint_as_float(l);
      }
    }
  };

  // STAGES - 2 steps in flight ahead of the one being split: the slot
  // the next copies fill was read by the products two steps back, which
  // every warpgroup has waited for by then
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    load(s, s);
    cp_async_commit();
  }

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // this thread's weight fragment rows: output channels wo + 16 (warp %
  // 4) + g and + 8 of the block's
  const int w_row = wo + 16 * (warp % 4) + g;
  for (int ks = 0; ks < k_steps; ++ks) {
    const int slot = ks % STAGES;
    cp_async_wait<STAGES - 3>();   // step ks has landed (this thread's part)
    split_x(slot);
    fence_proxy_async();           // the split tiles, to the async proxy
    __syncthreads();   // ... everyone's, split; the products of ks-2 are done
    load(ks + STAGES - 2, (ks + STAGES - 2) % STAGES);
    cp_async_commit();
    // the products of step ks-1 ran while this step was split and the
    // copies issued; their chains join the sums
    if (ks > 0) {
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    unsigned char* xs = smem + slot * T::STAGE_BYTES;
    const float* ws = reinterpret_cast<const float*>(xs + 2 * T::X_BYTES);
    // A fragments (weights^T) of the step's four 8-channel products:
    // (row g, channel t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float* wp = ws + (8 * kk + t) * LDW + w_row;
      split(wp[0], ah[kk][0], al[kk][0]);
      split(wp[8], ah[kk][1], al[kk][1]);
      split(wp[4 * LDW], ah[kk][2], al[kk][2]);
      split(wp[4 * LDW + 8], ah[kk][3], al[kk][3]);
    }
    // B: the warpgroup's 128 pixel rows, 8-row groups 1024 bytes apart,
    // each 8-channel product 32 bytes further along the rows
    const uint32_t xb = smem_addr(xs) + wpx * kRowBytes;
    const uint32_t xl = xb + T::X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_tf32(part, al[kk], desc(xb + 32 * kk, 0, 1024), kk > 0);
      wgmma_tf32(part, ah[kk], desc(xl + 32 * kk, 0, 1024), 1);
      wgmma_tf32(part, ah[kk], desc(xb + 32 * kk, 0, 1024), 1);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];
  cp_async_wait<0>();

  // wgmma's fragment: warp w % 4 of the warpgroup holds rows (output
  // channels) 16 (w % 4) + g and + 8; for each 8 columns (pixels) j,
  // columns 8 j + 2t and + 1
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long m = p0 + wpx + 8 * j + 2 * t + (e & 1);
      const int o = o0 + w_row + 8 * (e >> 1);
      if (m < rows && o < a.o) y[m * a.o + o] = acc[4 * j + e];
    }
  }
}

template <int BO, int VEC>
cudaError_t launch(const void* x, const void* w, void* y, const ConvArgs& a,
                   int smem, cudaStream_t s) {
  auto kernel = conv_f32_tc_kernel<BO, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const long long blocks =
      (rows + Tile<BO>::BP - 1) / Tile<BO>::BP * ((a.o + BO - 1) / BO);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), a);
  return cudaGetLastError();
}

// The plan's instance, as conv_f32_plan() picks it: bn (the O tile) 128
// with 4 ring slots or 64 with 3, vec 4 or 1 floats a copy, smem its
// bytes.
inline cudaError_t conv2d_f32(const void* x, const void* w, void* y,
                              const ConvArgs& a, int bn, int stages, int vec,
                              int smem, cudaStream_t s) {
  const uintptr_t align = 4 * static_cast<uintptr_t>(vec);
  if ((vec != 4 && vec != 1) || a.c % vec || a.o % vec ||
      reinterpret_cast<uintptr_t>(x) % align ||
      reinterpret_cast<uintptr_t>(w) % align || smem <= 0 ||
      smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  if (bn == 128 && stages == Tile<128>::STAGES)
    return vec == 4 ? launch<128, 4>(x, w, y, a, smem, s)
                    : launch<128, 1>(x, w, y, a, smem, s);
  if (bn == 64 && stages == Tile<64>::STAGES)
    return vec == 4 ? launch<64, 4>(x, w, y, a, smem, s)
                    : launch<64, 1>(x, w, y, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace conv_f32
}  // namespace zt
