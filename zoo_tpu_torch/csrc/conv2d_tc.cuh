// The bf16 implicit-GEMM convolution on the tensor cores (wgmma), and
// the argument block every conv kernel of conv2d.cu takes.
//
// Replaces, for bf16: zoo_tpu/ops/pallas/conv.py, _conv_kernel (:114),
// launched by _conv2d_pallas (the pallas_call at :199) for conv2d (:221).
// The Pallas kernel multiplies bf16 operands with f32 accumulation
// (preferred_element_type=f32, conv.py:121-124) and rounds the sum to
// bf16 once; so does this one. Only the order of the f32 sums differs.
//
// The product: rows are the N*OH*OW output pixels, columns the O output
// channels, the reduction runs over taps x C (tap-major, BK = 64
// channels a step). NHWC input, HWIO weights, so a weight row tap*C + c
// is contiguous over O.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes for
// ResNet-50's 1x1 convs at 56x56 (51 flop per byte), operations for
// its 3x3 ones (572 flop per byte at 28x28). The design:
// - wgmma.mma_async m64nNk16 (bf16 -> f32): one warpgroup (4 warps) per
//   64 rows of the block's 128 x BN output tile (BN = 64 or 128), both
//   operands read by the tensor cores from shared memory through matrix
//   descriptors, the sums in registers (BN / 2 floats a thread).
// - A ring of STAGES shared-memory slots (3 or 4) filled by cp.async, so
//   the copies of the next steps are in flight while step k is
//   multiplied; the block waits for its wgmma group before the barrier
//   that frees a slot.
// - A (activations) is gathered, VEC channels of one pixel per copy (16
//   bytes when C % 8 == 0): each row's image and window origin is
//   computed once per block into shared memory; a halo pixel, a row past
//   M or a channel past C is zero-filled by the copy's source size, so
//   SAME padding costs nothing and no padded copy or im2col buffer
//   exists. B (weights) is copied row by row, columns past O and rows
//   past C zero-filled. Where C, O or a pointer's alignment do not allow
//   16 bytes, the same template copies 8 or 4 bytes (cp.async) or 2
//   bytes (a plain load and store) at a time.
// - The slots hold the layouts wgmma reads with the 128-byte swizzle: A
//   K-major, 128-byte rows (64 channels) whose 16-byte chunk c of row r
//   sits at c ^ (r % 8); B MN-major, in atoms of 64 output channels x
//   BK rows, chunk c of row k at c ^ (k % 8). The slots start on
//   1024-byte boundaries, as the swizzle needs.
// - The epilogue rounds to bf16, stages the tile through the (drained)
//   ring and stores rows 16 bytes at a time; a ragged O edge is stored
//   element by element.
// - Blocks walk the N tiles of one M tile next to each other, so the
//   activation rows they share are read from device memory once and
//   then from L2. conv_plan() (ops/kernels/conv.py) picks BN, the stage
//   count, VEC and the shared-memory bytes (the ring or the epilogue tile,
//   whichever is larger, then 16 bytes of row origins per row, plus 1024
//   bytes of slack to align the ring); the entry takes them as they are,
//   checking the bytes only against the block limit.
// - At most 128 registers a thread (__launch_bounds__ with 2 blocks an
//   SM), so two blocks share an SM and the 196 tiles of ResNet-50's 7x7
//   convs are resident at once on 132 SMs.
#pragma once

#include "zt_mma.cuh"

namespace zt {

struct ConvArgs {
  int n, h, w, c;       // input, NHWC
  int kh, kw, o;        // weights, HWIO (kh, kw, c, o)
  int sh, sw, ph, pw;   // strides and leading pads
  int oh, ow;           // output spatial dims
};

namespace conv_tc {

using bf16 = __nv_bfloat16;

// ----------------------------------------------------------- wgmma

// Swizzle modes of a matrix descriptor (bits 62-63)
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2;

// Shared-memory matrix descriptor: start address, leading- and
// stride-dimension byte offsets (each >> 4), swizzle mode (128-byte by
// default; the int8 conv also reads 64-byte rows in the 64-byte one).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo,
                                         uint64_t mode = kSwizzle128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (this warpgroup's 64 x N f32 fragment) += A (64 x 16, K-major) *
// B (16 x N, MN-major: the trans-b flag is 1)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_n128(d, a, b);
  } else {
    static_assert(BN == 64, "BN: 64 or 128");
    wgmma_n64(d, a, b);
  }
}

// ----------------------------------------------------------- the kernel

constexpr int kBM = 128;                 // output rows of a block
constexpr int kBK = 64;                  // channels of one reduction step
constexpr int kThreads = 2 * kBM;        // a warpgroup per 64 rows
constexpr int kRowBytes = kBK * 2;       // an A row, a B atom row: 128 B

// Row r of the block's BM output rows from m0: its image (-1 past the
// last row) and the input pixel (y, x) of its window's top-left tap,
// which may lie in the halo; written to origin[r] by the THREADS threads.
template <int BM, int THREADS>
__device__ __forceinline__ void block_origins(const ConvArgs& a,
                                              long long m0, int4* origin) {
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int hw = a.oh * a.ow;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const long long m = m0 + r;
    int4 og = make_int4(-1, 0, 0, 0);
    if (m < rows) {
      const int img = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - static_cast<long long>(img) * hw);
      const int oy = rem / a.ow, ox = rem - oy * a.ow;
      og = make_int4(img, oy * a.sh - a.ph, ox * a.sw - a.pw, 0);
    }
    origin[r] = og;
  }
}

template <int BN, int STAGES>
struct Tile {
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = kBK * BN * 2;   // BN / 64 atoms
  static constexpr int kAtomBytes = kBK * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  static constexpr int kCStride = BN + 8;  // epilogue row, bf16 elements
  static constexpr int kCBytes = kBM * kCStride * 2;
  static constexpr int kOriginOffset =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
};

// Copy VEC bf16 from src to shared dst (zeros where !ok).
template <int VEC>
__device__ __forceinline__ void copy(unsigned char* dst, const bf16* src,
                                     bool ok) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<bf16*>(dst) = ok ? *src : __float2bfloat16_rn(0.f);
  } else {
    mma::cp_async<2 * VEC>(mma::smem_addr(dst), src, ok);
  }
}

template <int BN, int STAGES, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, ConvArgs a) {
  using T = Tile<BN, STAGES>;
  using namespace mma;
  extern __shared__ __align__(1024) unsigned char conv_smem_raw[];
  unsigned char* smem =
      conv_smem_raw + ((1024 - (smem_addr(conv_smem_raw) & 1023)) & 1023);
  int4* origin = reinterpret_cast<int4*>(smem + T::kOriginOffset);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const int n_tiles = (a.o + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;

  block_origins<kBM, kThreads>(a, m0, origin);
  __syncthreads();

  const int c_steps = (a.c + kBK - 1) / kBK;
  const int k_steps = a.kh * a.kw * c_steps;

  // issue the copies of reduction step ks into ring slot `slot`
  auto load = [&](int ks, int slot) {
    if (ks >= k_steps) return;
    const int tap = ks / c_steps;
    const int c0 = (ks - tap * c_steps) * kBK;
    const int dy = tap / a.kw, dx = tap - (tap / a.kw) * a.kw;
    unsigned char* as = smem + slot * T::kStageBytes;
    unsigned char* bs = as + T::kABytes;
    constexpr int kPerRow = kBK / VEC;
#pragma unroll 4
    for (int e = tid; e < kBM * kPerRow; e += kThreads) {
      const int r = e / kPerRow, col = (e % kPerRow) * VEC;
      const int c = c0 + col;
      const int4 og = origin[r];
      const int iy = og.y + dy, ix = og.z + dx;
      const bool ok = og.x >= 0 && c < a.c && iy >= 0 && iy < a.h &&
                      ix >= 0 && ix < a.w;
      const bf16* src =
          ok ? x + ((static_cast<long long>(og.x) * a.h + iy) * a.w + ix) *
                           a.c + c
             : x;
      copy<VEC>(as + r * kRowBytes + swizzle<8>(r, col / 8) * 16 +
                    (col % 8) * 2,
                src, ok);
    }
    constexpr int kBPerRow = BN / VEC;
#pragma unroll 4
    for (int e = tid; e < kBK * kBPerRow; e += kThreads) {
      const int k = e / kBPerRow, col = (e % kBPerRow) * VEC;
      const int c = c0 + k, n = n0 + col;
      const bool ok = c < a.c && n < a.o;
      const bf16* src =
          ok ? w + (static_cast<long long>(tap) * a.c + c) * a.o + n : w;
      copy<VEC>(bs + (col / 64) * T::kAtomBytes + k * kRowBytes +
                    swizzle<8>(k, (col % 64) / 8) * 16 + (col % 8) * 2,
                src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  const int wg = warp / 4;   // this thread's warpgroup: rows 64 wg ..
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<STAGES - 2>();   // step ks has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();   // ... everyone's; the wgmma of step ks-1 retired
    load(ks + STAGES - 1, (ks + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t a_base = smem_addr(smem + (ks % STAGES) * T::kStageBytes);
    const uint32_t b_base = a_base + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      // A: 8-row groups 1024 B apart; B: 16 rows of 128 B per k16 step,
      // 8-row groups 1024 B apart, 64-column atoms kAtomBytes apart
      wgmma<BN>(acc, desc(a_base + wg * 64 * kRowBytes + kk * 32, 0, 1024),
                desc(b_base + kk * 16 * kRowBytes, T::kAtomBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: stage the output tile there

  // wgmma's fragment: warp w of the warpgroup holds rows 16 w + lane / 4
  // and + 8; for each 8 columns j, cols 8 j + 2 (lane % 4) and + 1
  bf16* cs = reinterpret_cast<bf16*>(smem);
  const int r = wg * 64 + (warp % 4) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(cs + r * T::kCStride + col) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(cs + (r + 8) * T::kCStride + col) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const bool whole_rows = a.o % 8 == 0;
  for (int e = tid; e < kBM * (BN / 8); e += kThreads) {
    const int rr = e / (BN / 8), col = (e % (BN / 8)) * 8;
    const long long m = m0 + rr;
    const int n = n0 + col;
    if (m >= rows || n >= a.o) continue;
    const bf16* src = cs + rr * T::kCStride + col;
    bf16* dst = y + m * a.o + n;
    if (whole_rows) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n + j < a.o; ++j) dst[j] = src[j];
    }
  }
}

template <int BN, int STAGES, int VEC>
cudaError_t launch(const void* x, const void* w, void* y, const ConvArgs& a,
                   int smem, cudaStream_t s) {
  auto kernel = conv_tc_kernel<BN, STAGES, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.n) * a.oh * a.ow;
  const long long blocks = (rows + kBM - 1) / kBM * ((a.o + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), a);
  return cudaGetLastError();
}

template <int BN, int STAGES>
cudaError_t launch_vec(const void* x, const void* w, void* y,
                       const ConvArgs& a, int vec, int smem, cudaStream_t s) {
  switch (vec) {
    case 8: return launch<BN, STAGES, 8>(x, w, y, a, smem, s);
    case 4: return launch<BN, STAGES, 4>(x, w, y, a, smem, s);
    case 2: return launch<BN, STAGES, 2>(x, w, y, a, smem, s);
    case 1: return launch<BN, STAGES, 1>(x, w, y, a, smem, s);
  }
  return cudaErrorInvalidValue;
}

// The plan's instance, as conv_plan() picks it: (bn, stages) is (64, 4)
// or (128, 3), vec 8, 4, 2 or 1 channels a copy, smem its bytes.
inline cudaError_t conv2d_bf16(const void* x, const void* w, void* y,
                               const ConvArgs& a, int bn, int stages,
                               int vec, int smem, cudaStream_t s) {
  const uintptr_t align = 2 * static_cast<uintptr_t>(vec);
  if (vec < 1 || a.c % vec || a.o % vec ||
      reinterpret_cast<uintptr_t>(x) % align ||
      reinterpret_cast<uintptr_t>(w) % align ||
      reinterpret_cast<uintptr_t>(y) % 16 || smem <= 0 ||
      smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  if (bn == 64 && stages == 4)
    return launch_vec<64, 4>(x, w, y, a, vec, smem, s);
  if (bn == 128 && stages == 3)
    return launch_vec<128, 3>(x, w, y, a, vec, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace conv_tc
}  // namespace zt
