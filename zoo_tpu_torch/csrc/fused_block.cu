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
// VMEM on the MXU; an H100 block has at most 227 KB of shared memory, so
// the kernel tiles over space: one block of 8 warps per (image, TH x TW
// output tile), as large as shared memory allows (plan() in
// ops/kernels/fused_block.py picks it: 14x14 at conv2_x and conv3_x,
// 7x14 at conv4_x, the whole 7x7 image at conv5_x). The three products
// run on the tensor cores, mma.sync.m16n8k16 bf16 -> f32 with operands
// from ldmatrix, each warp on a 32 x 64 output tile:
//  1. reduce: t1 on the (TH+2) x (TW+2) halo pixels, K = Cin in 64-wide
//     slices of x. Pixels outside the image are zero-filled by the copy
//     (cp.async with source size 0), so their t1 rows come out relu(0) =
//     0: the SAME halo costs nothing.
//  2. 3x3: t2 on the tile, K = 9 taps x Cmid. ldmatrix takes one row
//     address per lane, so the A rows of a tap are the shifted window of
//     the t1 plane, gathered in place with no copy per tap.
//  3. expand: z3 = t2 @ w3 in column chunks; each chunk goes through a
//     shared staging tile so the residual x is read and y written with
//     16-byte accesses, once, and only for pixels inside the image.
// t1 and t2 stay in shared memory in rows of Cmid bf16 stored with the
// 16-byte XOR swizzle of zt_mma.cuh, so neither ldmatrix nor the
// epilogue's stores conflict. The x slices and the w1, w2 and w3 slices
// stream through one cp.async ring of 2-3 slots, 16 bytes a copy; the
// items of the three products (a k-slice of a pass over a row band and
// a column chunk) run as one sequence, so the next product's weights
// are in flight while the previous one finishes. The f32-x route loads
// x through registers and rounds it there. The halo is recomputed by
// neighbouring tiles: (TH+2)(TW+2)/(TH*TW) of the reduce GEMM (1.31 at
// 14x14). mma.sync, not wgmma: the 3x3's windows have no fixed
// core-matrix stride a wgmma descriptor could name.
//
// Rounding as the plain version rounds. Each 16-deep product leaves the
// tensor cores from zero and is added to the f32 sum with IEEE
// round-to-nearest (their own accumulation truncates). The reduce's sums
// also meet the plain version's f32 GEMM, which sums a t1 element as a
// chain over k in order: a t1 sum within a few f32 rounding steps of a
// bf16 rounding boundary is recomputed as that chain (near_tie,
// fix_ties). Without it, at conv4_x and conv5_x, fewer than 0.999 of
// the outputs equal the plain version's bit for bit (chip_smoke.py
// phase 3 holds each stage to that share).
//
// What holds it back (a clock64() timeline of one block, conv2_x): one
// block of 8 warps an SM (the plan takes up to 224 KB of shared memory
// and 255 registers a thread), so every item's barrier, copy issue and
// epilogue is on the critical path; the epilogues are long unrolled
// store loops; the expand epilogue waits for its residual x; the
// fix-up's chains are serial, one thread each; then mma.sync itself.
//
// The plan (tile, warps across N in each product, ring slots, shared
// memory) is counted by plan() and passed here; the entry lays shared
// memory out from it and checks the bytes against the plan and the
// 227 KB a block may use. Cmid arrives padded to 16, 32 or a multiple of
// 64 (the wrapper pads the weights with zeros), Cin a multiple of 8.
#include "zt_mma.cuh"

namespace zt {
namespace block {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMT = 2, kNT = 8;   // a warp's tile: 2 m16 x 8 n8 = 32 x 64
constexpr int kKB1 = 64;          // x channels in a reduce k-slice
// 16-byte units of y a thread writes in an expand pass: a pass covers
// band x chunk = (32 x 8 / wn) x (64 wn) outputs, 2048 units
constexpr int kYUnits = 32 * kWarps * 64 / 8 / kThreads;

struct Args {
  int b, h, w, cin, cmid;   // cmid padded
  int th, tw, tiles_x;
  int p, p1;                // pixels of a tile, of its halo
  int kb;                   // depth of a 3x3 / expand k-slice
  int u1;                   // 16-byte units in a t1 / t2 row
  int stages, stage_bytes;
  int t1_off, t2_off;       // t1 (and the expand's staging tile), t2
  int tab_off;              // the tile's pixel tables
  int ties_off, ties_cap;   // the reduce's near-tie list in t2's region
  int wn[3];                // warps across N, per product
  int kitems[3];            // k-slices of a pass
  int chunks[3];            // column chunks of a pass
  int bands[3];             // row bands of a product
  int total;                // items of the three products
};

// v[ph] by selects: a dynamic index into the kernel's argument would
// copy it to local memory
__device__ __forceinline__ int pick(const int (&v)[3], int ph) {
  return ph == 0 ? v[0] : ph == 1 ? v[1] : v[2];
}

// An item: k-slice ks of the pass over row band rb and column chunk cc of
// product ph, walked in that order (ks fastest) with no division.
struct Cursor {
  int ph = 0, ks = 0, rb = 0, cc = 0;
  __device__ __forceinline__ void next(const Args& a) {
    if (++ks < pick(a.kitems, ph)) return;
    ks = 0;
    if (++cc < pick(a.chunks, ph)) return;
    cc = 0;
    if (++rb < pick(a.bands, ph)) return;
    rb = 0;
    ++ph;
  }
  __device__ __forceinline__ int wn(const Args& a) const {
    return pick(a.wn, ph);
  }
  __device__ __forceinline__ int band0(const Args& a) const {
    return rb * (32 * kWarps / wn(a));
  }
  __device__ __forceinline__ int n0(const Args& a) const {
    return cc * 64 * wn(a);
  }
  __device__ __forceinline__ bool last(const Args& a) const {
    return ks == pick(a.kitems, ph) - 1;
  }
};

// physical 16-byte unit of unit u in a t1 / t2 row of U units (2, 4 or a
// multiple of 8): zt_mma.cuh's swizzle with U at run time
__device__ __forceinline__ int swz(int row, int u, int U) {
  return U >= 8 ? u ^ (row & 7) : U == 4 ? u ^ ((row >> 1) & 3)
                                         : u ^ ((row >> 2) & 1);
}

// eight channels of x into a 16-byte unit of shared memory as bf16
__device__ __forceinline__ void stage_x8(unsigned char* dst, const bf16* src,
                                         bool ok) {
  cp_async<16>(smem_addr(dst), src, ok);
}
__device__ __forceinline__ void stage_x8(unsigned char* dst,
                                         const float* src, bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                   pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// eight channels of x, loaded ahead of their use
template <typename T>
struct X8 {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ X8<T> load_x8(const T* x) {
  X8<T> r;
#pragma unroll
  for (int j = 0; j < static_cast<int>(sizeof(T)) / 2; ++j)
    r.v[j] = reinterpret_cast<const uint4*>(x)[j];
  return r;
}

// y = bf16(relu(z3 + bf16(x))) for eight channels
__device__ __forceinline__ void residual8(bf16* y, const X8<bf16>& xr,
                                          const uint4& z) {
  const uint4 xv = xr.v[0];
  const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&z);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 zf = __bfloat1622float2(zp[j]);
    const float2 xf = __bfloat1622float2(xp[j]);
    o[j] = pack_bf16(fmaxf(zf.x + xf.x, 0.f), fmaxf(zf.y + xf.y, 0.f));
  }
  *reinterpret_cast<uint4*>(y) = make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void residual8(float* y, const X8<float>& xr,
                                          const uint4& z) {
  const float4 lo = *reinterpret_cast<const float4*>(&xr.v[0]);
  const float4 hi = *reinterpret_cast<const float4*>(&xr.v[1]);
  const float xs[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&z);
  float o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 zf = __bfloat1622float2(zp[j]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xb = __bfloat162float(__float2bfloat16_rn(xs[2 * j + e]));
      o[2 * j + e] = __bfloat162float(
          __float2bfloat16_rn(fmaxf((e ? zf.y : zf.x) + xb, 0.f)));
    }
  }
  reinterpret_cast<float4*>(y)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// rows k0 .. k0+rows-1 and columns n0 .. n0 + 8 cu - 1 of the row-major
// bf16 weights w (ld elements a row) into a B slice (cu = 2**lcu units a
// row, swizzled); outside k_valid x n_valid it is zero
__device__ __forceinline__ void stage_b(unsigned char* dst, const bf16* w,
                                       int ld, int k0, int k_valid, int n0,
                                       int n_valid, int rows, int lcu) {
  for (int e = threadIdx.x; e < rows << lcu; e += kThreads) {
    const int r = e >> lcu, u = e & ((1 << lcu) - 1);
    const int k = k0 + r, n = n0 + u * 8;
    const bool ok = k < k_valid && n < n_valid;
    cp_async<16>(smem_addr(dst + (((r << lcu) + (u ^ (r & 7))) << 4)),
                 ok ? w + static_cast<size_t>(k) * ld + n : w, ok);
  }
}

__device__ __forceinline__ int log2_wn(int wn) {
  return wn == 1 ? 0 : wn == 2 ? 1 : wn == 4 ? 2 : 3;
}

// the copies of item `c` into `slot`; hpix maps a halo pixel to its
// pixel in x, or -1 outside the image
template <typename T>
__device__ __forceinline__ void load_item(const Args& a, const Cursor& c,
                                          const T* x, const bf16* w1,
                                          const bf16* w2, const bf16* w3,
                                          const int* hpix,
                                          unsigned char* slot) {
  const int wn = c.wn(a), lcu = 3 + log2_wn(wn), n0 = c.n0(a);
  if (c.ph == 0) {
    // A: halo pixels band0 .. band0 + band - 1, channels c0 .. c0 + 63
    const int band = 32 * kWarps / wn, band0 = c.band0(a);
    const int c0 = c.ks * kKB1;
    for (int e = threadIdx.x; e < band * 8; e += kThreads) {
      const int r = e >> 3, u = e & 7;
      const int hp = band0 + r, ch = c0 + u * 8;
      const int pix = hp < a.p1 ? hpix[hp] : -1;
      const bool ok = pix >= 0 && ch < a.cin;
      stage_x8(slot + r * 128 + ((u ^ (r & 7)) << 4),
               x + (ok ? static_cast<size_t>(pix) * a.cin + ch : 0), ok);
    }
    stage_b(slot + band * 128, w1, a.cmid, c0, a.cin, n0, a.cmid, kKB1, lcu);
  } else if (c.ph == 1) {
    const int per_tap = a.cmid / a.kb;
    const int tap = c.ks / per_tap, k0 = (c.ks - tap * per_tap) * a.kb;
    stage_b(slot, w2 + static_cast<size_t>(tap) * a.cmid * a.cmid, a.cmid,
            k0, a.cmid, n0, a.cmid, a.kb, lcu);
  } else {
    stage_b(slot, w3, a.cin, c.ks * a.kb, a.cmid, n0, a.cin, a.kb, lcu);
  }
}

// d = a * b on the tensor cores, bf16 operands, f32 result (C = 0)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// this warp's 32 x 64 tile of one k-slice on the tensor cores, added to
// sum; tbase maps an output pixel to its top-left tap's row of t1. The
// tensor cores' f32 accumulation truncates, so each 16-deep product
// starts from zero and is added to sum with IEEE round-to-nearest: the
// long reductions (K up to 9 x 512) round as an f32 sum does.
__device__ __forceinline__ void mma_item(const Args& a, const Cursor& c,
                                         const unsigned char* slot,
                                         const unsigned char* t1,
                                         const unsigned char* t2,
                                         const int* tbase, int row0, int wnx,
                                         int lane,
                                         float (&sum)[kMT][kNT][4]) {
  const int wn = c.wn(a), band0 = c.band0(a);
  const unsigned char* bsl = c.ph == 0 ? slot + 32 * kWarps / wn * 128 : slot;
  const int lcu = 3 + log2_wn(wn);
  const int ksteps = c.ph == 0 ? kKB1 / 16 : a.kb / 16;
  // the A row this lane addresses in each m16 tile, and the first unit
  int arow[kMT];
  const unsigned char* abase = c.ph == 0 ? slot : c.ph == 1 ? t1 : t2;
  int u0 = 0, U = 8, rbytes = 128;
  if (c.ph == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      arow[mt] = row0 - band0 + mt * 16 + (lane & 15);
  } else {
    U = a.u1;
    rbytes = a.u1 * 16;
    if (c.ph == 1) {
      const int per_tap = a.cmid / a.kb;
      const int tap = c.ks / per_tap;
      const int dy = tap / 3, dx = tap - dy * 3;
      u0 = (c.ks - tap * per_tap) * a.kb / 8;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int pp = row0 + mt * 16 + (lane & 15);
        // rows past the tile: any valid row
        arow[mt] = (pp < a.p ? tbase[pp] : 0) + dy * (a.tw + 2) + dx;
      }
    } else {
      u0 = c.ks * a.kb / 8;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        arow[mt] = row0 + mt * 16 + (lane & 15);
    }
  }
  const int wu = wnx * 8;   // this warp's first 16-byte unit of the chunk
#pragma unroll 1
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int u = u0 + kk * 2 + (lane >> 4);
      ldmatrix_x4(af[mt], smem_addr(abase + arow[mt] * rbytes +
                                    (swz(arow[mt], u, U) << 4)));
    }
    const int krow = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      const int u = wu + np * 2 + (lane >> 4);
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, smem_addr(bsl + (((krow << lcu) + (u ^ (krow & 7))) << 4)));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4];
          mma_bf16_zero(d, af[mt], bf[2 * h], bf[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mt][2 * np + h][e] += d[e];
        }
    }
  }
}

// The reduce's f32 sums as the plain version's f32 GEMM rounds them.
// That GEMM sums each t1 element as a chain over k = 0 .. Cin-1 (each
// product exact, one rounding an add), which the tensor cores' sums do
// not reproduce; a t1 element rounded to the other bf16 neighbour moves
// every channel of t2 at nine pixels, and with them y. So a t1 sum that
// lies within `bound` of a bf16 rounding boundary (a midpoint between
// neighbours, or 0 for the ReLU) is recomputed as that chain. `bound`,
// 2**-22 ||x_row|| ||w1_col||, is at least four f32 rounding steps of
// sum |x_k w_k| (Cauchy-Schwarz): the chain's own error stayed under two
// of them, and the tensor cores' sum is as close to the exact one.
__device__ __forceinline__ bool near_tie(float v, float bound) {
  if (fabsf(v) < bound) return true;
  if (v <= 0.f) return false;
  const uint32_t u = __float_as_uint(v);
  const float ulp = __uint_as_float(u & 0x7f800000u) * 0x1p-23f;
  return fabsf(static_cast<float>(static_cast<int>(u & 0xffffu) - 0x8000)) *
             ulp < bound;
}

// acc + the products of 8 bf16 pairs, in order, one rounding an add
__device__ __forceinline__ float chain8(float acc, const uint4& xv,
                                        const uint4& wv) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 xf = __bfloat1622float2(xp[j]);
    const float2 wf = __bfloat1622float2(wp[j]);
    acc = fmaf(xf.x, wf.x, acc);
    acc = fmaf(xf.y, wf.y, acc);
  }
  return acc;
}

__device__ __forceinline__ uint4 x8_bf16(const bf16* x) {
  return *reinterpret_cast<const uint4*>(x);
}
__device__ __forceinline__ uint4 x8_bf16(const float* x) {
  const float4 lo = reinterpret_cast<const float4*>(x)[0];
  const float4 hi = reinterpret_cast<const float4*>(x)[1];
  return make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                    pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

// 64 channels of x and w a chain step takes
constexpr int kChainUnits = 8;

template <typename T>
__device__ __forceinline__ void chain_load(const T* x, const bf16* w, int k,
                                           int n, uint4 (&xv)[kChainUnits],
                                           uint4 (&wv)[kChainUnits]) {
#pragma unroll
  for (int j = 0; j < kChainUnits; ++j) {
    if (k + 8 * j < n) {
      xv[j] = x8_bf16(x + k + 8 * j);
      wv[j] = *reinterpret_cast<const uint4*>(w + k + 8 * j);
    }
  }
}

template <typename T>
__device__ __forceinline__ float chain_step(float acc, int k, int n,
                                            const uint4 (&xv)[kChainUnits],
                                            const uint4 (&wv)[kChainUnits]) {
#pragma unroll
  for (int j = 0; j < kChainUnits; ++j)
    if (k + 8 * j < n) acc = chain8(acc, xv[j], wv[j]);
  return acc;
}

// sum over k < n of bf16(x[k]) * w[k], in order (n a multiple of 8); a
// step's 64 channels are all loaded before their products
template <typename T>
__device__ __forceinline__ float chain_row(const T* x, const bf16* w, int n) {
  float acc = 0.f;
  for (int k = 0; k < n; k += 8 * kChainUnits) {
    uint4 xv[kChainUnits], wv[kChainUnits];
    chain_load(x, w, k, n, xv, wv);
    acc = chain_step<T>(acc, k, n, xv, wv);
  }
  return acc;
}

// The n near ties of the reduce, as the chains the plain version sums,
// into t1 (a tie past the list's room keeps the tensor cores' sum).
template <typename T>
__device__ __forceinline__ void fix_ties(const Args& a, const T* x,
                                      const bf16* w1t, const int* hpix,
                                      const int* ties, int n,
                                      unsigned char* t1) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int e = ties[j];
    const int r = e / a.cmid, col = e - r * a.cmid;
    const float v = chain_row(x + static_cast<size_t>(hpix[r]) * a.cin,
                              w1t + static_cast<size_t>(col) * a.cin, a.cin);
    *reinterpret_cast<bf16*>(t1 + r * a.u1 * 16 +
                             (swz(r, col >> 3, a.u1) << 4) + (col & 7) * 2) =
        __float2bfloat16_rn(fmaxf(v, 0.f));
  }
}

// y of an expand pass: z3 (bf16) in the staging tile at stg, rows band0
// .., columns n0 .. n0 + 64 wn - 1; opix maps an output pixel to its
// pixel of y, -1 past a ragged edge. A pass is 2048 units of 8 channels,
// 8 a thread: their x loads are all issued before any is used.
template <typename T>
__device__ __forceinline__ void expand_out(const Args& a, const T* x, T* y,
                                        const int* opix, int band0, int n0,
                                        int wn, const unsigned char* stg) {
  const int lcu = 3 + log2_wn(wn);
  const int sstride = 64 * wn * 2 + 16;
  int pix[kYUnits], ch[kYUnits];
  X8<T> xs[kYUnits];
#pragma unroll
  for (int j = 0; j < kYUnits; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int pp = band0 + (e >> lcu);
    ch[j] = n0 + (e & ((1 << lcu) - 1)) * 8;
    // pixels past the tile or a ragged tile's image edge: no y
    pix[j] = pp < a.p && ch[j] < a.cin ? opix[pp] : -1;
    if (pix[j] >= 0)
      xs[j] = load_x8(x + static_cast<size_t>(pix[j]) * a.cin + ch[j]);
  }
  __syncthreads();   // the staging tile is whole
#pragma unroll
  for (int j = 0; j < kYUnits; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (pix[j] >= 0)
      residual8(y + static_cast<size_t>(pix[j]) * a.cin + ch[j], xs[j],
                *reinterpret_cast<const uint4*>(
                    stg + (e >> lcu) * sstride +
                    ((e & ((1 << lcu) - 1)) << 4)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bottleneck_kernel(const T* __restrict__ x,
                            const bf16* __restrict__ w1,
                            const bf16* __restrict__ w2,
                            const bf16* __restrict__ w3,
                            const bf16* __restrict__ w1t,
                            const float* __restrict__ w1n,
                            T* __restrict__ y, Args a) {
  extern __shared__ __align__(128) unsigned char block_smem[];
  unsigned char* t1 = block_smem + a.t1_off;
  unsigned char* t2 = block_smem + a.t2_off;
  // the tile's pixel tables: halo pixel -> pixel of x (-1 outside the
  // image), output pixel -> pixel of y (-1 past a ragged edge), output
  // pixel -> its top-left tap's row of t1
  int* hpix = reinterpret_cast<int*>(block_smem + a.tab_off);
  int* opix = hpix + a.p1;
  int* tbase = opix + a.p;
  // until the 3x3 writes t2, its region holds the reduce's fix-up state:
  // a count, the halo rows' norms ||bf16(x)||, the near ties found
  int* n_ties = reinterpret_cast<int*>(t2);
  float* xn = reinterpret_cast<float*>(t2 + 16);
  int* ties = reinterpret_cast<int*>(t2 + a.ties_off);
  const int img = blockIdx.y;
  const int tile_y = blockIdx.x / a.tiles_x;
  const int tile_x = blockIdx.x - tile_y * a.tiles_x;
  const int y0 = tile_y * a.th, x0 = tile_x * a.tw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb1 = a.u1 * 16;

  for (int e = threadIdx.x; e < a.p1; e += kThreads) {
    const int hy = e / (a.tw + 2), hx = e - hy * (a.tw + 2);
    const int iy = y0 - 1 + hy, ix = x0 - 1 + hx;
    hpix[e] = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w
                  ? (img * a.h + iy) * a.w + ix
                  : -1;
  }
  for (int e = threadIdx.x; e < a.p; e += kThreads) {
    const int py = e / a.tw, px = e - py * a.tw;
    const int iy = y0 + py, ix = x0 + px;
    opix[e] = iy < a.h && ix < a.w ? (img * a.h + iy) * a.w + ix : -1;
    tbase[e] = py * (a.tw + 2) + px;
  }
  if (threadIdx.x == 0) *n_ties = 0;
  __syncthreads();

  Cursor ld;   // the next item to load
  for (int s = 0; s < a.stages - 1; ++s, ld.next(a)) {
    if (s < a.total)
      load_item(a, ld, x, w1, w2, w3, hpix, block_smem + s * a.stage_bytes);
    cp_async_commit();
  }
  float sum[kMT][kNT][4];
  float xsq = 0.f;   // ||bf16(x)||^2 of this thread's halo row (reduce)
  Cursor c;          // the item computed
  for (int i = 0; i < a.total; ++i, c.next(a), ld.next(a)) {
    if (a.stages == 2) {
      cp_async_wait<0>();
    } else if (a.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<2>();
    }
    __syncthreads();   // item i landed; item i - 1's slot is free
    const int nx = i + a.stages - 1;
    if (nx < a.total)
      load_item(a, ld, x, w1, w2, w3, hpix,
                block_smem + (nx % a.stages) * a.stage_bytes);
    cp_async_commit();

    const unsigned char* slot = block_smem + (i % a.stages) * a.stage_bytes;
    const bool last = c.last(a);
    const int wn = c.wn(a), band = 32 * kWarps / wn, band0 = c.band0(a);
    const int n0 = c.n0(a);
    if (c.ph == 0 && c.cc == 0 && threadIdx.x < band) {
      // the norms of the band's x rows, in the first column chunk
      const int r = threadIdx.x;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            slot + r * 128 + ((u ^ (r & 7)) << 4));
        const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(vp[j]);
          xsq = fmaf(f.x, f.x, fmaf(f.y, f.y, xsq));
        }
      }
      if (last) {
        if (band0 + r < a.p1) xn[band0 + r] = sqrtf(xsq);
        xsq = 0.f;
      }
    }
    const int wnx = warp & (wn - 1);
    const int row0 = band0 + (warp / wn) * 32;
    const int m_rows = c.ph == 0 ? a.p1 : a.p;
    const bool active = row0 < m_rows;
    if (active) {
      if (c.ks == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
      }
      mma_item(a, c, slot, t1, t2, tbase, row0, wnx, lane, sum);
    }
    if (!last) continue;

    // the pass's epilogue
    const int chunk = 64 * wn;
    const int sstride = chunk * 2 + 16;   // the expand's staging rows
    if (c.ph == 0) __syncthreads();       // the band's row norms
    if (active) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + mt * 16 + g + 8 * hf;
            const int cl = wnx * 64 + nt * 8 + 2 * t;   // in the chunk
            const int col = n0 + cl;
            const float v0 = sum[mt][nt][2 * hf];
            const float v1 = sum[mt][nt][2 * hf + 1];
            if (c.ph == 2) {
              *reinterpret_cast<uint32_t*>(t1 + (r - band0) * sstride +
                                           cl * 2) = pack_bf16(v0, v1);
            } else if (r < m_rows && col < a.cmid) {
              unsigned char* dst = c.ph == 0 ? t1 : t2;
              *reinterpret_cast<uint32_t*>(
                  dst + r * rb1 + (swz(r, col >> 3, a.u1) << 4) +
                  (col & 7) * 2) = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
              if (c.ph == 0) {
                const float xr = 0x1p-22f * xn[r];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (near_tie(e ? v1 : v0, xr * w1n[col + e])) {
                    const int k = atomicAdd(n_ties, 1);
                    if (k < a.ties_cap) ties[k] = r * a.cmid + col + e;
                  }
                }
              }
            }
          }
    }
    if (c.ph == 0 && c.rb == pick(a.bands, 0) - 1 &&
        c.cc == pick(a.chunks, 0) - 1) {
      // the reduce is done: its near ties as the plain version sums them
      __syncthreads();
      fix_ties(a, x, w1t, hpix, ties, min(*n_ties, a.ties_cap), t1);
    }
    if (c.ph == 2) expand_out(a, x, y, opix, band0, n0, wn, t1);
  }
  cp_async_wait<0>();
}

// the layout of a plan, as plan() in ops/kernels/fused_block.py counts it;
// returns the shared memory it needs, or -1 if the plan is malformed
inline int layout(Args& a, int wn1, int wn2, int wn3) {
  const int wns[3] = {wn1, wn2, wn3};
  const int m[3] = {a.p1, a.p, a.p}, n[3] = {a.cmid, a.cmid, a.cin};
  a.kb = a.cmid < 64 ? a.cmid : 64;
  a.u1 = a.cmid / 8;
  a.kitems[0] = (a.cin + kKB1 - 1) / kKB1;
  a.kitems[1] = 9 * (a.cmid / a.kb);
  a.kitems[2] = a.cmid / a.kb;
  a.stage_bytes = 0;
  a.total = 0;
  int staging = 0;
  for (int ph = 0; ph < 3; ++ph) {
    const int wn = wns[ph];
    if (wn != 1 && wn != 2 && wn != 4 && wn != 8) return -1;
    const int band = 32 * (kWarps / wn), chunk = 64 * wn;
    a.wn[ph] = wn;
    a.chunks[ph] = (n[ph] + chunk - 1) / chunk;
    a.bands[ph] = (m[ph] + band - 1) / band;
    a.total += a.bands[ph] * a.chunks[ph] * a.kitems[ph];
    const int bytes = ph == 0 ? band * 128 + kKB1 * chunk * 2
                              : a.kb * chunk * 2;
    if (bytes > a.stage_bytes) a.stage_bytes = bytes;
    if (ph == 2) staging = band * (chunk * 2 + 16);
  }
  const int t1 = a.p1 * a.cmid * 2;
  // t2, or before it the reduce's fix-up state: a count, the halo rows'
  // norms and a list of at least 256 near ties
  a.ties_off = 16 + (a.p1 * 4 + 15) / 16 * 16;
  int t2 = (a.p + 31) / 32 * 32 * a.cmid * 2;
  if (t2 < a.ties_off + 4 * 256) t2 = a.ties_off + 4 * 256;
  a.ties_cap = (t2 - a.ties_off) / 4;
  a.t1_off = a.stages * a.stage_bytes;
  a.t2_off = a.t1_off + (t1 > staging ? t1 : staging);
  a.tab_off = a.t2_off + t2;
  return a.tab_off + ((a.p1 + 2 * a.p) * 4 + 15) / 16 * 16;
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const void* w1t, const float* w1n, void* y, const Args& a,
           int tiles, int smem, cudaStream_t s) {
  auto kernel = fused_bottleneck_kernel<T>;
  static int opted = 0;   // bytes this instance was opted in to
  if (smem > opted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    opted = smem;
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(a.b));
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<const bf16*>(w1t), w1n, static_cast<T*>(y), a);
  return cudaGetLastError();
}

}  // namespace block
}  // namespace zt

// x (b, h, w, cin) of dtype (0 = f32, 1 = bf16), 16-byte aligned, and y
// the same; w1 (cin, cmid), w2 (3, 3, cmid, cmid), w3 (cmid, cin) bf16,
// cmid padded with zeros to 16, 32 or a multiple of 64; w1t (cmid, cin),
// w1 transposed, and w1n (cmid) f32, its column norms; all contiguous.
// The plan: the output tile (th, tw), the warps across N of the reduce,
// 3x3 and expand products (wn1..wn3: 1, 2, 4 or 8), the ring's slots and
// the shared memory in bytes, as plan() counts them.
extern "C" int zt_fused_bottleneck(const void* x, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* w1t, const float* w1n, void* y,
                                   int dtype, int b, int h, int w, int cin,
                                   int cmid, int th, int tw, int wn1, int wn2,
                                   int wn3, int stages, int smem,
                                   void* stream) {
  using namespace zt;
  using namespace zt::block;
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 ||
      static_cast<long long>(b) * h * w > 0x7fffffffLL || cin <= 0 ||
      cin % 8 ||
      !(cmid == 16 || cmid == 32 || (cmid > 0 && cmid % 64 == 0)) ||
      th <= 0 || tw <= 0 || stages < 2 || stages > 4 ||
      smem > mma::kMaxSmem)
    return cudaErrorInvalidValue;
  Args a{};
  a.b = b;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cmid = cmid;
  a.th = th;
  a.tw = tw;
  a.tiles_x = (w + tw - 1) / tw;
  a.p = th * tw;
  a.p1 = (th + 2) * (tw + 2);
  a.stages = stages;
  const int need = layout(a, wn1, wn2, wn3);
  if (need < 0 || need > smem) return cudaErrorInvalidValue;
  const int tiles = (h + th - 1) / th * a.tiles_x;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(x, w1, w2, w3, w1t, w1n, y, a, tiles, smem, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w1, w2, w3, w1t, w1n, y, a, tiles, smem,
                                 s);
  return cudaErrorInvalidValue;
}
