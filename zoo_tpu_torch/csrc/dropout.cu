// Inverted dropout on JAX's threefry bits, and the threefry key
// derivations (split, fold_in) of the training loop's key chain.
//
// Replaces: no Pallas kernel. The JAX package draws its dropout masks
// with jax.random.bernoulli and applies them with jnp.where, which XLA
// fuses into the neighbouring ops: Dropout (zoo_tpu/pipeline/api/keras/
// layers/core.py:88-105), SpatialDropout1D/2D (convolutional.py:280-311),
// the dense attention's probabilities (zoo_tpu/ops/attention.py:87-90)
// and BERT's hidden dropout (self_attention.py:91-108). Eager PyTorch
// has no such fusion: the same bits composed from int64 tensor ops
// (ops/random.py) take ~120 launches over the whole tensor. This file
// computes them in registers instead.
//
// Semantics, bit for bit those of ops/random.py (JAX 0.9, the
// jax_threefry_partitionable mode):
// - element i of x reads its mask element m(i): m = i when the mask has
//   x's shape; for a mask broadcast over a run of `inner` elements (the
//   spatial dropouts), m = (i / (inner * c)) * c + i % c, c the elements
//   after the run;
// - bits = x0 ^ x1 of threefry2x32(key, (m >> 32, m & 0xffffffff));
// - u = float((bits >> 9) | 0x3F800000) - 1, in [0, 1);
// - y = u < keep ? x / divisor : 0, the quotient taken in f32 (one IEEE
//   division: nvcc's default -prec-div) and rounded to x's dtype;
//   `keep` is float32(1 - p) and `divisor` is 1 - p rounded to x's
//   dtype, as JAX divides a bf16 tensor by a weak float.
// The backward of y = where(mask, x / keep, 0) is the same function of
// the incoming gradient, so one kernel serves both passes, and the mask
// is never stored: the backward draws it again from the key.
//
// What bounds it on an H100: integer operations. An element costs the
// 20 rounds of threefry (an add, a funnel-shift rotation and an xor
// each), the 5 key injections (2 adds each, one of a constant), the
// counter and the compare: ~75 32-bit integer ops, against 2 to 8 bytes
// moved. At 16.7 T INT32 ops/s (64 INT32 lanes of 132 SMs at the
// 1.98 GHz boost clock) that is ~4.5 ns per 1000 elements, four to
// eight times the time of its bytes at 3.35 TB/s.
//
// What the design does about it: the key words and the counter stay in
// registers; each rotation is one SHF (__funnelshift_l), the whole
// cipher unrolled with constant rotations. A grid-stride loop of 256
// threads, at most 16 blocks an SM, keeps every SM's integer pipes fed;
// loads and stores are coalesced element by element, which the integer
// work hides. The key is read from device memory (two words, cached),
// so a key derived on the device needs no copy to the host.
#include "zt_common.cuh"

namespace zt {

constexpr int kDropThreads = 256;
constexpr int kDropMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, in place on the counter (x0, x1): the rounds
// of jax._src.prng's threefry lowering
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define ZT_TF_ROUND(r) \
  x0 += x1;            \
  x1 = rotl32(x1, r);  \
  x1 ^= x0;
#define ZT_TF_A ZT_TF_ROUND(13) ZT_TF_ROUND(15) ZT_TF_ROUND(26) ZT_TF_ROUND(6)
#define ZT_TF_B ZT_TF_ROUND(17) ZT_TF_ROUND(29) ZT_TF_ROUND(16) ZT_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  ZT_TF_A x0 += k1; x1 += k2 + 1u;
  ZT_TF_B x0 += k2; x1 += k0 + 2u;
  ZT_TF_A x0 += k0; x1 += k1 + 3u;
  ZT_TF_B x0 += k1; x1 += k2 + 4u;
  ZT_TF_A x0 += k2; x1 += k0 + 5u;
#undef ZT_TF_A
#undef ZT_TF_B
#undef ZT_TF_ROUND
}

template <typename T>
__global__ void __launch_bounds__(kDropThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                   int64_t inner, int64_t c, const int64_t* __restrict__ key,
                   float keep, float divisor) {
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const int64_t span = inner * c;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t m = inner == 1 ? i : (i / span) * c + i % c;
    uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(m) >> 32);
    uint32_t x1 = static_cast<uint32_t>(m);
    threefry2x32(k0, k1, x0, x1);
    const float u = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
    y[i] = u < keep ? from_f32<T>(to_f32(x[i]) / divisor) : from_f32<T>(0.0f);
  }
}

// out[i] = both words of threefry2x32(key, (0, first + i)), i < n: the
// keys of jax.random.split (first = 0) and fold_in (n = 1, first = data)
__global__ void derive_keys_kernel(const int64_t* __restrict__ key,
                                   int64_t* __restrict__ out, int n,
                                   uint32_t first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = 0u, x1 = first + static_cast<uint32_t>(i);
  threefry2x32(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
               x0, x1);
  out[2 * i] = x0;
  out[2 * i + 1] = x1;
}

}  // namespace zt

// y = where(mask(key), x / divisor, 0) over n contiguous elements of x
// (dtype 0 = f32, 1 = bf16); the mask broadcast over runs of `inner`
// elements followed by c elements (inner = 1: a mask of x's shape).
// key: two int64 words holding uint32 values, on the device.
extern "C" int zt_dropout(const void* x, void* y, long long n,
                          long long inner, long long c, const void* key,
                          float keep, float divisor, int dtype,
                          void* stream) {
  using namespace zt;
  if (n < 0 || inner < 1 || c < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long want = (n + kDropThreads - 1) / kDropThreads;
  const int blocks = static_cast<int>(want < kDropMaxBlocks ? want
                                                            : kDropMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  if (dtype == kF32) {
    dropout_kernel<float><<<blocks, kDropThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, inner, c, k,
        keep, divisor);
  } else if (dtype == kBF16) {
    dropout_kernel<__nv_bfloat16><<<blocks, kDropThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, inner, c, k, keep, divisor);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out (n, 2) int64 = the keys threefry2x32(key, (0, first + i))
extern "C" int zt_derive_keys(const void* key, void* out, int n,
                              long long first, void* stream) {
  using namespace zt;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  derive_keys_kernel<<<(n + 127) / 128, 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<int64_t*>(out), n,
      static_cast<uint32_t>(first));
  return cudaGetLastError();
}
