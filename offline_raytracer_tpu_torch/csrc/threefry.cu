// Counter-based threefry-2x32 draws for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package draws with jax.random (XLA's
// threefry), and the port's plain version,
// offline_raytracer_tpu_torch/utils/rng.py, runs the rounds as int64
// PyTorch operations masked to 32 bits: about 7 launches a round, 5,716
// device operations for the draws of one 262,144-ray, 8-bounce render
// launch, each a few microseconds of host issue. This kernel draws the same
// bits in one launch per call, so the host issues one operation where it
// issued thousands.
//
// One library, two modes of one entry point (threefry_draw): the planes and
// the keys share the rounds, and one source is one nvcc build at a
// checkout's first run with no header beside it (a new csrc/*.cuh would
// change every other kernel's build key).
// - MODE_PLANES: (R, 2) int64 keys -> (n_tags * n, R) float32 planes. Row
//   i * n + j is column j of tag tag_lo + i: word (j & 1) of
//   threefry2x32(key, (tag, j & ~1)), mapped to (word >> 8) * 2^-24, which
//   is exact, so the planes equal the plain version's bit for bit.
// - MODE_KEYS: root key (2,) int64, pixel ids and sample ids (R,) int32
//   (fold_in reads a 32-bit word) -> the (R, 2) int64 keys
//   fold_in(fold_in(root, pixel), sample), fold_in(k, d) being
//   threefry2x32(k, (0, d)).
//
// What bounds it on this card. A block is 20 rounds (an add, a funnel shift
// and a xor each) and 6 key injections: about 72 32-bit integer
// instructions for two words, some 50 of them on the ALU pipe (the compiler
// moves the other adds to the FMA pipe as IMAD). One thread per ray
// computes every block of its ray for every tag, with the key schedule in
// registers, and writes each plane's word at column r, so a warp's stores
// are 128 contiguous bytes. The draws of a bunny render launch (8 tags, 4
// blocks a tag, 262,144 rays) write 67 MB of planes and read 17 MB of keys,
// ~25 us at 3.35 TB/s, and issue ~0.42 G ALU instructions, ~25 us at 64 a
// clock on each of the 132 SMs at 1.98 GHz: bytes and issue bound it alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MODE_PLANES = 0;
constexpr int MODE_KEYS = 1;

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1) {
  return {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// threefry2x32 of counter (x0, x1) under key k, in place (jax.random's
// 20-round schedule)
__device__ __forceinline__ void threefry(const Key& k, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += k.k0; x1 += k.k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k1; x1 += k.k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k2; x1 += k.k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k0; x1 += k.k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k1; x1 += k.k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k2; x1 += k.k0 + 5u;
}

// a 32-bit word -> float32 in [0, 1) from its top 24 bits (exact)
__device__ __forceinline__ float unit(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(THREADS) threefry_planes_kernel(
    const long long* __restrict__ keys, float* __restrict__ out, int R,
    uint32_t tag_lo, int n_tags, int n) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const Key k = make_key(static_cast<uint32_t>(keys[2 * r]),
                         static_cast<uint32_t>(keys[2 * r + 1]));
  float* col = out + r;
  const size_t stride = static_cast<size_t>(R);
  for (int t = 0; t < n_tags; ++t) {
    const uint32_t tag = tag_lo + static_cast<uint32_t>(t);
    for (int j = 0; j < n; j += 2) {
      uint32_t x0 = tag, x1 = static_cast<uint32_t>(j);
      threefry(k, x0, x1);
      col[0] = unit(x0);
      if (j + 1 < n) col[stride] = unit(x1);
      col += 2 * stride;
    }
    if (n & 1) col -= stride;   // an odd n wrote one row of its last pair
  }
}

__global__ void __launch_bounds__(THREADS) threefry_keys_kernel(
    const long long* __restrict__ root, const int* __restrict__ pix,
    const int* __restrict__ smp, long long* __restrict__ out, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  uint32_t x0 = 0u, x1 = static_cast<uint32_t>(pix[r]);
  threefry(make_key(static_cast<uint32_t>(root[0]),
                    static_cast<uint32_t>(root[1])), x0, x1);
  const Key k = make_key(x0, x1);
  x0 = 0u;
  x1 = static_cast<uint32_t>(smp[r]);
  threefry(k, x0, x1);
  out[2 * r] = static_cast<long long>(x0);
  out[2 * r + 1] = static_cast<long long>(x1);
}

}  // namespace

// MODE_PLANES: in0 the keys, out the planes; tag_lo, n_tags, n as above.
// MODE_KEYS: in0 the root key, in1 and in2 the int32 pixel and sample
// ids, out the keys.
// Returns the launch's CUDA error (0 on success); no sync.
extern "C" int threefry_draw(int mode, const void* in0, const void* in1,
                             const void* in2, void* out, int R,
                             unsigned int tag_lo, int n_tags, int n,
                             void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + THREADS - 1) / THREADS;
  if (mode == MODE_PLANES) {
    if (n_tags <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    threefry_planes_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const long long*>(in0), static_cast<float*>(out), R,
        tag_lo, n_tags, n);
  } else if (mode == MODE_KEYS) {
    threefry_keys_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const long long*>(in0), static_cast<const int*>(in1),
        static_cast<const int*>(in2), static_cast<long long*>(out), R);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
