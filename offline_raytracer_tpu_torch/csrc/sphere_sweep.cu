// Closest-sphere search of the wavefront route for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package sweeps the sphere table in XLA,
// and the port's plain version, ops/intersect.sphere_ts(...).min(-1),
// builds (R, N, 3) and (R, N) float32 temporaries for every ray-sphere
// pair: at 810,000 rays and 486 spheres one (R, N, 3) tensor is 4.7 GB, and
// a bounce's ~90 operations move tens of GB through device memory. This
// kernel does the whole search of one query in one launch and returns, for
// each lane, the closest sphere's distance and its index; nothing but the
// answer leaves the chip.
//
// Semantics are those of sphere_ts(...).min(-1), pair by pair:
//   rel = o - c;  b = sum(d * rel);  c' = sum(rel * rel) - r * r;
//   disc = b * b - c';  sq = sqrt(max(disc, 0));  tn, tp = -b - sq, -b + sq;
//   t = tn >= t_min ? tn : tp;  a hit only where disc > 0 and t >= t_min;
// the smallest t wins, the first index among equals (strict < in table
// order), and a lane with no hit gets t = +inf and index 0. The operations
// round as the plain version's do on the card: every product is formed on
// its own (the library is built with -fmad=false, so no a * b + c becomes
// an FMA), sqrtf is IEEE (no fast math), and each 3-term sum is added in
// PyTorch's order for a sum over a contiguous last dimension of 3 on CUDA:
// its reduce kernel splits the 3 terms over 2 threads (x0 and x2 on one,
// x1 on the other) and adds the two partial sums with a warp shuffle, so
// the sum is (x0 + x2) + x1. t is therefore bit for bit the plain sweep's,
// and so are the winners.
//
// A lane whose alive byte is 0 is answered as a miss without a sphere
// test: the wavefront's finished lanes, which nothing downstream reads.
//
// What bounds it on this card. A pair test is ~17 FP32 operations before
// the root (3 subtractions, 7 products, 4 additions, 2 subtractions and a
// compare), none of them fusable, so the search is bound by FP32 issue:
// 132 SMs x 128 lanes x 1.98 GHz, ~33 T operations a second. The bytes are
// small (32 a live lane, 16 a sphere staged once a block). The design keeps
// every issue slot on a live pair:
// - each block takes a chunk of CHUNK lanes and compacts its live ones into
//   a shared-memory list (__ballot_sync, __popc and a block prefix over the
//   warps), in lane order, with no global atomics; its threads then sweep
//   that list, so a warp holds live lanes only, however thinly they are
//   spread (at 5% live and random spread, 80% of plain 32-lane warps would
//   still hold one);
// - the sphere table is staged in shared memory as float4 (centre, r * r)
//   in tiles of TILE spheres, which every thread reads at the same address
//   (a broadcast); a table of any size is swept tile by tile, each lane's
//   running best kept in registers across tiles;
// - the square root is taken only where disc > 0;
// - each lane's result is written once at its own index; the dead lanes of
//   the chunk are written as misses while the list is built.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 8;                  // lanes of a chunk per thread
constexpr int CHUNK = THREADS * PER;    // lanes a block compacts
constexpr int TILE = 1024;              // spheres staged at once (16 KB)
constexpr unsigned FULL = 0xffffffffu;

// PyTorch's 3-term sum over a contiguous last dimension on CUDA (above)
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

// one lane against the staged spheres [0, nt) of the tile starting at
// table index base; (bt, bi) the lane's running best
__device__ __forceinline__ void sweep_tile(const float4* __restrict__ tile,
                                           int nt, int base, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float t_min,
                                           float& bt, int& bi) {
#pragma unroll 4
  for (int j = 0; j < nt; ++j) {
    const float4 s = tile[j];
    const float rx = ox - s.x, ry = oy - s.y, rz = oz - s.z;
    const float b = sum3(dx * rx, dy * ry, dz * rz);
    const float c = sum3(rx * rx, ry * ry, rz * rz) - s.w;
    const float disc = b * b - c;
    if (disc > 0.0f) {
      const float sq = sqrtf(disc);
      const float tn = -b - sq;
      const float tp = -b + sq;
      const float t = tn >= t_min ? tn : tp;
      if (t >= t_min && t < bt) {
        bt = t;
        bi = base + j;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) sphere_sweep_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ center, const float* __restrict__ radius,
    const unsigned char* __restrict__ alive, float* __restrict__ t_out,
    int* __restrict__ i_out, int R, int N, float t_min) {
  __shared__ float4 tile[TILE];
  __shared__ int list[CHUNK];
  __shared__ int warp_n[WARPS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane_bit = tid & 31;
  const int chunk0 = blockIdx.x * CHUNK;

  // ---- compact the chunk's live lanes into list[0, n_live), in order
  int n_live = 0;   // the same in every thread
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int lane = chunk0 + k * THREADS + tid;
    const bool in = lane < R;
    const bool live = in && (alive == nullptr || alive[lane] != 0);
    if (in && !live) {
      t_out[lane] = INFINITY;
      i_out[lane] = 0;
    }
    const unsigned m = __ballot_sync(FULL, live);
    if (lane_bit == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = n_live, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_n[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (live) list[off + __popc(m & ((1u << lane_bit) - 1u))] = lane;
    n_live += total;
    __syncthreads();   // warp_n is rewritten by the next pass
  }
  if (n_live == 0) return;

  // ---- sweep: thread tid takes list slots tid, tid + THREADS, ...
  float bt[PER];
  int bi[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    bt[k] = INFINITY;
    bi[k] = 0;
  }
  for (int base = 0; base < N; base += TILE) {
    const int nt = min(TILE, N - base);
    if (base > 0) __syncthreads();   // the last tile is swept
    for (int j = tid; j < nt; j += THREADS) {
      const int g = base + j;
      const float r = radius[g];
      tile[j] = make_float4(center[3 * g], center[3 * g + 1],
                            center[3 * g + 2], r * r);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = tid + k * THREADS;
      if (s < n_live) {
        const int lane = list[s];
        sweep_tile(tile, nt, base, ro[3 * lane], ro[3 * lane + 1],
                   ro[3 * lane + 2], rd[3 * lane], rd[3 * lane + 1],
                   rd[3 * lane + 2], t_min, bt[k], bi[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = tid + k * THREADS;
    if (s < n_live) {
      const int lane = list[s];
      t_out[lane] = bt[k];
      i_out[lane] = bi[k];
    }
  }
}

}  // namespace

// ro, rd (R, 3), center (N, 3), radius (N,): float32, contiguous; alive
// (R,) bytes (torch.bool) or null for every lane; t_out (R,) float32 and
// i_out (R,) int32 written for every lane.
// Returns the launch's CUDA error (0 on success); no sync.
extern "C" int sphere_sweep(const void* ro, const void* rd,
                            const void* center, const void* radius,
                            const void* alive, void* t_out, void* i_out,
                            int R, int N, float t_min, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + CHUNK - 1) / CHUNK;
  sphere_sweep_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(center), static_cast<const float*>(radius),
      static_cast<const unsigned char*>(alive), static_cast<float*>(t_out),
      static_cast<int*>(i_out), R, N, t_min);
  return (int)cudaGetLastError();
}
