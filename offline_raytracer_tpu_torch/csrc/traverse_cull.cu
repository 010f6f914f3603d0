// Cull-and-sweep triangle query for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel offline_raytracer_tpu/ops/traverse_cull.py::_kernel
// (launched by _sweep_pallas through pl.pallas_call): for each 128-ray row,
// a sweep of the 128 triangles of every leaf on the row's list of wanted
// leaves, closest hit or any hit. On the TPU the lists were built before the
// grid by a dense (R, L) slab cull and an argsort, because the kernel reads
// them as scalar-prefetched rows. The plain PyTorch version of the same
// contract is ops/traverse.py::tri_hit_plain (a dense sweep over all
// leaves); ops/traverse_cull.py row_cull_plain is the plain version of this
// kernel's cull.
//
// What bounds it on this card: the cull is a slab test of every live ray
// against every leaf box (~20 flops each; 262,144 rays x 543 leaves is
// ~2.8 GFLOP, ~43 µs at 67 TFLOP/s); then, per ray, a box test per listed
// leaf and the sub-boxes and triangles of the leaves it may hit. Bytes are
// the rays in and (t, slot) out. The tables (leaf boxes, sub-boxes,
// coefficients) stay in L2 and L1.
//
// The design (the host builds no lists; one launch per query):
// - one block of 128 threads per row; a group of G lanes carries each ray
//   (template G; the wrapper picks it from the number of rays,
//   ops/traverse.py group_size), so a row is 128 / G rays and few live
//   rays still launch many lanes;
// - the block culls its own row: in chunks of 32 leaves, each group's lanes
//   slab-test the ray against the chunk's leaf boxes (read through L1), a
//   ballot per warp gathers the chunk's wanted bits, the warp folds them
//   over its groups, and one atomicOr per warp ORs them into the row's
//   bitmap in shared memory (at most 4096 leaves: 128 words);
// - the set bits, walked in leaf-id order with __ffs, are the row's list:
//   each group tests the listed leaf's box against its ray's best t so far
//   and sweeps the leaves that pass with the shared leaf sweep
//   (leaf_sweep.cuh: 16 sub-boxes, then the hit boxes' triangles spread
//   over the group);
// - a row with no live ray (t_far <= t_min: the integrator launches its
//   finished paths so) writes misses and stops after one barrier; the hardware's
//   block scheduler balances rows of unequal lists;
// - the cull is conservative (leaf_sweep.cuh slab), so the list holds every
//   leaf the dense sweep may hit: the closest hit is the dense sweep's, and
//   the any-hit slot is its least hit slot too, because leaves are visited
//   in slot order.
// No (R, L) array, argsort or host work: one launch per query. Persistent
// blocks pulling rows from an atomic counter, or striding over rows, were
// slower on the H100 than one block per row (PERF.md).

#include "leaf_sweep.cuh"

namespace {

using namespace leaf_sweep;

constexpr int THREADS = 128;            // per block: one row
constexpr int MAX_LEAVES = 4096;        // ops/traverse_cull.py MAX_CULL_LEAVES
constexpr int MAX_WORDS = MAX_LEAVES / 32;

struct Params {
  const float* ro;        // (R, 3)
  const float* rd;        // (R, 3)
  const float* t_far;     // (R,) or null: no bound
  const float* boxes;     // (6, L_lane) leaf boxes: min x, y, z, max x, y, z rows
  Leaves lv;
  float* t_out;           // (R,) hit t (t_min for an any hit), inf on a miss
  int* slot_out;          // (R,) slot, -1 on a miss
  int R, m_occ, lw;       // lw: L_lane, the boxes' row stride
};

__device__ __forceinline__ bool leaf_slab(const Params& p, int leaf, const Ray& r, float lim) {
  const float* b = p.boxes + leaf;
  const size_t w = (size_t)p.lw;
  float nn;
  return slab(__ldg(b), __ldg(b + w), __ldg(b + 2 * w), __ldg(b + 3 * w), __ldg(b + 4 * w),
              __ldg(b + 5 * w), r, lim, nn);
}

template <bool ANY, int G>
__global__ void __launch_bounds__(THREADS) cull_kernel(Params p) {
  __shared__ unsigned row_bits[MAX_WORDS];
  const Group<G> g;
  const int i = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int n_words = (p.m_occ + 31) / 32;
  Ray r{};
  float t_far = 0.f;
  bool is_live = false;
  if (i < p.R) {
    r = load_ray(p.ro, p.rd, i);
    t_far = p.t_far ? p.t_far[i] : INFINITY;
    is_live = live(t_far, p.lv.t_min);
  }
  for (int k = threadIdx.x; k < n_words; k += THREADS) row_bits[k] = 0u;
  // the barrier also orders the clearing before the cull's ORs
  if (!__syncthreads_or(is_live)) {
    if (i < p.R && g.lane == 0) { p.t_out[i] = INFINITY; p.slot_out[i] = -1; }
    return;
  }

  // ---- cull: the row's wanted leaves, 32 a chunk; every lane of the warp
  // runs every iteration (the ballots need them all)
  const int lane32 = threadIdx.x & 31;
  const unsigned low = (G == 32) ? FULL : ((1u << G) - 1u);
  for (int c = 0; c < n_words; ++c) {
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 32 / G; ++k) {
      const int leaf = 32 * c + k * G + g.lane;
      const bool want = is_live && leaf < p.m_occ && leaf_slab(p, leaf, r, t_far);
      unsigned b = __ballot_sync(FULL, want);
#pragma unroll
      for (int s = G; s < 32; s <<= 1) b |= b >> s;   // OR over the warp's groups
      word |= (b & low) << (k * G);
    }
    if (lane32 == 0 && word) atomicOr(&row_bits[c], word);
  }
  __syncthreads();

  // ---- sweep the listed leaves in leaf-id order
  float t_out = INFINITY;
  int s_out = -1;
  if (is_live) {
    Best b;
    b.t = t_far;
    b.slot = NO_SLOT;
    int any = NO_SLOT;
    for (int c = 0; c < n_words && any == NO_SLOT; ++c) {
      unsigned bits = row_bits[c];
      while (bits) {
        const int leaf = 32 * c + __ffs(bits) - 1;
        bits &= bits - 1;
        if (!leaf_slab(p, leaf, r, b.t)) continue;
        if (ANY) {
          any = leaf_anyhit(p.lv, g, leaf, r, t_far);
          if (any != NO_SLOT) break;
        } else {
          leaf_closest(p.lv, g, leaf, r, t_far, b);
        }
      }
    }
    if (ANY && any != NO_SLOT) { t_out = p.lv.t_min; s_out = any; }
    if (!ANY && b.slot != NO_SLOT) { t_out = b.t; s_out = b.slot; }
  }
  if (i < p.R && g.lane == 0) {
    p.t_out[i] = t_out;
    p.slot_out[i] = s_out;
  }
}

template <bool ANY, int G>
int launch(const Params& p, cudaStream_t s) {
  constexpr int rays_per_row = THREADS / G;
  const int rows = (p.R + rays_per_row - 1) / rays_per_row;
  cull_kernel<ANY, G><<<rows, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool ANY>
int launch_group(const Params& p, int group, cudaStream_t s) {
  switch (group) {
    case 1: return launch<ANY, 1>(p, s);
    case 2: return launch<ANY, 2>(p, s);
    case 4: return launch<ANY, 4>(p, s);
    case 8: return launch<ANY, 8>(p, s);
    case 16: return launch<ANY, 16>(p, s);
    case 32: return launch<ANY, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// group: lanes per ray, one of 1, 2, 4, 8, 16, 32; lw: the leaf boxes' row
// stride (L_lane >= m_occ); m_occ <= 4096. t_far may be null.
extern "C" int traverse_cull(
    const void* ro, const void* rd, const void* t_far, const void* boxes,
    const void* tri_lm, const void* sub, void* t_out, void* slot_out, int R,
    int m_occ, int lw, int any_hit, int group, float t_min, void* stream) {
  if (R <= 0) return 0;
  if (m_occ < 0 || m_occ > MAX_LEAVES || lw < m_occ) return (int)cudaErrorInvalidValue;
  Params p;
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.t_far = static_cast<const float*>(t_far);
  p.boxes = static_cast<const float*>(boxes);
  p.lv.tri = static_cast<const float4*>(tri_lm);
  p.lv.sub = static_cast<const float4*>(sub);
  p.lv.t_min = t_min;
  p.t_out = static_cast<float*>(t_out);
  p.slot_out = static_cast<int*>(slot_out);
  p.R = R;
  p.m_occ = m_occ;
  p.lw = lw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch_group<true>(p, group, s) : launch_group<false>(p, group, s);
}
