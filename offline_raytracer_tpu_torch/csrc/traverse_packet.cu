// Tree walk of the implicit-heap LBVH for NVIDIA Hopper (sm_90a): the
// "packet" route's triangle query.
//
// Replaces the TPU kernel offline_raytracer_tpu/ops/traverse_pallas.py::_kernel
// (launched by _traverse_pallas through pl.pallas_call), a packet walk: one
// node stack per (8, 128) block of rays. Closest hit, or any hit with an
// early exit. The plain PyTorch version of the same contract is
// ops/traverse.py::tri_hit_plain (a dense sweep over all leaves).
//
// What bounds it on this card: per live ray, a walk of ~2 log2(leaves)
// slab tests and, per leaf reached, 16 sub-box tests and the triangles of
// the boxes hit, all from the tables resident in the 50 MB L2. Bytes are
// the rays in and (t, slot) out: a few µs at 3.35 TB/s. What limits it is
// the latency of each ray's chain of dependent node loads and how many rays
// are in flight to hide it.
//
// The design is not the TPU's packet walk: a packet with a shared node
// stack visits the union of the leaves its rays want, and a late bounce's
// few live rays would sit in a few warps. Instead:
// - a group of G lanes carries one ray (template G; the wrapper picks it
//   from the number of rays, ops/traverse.py group_size), so few live rays
//   still launch many lanes;
// - each group walks its own ray's path, stackless: the heap's node ids give
//   each ancestor and sibling, and one 32-bit trail marks the levels whose
//   far child is still to visit; on the way back the far child's box is
//   tested again against the bound as it stands then (as csrc/mega.cu does);
// - a leaf is swept by the shared leaf sweep (leaf_sweep.cuh): 16 sub-boxes
//   first, then only the hit boxes' triangles, spread over the group;
// - a dead ray (t_far <= t_min) does no work and returns a miss;
// - registers are not capped: both kernels compile to 42-53 registers with
//   no spills, and a cap for 8 blocks per SM (the segment kernel's) was no
//   faster (PERF.md).
// The G lanes of a group walk the same node sequence; only lane 0 writes.

#include "leaf_sweep.cuh"

namespace {

using namespace leaf_sweep;

constexpr int THREADS = 128;            // per block

struct Params {
  const float* ro;        // (R, 3)
  const float* rd;        // (R, 3)
  const float* t_far;     // (R,) or null: no bound
  const float* nodes;     // (n_internal, 12) child AABBs
  Leaves lv;
  float* t_out;           // (R,) hit t (t_min for an any hit), inf on a miss
  int* slot_out;          // (R,) slot, -1 on a miss
  int R, n_leaves, m_occ;
};

// A child box of an internal node (half 0: child 2i+1, half 1: child 2i+2).
__device__ __forceinline__ bool child_slab(const float* nodes, int node, int half, const Ray& r,
                                           float lim, float& near) {
  const float* c = nodes + (size_t)node * 12 + 6 * half;
  return slab(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3), __ldg(c + 4), __ldg(c + 5), r,
              lim, near);
}

// Walk the heap (children of node i at 2i+1 and 2i+2, leaves from
// n_leaves - 1 on), nearer child first, pruning against the best t so far
// (closest hit) or t_far (any hit). No stack: bit L of `trail` says the far
// child at depth L is still to visit. Returns the any-hit slot (NO_SLOT:
// none); closest hits land in b. Every lane of the group walks alike.
template <bool ANY, int G>
__device__ int walk(const Params& p, const Group<G>& g, const Ray& r, float t_far, Best& b) {
  if (p.n_leaves == 1) {
    if (ANY) return leaf_anyhit(p.lv, g, 0, r, t_far);
    leaf_closest(p.lv, g, 0, r, t_far, b);
    return NO_SLOT;
  }
  const int first_leaf = p.n_leaves - 1;
  int node = 0, depth = 0;
  unsigned trail = 0;
  while (true) {
    if (node < first_leaf) {
      float n1 = 0.f, n2 = 0.f;
      const bool h1 = child_slab(p.nodes, node, 0, r, b.t, n1);
      const bool h2 = child_slab(p.nodes, node, 1, r, b.t, n2);
      if (h1 || h2) {
        ++depth;
        if (h1 && h2) {
          trail |= 1u << depth;
          node = (n1 <= n2) ? 2 * node + 1 : 2 * node + 2;
        } else {
          node = h1 ? 2 * node + 1 : 2 * node + 2;
        }
        continue;
      }
    } else {
      const int leaf = node - first_leaf;
      if (leaf < p.m_occ) {
        if (ANY) {
          const int s = leaf_anyhit(p.lv, g, leaf, r, t_far);
          if (s != NO_SLOT) return s;
        } else {
          leaf_closest(p.lv, g, leaf, r, t_far, b);
        }
      }
    }
    // back to the deepest far child still to visit whose box the bound
    // has not pruned since
    while (true) {
      if (trail == 0) return NO_SLOT;
      const int L = 31 - __clz(trail);
      trail &= ~(1u << L);
      const int anc = ((node + 1) >> (depth - L)) - 1;
      node = (anc & 1) ? anc + 1 : anc - 1;
      depth = L;
      float nn;
      if (child_slab(p.nodes, (node - 1) >> 1, (node & 1) ? 0 : 1, r, b.t, nn)) break;
    }
  }
}

template <bool ANY, int G>
__global__ void __launch_bounds__(THREADS) packet_kernel(Params p) {
  const Group<G> g;
  const int i = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  if (i >= p.R) return;                         // the whole group leaves
  const Ray r = load_ray(p.ro, p.rd, i);
  const float t_far = p.t_far ? p.t_far[i] : INFINITY;
  float t_out = INFINITY;
  int s_out = -1;
  if (p.m_occ > 0 && live(t_far, p.lv.t_min)) {
    Best b;
    b.t = t_far;
    b.slot = NO_SLOT;
    const int s = walk<ANY, G>(p, g, r, t_far, b);
    if (ANY && s != NO_SLOT) { t_out = p.lv.t_min; s_out = s; }
    if (!ANY && b.slot != NO_SLOT) { t_out = b.t; s_out = b.slot; }
  }
  if (g.lane == 0) {
    p.t_out[i] = t_out;
    p.slot_out[i] = s_out;
  }
}

template <bool ANY, int G>
int launch(const Params& p, cudaStream_t s) {
  constexpr int rays_per_block = THREADS / G;
  const int blocks = (p.R + rays_per_block - 1) / rays_per_block;
  packet_kernel<ANY, G><<<blocks, THREADS, 0, s>>>(p);
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

// group: lanes per ray, one of 1, 2, 4, 8, 16, 32. t_far may be null.
extern "C" int traverse_packet(
    const void* ro, const void* rd, const void* t_far, const void* tri_lm,
    const void* sub, const void* nodes, void* t_out, void* slot_out, int R,
    int n_leaves, int m_occ, int any_hit, int group, float t_min, void* stream) {
  if (R <= 0) return 0;
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.t_far = static_cast<const float*>(t_far);
  p.nodes = static_cast<const float*>(nodes);
  p.lv.tri = static_cast<const float4*>(tri_lm);
  p.lv.sub = static_cast<const float4*>(sub);
  p.lv.t_min = t_min;
  p.t_out = static_cast<float*>(t_out);
  p.slot_out = static_cast<int*>(slot_out);
  p.R = R;
  p.n_leaves = n_leaves;
  p.m_occ = m_occ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch_group<true>(p, group, s) : launch_group<false>(p, group, s);
}
