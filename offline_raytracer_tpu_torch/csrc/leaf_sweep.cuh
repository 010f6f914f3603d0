// The leaf sweep both traversal kernels share (traverse_cull.cu,
// traverse_packet.cu), for NVIDIA Hopper (sm_90a).
//
// A group of G lanes (G in {1, 2, 4, 8, 16, 32}, dividing a warp) carries
// one ray. For each leaf it visits, the group first tests the leaf's 16
// sub-boxes (runs of 8 consecutive slots, TriBVH.sub_bounds; lane k tests
// boxes k, k+G, ...), agrees on the mask of boxes that may hold a hit, and
// spreads only those boxes' triangles over its lanes. The triangles' three
// coefficient rows come from the leaf-major table (per leaf: 128 float4
// [n cw], then 128 [s1 c1], then 128 [s2 c2]; ops/traverse.py leaf_major),
// loaded together, so a group's loads are contiguous.
//
// Numerics. The slab tests are only a cull and are conservative: a NaN
// slab (a ray in a box face's plane) never rejects, and a relative slack
// of 1e-5 widens both ends, so no box is skipped that holds a hit the dense
// sweep finds. The triangle test has the plain version's expression order
// (ops/traverse.py tri_hit_plain); the kernels are built with -fmad=false
// and IEEE division, so t, u and v are bit-identical to it. The closest-hit
// winner is the least (t, slot) among hits with t_min <= t < t_far, which
// does not depend on the visit order, so every G gives the same answer.
// Any hit: the least slot of the first leaf, in the kernel's visit order,
// that holds a hit (a group-uniform order, so again the same for every G).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace leaf_sweep {

constexpr int LEAF = 128;               // slots per leaf
constexpr int SUB = 16;                 // sub-boxes per leaf
constexpr int SUB_TRIS = LEAF / SUB;    // consecutive slots per sub-box
constexpr float SLACK = 1.00001f;       // relative slack of the cull
constexpr int NO_SLOT = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The G lanes of a group that carries one ray.
template <int G>
struct Group {
  unsigned mask;
  int lane;
  __device__ __forceinline__ Group() {
    const int l = threadIdx.x & 31;
    lane = l & (G - 1);
    mask = (G == 32) ? FULL : (((1u << G) - 1u) << (l & ~(G - 1)));
  }
  __device__ __forceinline__ unsigned or_all(unsigned x) const {
    if constexpr (G == 1) return x;
    else return __reduce_or_sync(mask, x);
  }
  __device__ __forceinline__ unsigned min_all(unsigned x) const {
    if constexpr (G == 1) return x;
    else return __reduce_min_sync(mask, x);
  }
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* ro, const float* rd, int i) {
  Ray r;
  r.ox = ro[3 * i]; r.oy = ro[3 * i + 1]; r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i]; r.dy = rd[3 * i + 1]; r.dz = rd[3 * i + 2];
  r.ix = 1.f / r.dx; r.iy = 1.f / r.dy; r.iz = 1.f / r.dz;
  return r;
}

// Does the query ask anything of this ray? Not if its bound is empty (a
// dead lane: t_far <= t_min). The bound is the only dead mark: a ray may
// start anywhere, however far out.
__device__ __forceinline__ bool live(float t_far, float t_min) { return t_far > t_min; }

// Conservative slab test of the box [lo, hi]: may it hold a hit nearer than
// lim? An inverted box (lo.x > hi.x: padding, an empty subtree) never does.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy,
                                     float hz, const Ray& r, float lim, float& near) {
  if (!(lx <= hx)) return false;
  const float lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
  const float oo[3] = {r.ox, r.oy, r.oz}, ii[3] = {r.ix, r.iy, r.iz};
  float tn = -INFINITY, tf = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = (lo[k] - oo[k]) * ii[k];
    const float b = (hi[k] - oo[k]) * ii[k];
    if (a != a || b != b) continue;             // ray in the slab's plane
    tn = fmaxf(tn, fminf(a, b));
    tf = fminf(tf, fmaxf(a, b));
  }
  near = fmaxf(tn, 0.f);
  return (tf * SLACK >= near) && (near <= lim * SLACK);
}

// The ray against slot j of a leaf (base: the leaf's leaf-major rows): true
// and its t if the plain version counts it a hit with t <= lim. The plain
// version's expression order: o_w, d_w, t = -o_w / d_w, u = o_u + t d_u,
// v = o_v + t d_v.
__device__ __forceinline__ bool tri_test(const float4* base, int j, const Ray& r,
                                         float t_min, float t_far, float lim, float& t) {
  const float4 cn = __ldg(base + j);
  const float4 c1 = __ldg(base + LEAF + j);
  const float4 c2 = __ldg(base + 2 * LEAF + j);
  const float d_w = r.dx * cn.x + r.dy * cn.y + r.dz * cn.z;
  if (!(fabsf(d_w) > 1e-12f)) return false;
  const float o_w = r.ox * cn.x + r.oy * cn.y + r.oz * cn.z + cn.w;
  t = -o_w / d_w;
  if (!(t >= t_min && t < t_far && t <= lim)) return false;
  const float o_u = r.ox * c1.x + r.oy * c1.y + r.oz * c1.z + c1.w;
  const float d_u = r.dx * c1.x + r.dy * c1.y + r.dz * c1.z;
  const float u = o_u + t * d_u;
  if (!(u >= 0.f)) return false;
  const float o_v = r.ox * c2.x + r.oy * c2.y + r.oz * c2.z + c2.w;
  const float d_v = r.dx * c2.x + r.dy * c2.y + r.dz * c2.z;
  const float v = o_v + t * d_v;
  return v >= 0.f && u + v <= 1.f;
}

// The tables a sweep reads.
struct Leaves {
  const float4* tri;      // (S / 128, 3, 128) float4, leaf-major
  const float4* sub;      // (S / 128, 16, 2) float4: [min xyz, max x] [max yz, 0, 0]
  float t_min;
};

// The leaf's sub-boxes that may hold a hit nearer than lim, as a mask the
// group agrees on.
template <int G>
__device__ __forceinline__ unsigned leaf_boxes(const Leaves& lv, const Group<G>& g, int leaf,
                                               const Ray& r, float lim) {
  const float4* boxes = lv.sub + (size_t)leaf * SUB * 2;
  unsigned m = 0;
  for (int b = g.lane; b < SUB; b += G) {
    const float4 p = __ldg(boxes + 2 * b), q = __ldg(boxes + 2 * b + 1);
    float nn;
    if (slab(p.x, p.y, p.z, p.w, q.x, q.y, r, lim, nn)) m |= 1u << b;
  }
  return g.or_all(m);
}

// Slot (within the leaf) of work item w: triangle w % SUB_TRIS of the
// (w / SUB_TRIS)-th box of mask m. Work items run in slot order.
__device__ __forceinline__ int work_slot(unsigned m, int w) {
  for (int k = w / SUB_TRIS; k > 0; --k) m &= m - 1;
  return (__ffs(m) - 1) * SUB_TRIS + w % SUB_TRIS;
}

// Closest hit so far: t and slot (NO_SLOT: none; t is then the ray's t_far).
struct Best {
  float t;
  int slot;
};

// Closest-hit sweep of one leaf by the group: lane k takes work items k,
// k+G, ... and prunes on its own best; the group then agrees on the least
// (t, slot).
template <int G>
__device__ __forceinline__ void leaf_closest(const Leaves& lv, const Group<G>& g, int leaf,
                                             const Ray& r, float t_far, Best& b) {
  const unsigned m = leaf_boxes(lv, g, leaf, r, b.t);
  const int n = __popc(m) * SUB_TRIS;
  const float4* base = lv.tri + (size_t)leaf * 3 * LEAF;
  for (int w = g.lane; w < n; w += G) {
    const int j = work_slot(m, w);
    float t;
    if (!tri_test(base, j, r, lv.t_min, t_far, b.t, t)) continue;
    const int s = leaf * LEAF + j;
    if (t < b.t || s < b.slot) { b.t = t; b.slot = s; }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float t = __shfl_xor_sync(g.mask, b.t, off);
      const int s = __shfl_xor_sync(g.mask, b.slot, off);
      if (t < b.t || (t == b.t && s < b.slot)) { b.t = t; b.slot = s; }
    }
  }
}

// Any-hit sweep of one leaf by the group, in rounds of G work items: the
// first round in which some lane hits ends it, with the least slot hit in
// that round, which is the leaf's least hit slot (work items run in slot
// order). NO_SLOT if nothing in the leaf is hit.
template <int G>
__device__ __forceinline__ int leaf_anyhit(const Leaves& lv, const Group<G>& g, int leaf,
                                           const Ray& r, float t_far) {
  const unsigned m = leaf_boxes(lv, g, leaf, r, t_far);
  const int n = __popc(m) * SUB_TRIS;
  const float4* base = lv.tri + (size_t)leaf * 3 * LEAF;
  for (int w0 = 0; w0 < n; w0 += G) {
    const int w = w0 + g.lane;
    unsigned s = NO_SLOT;
    if (w < n) {
      const int j = work_slot(m, w);
      float t;
      if (tri_test(base, j, r, lv.t_min, t_far, t_far, t)) s = leaf * LEAF + j;
    }
    s = g.min_all(s);
    if (s != (unsigned)NO_SLOT) return (int)s;
  }
  return NO_SLOT;
}

}  // namespace leaf_sweep
