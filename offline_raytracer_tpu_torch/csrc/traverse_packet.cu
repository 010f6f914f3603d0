// Packet walk of the implicit-heap LBVH for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel offline_raytracer_tpu/ops/traverse_pallas.py::_kernel
// (launched by _traverse_pallas through pl.pallas_call). A packet of rays
// shares one node stack: an internal node slab-tests both child boxes for
// every ray of the packet and pushes each child any ray wants, the nearer
// one last (popped first); a leaf tests its 128 triangles against every ray
// of the packet. Closest hit, or any hit with an early exit once every live
// ray is resolved. The plain PyTorch version of the same contract is
// ops/traverse.py::tri_hit_plain (a dense sweep over all leaves).
//
// What bounds it on this card: latency of the dependent node loads of the
// walk (a node's 48 bytes come from L2 or L1) and divergence between the
// rays of a packet, since a packet visits the union of the leaves its rays
// want. Not bytes: the tree and the coefficients stay resident in the 50 MB
// L2.
//
// The design, simply for now:
// - one warp is one packet of 32 rays (the TPU packet is a (8, 128) block);
//   the stack is uniform across the warp, so it lives in shared memory,
//   written by lane 0; push decisions come from __any_sync, and the nearer
//   child is the one with the smaller warp minimum of entry distances;
// - a leaf's coefficients are read with warp-uniform addresses, so each
//   16-byte load is one broadcast;
// - pruning uses each ray's own best t, so the packet size does not change
//   the result: every leaf any ray may need is visited.
//
// Numerics: the slab test is only a cull, and is made conservative as in
// csrc/mega.cu (a NaN slab never rejects, a relative slack of 1e-5 on both
// ends), so the walk never skips a leaf the dense sweep would hit. The
// triangle test has the plain version's expression order, built with
// -fmad=false and IEEE division, so t, u and v are bit-identical to it. The
// winner is the least (t, slot) among hits with t_min <= t < t_far, whatever
// the visit order. Any hit: the first hit found resolves the ray.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;            // 4 packets per block
constexpr int WARPS = THREADS / 32;
constexpr int STACK = 64;               // > tree depth + 1 (host checks)
constexpr int LEAF = 128;
constexpr float SLACK = 1.00001f;       // relative slack of the cull
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* ro;        // (Rp, 3)
  const float* rd;        // (Rp, 3)
  const float* t_far;     // (Rp,)
  const float4* tri;      // (S, 3) float4: [s1 c1] [s2 c2] [n cw]
  const float* nodes;     // (n_internal, 12) child AABBs
  float* t_out;           // (Rp,)
  int* slot_out;          // (Rp,)
  int n_leaves, m_occ;
  float t_min;
};

// Conservative slab test of one box (min xyz, max xyz): may the box hold a
// hit nearer than lim? near = entry distance.
__device__ __forceinline__ bool slab(const float* box, float ox, float oy, float oz,
                                     float ix, float iy, float iz, float lim,
                                     float t_min, float& near) {
  near = INFINITY;
  if (!(lim > t_min)) return false;             // dead or resolved ray
  const float b0 = __ldg(&box[0]), b3 = __ldg(&box[3]);
  if (!(b0 <= b3)) return false;                // inverted: empty subtree
  const float lo[3] = {b0, __ldg(&box[1]), __ldg(&box[2])};
  const float hi[3] = {b3, __ldg(&box[4]), __ldg(&box[5])};
  const float oo[3] = {ox, oy, oz};
  const float ii[3] = {ix, iy, iz};
  float tn = -INFINITY, tf = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = (lo[k] - oo[k]) * ii[k];
    const float b = (hi[k] - oo[k]) * ii[k];
    if (a != a || b != b) continue;             // ray in the slab's plane
    tn = fmaxf(tn, fminf(a, b));
    tf = fminf(tf, fmaxf(a, b));
  }
  const float nr = fmaxf(tn, 0.f);
  const bool want = (tf * SLACK >= nr) && (nr <= lim * SLACK);
  if (want) near = nr;
  return want;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

template <bool ANY>
__device__ __forceinline__ void leaf_sweep(const float4* tri, int leaf, float ox,
                                           float oy, float oz, float dx, float dy,
                                           float dz, float t_min, float& best_t,
                                           int& best_i) {
  const int s0 = leaf * LEAF;
  const float4* c = tri + (size_t)s0 * 3;
  for (int j = 0; j < LEAF; ++j) {
    const float4 c1 = __ldg(&c[3 * j]), c2 = __ldg(&c[3 * j + 1]);
    const float4 cn = __ldg(&c[3 * j + 2]);
    const float o_w = ox * cn.x + oy * cn.y + oz * cn.z + cn.w;
    const float d_w = dx * cn.x + dy * cn.y + dz * cn.z;
    const float o_u = ox * c1.x + oy * c1.y + oz * c1.z + c1.w;
    const float d_u = dx * c1.x + dy * c1.y + dz * c1.z;
    const float o_v = ox * c2.x + oy * c2.y + oz * c2.z + c2.w;
    const float d_v = dx * c2.x + dy * c2.y + dz * c2.z;
    const bool ok_w = fabsf(d_w) > 1e-12f;
    const float t = -o_w / (ok_w ? d_w : 1.f);
    const float u = o_u + t * d_u;
    const float v = o_v + t * d_v;
    const int s = s0 + j;
    const bool ok = ok_w && u >= 0.f && v >= 0.f && u + v <= 1.f && t >= t_min;
    if (ANY) {
      if (ok && t < best_t) { best_t = t_min; best_i = s; return; }
    } else if (ok && (t < best_t || (t == best_t && s < best_i))) {
      best_t = t; best_i = s;
    }
  }
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS) packet_kernel(Params p) {
  __shared__ int stack[WARPS][STACK];
  const int lane = threadIdx.x & 31;
  int* st = stack[threadIdx.x >> 5];
  const int i = blockIdx.x * THREADS + threadIdx.x;   // Rp % THREADS == 0
  const float ox = p.ro[3 * i], oy = p.ro[3 * i + 1], oz = p.ro[3 * i + 2];
  const float dx = p.rd[3 * i], dy = p.rd[3 * i + 1], dz = p.rd[3 * i + 2];
  const float ix = 1.f / dx, iy = 1.f / dy, iz = 1.f / dz;
  const float tf = p.t_far[i];
  float best_t = tf;
  int best_i = -1;
  const int first_leaf = p.n_leaves - 1;

  if (lane == 0) st[0] = 0;
  int sp = 1;                                   // warp-uniform
  __syncwarp();
  while (sp > 0) {
    if (ANY && !__any_sync(FULL, best_i < 0 && tf > p.t_min)) break;
    const int node = st[sp - 1];
    --sp;
    __syncwarp();                               // all lanes read before a push
    if (node >= first_leaf) {
      const int leaf = node - first_leaf;
      if (leaf < p.m_occ && best_t > p.t_min)
        leaf_sweep<ANY>(p.tri, leaf, ox, oy, oz, dx, dy, dz, p.t_min, best_t, best_i);
      continue;
    }
    const float* c = p.nodes + (size_t)node * 12;
    float n1, n2;
    const bool w1 = slab(c, ox, oy, oz, ix, iy, iz, best_t, p.t_min, n1);
    const bool w2 = slab(c + 6, ox, oy, oz, ix, iy, iz, best_t, p.t_min, n2);
    const bool any1 = __any_sync(FULL, w1), any2 = __any_sync(FULL, w2);
    const float m1 = warp_min(n1), m2 = warp_min(n2);
    const int c1 = 2 * node + 1;
    const bool first1 = m1 <= m2;
    const int near_c = first1 ? c1 : c1 + 1, far_c = first1 ? c1 + 1 : c1;
    const bool push_far = first1 ? any2 : any1;
    const bool push_near = first1 ? any1 : any2;
    if (push_far) { if (lane == 0) st[sp] = far_c; ++sp; }
    if (push_near) { if (lane == 0) st[sp] = near_c; ++sp; }
    __syncwarp();
  }
  p.t_out[i] = best_t;
  p.slot_out[i] = best_i;
}

}  // namespace

extern "C" int traverse_packet(
    const void* ro, const void* rd, const void* t_far, const void* tri,
    const void* nodes, void* t_out, void* slot_out, int Rp, int n_leaves,
    int m_occ, int any_hit, float t_min, void* stream) {
  Params p;
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.t_far = static_cast<const float*>(t_far);
  p.tri = static_cast<const float4*>(tri);
  p.nodes = static_cast<const float*>(nodes);
  p.t_out = static_cast<float*>(t_out);
  p.slot_out = static_cast<int*>(slot_out);
  p.n_leaves = n_leaves;
  p.m_occ = m_occ;
  p.t_min = t_min;
  if (Rp <= 0) return 0;
  if (Rp % THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    packet_kernel<true><<<Rp / THREADS, THREADS, 0, s>>>(p);
  } else {
    packet_kernel<false><<<Rp / THREADS, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
