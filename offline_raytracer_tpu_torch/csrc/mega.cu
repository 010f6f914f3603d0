// Fused bounce segment for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel offline_raytracer_tpu/ops/mega.py::_mega_kernel
// (launched by render_paths_mega.seg_call through pl.pallas_call). One
// launch runs bounces [b_start, b_start + nf) for every ray: analytic
// closest hit (spheres, boxes, cylinders), triangle closest hit over the
// packed LBVH, emission with MIS, next-event estimation with an any-hit
// shadow walk, Russian roulette and the 3-lobe BSDF, with the per-bounce
// records (hit id, NEE visibility, alive) the host loop and the replay need.
// The plain PyTorch version with the same contract is
// offline_raytracer_tpu_torch/ops/mega.py::mega_segment_plain.
//
// What bounds it on this card. A bounce-0 segment of 262,144 rays moves
// ~48 MB of ray planes (184 B per ray in and out) and ~4 MB of scene
// tables: ~15.5 us at 3.35 TB/s. Its arithmetic is data-dependent, at
// least ~20 slab tests and a leaf's worth of triangle tests per query, two
// queries per live ray: ~1.6 GFLOP, ~25 us at 67 TFLOP/s. The first design
// (one thread per ray) took ~52 ms for the four segments of a sample,
// about 0.2% of that: it was bound by the latency of each ray's
// long chain of dependent loads, not by bytes or operations. What this
// design does about each cause:
// 1. Few live rays underfilled the card (the fused tail's ~43k live rays
//    sat in ~1 block per SM). A group of G lanes (G in {1, 2, 4, 8, 16,
//    32}, a template parameter; the wrapper picks it per segment) now
//    carries each ray, so a segment launches G times the threads.
// 2. Each leaf was a serial 128-iteration loop of dependent L2 loads per
//    thread, ~880 triangle tests per bounce-0 ray. Each leaf now has 16
//    sub-boxes (runs of 8 consecutive slots, built with the tree:
//    ops/bvh.py sub_bounds_rows); the group tests them first, agrees on
//    the mask of boxes hit, and spreads only those boxes' triangles over
//    its lanes (~110 triangle tests per bounce-0 ray). A triangle's three
//    coefficient rows come from a leaf-major copy of the table (per leaf:
//    128 float4 c_n, then 128 c1, then 128 c2), loaded together, so a
//    group's loads are contiguous and a test costs one trip to L2. The
//    group reduces its least (enc, slot) with shuffles; the shadow walk
//    ends a leaf on a vote of the group.
// 3. The per-thread stack (int[64] + float[64]) lived in local memory.
//    The walk is now stackless: the heap's node ids give each ancestor and
//    sibling, and one 32-bit trail marks the levels whose far child is
//    still to visit; on the way back the far child's box is tested again
//    against the current bound. Registers are capped at 64 (8 blocks of 128
//    threads per SM): the spills that costs are cheaper than the latency
//    the extra warps hide.
// 4. In the fused tail a lane whose ray died idles until its warp is done.
//    This is not removed, only shortened: a warp holds 32 / G rays, and
//    each ray's walk is split G ways.
// The G lanes of a group walk the same node sequence and compute the
// shading redundantly (no divergence inside a group, no broadcasts); only
// lane 0 writes. The scene's small tables are staged per block in shared
// memory, cut to the columns the scene uses.
// Not here: wgmma (no matrix product), TMA, persistent threads.
//
// Numerics follow the JAX kernel: IEEE division (no fast math), NaN-
// propagating min/max where jnp.minimum/maximum stood, sign(0) == 0. The
// triangle winner is the least (hit t with its low 7 mantissa bits
// cleared, slot) over all triangles hit before the analytic hit, which
// makes the result independent of visit order and so of G; the plain
// version applies the same rule. The tree walk's slab tests are only a
// cull: they are made conservative (a NaN slab never rejects, a small
// relative slack on both ends), so the walk never skips a leaf or a
// sub-box the dense sweep would hit. Built with -fmad=false, so no
// instantiation contracts a product into an FMA where another does not:
// every G gives bitwise the same outputs as G = 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (ops/_kernels.py does this at first
//        use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;               // columns of the consts table; slots per leaf
constexpr int N_CONST_ROWS = 46;
constexpr int SPH = 0, BOX = 5, CYL = 12, MAT = 27, LGT = 45;
constexpr float INF = 3.4e38f;
constexpr float PARK = 1e8f;
constexpr float PI = 3.14159265358979f;
constexpr int THREADS = 128;            // per block (256 measured slower)
constexpr int MIN_BLOCKS = 8;           // per SM: caps registers at 64 per thread
constexpr int SUB = 16;                 // sub-leaf boxes per leaf
constexpr int SUB_TRIS = LANE / SUB;    // consecutive slots per sub-box
constexpr float SLACK = 1.00001f;       // relative slack of the cull

struct Params {
  const float* state;     // (11, Rp)
  const float* u;         // (8 nf, Rp)
  const float* ls;        // (10 nf, Rp)
  const float* consts;    // (46, 128)
  const float4* tri;      // (S / 128, 3, 128) float4: [c_n x128][c1 x128][c2 x128]
  const float* sub;       // (S / 128, 16, 8) sub-leaf boxes: min xyz, max xyz, 2 pad
  const int* tri_mat;     // (S,)
  const float* nodes;     // (n_internal, 12) child AABBs
  float* state_out;       // (11, Rp)
  float* rad_out;         // (3 + 3 nf, Rp)
  int Rp, nf, b_start, rr_start, n_leaves, m_occ, has_tris;
  int ns, nb, nc, nl, do_nee, do_mis, rr_quirk, cw;
  float t_min, hit_eps, rr_p;
};

// the consts table as staged in shared memory: 46 rows of cw columns
struct Tab {
  const float* s;
  int w;
  __device__ __forceinline__ float operator()(int row, int j) const { return s[row * w + j]; }
};

// The G lanes of a group that carries one ray (G divides 32).
template <int G>
struct Group {
  unsigned mask;
  int lane;
  __device__ __forceinline__ Group() {
    const int l = threadIdx.x & 31;
    lane = l & (G - 1);
    mask = (G == 32) ? 0xFFFFFFFFu : (((1u << G) - 1u) << (l & ~(G - 1)));
  }
  __device__ __forceinline__ bool any(bool x) const {
    if constexpr (G == 1) return x;
    else return __any_sync(mask, x);
  }
  __device__ __forceinline__ unsigned or_all(unsigned x) const {
    if constexpr (G == 1) return x;
    else return __reduce_or_sync(mask, x);
  }
};

struct V { float x, y, z; };

__device__ __forceinline__ V mk(float x, float y, float z) { V r; r.x = x; r.y = y; r.z = z; return r; }
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V add(V a, V b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V sub(V a, V b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V scale(float s, V a) { return mk(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V neg(V a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V sel(bool c, V a, V b) { return c ? a : b; }
__device__ __forceinline__ V cross(V a, V b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
// jnp.sign: 0 -> 0, NaN -> NaN
__device__ __forceinline__ float jsign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }

__device__ __forceinline__ V vnormalize(V a, float eps) {
  float inv = rsqrtf(jmax(dot(a, a), eps * eps));
  return scale(inv, a);
}

struct Mat {
  V kd, ks, kt, emit;
  float ior, isl, tol, rough, pd_c, ps_c;
};

__device__ Mat gather_mat(Tab sc, int m) {
  Mat r;
  r.kd = mk(sc(MAT + 0, m), sc(MAT + 1, m), sc(MAT + 2, m));
  r.ks = mk(sc(MAT + 3, m), sc(MAT + 4, m), sc(MAT + 5, m));
  r.kt = mk(sc(MAT + 6, m), sc(MAT + 7, m), sc(MAT + 8, m));
  r.ior = sc(MAT + 9, m);
  r.emit = mk(sc(MAT + 10, m), sc(MAT + 11, m), sc(MAT + 12, m));
  r.isl = sc(MAT + 13, m);
  r.tol = sc(MAT + 14, m);
  r.rough = sc(MAT + 15, m);
  r.pd_c = sc(MAT + 16, m);
  r.ps_c = sc(MAT + 17, m);
  return r;
}

// ---------------------------------------------------------------------------
// analytic primitives (ops/mega.py sphere/box/cylinder_consider)
// ---------------------------------------------------------------------------

__device__ void sphere_consider(Tab sc, int j, V o, V d, float t_min,
                                float& bt, V& bn, int& bm, int& bi, int id) {
  float cx = sc(SPH + 0, j), cy = sc(SPH + 1, j), cz = sc(SPH + 2, j);
  float r = sc(SPH + 3, j);
  int mt = (int)sc(SPH + 4, j);
  V rel = mk(o.x - cx, o.y - cy, o.z - cz);
  float b = dot(d, rel);
  float c = dot(rel, rel) - r * r;
  float disc = b * b - c;
  float sq = sqrtf(jmax(disc, 0.f));
  float tn = -b - sq, tp = -b + sq;
  float t = (tn >= t_min) ? tn : tp;
  if ((disc > 0.f) && (t >= t_min) && (t < bt)) {
    bt = t; bn = add(rel, scale(t, d)); bm = mt; bi = id;
  }
}

__device__ void box_consider(Tab sc, int j, V o, V d, float t_min,
                             float& bt, V& bn, int& bm, int& bi, int id) {
  float x0 = sc(BOX + 0, j), y0 = sc(BOX + 1, j), z0 = sc(BOX + 2, j);
  float x1 = sc(BOX + 3, j), y1 = sc(BOX + 4, j), z1 = sc(BOX + 5, j);
  int mt = (int)sc(BOX + 6, j);
  float ivx = 1.f / d.x, ivy = 1.f / d.y, ivz = 1.f / d.z;
  float ax0 = (x0 - o.x) * ivx, bx0 = (x1 - o.x) * ivx;
  float ay0 = (y0 - o.y) * ivy, by0 = (y1 - o.y) * ivy;
  float az0 = (z0 - o.z) * ivz, bz0 = (z1 - o.z) * ivz;
  float tnx = jmin(ax0, bx0), tfx = jmax(ax0, bx0);
  float tny = jmin(ay0, by0), tfy = jmax(ay0, by0);
  float tnz = jmin(az0, bz0), tfz = jmax(az0, bz0);
  float t_en = jmax(jmax(tnx, tny), tnz);
  float t_ex = jmin(jmin(tfx, tfy), tfz);
  bool inner = t_en < t_min;
  float t = inner ? t_ex : t_en;
  bool ok = (t_ex >= jmax(t_en, t_min)) && (t >= t_min) && (t < bt);
  if (!ok) return;
  bool w0_ex = (tfx <= tfy) && (tfx <= tfz);
  bool w0_en = (tnx >= tny) && (tnx >= tnz);
  bool w0 = (inner && w0_ex) || (!inner && w0_en);
  bool w1 = !w0 && ((inner && (tfy <= tfz)) || (!inner && (tny >= tnz)));
  bool w2 = !w0 && !w1;
  float flip = inner ? 1.f : -1.f;
  bt = t;
  bn = mk(w0 ? flip * jsign(d.x) : 0.f, w1 ? flip * jsign(d.y) : 0.f,
          w2 ? flip * jsign(d.z) : 0.f);
  bm = mt; bi = id;
}

__device__ void cylinder_consider(Tab sc, int j, V o, V d, float t_min,
                                  float& bt, V& bn, int& bm, int& bi, int id) {
  float bx = sc(CYL + 0, j), by = sc(CYL + 1, j), bz = sc(CYL + 2, j);
  float r = sc(CYL + 3, j), h = sc(CYL + 4, j);
  float q[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = sc(CYL + 5 + k, j);
  int mt = (int)sc(CYL + 14, j);
  V rel = mk(o.x - bx, o.y - by, o.z - bz);
  float ox = q[0] * rel.x + q[1] * rel.y + q[2] * rel.z;
  float oy = q[3] * rel.x + q[4] * rel.y + q[5] * rel.z;
  float oz = q[6] * rel.x + q[7] * rel.y + q[8] * rel.z;
  float dx = q[0] * d.x + q[1] * d.y + q[2] * d.z;
  float dy = q[3] * d.x + q[4] * d.y + q[5] * d.z;
  float dz = q[6] * d.x + q[7] * d.y + q[8] * d.z;
  float dz_s = (fabsf(dz) > 1e-12f) ? dz : 1e-12f;
  float t_bot = -oz / dz_s;
  float t_top = (h - oz) / dz_s;
  float t_slab_min = jmin(t_bot, t_top), t_slab_max = jmax(t_bot, t_top);
  float a = dx * dx + dy * dy;
  float b = dx * ox + dy * oy;
  float c = ox * ox + oy * oy - r * r;
  float disc = b * b - a * c;
  float sq = sqrtf(jmax(disc, 0.f));
  bool a_ok = a > 1e-12f;
  float safe_a = a_ok ? a : 1.f;
  float t_cyl_min = a_ok ? (-b - sq) / safe_a : -INF;
  float t_cyl_max = a_ok ? (-b + sq) / safe_a : INF;
  float t_en = jmax(t_slab_min, t_cyl_min);
  float t_ex = jmin(t_slab_max, t_cyl_max);
  bool inner = t_en < t_min;
  float t = inner ? t_ex : t_en;
  bool ok = (disc >= 0.f) && (t_ex >= jmax(t_en, t_min)) && (t >= t_min) && (t < bt);
  if (!ok) return;
  bool cap_win = (inner && (t_slab_max < t_cyl_max)) || (!inner && (t_slab_min > t_cyl_min));
  float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
  float cap_z = (pz > 0.5f * h) ? 1.f : -1.f;
  float nlx = cap_win ? 0.f : px;
  float nly = cap_win ? 0.f : py;
  float nlz = cap_win ? cap_z : 0.f;
  bt = t;
  bn = mk(q[0] * nlx + q[3] * nly + q[6] * nlz,
          q[1] * nlx + q[4] * nly + q[7] * nlz,
          q[2] * nlx + q[5] * nly + q[8] * nlz);
  bm = mt; bi = id;
}

__device__ void analytic_closest(Tab sc, const Params& p, V o, V d,
                                 float& bt, V& bn, int& bm, int& bi) {
  for (int j = 0; j < p.ns; ++j) sphere_consider(sc, j, o, d, p.t_min, bt, bn, bm, bi, j);
  for (int j = 0; j < p.nb; ++j) box_consider(sc, j, o, d, p.t_min, bt, bn, bm, bi, p.ns + j);
  for (int j = 0; j < p.nc; ++j)
    cylinder_consider(sc, j, o, d, p.t_min, bt, bn, bm, bi, p.ns + p.nb + j);
}

__device__ bool analytic_occluded(Tab sc, const Params& p, V o, V d, float tf) {
  V bn; int bm, bi;
  for (int j = 0; j < p.ns; ++j) {
    float t = INF; sphere_consider(sc, j, o, d, p.t_min, t, bn, bm, bi, 0);
    if (t < tf) return true;
  }
  for (int j = 0; j < p.nb; ++j) {
    float t = INF; box_consider(sc, j, o, d, p.t_min, t, bn, bm, bi, 0);
    if (t < tf) return true;
  }
  for (int j = 0; j < p.nc; ++j) {
    float t = INF; cylinder_consider(sc, j, o, d, p.t_min, t, bn, bm, bi, 0);
    if (t < tf) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// triangles: a group's stackless walk of the implicit-heap LBVH
// ---------------------------------------------------------------------------

// Conservative slab test of one AABB (6 floats: min xyz, max xyz). Returns
// whether the box may hold a hit nearer than lim; near = entry distance.
__device__ __forceinline__ bool slab(const float* box, V o, V iv, float lim, float& near) {
  if (!(box[0] <= box[3])) return false;          // inverted: empty subtree
  float tn = -INFINITY, tf = INFINITY;
  float oo[3] = {o.x, o.y, o.z};
  float ii[3] = {iv.x, iv.y, iv.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float a = (__ldg(&box[k]) - oo[k]) * ii[k];
    float b = (__ldg(&box[3 + k]) - oo[k]) * ii[k];
    if (a != a || b != b) continue;               // ray in the slab's plane
    tn = fmaxf(tn, fminf(a, b));
    tf = fminf(tf, fmaxf(a, b));
  }
  near = fmaxf(tn, 0.f);
  return (tf * SLACK >= near) && (near <= lim * SLACK);
}

// The ray against triangle j of a leaf (base = the leaf's leaf-major
// coefficients): true and its t if t_min <= t < lim and the hit lies in the
// triangle. The three coefficient loads are issued at once (one trip to L2
// instead of up to three in a row).
__device__ __forceinline__ bool tri_test(const float4* base, int j, V o, V d, float t_min,
                                         float lim, float& t) {
  const float4 cn = __ldg(base + j);
  const float4 c1 = __ldg(base + LANE + j);
  const float4 c2 = __ldg(base + 2 * LANE + j);
  float d_w = d.x * cn.x + d.y * cn.y + d.z * cn.z;
  if (!(fabsf(d_w) > 1e-12f)) return false;
  float o_w = o.x * cn.x + o.y * cn.y + o.z * cn.z + cn.w;
  t = -o_w / d_w;
  if (!(t >= t_min && t < lim)) return false;
  float uu = (o.x * c1.x + o.y * c1.y + o.z * c1.z + c1.w) + t * (d.x * c1.x + d.y * c1.y + d.z * c1.z);
  if (!(uu >= 0.f)) return false;
  float vv = (o.x * c2.x + o.y * c2.y + o.z * c2.z + c2.w) + t * (d.x * c2.x + d.y * c2.y + d.z * c2.z);
  return vv >= 0.f && uu + vv <= 1.f;
}

struct TriHit { int enc, slot; float lim; };

// The leaf's sub-boxes (runs of SUB_TRIS consecutive slots) that may hold
// a hit nearer than lim, as a mask agreed by the group: lane k tests boxes
// k, k+G, ...
template <int G>
__device__ unsigned leaf_boxes(const Params& p, const Group<G>& g, int leaf, V o, V iv, float lim) {
  const float* boxes = p.sub + (size_t)leaf * SUB * 8;
  unsigned m = 0;
  for (int b = g.lane; b < SUB; b += G) {
    float nn;
    if (slab(boxes + b * 8, o, iv, lim, nn)) m |= 1u << b;
  }
  return g.or_all(m);
}

// Slot (within the leaf) of work item w: triangle w % SUB_TRIS of the
// (w / SUB_TRIS)-th box of mask m.
__device__ __forceinline__ int work_slot(unsigned m, int w) {
  for (int k = w / SUB_TRIS; k > 0; --k) m &= m - 1;
  return (__ffs(m) - 1) * SUB_TRIS + w % SUB_TRIS;
}

// Closest-hit sweep of one leaf by the group: the triangles of the boxes
// that pass, spread over the lanes (lane k takes work items k, k+G, ...).
// Keep the least (enc, slot) among hits with t < A (the analytic best);
// lim = min(A, first t whose enc exceeds best). Each lane prunes on its own
// best; the group then agrees on the least (enc, slot) and lim.
template <int G>
__device__ void leaf_closest(const Params& p, const Group<G>& g, int leaf, V o, V d, V iv,
                             float A, TriHit& h) {
  const unsigned m = leaf_boxes(p, g, leaf, o, iv, h.lim);
  const int n = __popc(m) * SUB_TRIS;
  const float4* base = p.tri + (size_t)leaf * 3 * LANE;
  for (int w = g.lane; w < n; w += G) {
    const int j = work_slot(m, w);
    float t;
    if (!tri_test(base, j, o, d, p.t_min, h.lim, t)) continue;
    int enc = __float_as_int(t) & ~127;
    int s = leaf * LANE + j;
    if (enc < h.enc || (enc == h.enc && s < h.slot)) {
      h.enc = enc; h.slot = s;
      h.lim = fminf(A, __int_as_float(enc + 128));
    }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      int e = __shfl_xor_sync(g.mask, h.enc, off);
      int s = __shfl_xor_sync(g.mask, h.slot, off);
      float l = __shfl_xor_sync(g.mask, h.lim, off);
      if (e < h.enc || (e == h.enc && s < h.slot)) { h.enc = e; h.slot = s; }
      h.lim = fminf(h.lim, l);
    }
  }
}

// Any-hit sweep of one leaf by the group: ends at the first round of G
// work items in which some lane hits nearer than tf.
template <int G>
__device__ bool leaf_anyhit(const Params& p, const Group<G>& g, int leaf, V o, V d, V iv,
                            float tf) {
  const unsigned m = leaf_boxes(p, g, leaf, o, iv, tf);
  const int n = __popc(m) * SUB_TRIS;
  const float4* base = p.tri + (size_t)leaf * 3 * LANE;
  for (int w0 = 0; w0 < n; w0 += G) {
    const int w = w0 + g.lane;
    float t;
    bool hit = w < n && tri_test(base, work_slot(m, w), o, d, p.t_min, tf, t);
    if (g.any(hit)) return true;
  }
  return false;
}

// Walk the heap (children of node i at 2i+1 and 2i+2, leaves from
// n_leaves - 1 on), nearer child first, pruning against h.lim. No stack:
// bit L of `trail` says the far child at depth L is still to visit; the
// way back finds it from the current node's id and tests its box again
// against the bound as it stands then. any_hit: stop at the first hit
// nearer than h.lim. Returns true on an any-hit; closest hits land in h.
// Every lane of the group computes the same walk.
template <bool ANY, int G>
__device__ bool walk(const Params& p, const Group<G>& g, V o, V d, float A, TriHit& h) {
  if (p.m_occ <= 0) return false;
  V iv = mk(1.f / d.x, 1.f / d.y, 1.f / d.z);
  if (p.n_leaves == 1) {
    if (ANY) return leaf_anyhit(p, g, 0, o, d, iv, h.lim);
    leaf_closest(p, g, 0, o, d, iv, A, h);
    return false;
  }
  const int first_leaf = p.n_leaves - 1;
  int node = 0, depth = 0;
  unsigned trail = 0;
  while (true) {
    if (node < first_leaf) {
      const float* c = p.nodes + (size_t)node * 12;
      float n1 = 0.f, n2 = 0.f;
      bool h1 = slab(c, o, iv, h.lim, n1);
      bool h2 = slab(c + 6, o, iv, h.lim, n2);
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
      int leaf = node - first_leaf;
      if (leaf < p.m_occ) {
        if (ANY) {
          if (leaf_anyhit(p, g, leaf, o, d, iv, h.lim)) return true;
        } else {
          leaf_closest(p, g, leaf, o, d, iv, A, h);
        }
      }
    }
    // back to the deepest far child still to visit whose box the bound
    // has not pruned since
    while (true) {
      if (trail == 0) return false;
      const int L = 31 - __clz(trail);
      trail &= ~(1u << L);
      const int anc = ((node + 1) >> (depth - L)) - 1;
      node = (anc & 1) ? anc + 1 : anc - 1;
      depth = L;
      float nn;
      if (slab(p.nodes + (size_t)((node - 1) >> 1) * 12 + ((node & 1) ? 0 : 6), o, iv, h.lim, nn))
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// 3-lobe BSDF (ops/mega.py eval_bsdf_pl / pdf_bsdf_pl / sample_bsdf_pl)
// ---------------------------------------------------------------------------

__device__ __forceinline__ V schlick(V ks, float cos_d) {
  float m = jclip(1.f - fabsf(cos_d), 0.f, 1.f);
  float m2 = m * m;
  float p5 = m2 * m2 * m;
  return mk(ks.x + (1.f - ks.x) * p5, ks.y + (1.f - ks.y) * p5, ks.z + (1.f - ks.z) * p5);
}

__device__ __forceinline__ float ggx_d(float n_dot_h, float rough) {
  float a2 = rough * rough;
  float c = jclip(n_dot_h, 1e-6f, 1.f);
  float c2 = c * c;
  float tan2 = (1.f - c2) / c2;
  float s = a2 + tan2;
  float denom = PI * c2 * c2 * (s * s);
  float d = a2 / jmax(denom, 1e-20f);
  return (n_dot_h > 0.f) ? d : 0.f;
}

__device__ __forceinline__ float smith_g1(V w, V n, V m, float rough) {
  float w_dot_n = dot(w, n);
  float w_dot_m = dot(w, m);
  bool same_side = (w_dot_n * w_dot_m) > 0.f;
  float c2 = jclip(w_dot_n * w_dot_n, 1e-9f, 1.f);
  float tan2 = (1.f - c2) / c2;
  float g = 2.f / (1.f + sqrtf(1.f + rough * rough * tan2));
  return same_side ? g : 0.f;
}

__device__ __forceinline__ void etas(float n_dot_wo, float ior, float& eta_wo, float& eta_wi) {
  bool outside = n_dot_wo >= 0.f;
  eta_wo = outside ? 1.f : ior;
  eta_wi = outside ? ior : 1.f;
}

__device__ V eval_bsdf(V n, V wi, V wo, const Mat& mp, float distance) {
  float n_dot_wi = dot(wi, n);
  float n_dot_wo = dot(wo, n);
  bool same_side = (n_dot_wi * n_dot_wo) > 0.f;
  V ed = same_side ? mk(mp.kd.x / PI, mp.kd.y / PI, mp.kd.z / PI) : mk(0.f, 0.f, 0.f);

  float sgn_wi = jsign(n_dot_wi);
  V h = scale(sgn_wi, vnormalize(add(wi, wo), 1e-8f));
  float wi_dot_h = dot(wi, h);
  V f_spec = schlick(mp.ks, wi_dot_h);
  float d_spec = ggx_d(dot(n, h), mp.rough);
  float g_spec = smith_g1(wi, n, h, mp.rough) * smith_g1(wo, n, h, mp.rough);
  float denom_s = 4.f * jmax(fabsf(n_dot_wi) * fabsf(n_dot_wo), 1e-6f);
  float spec_scale = d_spec * g_spec / denom_s;
  float ks2 = dot(mp.ks, mp.ks);
  bool h_faces_wi = wi_dot_h * sgn_wi > 0.f;
  bool has_spec = (ks2 > 0.f) && h_faces_wi && same_side;
  V es = has_spec ? mk(f_spec.x * spec_scale, f_spec.y * spec_scale, f_spec.z * spec_scale)
                  : mk(0.f, 0.f, 0.f);

  float eta_wo, eta_wi;
  etas(n_dot_wo, mp.ior, eta_wo, eta_wi);
  V ht = neg(add(scale(eta_wo, wo), scale(eta_wi, wi)));
  V m = vnormalize(ht, 1e-8f);
  m = scale(jsign(dot(m, n)), m);
  float wo_dot_m = dot(wo, m);
  float wi_dot_m = dot(wi, m);
  float eta = eta_wo / eta_wi;

  bool inside = n_dot_wo < 0.f;
  V att = inside ? mk(expf(distance * logf(jclip(mp.kt.x, 1e-6f, 1.f))),
                      expf(distance * logf(jclip(mp.kt.y, 1e-6f, 1.f))),
                      expf(distance * logf(jclip(mp.kt.z, 1e-6f, 1.f))))
                 : mk(1.f, 1.f, 1.f);

  float d_t = ggx_d(dot(n, m), mp.rough);
  float g_t = smith_g1(wi, n, m, mp.rough) * smith_g1(wo, n, m, mp.rough);
  V f_t = schlick(mp.ks, wi_dot_m);
  float jd = eta_wo * wo_dot_m + eta_wi * wi_dot_m;
  float jac_denom = jd * jd;
  float denom_t = jmax(fabsf(n_dot_wi) * fabsf(n_dot_wo) * jmax(jac_denom, 1e-9f), 1e-9f);
  float num_t = d_t * g_t * fabsf(wi_dot_m) * fabsf(wo_dot_m) * eta_wi * eta_wi;
  float t_scale = num_t / denom_t;
  V et_refract = !same_side ? mk((1.f - f_t.x) * t_scale, (1.f - f_t.y) * t_scale,
                                 (1.f - f_t.z) * t_scale)
                            : mk(0.f, 0.f, 0.f);
  float wo_dot_h = dot(wo, h);
  float radicand_h = 1.f - eta * eta * (1.f - wo_dot_h * wo_dot_h);
  bool es_tir_on = same_side && (radicand_h < 0.f) && h_faces_wi;
  V es_tir = es_tir_on ? mk(f_spec.x * spec_scale, f_spec.y * spec_scale, f_spec.z * spec_scale)
                       : mk(0.f, 0.f, 0.f);
  float kt2 = dot(mp.kt, mp.kt);
  bool has_trans = kt2 > 0.f;
  V sel_t = same_side ? es_tir : et_refract;
  V et = has_trans ? mk(att.x * sel_t.x, att.y * sel_t.y, att.z * sel_t.z) : mk(0.f, 0.f, 0.f);

  float aw = fabsf(n_dot_wi);
  return mk(aw * (ed.x + es.x + et.x), aw * (ed.y + es.y + et.y), aw * (ed.z + es.z + et.z));
}

__device__ float pdf_bsdf(V n, V wi, V wo, const Mat& mp) {
  float pd_c = mp.pd_c, ps_c = mp.ps_c;
  float pt_c = jmax(1.f - pd_c - ps_c, 0.f);
  float n_dot_wi = dot(wi, n);
  float n_dot_wo = dot(wo, n);
  float pd = jmax(n_dot_wi * jsign(n_dot_wo), 0.f) / PI;
  bool same_side = (n_dot_wi * n_dot_wo) > 0.f;

  V h = scale(jsign(n_dot_wi), vnormalize(add(wi, wo), 1e-8f));
  float wi_dot_h = dot(wi, h);
  float n_dot_h = dot(n, h);
  float d_spec = ggx_d(n_dot_h, mp.rough);
  float ps = d_spec * fabsf(n_dot_h) / jmax(4.f * fabsf(wi_dot_h), 1e-9f);
  ps = same_side ? ps : 0.f;

  float eta_wo, eta_wi;
  etas(n_dot_wo, mp.ior, eta_wo, eta_wi);
  V m = vnormalize(neg(add(scale(eta_wo, wo), scale(eta_wi, wi))), 1e-8f);
  m = scale(jsign(dot(m, n)), m);
  float wo_dot_m = dot(wo, m);
  float wi_dot_m = dot(wi, m);
  float eta = eta_wo / eta_wi;
  float d_t = ggx_d(dot(n, m), mp.rough);
  float jd = eta_wo * wo_dot_m + eta_wi * wi_dot_m;
  float jac_denom = jmax(jd * jd, 1e-9f);
  float pt_refract = d_t * fabsf(dot(n, m)) * eta_wi * eta_wi * fabsf(wi_dot_m) / jac_denom;
  pt_refract = same_side ? 0.f : pt_refract;
  float wo_dot_h = dot(wo, h);
  float radicand_h = 1.f - eta * eta * (1.f - wo_dot_h * wo_dot_h);
  float pt = same_side ? ((radicand_h < 0.f) ? ps : 0.f) : pt_refract;
  return pd_c * pd + ps_c * ps + pt_c * pt;
}

__device__ __forceinline__ V frame_to_world(float lx, float ly, float lz, V n) {
  bool near_pole = fabsf(n.z) > 0.999f;
  float inv = rsqrtf(jmax(n.x * n.x + n.y * n.y, 1e-16f));
  V b0 = near_pole ? mk(1.f, 0.f, 0.f) : mk(-n.y * inv, n.x * inv, 0.f);
  V t = vnormalize(cross(b0, n), 1e-8f);
  V b = cross(n, t);
  return add(add(scale(lx, t), scale(ly, b)), scale(lz, n));
}

__device__ V sample_bsdf(float e0, float e1, float choice, V n, V wo, const Mat& mp, bool& is_trans) {
  float pd_c = mp.pd_c, ps_c = mp.ps_c;
  float phi = 2.f * PI * e1;
  float cphi = cosf(phi), sphi = sinf(phi);

  float n_dot_wo = dot(wo, n);
  V n_face = scale(jsign(n_dot_wo), n);

  float cos_d = sqrtf(e0);
  float sin_d = sqrtf(jclip(1.f - e0, 0.f, 1.f));
  V wi_diffuse = frame_to_world(sin_d * cphi, sin_d * sphi, cos_d, n_face);

  float a2e = mp.rough * mp.rough * e0 / jmax(1.f - e0, 1e-9f);
  float cos_m = rsqrtf(1.f + a2e);
  float sin_m = sqrtf(jclip(1.f - cos_m * cos_m, 0.f, 1.f));
  V m = frame_to_world(sin_m * cphi, sin_m * sphi, cos_m, n_face);

  float wo_dot_m = dot(wo, m);
  V wi_spec = sub(scale(2.f * fabsf(wo_dot_m), m), wo);

  float eta_wo, eta_wi;
  etas(n_dot_wo, mp.ior, eta_wo, eta_wi);
  float eta = eta_wo / eta_wi;
  float radicand = 1.f - eta * eta * (1.f - wo_dot_m * wo_dot_m);
  bool tir = radicand < 0.f;
  float sq = sqrtf(jclip(radicand, 0.f, 1.f));
  V wi_refract = sub(scale(eta * wo_dot_m - sq, m), scale(eta, wo));
  V wi_trans = tir ? wi_spec : wi_refract;

  bool pick_d = choice < pd_c;
  bool pick_s = !pick_d && (choice < pd_c + ps_c);
  V wi = pick_d ? wi_diffuse : (pick_s ? wi_spec : wi_trans);
  is_trans = !pick_d && !pick_s && !tir;
  return vnormalize(wi, 1e-8f);
}

// ---------------------------------------------------------------------------
// the kernel: a group of G lanes per ray, bounces [b_start, b_start + nf)
// ---------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mega_kernel(Params p) {
  extern __shared__ float smem[];
  const int cw = p.cw;
  for (int k = threadIdx.x; k < N_CONST_ROWS * cw; k += blockDim.x)
    smem[k] = p.consts[(k / cw) * LANE + k % cw];
  __syncthreads();
  const Tab sc{smem, cw};

  const Group<G> g;
  const int i = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int Rp = p.Rp;
  if (i >= Rp) return;
  const bool lead = g.lane == 0;   // the lane that writes the ray's outputs
  const int nf = p.nf;
  const int tri_base = p.ns + p.nb + p.nc;
  const int INF_ENC = __float_as_int(INF) & ~127;

  const float* st = p.state + i;
  V o = mk(st[0], st[Rp], st[2 * Rp]);
  V d = mk(st[3 * Rp], st[4 * Rp], st[5 * Rp]);
  V tp = mk(st[6 * Rp], st[7 * Rp], st[8 * Rp]);
  float prev_pdf = st[9 * Rp];
  bool alive = st[10 * Rp] > 0.5f;
  float rx = 0.f, ry = 0.f, rz = 0.f;

  float* rad = p.rad_out + i;
  for (int fb = 0; fb < nf; ++fb) {
    float* rec_id = rad + (size_t)(3 + fb) * Rp;
    float* rec_vis = rad + (size_t)(3 + nf + fb) * Rp;
    float* rec_alive = rad + (size_t)(3 + 2 * nf + fb) * Rp;
    if (!alive) {                 // dead at the bounce's start: miss records
      if (lead) { *rec_id = -1.f; *rec_vis = 0.f; *rec_alive = 0.f; }
      continue;
    }
    const float* uu = p.u + (size_t)(fb * 8) * Rp + i;

    // ---- closest hit: analytic, then triangles nearer than it
    float bt = INF;
    V bn = mk(0.f, 0.f, 1.f);
    int bm = 0, bid = -1;
    analytic_closest(sc, p, o, d, bt, bn, bm, bid);
    if (p.has_tris) {
      TriHit h; h.enc = 0x7FFFFFFF; h.slot = 0x7FFFFFFF; h.lim = bt;
      walk<false>(p, g, o, d, bt, h);
      if (h.slot != 0x7FFFFFFF && h.enc < INF_ENC) {
        bt = __int_as_float(h.enc);
        float4 cn = __ldg(p.tri + (size_t)(h.slot >> 7) * 3 * LANE + (h.slot & 127));
        bn = mk(cn.x, cn.y, cn.z);
        bm = __ldg(&p.tri_mat[h.slot]);
        bid = tri_base + h.slot;
      }
    }
    float t = bt;
    V n = vnormalize(bn, 1e-12f);
    bool valid = t < INF;
    Mat mp = gather_mat(sc, valid ? bm : 0);

    // ---- emission with MIS
    bool hit_light = (mp.isl > 0.5f) && valid;
    float mis_w = 1.f;
    if (p.do_nee && p.do_mis) {
      float inv_l_hit = 0.f;
      if (mp.tol >= 0.f && mp.tol < (float)p.nl) inv_l_hit = sc(LGT, (int)mp.tol);
      float cos_l = dot(n, neg(d));
      float p_nee = inv_l_hit * t * t / jmax(fabsf(cos_l), 1e-6f);
      p_nee = valid ? p_nee : 0.f;
      bool mis_applies = (mp.tol >= 0.f) && (prev_pdf >= 0.f);
      mis_w = mis_applies ? prev_pdf / jmax(prev_pdf + p_nee, 1e-12f) : 1.f;
    } else if (p.do_nee) {
      bool front = dot(n, neg(d)) > 1e-6f;
      mis_w = ((mp.tol >= 0.f) && (prev_pdf >= 0.f) && front) ? 0.f : 1.f;
    }
    if (p.rr_quirk && p.rr_p < 1.f && (p.b_start + fb) > p.rr_start)
      mis_w = mis_w * ((prev_pdf >= 0.f) ? p.rr_p : 1.f);
    if (hit_light) {
      rx += tp.x * mp.emit.x * mis_w;
      ry += tp.y * mp.emit.y * mis_w;
      rz += tp.z * mp.emit.z * mis_w;
    }
    alive = valid && !hit_light;

    // ---- shading point
    float t_safe = valid ? t : 1.f;
    V x = alive ? add(o, scale(t_safe - p.hit_eps, d)) : o;
    V wo = neg(d);
    float seg_len = valid ? t : 0.f;

    // ---- next-event estimation with the any-hit shadow walk
    float vis_out = 1.f;
    if (p.do_nee && alive) {
      const float* L = p.ls + (size_t)(fb * 10) * Rp + i;
      V lp = mk(L[0], L[Rp], L[2 * Rp]);
      V ln = mk(L[3 * Rp], L[4 * Rp], L[5 * Rp]);
      V lemit = mk(L[6 * Rp], L[7 * Rp], L[8 * Rp]);
      float pdf_area = L[9 * Rp];
      V to_l = sub(lp, x);
      float dist = sqrtf(jmax(dot(to_l, to_l), 1e-18f));
      V wi_l = scale(1.f / dist, to_l);
      float cos_l2 = dot(ln, neg(wi_l));
      float p_nee_solid = pdf_area * dist * dist / jmax(fabsf(cos_l2), 1e-6f);
      bool occ = false;
      if (cos_l2 > 1e-6f) {
        float tfb = dist * 0.999f;
        occ = analytic_occluded(sc, p, x, wi_l, tfb);
        if (!occ && p.has_tris) {
          TriHit h; h.lim = tfb;
          occ = walk<true>(p, g, x, wi_l, tfb, h);
        }
      }
      vis_out = occ ? 0.f : 1.f;
      if (!occ && (cos_l2 > 1e-6f) && (p_nee_solid > 1e-9f)) {
        V f_l = eval_bsdf(n, wi_l, wo, mp, seg_len);
        float w_l = 1.f;
        if (p.do_mis) {
          float p_b = pdf_bsdf(n, wi_l, wo, mp);
          w_l = p_nee_solid / jmax(p_nee_solid + p_b, 1e-12f);
        }
        float geom = cos_l2 / jmax(dist * dist, 1e-12f);
        float scl = geom * w_l / jmax(pdf_area, 1e-12f);
        rx += tp.x * f_l.x * lemit.x * scl;
        ry += tp.y * f_l.y * lemit.y * scl;
        rz += tp.z * f_l.z * lemit.z * scl;
      }
    }

    // ---- Russian roulette
    if (p.rr_p < 1.f && (p.b_start + fb) >= p.rr_start) {
      alive = alive && (uu[4 * (size_t)Rp] < p.rr_p);
      tp = mk(tp.x / p.rr_p, tp.y / p.rr_p, tp.z / p.rr_p);
    }

    // ---- BSDF continuation
    if (alive) {
      bool is_trans;
      V wi = sample_bsdf(uu[5 * (size_t)Rp], uu[6 * (size_t)Rp], uu[7 * (size_t)Rp], n, wo, mp,
                         is_trans);
      float pdf = pdf_bsdf(n, wi, wo, mp);
      bool ok_pdf = pdf > 1e-8f;
      if (ok_pdf) {
        V f = eval_bsdf(n, wi, wo, mp, seg_len);
        float inv_pdf = 1.f / jmax(pdf, 1e-8f);
        tp = mk(tp.x * f.x * inv_pdf, tp.y * f.y * inv_pdf, tp.z * f.z * inv_pdf);
        o = is_trans ? add(o, scale(t_safe + p.hit_eps, d)) : x;
        d = wi;
        prev_pdf = pdf;
      } else {
        alive = false;
      }
    }
    if (!alive) {
      o = mk(PARK, PARK, PARK);
      prev_pdf = -1.f;
    }
    if (lead) {
      *rec_id = (float)bid;
      *rec_vis = vis_out;
      *rec_alive = alive ? 1.f : 0.f;
    }
  }

  if (!lead) return;
  float* so = p.state_out + i;
  so[0] = o.x; so[Rp] = o.y; so[2 * Rp] = o.z;
  so[3 * Rp] = d.x; so[4 * Rp] = d.y; so[5 * Rp] = d.z;
  so[6 * Rp] = tp.x; so[7 * Rp] = tp.y; so[8 * Rp] = tp.z;
  so[9 * Rp] = prev_pdf;
  so[10 * Rp] = alive ? 1.f : 0.f;
  rad[0] = rx; rad[Rp] = ry; rad[2 * Rp] = rz;
}

template <int G>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int rays_per_block = THREADS / G;
  const int blocks = (p.Rp + rays_per_block - 1) / rays_per_block;
  const size_t smem = sizeof(float) * N_CONST_ROWS * p.cw;
  mega_kernel<G><<<blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// group: lanes per ray, one of 1, 2, 4, 8, 16, 32; cols: columns of the
// consts table the scene uses (staged in shared memory), 1..128.
extern "C" int mega_segment(
    const void* state, const void* u, const void* ls, const void* consts,
    const void* tri, const void* sub, const void* tri_mat, const void* nodes,
    void* state_out, void* rad_out,
    int Rp, int nf, int b_start, int rr_start, int n_leaves, int m_occ, int has_tris,
    int ns, int nb, int nc, int nl, int do_nee, int do_mis, int rr_quirk,
    int cols, int group, float t_min, float hit_eps, float rr_p, void* stream) {
  if (cols < 1 || cols > LANE) return (int)cudaErrorInvalidValue;
  Params p;
  p.state = static_cast<const float*>(state);
  p.u = static_cast<const float*>(u);
  p.ls = static_cast<const float*>(ls);
  p.consts = static_cast<const float*>(consts);
  p.tri = static_cast<const float4*>(tri);
  p.sub = static_cast<const float*>(sub);
  p.tri_mat = static_cast<const int*>(tri_mat);
  p.nodes = static_cast<const float*>(nodes);
  p.state_out = static_cast<float*>(state_out);
  p.rad_out = static_cast<float*>(rad_out);
  p.Rp = Rp; p.nf = nf; p.b_start = b_start; p.rr_start = rr_start;
  p.n_leaves = n_leaves; p.m_occ = m_occ; p.has_tris = has_tris;
  p.ns = ns; p.nb = nb; p.nc = nc; p.nl = nl;
  p.do_nee = do_nee; p.do_mis = do_mis; p.rr_quirk = rr_quirk; p.cw = cols;
  p.t_min = t_min; p.hit_eps = hit_eps; p.rr_p = rr_p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 4: return launch<4>(p, s);
    case 8: return launch<8>(p, s);
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
