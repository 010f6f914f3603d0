// One light sample for next-event estimation, per lane, on the card: the
// device twin of ops/lights.sample_lights.
//
// area_lights::sample(lights, u_pick, u_a, u_b, u_c) picks a light
// uniformly and a point on it, as sample_lights does for one row of its
// (R, 4) uniforms: a sphere uniformly over its surface, a cylinder over its
// lateral surface or a cap by area (the local point and normal rotated to
// the world by rot^T), a mesh by a binary search of its area CDF for the
// triangle and a barycentric point on it. It computes the picked light's
// kind only; sample_lights computes every kind and selects, which gives the
// same values.
//
// Every value rounds as PyTorch's CUDA kernels round sample_lights' on the
// card, so the sample is sample_lights' bit for bit:
// - every product, sum and quotient is formed on its own: a library that
//   includes this header is built with -fmad=false, so no a * b + c
//   becomes an FMA; sqrtf and the division are IEEE, sinf and cosf the
//   libm calls of PyTorch's elementwise kernels;
// - a 3-term sum over a last dimension (torch.sum(x * x, -1)) adds in
//   PyTorch's CUDA order for a contiguous last dimension of 3,
//   (x0 + x2) + x1;
// - the cylinder's rotation adds the rows in lights._rot_t's order,
//   (row 0 + row 1) + row 2;
// - torch.linalg.cross's CUDA kernel is compiled with FMA contraction:
//   a1 * b2 - a2 * b1 is fma(a1, b2, -(a2 * b1)), and so for each row;
// - torch.searchsorted(right=False) is PyTorch's lower bound, mid by mid;
// - c / x for a Python float c is (1 / x) * c; a Python float scalar is
//   its nearest float (1e-7, 1 - 1e-7 and 1e-12 below);
// - clamp passes NaN through.
//
// The light table is tiny (a few lights, a few emissive triangles) and is
// read through the read-only cache.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace area_lights {

// ops/lights.KIND_SPHERE, KIND_CYLINDER; anything else is a mesh
constexpr int KIND_SPHERE = 0;
constexpr int KIND_CYLINDER = 1;

constexpr float PI_F = 3.14159274f;      // float(math.pi)
constexpr float TWO_PI_F = 6.28318548f;  // float(2.0 * math.pi)
constexpr float CDF_LO = 0x1.ad7f2ap-24f;  // float(1e-7)
constexpr float CDF_HI = 0x1.fffffcp-1f;   // float(1.0 - 1e-7)
constexpr float TINY = 0x1.197998p-40f;    // float(1e-12)

// ops/lights.AreaLights on the card, every array contiguous, and the
// material table's (M, 3) emission
struct Lights {
  const int* kind;        // (L,)
  const int* mat;         // (L,)
  const float* area;      // (L,)
  const float* p0;        // (L, 3)
  const float* axis;      // (L, 3)
  const float* radius;    // (L,)
  const float* rot;       // (L, 3, 3)
  const int* tri_lo;      // (L,)
  const int* tri_hi;      // (L,)
  const float* cdf_base;  // (L,)
  const float* em_v0;     // (T, 3)
  const float* em_v1;     // (T, 3)
  const float* em_v2;     // (T, 3)
  const float* em_cdf;    // (T,)
  const float* emit;      // (M, 3)
  int L;                  // lights, at least 1
  int T;                  // emissive triangles, 0 without a mesh light
};

struct Vec {
  float x, y, z;
};

// a ops/lights.LightSample row
struct Sample {
  Vec p;           // point on the light
  Vec n;           // outward surface normal
  Vec emit;        // emitted radiance
  float pdf_area;  // area pdf incl. the 1/L pick
};

__device__ __forceinline__ Vec ld3(const float* a, int i) {
  return Vec{__ldg(a + 3 * i), __ldg(a + 3 * i + 1), __ldg(a + 3 * i + 2)};
}

__device__ __forceinline__ Vec vsub(Vec a, Vec b) {
  return Vec{a.x - b.x, a.y - b.y, a.z - b.z};
}

// torch.clamp(x, lo, hi), torch.clamp(x, min=lo)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_minf(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.sqrt(torch.sum(a * a, -1)) over a contiguous last dimension of 3
__device__ __forceinline__ float norm(Vec a) {
  return sqrtf((a.x * a.x + a.z * a.z) + a.y * a.y);
}

// torch.linalg.cross on CUDA (its kernel contracts to an FMA)
__device__ __forceinline__ Vec cross(Vec a, Vec b) {
  return Vec{__fmaf_rn(a.y, b.z, -(a.z * b.y)),
             __fmaf_rn(a.z, b.x, -(a.x * b.z)),
             __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// lights._rot_t: rot^T v, rot row-major (3, 3)
__device__ __forceinline__ Vec rot_t(const float* rot, Vec v) {
  const Vec r0 = ld3(rot, 0), r1 = ld3(rot, 1), r2 = ld3(rot, 2);
  return Vec{(r0.x * v.x + r1.x * v.y) + r2.x * v.z,
             (r0.y * v.x + r1.y * v.y) + r2.y * v.z,
             (r0.z * v.x + r1.z * v.y) + r2.z * v.z};
}

// torch.searchsorted(cdf, key, right=False) over a 1-D cdf of T values:
// PyTorch's lower bound, so its answer even where cdf is not sorted
__device__ __forceinline__ int lower_bound(const float* cdf, int T,
                                           float key) {
  int start = 0, end = T;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(__ldg(cdf + mid) >= key)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

__device__ inline Sample sample(const Lights& lt, float u_pick, float u_a,
                                float u_b, float u_c) {
  const int L = lt.L;
  // torch.clamp((u_pick * L).to(torch.int32), max=L - 1)
  const int i = min((int)(u_pick * (float)L), L - 1);
  const int kind = __ldg(lt.kind + i);
  const float r = __ldg(lt.radius + i);
  const Vec p0 = ld3(lt.p0, i);
  Sample s;
  if (kind == KIND_SPHERE) {
    // uniform on the surface
    const float z = 1.0f - 2.0f * u_a;
    const float phi = TWO_PI_F * u_b;
    const float sr = sqrtf(clampf(1.0f - z * z, 0.0f, 1.0f));
    s.n = Vec{sr * cosf(phi), sr * sinf(phi), z};
    s.p = Vec{p0.x + r * s.n.x, p0.y + r * s.n.y, p0.z + r * s.n.z};
  } else if (kind == KIND_CYLINDER) {
    // lateral surface vs caps by area; local frame: base at the origin,
    // axis +z, height h; world = rot^T local + base
    const float h = norm(ld3(lt.axis, i));
    const float a_lat = (TWO_PI_F * r) * h;
    const float a_cap = (PI_F * r) * r;
    const float a_tot = clamp_minf(a_lat + 2.0f * a_cap, TINY);
    const bool pick_lat = u_c < a_lat / a_tot;
    const bool pick_top = !pick_lat && u_c < (a_lat + a_cap) / a_tot;
    const float phi = TWO_PI_F * u_b;
    const float cphi = cosf(phi), sphi = sinf(phi);
    const float rad = pick_lat ? r : r * sqrtf(u_a);
    const float z = pick_lat ? u_a * h : (pick_top ? h : 0.0f);
    const Vec p_local{rad * cphi, rad * sphi, z};
    const Vec n_local = pick_lat ? Vec{cphi, sphi, 0.0f}
                                 : Vec{0.0f, 0.0f, pick_top ? 1.0f : -1.0f};
    const float* rot = lt.rot + 9 * i;
    const Vec pw = rot_t(rot, p_local);
    s.p = Vec{pw.x + p0.x, pw.y + p0.y, pw.z + p0.z};
    s.n = rot_t(rot, n_local);
  } else if (lt.T > 0) {
    // the light is chosen; the triangle comes from the globally monotone
    // CDF (mesh light k's slice spans (k, k + 1])
    const int lo = __ldg(lt.tri_lo + i), hi = __ldg(lt.tri_hi + i);
    const float key = __ldg(lt.cdf_base + i) + clampf(u_a, CDF_LO, CDF_HI);
    const int t =
        min(max(lower_bound(lt.em_cdf, lt.T, key), lo), max(hi - 1, lo));
    const Vec v0 = ld3(lt.em_v0, t), v1 = ld3(lt.em_v1, t),
              v2 = ld3(lt.em_v2, t);
    const float su = sqrtf(clampf(u_b, TINY, 1.0f));
    const float b0 = 1.0f - su;
    const float b1 = su * (1.0f - u_c);
    const float b2 = (1.0f - b0) - b1;
    s.p = Vec{(b0 * v0.x + b1 * v1.x) + b2 * v2.x,
              (b0 * v0.y + b1 * v1.y) + b2 * v2.y,
              (b0 * v0.z + b1 * v1.z) + b2 * v2.z};
    const Vec c = cross(vsub(v1, v0), vsub(v2, v0));
    const float d = clamp_minf(norm(c), TINY);
    s.n = Vec{c.x / d, c.y / d, c.z / d};
  } else {
    // a mesh light with no triangle pool: sample_lights' placeholder
    s.p = Vec{0.0f, 0.0f, 0.0f};
    s.n = Vec{0.0f, 0.0f, 1.0f};
  }
  s.pdf_area = 1.0f / (clamp_minf(__ldg(lt.area + i), TINY) * (float)L);
  s.emit = ld3(lt.emit, __ldg(lt.mat + i));
  return s;
}

}  // namespace area_lights
