// Forward shading of one wavefront bounce for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package shades a bounce in XLA, and the
// port's plain version, integrator.shade_bounce, issues ~580 PyTorch
// operations a bounce over every lane, dead ones too: at
// 810,000 lanes and 50 bounces the host spends ~12 us issuing each, and the
// card ~3 ms a bounce running them. This kernel does the whole of a bounce's
// shading without next-event estimation in one launch, one thread a lane:
// emission (with the reference's RR quirk), the sky, the backed-off hit
// point, Russian roulette, the material gather, the BSDF sample, its pdf
// and value, the transmission push-through and the parking of finished
// lanes. NEE scenes, the replay and autograd keep the plain body.
//
// Semantics are the plain body's, operation for operation, and every value
// rounds as PyTorch's CUDA kernels round it on the card, so each output is
// bit for bit the plain body's:
// - every product, sum and quotient is formed on its own (the library is
//   built with -fmad=false, so no a * b + c becomes an FMA), sqrtf and the
//   division are IEEE (no fast math), and expf, logf, sinf, cosf and powf
//   are the libm calls PyTorch's elementwise kernels make (pow(x, 5) is
//   powf; pow(x, 2) is x * x);
// - a 3-term sum over a last dimension (torch.sum(a * b, -1)) and the
//   2-norm (torch.linalg.vector_norm) add in PyTorch's CUDA order for a
//   contiguous last dimension of 3, (x0 + x2) + x1, each square rounded;
// - torch.linalg.cross's CUDA kernel is compiled with FMA contraction:
//   a1 * b2 - a2 * b1 is fma(a1, b2, -(a2 * b1)), and so for each row;
// - x / c for a Python float c is x * (1.0f / c) (PyTorch multiplies by
//   the reciprocal of a CPU scalar), and c / x is (1 / x) * c (Tensor's
//   __rtruediv__ is reciprocal() * c);
// - clamp, maximum and minimum pass NaN through; sign(x) is (0 < x) -
//   (x < 0).
//
// Dead lanes. A lane dead on entry does no BSDF work: it reads its alive
// byte and, when the outputs are the inputs (the wrapper shades in place
// after its first bounce), writes only its throughput, and that only when
// Russian roulette divides every lane's by the survival probability; else
// it copies its state with the parked origin. Nothing downstream reads a
// dead lane but its radiance and alive byte.
//
// What bounds it on this card: the bytes. A live lane reads ~163 B
// (hit, state, 8 uniforms, its material rows) and writes ~53 B, a dead one
// reads 1 B in place; the ~600 FP32 operations and 9 libm calls of a live lane are
// far below the issue rate at the wavefront's live shares.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// flags (ops/wave_shade.py)
constexpr int RR_ON = 1;      // this bounce runs the RR gate
constexpr int QUIRK_ON = 2;   // the reference's final RR gate on emission
constexpr int ROUGH_MAT = 4;  // roughness from the Phong exponent

constexpr float PI_F = 3.14159274f;          // float(math.pi)
constexpr float TWO_PI_F = 6.28318548f;      // float(2.0 * math.pi)
constexpr float PARK_ORIGIN = 1e8f;          // integrator.PARK_ORIGIN

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.sum(x, -1) over a contiguous last dimension of 3 on CUDA
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}
// torch.sum(a * b, -1)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// torch.linalg.vector_norm(a, dim=-1); also bsdf._length
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

// torch.clamp(x, min=lo), torch.clamp(x, lo, hi), torch.maximum/minimum
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// torch.sign
__device__ __forceinline__ float sgn(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// utils/math.normalize: a / max(|a|, 1e-8)
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = clamp_min(norm(a), 1e-8f);
  return V3{a.x / n, a.y / n, a.z / n};
}

// torch.linalg.cross on CUDA (its kernel contracts to an FMA)
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{__fmaf_rn(a.y, b.z, -(a.z * b.y)),
            __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// utils/math.frame_to_world(local, n), build_frame inlined
__device__ V3 frame_to_world(float l0, float l1, float l2, V3 n) {
  const bool near_pole = fabsf(n.z) > 0.999f;
  const float inv =
      (1.0f / sqrtf(clamp_min(n.x * n.x + n.y * n.y, 1e-16f))) * 1.0f;
  const V3 b_generic{-n.y * inv, n.x * inv, 0.0f};
  const V3 b0 = pick(near_pole, V3{1.0f, 0.0f, 0.0f}, b_generic);
  const V3 t = normalize(cross(b0, n));
  const V3 b = cross(n, t);
  return add(add(scale(t, l0), scale(b, l1)), scale(n, l2));
}

// ---- ops/bsdf.py

struct Mat {
  V3 kd, ks, kt;
  float ior, rough;
  float pd_c, ps_c, pt_c;   // lobe_weights
};

// schlick_fresnel(ks, cos_d)
__device__ __forceinline__ V3 schlick(V3 ks, float cos_d) {
  const float m = clamp(1.0f - fabsf(cos_d), 0.0f, 1.0f);
  const float m5 = powf(m, 5.0f);
  return V3{ks.x + (1.0f - ks.x) * m5, ks.y + (1.0f - ks.y) * m5,
            ks.z + (1.0f - ks.z) * m5};
}

__device__ __forceinline__ float ggx_d(float n_dot_h, float roughness) {
  const float a2 = roughness * roughness;
  const float c = clamp(n_dot_h, 1e-6f, 1.0f);
  const float c2 = c * c;
  const float tan2 = (1.0f - c2) / c2;
  const float s = a2 + tan2;
  const float denom = ((PI_F * c2) * c2) * (s * s);
  const float d = a2 / clamp_min(denom, 1e-20f);
  return n_dot_h > 0.0f ? d : 0.0f;
}

__device__ __forceinline__ float smith_g1(V3 w, V3 n, V3 m, float roughness) {
  const float w_dot_n = dot(w, n);
  const float w_dot_m = dot(w, m);
  const bool same_side = (w_dot_n * w_dot_m) > 0.0f;
  const float c2 = clamp(w_dot_n * w_dot_n, 1e-9f, 1.0f);
  const float tan2 = (1.0f - c2) / c2;
  const float g =
      (1.0f / (1.0f + sqrtf(1.0f + (roughness * roughness) * tan2))) * 2.0f;
  return same_side ? g : 0.0f;
}

// eval_bsdf(n, wi, wo, mat, distance): f |wi.N|
__device__ V3 eval_bsdf(V3 n, V3 wi, V3 wo, const Mat& mat, float distance,
                        float inv_pi) {
  const float n_dot_wi = dot(wi, n);
  const float n_dot_wo = dot(wo, n);
  const bool same_side = (n_dot_wi * n_dot_wo) > 0.0f;

  const V3 ed = pick(same_side, scale(mat.kd, inv_pi), V3{0.0f, 0.0f, 0.0f});

  const V3 h = scale(normalize(add(wi, wo)), sgn(n_dot_wi));
  const float wi_dot_h = dot(wi, h);
  const V3 f_spec = schlick(mat.ks, wi_dot_h);
  const float d_spec = ggx_d(dot(n, h), mat.rough);
  const float g_spec =
      smith_g1(wi, n, h, mat.rough) * smith_g1(wo, n, h, mat.rough);
  const float denom_s =
      4.0f * clamp_min(fabsf(n_dot_wi) * fabsf(n_dot_wo), 1e-6f);
  const float spec_w = (d_spec * g_spec) / denom_s;
  const bool h_faces_wi = wi_dot_h * sgn(n_dot_wi) > 0.0f;
  const bool has_spec = (dot(mat.ks, mat.ks) > 0.0f) && h_faces_wi && same_side;
  const V3 es = pick(has_spec, scale(f_spec, spec_w), V3{0.0f, 0.0f, 0.0f});

  const bool outside = n_dot_wo >= 0.0f;
  const float eta_wo = outside ? 1.0f : mat.ior;
  const float eta_wi = outside ? mat.ior : 1.0f;
  const V3 ht = neg(add(scale(wo, eta_wo), scale(wi, eta_wi)));
  V3 m = normalize(ht);
  m = scale(m, sgn(dot(m, n)));
  const float wo_dot_m = dot(wo, m);
  const float wi_dot_m = dot(wi, m);
  const float eta = eta_wo / eta_wi;

  V3 att{1.0f, 1.0f, 1.0f};
  if (n_dot_wo < 0.0f) {
    att = V3{expf(distance * logf(minimum(maximum(mat.kt.x, 1e-6f), 1.0f))),
             expf(distance * logf(minimum(maximum(mat.kt.y, 1e-6f), 1.0f))),
             expf(distance * logf(minimum(maximum(mat.kt.z, 1e-6f), 1.0f)))};
  }

  const float d_t = ggx_d(dot(n, m), mat.rough);
  const float g_t =
      smith_g1(wi, n, m, mat.rough) * smith_g1(wo, n, m, mat.rough);
  const V3 fr_t = schlick(mat.ks, wi_dot_m);
  const V3 f_t{1.0f - fr_t.x, 1.0f - fr_t.y, 1.0f - fr_t.z};
  const float jac = eta_wo * wo_dot_m + eta_wi * wi_dot_m;
  const float jac_denom = jac * jac;
  const float denom_t = clamp_min(
      (fabsf(n_dot_wi) * fabsf(n_dot_wo)) * clamp_min(jac_denom, 1e-9f),
      1e-9f);
  const float num_t = (((d_t * g_t) * fabsf(wi_dot_m)) * fabsf(wo_dot_m)) *
                      (eta_wi * eta_wi);
  const V3 et_refract = pick(!same_side, scale(f_t, num_t / denom_t),
                             V3{0.0f, 0.0f, 0.0f});
  const float wo_dot_h = dot(wo, h);
  const float radicand_h = 1.0f - (eta * eta) * (1.0f - wo_dot_h * wo_dot_h);
  const bool tir_ok = same_side && (radicand_h < 0.0f) && h_faces_wi;
  const V3 es_tir = pick(tir_ok, scale(f_spec, spec_w), V3{0.0f, 0.0f, 0.0f});
  V3 et = pick(same_side, es_tir, et_refract);
  const bool has_trans = dot(mat.kt, mat.kt) > 0.0f;
  et = pick(has_trans, mul(att, et), V3{0.0f, 0.0f, 0.0f});

  return scale(add(add(ed, es), et), fabsf(n_dot_wi));
}

// pdf_bsdf(n, wi, wo, mat)
__device__ float pdf_bsdf(V3 n, V3 wi, V3 wo, const Mat& mat, float inv_pi) {
  const float n_dot_wi = dot(wi, n);
  const float n_dot_wo = dot(wo, n);

  const float pd = clamp_min(n_dot_wi * sgn(n_dot_wo), 0.0f) * inv_pi;
  const bool same_side = (n_dot_wi * n_dot_wo) > 0.0f;

  const V3 h = scale(normalize(add(wi, wo)), sgn(n_dot_wi));
  const float wi_dot_h = dot(wi, h);
  const float n_dot_h = dot(n, h);
  const float d_spec = ggx_d(n_dot_h, mat.rough);
  float ps = (d_spec * fabsf(n_dot_h)) /
             clamp_min(4.0f * fabsf(wi_dot_h), 1e-9f);
  ps = same_side ? ps : 0.0f;

  const bool outside = n_dot_wo >= 0.0f;
  const float eta_wo = outside ? 1.0f : mat.ior;
  const float eta_wi = outside ? mat.ior : 1.0f;
  V3 m = normalize(neg(add(scale(wo, eta_wo), scale(wi, eta_wi))));
  m = scale(m, sgn(dot(m, n)));
  const float wo_dot_m = dot(wo, m);
  const float wi_dot_m = dot(wi, m);
  const float eta = eta_wo / eta_wi;
  const float n_dot_m = dot(n, m);
  const float d_t = ggx_d(n_dot_m, mat.rough);
  const float jac = eta_wo * wo_dot_m + eta_wi * wi_dot_m;
  const float jac_denom = clamp_min(jac * jac, 1e-9f);
  float pt_refract = ((((d_t * fabsf(n_dot_m)) * (eta_wi * eta_wi)) *
                       fabsf(wi_dot_m)) / jac_denom);
  pt_refract = same_side ? 0.0f : pt_refract;
  const float wo_dot_h = dot(wo, h);
  const float radicand_h = 1.0f - (eta * eta) * (1.0f - wo_dot_h * wo_dot_h);
  const float pt =
      same_side ? (radicand_h < 0.0f ? ps : 0.0f) : pt_refract;
  return (mat.pd_c * pd + mat.ps_c * ps) + mat.pt_c * pt;
}

// sample_bsdf(u, n, wo, mat): (normalised wi, is_transmission)
__device__ V3 sample_bsdf(float e0, float e1, float choice, V3 n, V3 wo,
                          const Mat& mat, bool& is_trans) {
  const float phi = TWO_PI_F * e1;
  const float cos_phi = cosf(phi), sin_phi = sinf(phi);

  const float n_dot_wo = dot(wo, n);
  const V3 n_face = scale(n, sgn(n_dot_wo));

  const float cos_d = sqrtf(e0);
  const float sin_d = sqrtf(clamp(1.0f - e0, 0.0f, 1.0f));
  const V3 wi_diffuse =
      frame_to_world(sin_d * cos_phi, sin_d * sin_phi, cos_d, n_face);

  const float a2e =
      ((mat.rough * mat.rough) * e0) / clamp_min(1.0f - e0, 1e-9f);
  const float cos_m = (1.0f / sqrtf(1.0f + a2e)) * 1.0f;
  const float sin_m = sqrtf(clamp(1.0f - cos_m * cos_m, 0.0f, 1.0f));
  const V3 m = frame_to_world(sin_m * cos_phi, sin_m * sin_phi, cos_m, n_face);

  const float wo_dot_m = dot(wo, m);
  const V3 wi_spec = sub(scale(m, 2.0f * fabsf(wo_dot_m)), wo);

  const bool outside = n_dot_wo >= 0.0f;
  const float eta_wo = outside ? 1.0f : mat.ior;
  const float eta_wi = outside ? mat.ior : 1.0f;
  const float eta = eta_wo / eta_wi;
  const float radicand = 1.0f - (eta * eta) * (1.0f - wo_dot_m * wo_dot_m);
  const bool tir = radicand < 0.0f;
  const float sq = sqrtf(clamp(radicand, 0.0f, 1.0f));
  const V3 wi_refract = sub(scale(m, eta * wo_dot_m - sq), scale(wo, eta));
  const V3 wi_trans = pick(tir, wi_spec, wi_refract);

  const bool pick_d = choice < mat.pd_c;
  const bool pick_s = !pick_d && (choice < mat.pd_c + mat.ps_c);
  const V3 wi = pick(pick_d, wi_diffuse, pick(pick_s, wi_spec, wi_trans));
  is_trans = !pick_d && !pick_s && !tir;
  return normalize(wi);
}

struct Args {
  // the bounce's hit
  const float* t;
  const float* normal;
  const int* mat;
  const unsigned char* valid;
  // the path state in
  const float* origin;
  const float* direction;
  const float* throughput;
  const float* radiance;
  const unsigned char* alive;
  const float* prev_pdf;
  // (8, R) uniform planes
  const float* u;
  // the material table, M rows
  const float* kd;
  const float* ks;
  const float* kt;
  const float* ior;
  const float* spec_exp;
  const float* emit;
  const unsigned char* is_light;
  // the sky's (bottom, top, up), or null
  const float* sky;
  // the path state out (may be the state in)
  float* o_origin;
  float* o_direction;
  float* o_throughput;
  float* o_radiance;
  unsigned char* o_alive;
  float* o_prev_pdf;
  int R;
  int flags;
  float hit_eps;
  float rr;          // float(cfg.russian_roulette)
  float inv_rr;      // 1.0f / rr
  float inv_pi;      // 1.0f / float(pi)
  float roughness;   // float(cfg.default_roughness)
};

__global__ void __launch_bounds__(THREADS) wave_shade_kernel(const Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.R) return;
  const bool in_place = a.o_alive == a.alive;
  const bool rr_on = (a.flags & RR_ON) != 0;

  if (a.alive[i] == 0) {
    // dead on entry: no contribution, no continuation
    if (!in_place) {
      store3(a.o_origin, i, V3{PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN});
      store3(a.o_direction, i, load3(a.direction, i));
      const V3 r = load3(a.radiance, i);
      V3 rad = add(r, V3{0.0f, 0.0f, 0.0f});
      if (a.sky != nullptr) rad = add(rad, V3{0.0f, 0.0f, 0.0f});
      store3(a.o_radiance, i, rad);
      a.o_alive[i] = 0;
      a.o_prev_pdf[i] = -1.0f;
    }
    if (!in_place || rr_on) {
      const V3 tp = load3(a.throughput, i);
      store3(a.o_throughput, i, rr_on ? scale(tp, a.inv_rr) : tp);
    }
    return;
  }

  const bool valid = a.valid[i] != 0;
  const float t = a.t[i];
  const V3 o = load3(a.origin, i);
  const V3 d = load3(a.direction, i);
  V3 tp = load3(a.throughput, i);
  const V3 r0 = load3(a.radiance, i);
  const float prev_pdf = a.prev_pdf[i];
  const int m = a.mat[i];
  const bool hit_light = a.is_light[m] != 0 && valid;

  // ---- emission (implicit light connection), MIS weight 1 without NEE
  float mis_w = 1.0f;
  if (a.flags & QUIRK_ON) mis_w = mis_w * (prev_pdf >= 0.0f ? a.rr : 1.0f);
  const V3 em = hit_light ? scale(mul(tp, load3(a.emit, m)), mis_w)
                          : V3{0.0f, 0.0f, 0.0f};
  V3 rad = add(r0, em);

  // ---- the sky: a live ray that misses reaches it
  if (a.sky != nullptr) {
    V3 sky_term{0.0f, 0.0f, 0.0f};
    if (!valid) {
      const V3 bottom = load3(a.sky, 0), top = load3(a.sky, 1),
               up = load3(a.sky, 2);
      const float s = 0.5f * (dot(d, up) + 1.0f);
      const V3 sky = add(scale(bottom, 1.0f - s), scale(top, s));
      sky_term = mul(tp, sky);
    }
    rad = add(rad, sky_term);
  }

  bool alive = valid && !hit_light;

  // ---- surface interaction: backed-off hit point
  const float t_safe = valid ? t : 1.0f;
  const float seg_len = valid ? t : 0.0f;

  // ---- Russian roulette
  if (rr_on) {
    alive = alive && (a.u[4 * (size_t)a.R + i] < a.rr);
    tp = scale(tp, a.inv_rr);
  }

  if (!alive) {
    store3(a.o_origin, i, V3{PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN});
    store3(a.o_direction, i, d);
    store3(a.o_throughput, i, tp);
    store3(a.o_radiance, i, rad);
    a.o_alive[i] = 0;
    a.o_prev_pdf[i] = -1.0f;
    return;
  }

  const V3 x = add(o, scale(d, t_safe - a.hit_eps));
  const V3 wo = neg(d);
  const V3 n = load3(a.normal, i);

  // ---- bsdf.gather_mat_params
  Mat mat;
  mat.kd = load3(a.kd, m);
  mat.ks = load3(a.ks, m);
  mat.kt = load3(a.kt, m);
  mat.ior = maximum(a.ior[m], 1.0f);
  mat.rough = (a.flags & ROUGH_MAT)
                  ? sqrtf((1.0f / (a.spec_exp[m] + 2.0f)) * 2.0f)
                  : a.roughness;
  {
    // bsdf.lobe_weights
    const float ld = norm(mat.kd), ls = norm(mat.ks), lt = norm(mat.kt);
    const float s = clamp_min((ld + ls) + lt, 1e-12f);
    mat.pd_c = ld / s;
    mat.ps_c = ls / s;
    mat.pt_c = lt / s;
  }

  // ---- BSDF continuation
  const size_t R = (size_t)a.R;
  bool is_trans;
  V3 wi = sample_bsdf(a.u[5 * R + i], a.u[6 * R + i], a.u[7 * R + i], n, wo,
                      mat, is_trans);
  wi = normalize(wi);
  const float pdf = pdf_bsdf(n, wi, wo, mat, a.inv_pi);
  const V3 f = eval_bsdf(n, wi, wo, mat, seg_len, a.inv_pi);
  const bool ok_pdf = pdf > 1e-8f;
  alive = ok_pdf;
  if (ok_pdf) {
    const float c = clamp_min(pdf, 1e-8f);
    const V3 tf = mul(tp, f);
    tp = V3{tf.x / c, tf.y / c, tf.z / c};
  }

  // transmission pushes through the surface instead of backing off
  const V3 x_next = is_trans ? add(o, scale(d, t_safe + a.hit_eps)) : x;

  store3(a.o_origin, i,
         alive ? x_next : V3{PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN});
  store3(a.o_direction, i, alive ? wi : d);
  store3(a.o_throughput, i, tp);
  store3(a.o_radiance, i, rad);
  a.o_alive[i] = alive ? 1 : 0;
  a.o_prev_pdf[i] = alive ? pdf : -1.0f;
}

}  // namespace

// One bounce's shading without NEE (integrator.shade_bounce).
// Hit: t (R,) float32, normal (R, 3) float32, mat (R,) int32, valid (R,)
// bytes. State in: origin, direction, throughput, radiance (R, 3) float32,
// alive (R,) bytes, prev_pdf (R,) float32. u: the bounce's (8, R) uniform
// planes. Materials (M rows): kd, ks, kt, emit (M, 3) float32, ior and
// spec_exp (M,) float32, is_light (M,) bytes. sky: (3, 3) float32 rows
// bottom, top, up, or null for none. State out: the six state planes,
// either all distinct from the state in or all the same buffers (in
// place). Every pointer contiguous. flags: 1 RR gate this bounce, 2 the
// RR quirk on emission, 4 roughness from the Phong exponent.
// Returns the launch's CUDA error (0 on success); no sync.
extern "C" int wave_shade(const void* t, const void* normal, const void* mat,
                          const void* valid, const void* origin,
                          const void* direction, const void* throughput,
                          const void* radiance, const void* alive,
                          const void* prev_pdf, const void* u, const void* kd,
                          const void* ks, const void* kt, const void* ior,
                          const void* spec_exp, const void* emit,
                          const void* is_light, const void* sky,
                          void* o_origin, void* o_direction,
                          void* o_throughput, void* o_radiance, void* o_alive,
                          void* o_prev_pdf, int R, int flags, float hit_eps,
                          float rr, float inv_rr, float inv_pi,
                          float roughness, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.t = static_cast<const float*>(t);
  a.normal = static_cast<const float*>(normal);
  a.mat = static_cast<const int*>(mat);
  a.valid = static_cast<const unsigned char*>(valid);
  a.origin = static_cast<const float*>(origin);
  a.direction = static_cast<const float*>(direction);
  a.throughput = static_cast<const float*>(throughput);
  a.radiance = static_cast<const float*>(radiance);
  a.alive = static_cast<const unsigned char*>(alive);
  a.prev_pdf = static_cast<const float*>(prev_pdf);
  a.u = static_cast<const float*>(u);
  a.kd = static_cast<const float*>(kd);
  a.ks = static_cast<const float*>(ks);
  a.kt = static_cast<const float*>(kt);
  a.ior = static_cast<const float*>(ior);
  a.spec_exp = static_cast<const float*>(spec_exp);
  a.emit = static_cast<const float*>(emit);
  a.is_light = static_cast<const unsigned char*>(is_light);
  a.sky = static_cast<const float*>(sky);
  a.o_origin = static_cast<float*>(o_origin);
  a.o_direction = static_cast<float*>(o_direction);
  a.o_throughput = static_cast<float*>(o_throughput);
  a.o_radiance = static_cast<float*>(o_radiance);
  a.o_alive = static_cast<unsigned char*>(o_alive);
  a.o_prev_pdf = static_cast<float*>(o_prev_pdf);
  a.R = R;
  a.flags = flags;
  a.hit_eps = hit_eps;
  a.rr = rr;
  a.inv_rr = inv_rr;
  a.inv_pi = inv_pi;
  a.roughness = roughness;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wave_shade_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
