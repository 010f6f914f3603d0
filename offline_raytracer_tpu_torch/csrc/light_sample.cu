// The segment route's light-sample planes for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package samples the lights in XLA, and
// the port's plain version runs ops/lights.sample_lights once a bounce of a
// segment over every lane, then concatenates the planes: ~100 PyTorch
// operations a bounce, the cylinder's rotation among them as a batched 3x3
// gemv, which cuBLAS ran ~70x slower than its bytes allow (~1.2 ms a call
// over the showcase's 921,600 lanes). This kernel writes all of a
// segment's planes in one launch, one thread a lane and bounce, each
// sample light_sample.cuh's device function, bit for bit sample_lights' on
// the card.
//
// Every lane is sampled, dead ones too, as the plain version does, so the
// planes are its planes; the segment kernel reads the live lanes' only.
//
// What bounds it on this card: the bytes. A lane and bounce reads its 4
// uniforms (16 B) and writes 10 planes (40 B); the light table (a few
// hundred bytes) stays in the read-only cache, and the arithmetic of one
// sample (a sine and cosine, a square root, a few dozen FP32 operations, a
// binary search over a mesh light's few triangles) is far below the issue
// rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "light_sample.cuh"

namespace {

constexpr int THREADS = 256;

// u: (8 * nf, Rp) uniform planes, bounce b's light sample from rows
// 8b .. 8b + 3 (pick, a, b, c). out: (10 * nf, Rp), bounce b's planes in
// rows 10b .. 10b + 9: point (3), normal (3), emit (3), area pdf.
__global__ void __launch_bounds__(THREADS)
    light_sample_kernel(const area_lights::Lights lt,
                        const float* __restrict__ u, float* __restrict__ out,
                        int Rp) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= Rp) return;
  const size_t R = (size_t)Rp;
  const float* ub = u + (size_t)(8 * blockIdx.y) * R + lane;
  const area_lights::Sample s =
      area_lights::sample(lt, ub[0], ub[R], ub[2 * R], ub[3 * R]);
  float* ob = out + (size_t)(10 * blockIdx.y) * R + lane;
  ob[0] = s.p.x;
  ob[R] = s.p.y;
  ob[2 * R] = s.p.z;
  ob[3 * R] = s.n.x;
  ob[4 * R] = s.n.y;
  ob[5 * R] = s.n.z;
  ob[6 * R] = s.emit.x;
  ob[7 * R] = s.emit.y;
  ob[8 * R] = s.emit.z;
  ob[9 * R] = s.pdf_area;
}

}  // namespace

// u: (8 * nf, Rp) float32. The table: ops/lights.AreaLights' arrays kind,
// mat (L,) int32, area (L,), p0, axis (L, 3), radius (L,), rot (L, 3, 3),
// tri_lo, tri_hi (L,) int32, cdf_base (L,), em_v0, em_v1, em_v2 (T, 3),
// em_cdf (T,) float32, and the material table's emit (M, 3) float32. out:
// (10 * nf, Rp) float32. Every pointer contiguous; L >= 1, T >= 0.
// Returns the launch's CUDA error (0 on success); no sync.
extern "C" int light_sample(const void* u, const void* kind, const void* mat,
                            const void* area, const void* p0,
                            const void* axis, const void* radius,
                            const void* rot, const void* tri_lo,
                            const void* tri_hi, const void* cdf_base,
                            const void* em_v0, const void* em_v1,
                            const void* em_v2, const void* em_cdf,
                            const void* emit, void* out, int Rp, int nf,
                            int L, int T, void* stream) {
  if (Rp <= 0 || nf <= 0 || nf > 65535 || L <= 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  area_lights::Lights lt;
  lt.kind = static_cast<const int*>(kind);
  lt.mat = static_cast<const int*>(mat);
  lt.area = static_cast<const float*>(area);
  lt.p0 = static_cast<const float*>(p0);
  lt.axis = static_cast<const float*>(axis);
  lt.radius = static_cast<const float*>(radius);
  lt.rot = static_cast<const float*>(rot);
  lt.tri_lo = static_cast<const int*>(tri_lo);
  lt.tri_hi = static_cast<const int*>(tri_hi);
  lt.cdf_base = static_cast<const float*>(cdf_base);
  lt.em_v0 = static_cast<const float*>(em_v0);
  lt.em_v1 = static_cast<const float*>(em_v1);
  lt.em_v2 = static_cast<const float*>(em_v2);
  lt.em_cdf = static_cast<const float*>(em_cdf);
  lt.emit = static_cast<const float*>(emit);
  lt.L = L;
  lt.T = T;
  const dim3 grid((Rp + THREADS - 1) / THREADS, nf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  light_sample_kernel<<<grid, THREADS, 0, s>>>(
      lt, static_cast<const float*>(u), static_cast<float*>(out), Rp);
  return (int)cudaGetLastError();
}
