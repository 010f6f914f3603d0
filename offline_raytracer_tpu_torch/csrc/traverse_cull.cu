// Listed-leaf triangle sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel offline_raytracer_tpu/ops/traverse_cull.py::_kernel
// (launched by _sweep_pallas through pl.pallas_call). The host
// (ops/traverse_cull.py) has already culled every ray against every leaf box
// and reduced the result to one list of wanted leaves per 128-ray row. This
// kernel sweeps, for each ray, the 128 triangles of every leaf on its row's
// list: closest hit, or any hit with an early exit per row. The plain
// PyTorch version of the same contract is ops/traverse.py::tri_hit_plain
// (a dense sweep over all leaves).
//
// What bounds it on this card: the sweep is ~40 flops per (ray, triangle),
// all of it from registers and shared memory, with the coefficients read
// once per (row, leaf): 6 KB from L2 (a bunny-sized table is 3.3 MB and
// stays in the 50 MB L2). So it is bound by issue rate and by how evenly
// the rows' list lengths fill the SMs, not by bytes.
//
// The design, simply for now:
// - one block per row, one thread per ray (128 threads); the block walks
//   its row's list; rows launch longest list first (the host's order);
// - per leaf, the block stages the leaf's 128 x 12 coefficients in shared
//   memory with coalesced 16-byte loads, then each thread sweeps them;
//   every thread reads the same address at once (a broadcast);
// - any hit: a resolved ray stops testing, and the row stops once no ray
//   of it is still unresolved (__syncthreads_or), as the TPU kernel's
//   while condition does.
//
// Numerics: the same expression order as the plain version, built with
// -fmad=false (ops/_kernels.py) so no a*b+c is contracted to an FMA, and
// IEEE division; so kernel and plain version compute bit-identical t, u
// and v. The winner is the least (t, slot) among hits with
// t_min <= t < t_far, whatever the visit order. Any hit: the first hit
// found resolves the ray (its t becomes t_min).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;    // rays per row = threads per block = tris per leaf

struct Params {
  const float* ro;        // (Rp, 3)
  const float* rd;        // (Rp, 3)
  const float* t_far;     // (Rp,)
  const int* lists;       // (n_rows, L) wanted leaves first, in leaf order
  const int* counts;      // (n_rows,)
  const int* rows;        // (n_rows,) launch order
  const float4* tri;      // (S, 3) float4: [s1 c1] [s2 c2] [n cw]
  float* t_out;           // (Rp,)
  int* slot_out;          // (Rp,)
  int L;
  float t_min;
};

// One leaf's 128 triangles from shared memory against one ray.
template <bool ANY>
__device__ __forceinline__ void sweep(const float4* sh, int s0, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float t_min, float& best_t, int& best_i) {
  for (int j = 0; j < ROW; ++j) {
    const float4 c1 = sh[3 * j], c2 = sh[3 * j + 1], cn = sh[3 * j + 2];
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
__global__ void __launch_bounds__(ROW) cull_kernel(Params p) {
  __shared__ float4 sh[3 * ROW];
  const int row = p.rows[blockIdx.x];
  const int i = row * ROW + threadIdx.x;
  const float ox = p.ro[3 * i], oy = p.ro[3 * i + 1], oz = p.ro[3 * i + 2];
  const float dx = p.rd[3 * i], dy = p.rd[3 * i + 1], dz = p.rd[3 * i + 2];
  const float tf = p.t_far[i];
  float best_t = tf;
  int best_i = -1;
  const int count = p.counts[row];
  const int* list = p.lists + (size_t)row * p.L;
  for (int k = 0; k < count; ++k) {
    // the barrier also keeps the previous leaf's readers ahead of the
    // next leaf's stores
    if (ANY) {
      if (!__syncthreads_or(best_i < 0 && tf > p.t_min)) break;
    } else {
      __syncthreads();
    }
    const int leaf = list[k];
    const float4* src = p.tri + (size_t)leaf * ROW * 3;
    sh[threadIdx.x] = src[threadIdx.x];
    sh[threadIdx.x + ROW] = src[threadIdx.x + ROW];
    sh[threadIdx.x + 2 * ROW] = src[threadIdx.x + 2 * ROW];
    __syncthreads();
    if (!(best_t > p.t_min)) continue;     // dead or resolved
    sweep<ANY>(sh, leaf * ROW, ox, oy, oz, dx, dy, dz, p.t_min, best_t, best_i);
  }
  p.t_out[i] = best_t;
  p.slot_out[i] = best_i;
}

}  // namespace

extern "C" int traverse_cull(
    const void* ro, const void* rd, const void* t_far, const void* lists,
    const void* counts, const void* rows, const void* tri, void* t_out,
    void* slot_out, int n_rows, int L, int any_hit, float t_min, void* stream) {
  Params p;
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.t_far = static_cast<const float*>(t_far);
  p.lists = static_cast<const int*>(lists);
  p.counts = static_cast<const int*>(counts);
  p.rows = static_cast<const int*>(rows);
  p.tri = static_cast<const float4*>(tri);
  p.t_out = static_cast<float*>(t_out);
  p.slot_out = static_cast<int*>(slot_out);
  p.L = L;
  p.t_min = t_min;
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    cull_kernel<true><<<n_rows, ROW, 0, s>>>(p);
  } else {
    cull_kernel<false><<<n_rows, ROW, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
