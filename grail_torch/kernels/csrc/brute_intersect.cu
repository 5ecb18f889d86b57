// Brute-force ray / triangle-set intersection for Hopper (sm_90a).
//
// Replaces grail/kernels/pallas_intersect.py::_kernel, the TPU kernel that
// streams a packed (T,9) [v0|e1|e2] triangle table through SMEM over (8,128)
// ray tiles. Here: one thread per ray, 256 threads a block; the block stages
// the whole table (at most 1024 triangles, 36 KB) in shared memory, and every
// thread then reads the same triangle in the same iteration (a broadcast).
//
// Contract, as the reference: each ray keeps the hit with tmin < t < t_best,
// compared strictly, looping over triangles in index order, so the lowest
// index wins ties. A miss writes t = tmax, prim = -1, b1 = b2 = 0. The
// any-hit variant stops at the first hit in index order (occluded =
// prim >= 0). A lane with tmax <= tmin (the integrator's dead-lane mask)
// cannot hit and skips the loop.
//
// Arithmetic keeps the operation order of the reference kernel. Built with
// --fmad=false and without fast math, so no multiply-add is contracted and
// the division is IEEE: the result should equal the plain PyTorch version
// (brute_intersect.py) bit for bit.
//
// Bound: about 55 FP32 operations per ray-triangle pair against 48 bytes of
// ray I/O per ray. At the Cornell box's 36 triangles and 1M rays that is
// ~2.0 G operations (~0.03 ms at 67 TFLOP/s) against 48 MB (~0.014 ms at
// 3.35 TB/s): compute-bound, and the more so as T grows. The design answers
// with the cheapest operand path (shared-memory broadcast, no per-pair global
// traffic) and an early exit for dead lanes and for any-hit rays; the ray I/O
// is read and written exactly once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) brute_intersect_kernel(
    const float* __restrict__ tris, int n_tris,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out, int n) {
  extern __shared__ float s_tris[];
  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x) s_tris[i] = tris[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float t_min = tmin[r];
  float t_best = tmax[r];
  int prim_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;

  if (t_best > t_min) {
    for (int k = 0; k < n_tris; ++k) {
      const float* tri = s_tris + 9 * k;
      const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
      const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
      const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
      // s1 = d x e2
      const float s1x = dy * e2z - dz * e2y;
      const float s1y = dz * e2x - dx * e2z;
      const float s1z = dx * e2y - dy * e2x;
      const float divisor = s1x * e1x + s1y * e1y + s1z * e1z;
      const float inv = 1.0f / (divisor == 0.0f ? 1.0f : divisor);
      const float sx = ox - v0x;
      const float sy = oy - v0y;
      const float sz = oz - v0z;
      const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
      // s2 = s x e1
      const float s2x = sy * e1z - sz * e1y;
      const float s2y = sz * e1x - sx * e1z;
      const float s2z = sx * e1y - sy * e1x;
      const float b2 = (dx * s2x + dy * s2y + dz * s2z) * inv;
      const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
      const bool hit = (divisor != 0.0f) && (b1 >= 0.0f) && (b1 <= 1.0f) &&
                       (b2 >= 0.0f) && (b1 + b2 <= 1.0f) && (t > t_min) &&
                       (t < t_best);
      if (hit) {
        t_best = t;
        prim_best = k;
        b1_best = b1;
        b2_best = b2;
        if (kAnyHit) break;
      }
    }
  }
  t_out[r] = t_best;
  prim_out[r] = prim_best;
  b1_out[r] = b1_best;
  b2_out[r] = b2_best;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, types, devices and n_tris <= 1024 (36 KB of shared memory,
// under the 48 KB a block may take without opting in).
extern "C" int grail_brute_intersect(const float* tris, int n_tris,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     float* t_out, int* prim_out,
                                     float* b1_out, float* b2_out, int n,
                                     int any_hit, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * 9 * static_cast<size_t>(n_tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    brute_intersect_kernel<true><<<grid, kThreads, smem, s>>>(
        tris, n_tris, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n);
  } else {
    brute_intersect_kernel<false><<<grid, kThreads, smem, s>>>(
        tris, n_tris, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
