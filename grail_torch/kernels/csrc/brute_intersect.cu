// Brute-force ray / triangle-set intersection for Hopper (sm_90a).
//
// Replaces grail/kernels/pallas_intersect.py::_kernel, the TPU kernel that
// streams a packed (T,9) [v0|e1|e2] triangle table through SMEM over (8,128)
// ray tiles.
//
// Contract, as the reference: each ray keeps the hit with tmin < t < t_best,
// compared strictly, looping over triangles in index order, so the lowest
// index wins ties. A miss writes t = tmax, prim = -1, b1 = b2 = 0. The
// any-hit variant stops at the first hit in index order (occluded =
// prim >= 0). A lane with tmax <= tmin (the integrator's dead-lane mask)
// cannot hit.
//
// What bounds it on the H100: issue. The work is ~55 FP32 operations per
// ray-triangle pair against 48 bytes of ray I/O per ray (36 triangles, 1M
// rays: ~0.03 ms of operations at 67 TFLOP/s, ~0.014 ms of bytes). Built
// with --fmad=false (no multiply-add may be contracted, or the bits would
// differ from the plain version), every multiply and add is its own
// instruction, so the ceiling is the FP32 issue rate (132 SMs x 128 lanes a
// clock), not the FMA rate that the operations bound divides by. Every
// instruction a pair does not issue is time saved. The design:
//   - A 48-byte triangle row in shared memory, float4 v0|0, e1|0, e2|0: a
//     lane reads a triangle as 3 aligned 16-byte broadcasts. The block pads
//     the (T,9) rows as it stages them (the fourth words are never read), so
//     the padding costs no launch and no host time: a pad in the wrapper
//     made the wrapper's host time, not the kernel, set the launch rate.
//   - kRays rays a thread: one triangle's 3 loads and the loop's bookkeeping
//     serve kRays rays. Fixed at 2 by measurement on the H100 (4 was slower
//     on every wave: PERF.md).
//   - The loop runs while one ray of the warp can still hit. A closest-hit
//     ray that cannot (t_best <= t_min: a dead lane, or past the end of the
//     wave) is evaluated with the others rather than tested for: no pair
//     passes t_min < t < t_best, so it keeps its miss.
//   - A warp skips the rest of a triangle as soon as the reference rejects
//     it for every lane. The hit predicate is a conjunction of tests on b1,
//     b2 and t in that order, so where no lane passes the b1 test the warp
//     skips s2, b2 and t, and where none passes the b2 tests it skips t.
//     The skips are warp votes (__any_sync), so the warp never splits: where
//     one lane goes on, every lane computes the next values and its part of
//     the predicate, branch free, as the first CUDA kernel did everywhere.
//     Coherent waves (the camera wave) skip most pairs early; on incoherent
//     waves, whose lanes disagree, the votes cost 4 instructions a pair.
//     Measured and dropped (PERF.md): letting each lane stop on its own
//     (slower than the first kernel on incoherent waves: the warp runs
//     every path plus the branching), and a test ahead of the IEEE division
//     that rejects only what the reference rejects (its SASS was as long as
//     the division it skips).
//     A pair computes every value with the reference's expressions in the
//     reference's order, so it keeps its bits.
// Built with --fmad=false and IEEE division: the result equals the plain
// PyTorch version (brute_intersect.py) bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRays = 2;                       // rays a thread
constexpr int kRaysPerBlock = kThreads * kRays;
constexpr unsigned kAll = 0xffffffffu;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) brute_intersect_kernel(
    const float* __restrict__ tris, int n_tris,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out, int n) {
  extern __shared__ float4 s_tris[];
  for (int i = threadIdx.x; i < 3 * n_tris; i += kThreads)
    s_tris[i] = make_float4(tris[3 * i], tris[3 * i + 1], tris[3 * i + 2], 0.0f);
  __syncthreads();

  const int first = blockIdx.x * kRaysPerBlock + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float t_min[kRays], t_best[kRays], b1_best[kRays], b2_best[kRays];
  int prim_best[kRays];
  bool live[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = first + j * kThreads;
    live[j] = false;
    prim_best[j] = -1;
    b1_best[j] = b2_best[j] = 0.0f;
    ox[j] = oy[j] = oz[j] = dx[j] = dy[j] = dz[j] = t_min[j] = t_best[j] = 0.0f;
    if (r < n) {
      ox[j] = o[3 * r + 0], oy[j] = o[3 * r + 1], oz[j] = o[3 * r + 2];
      dx[j] = d[3 * r + 0], dy[j] = d[3 * r + 1], dz[j] = d[3 * r + 2];
      t_min[j] = tmin[r];
      t_best[j] = tmax[r];
      live[j] = t_best[j] > t_min[j];
    }
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRays; ++j) any = any || live[j];

  // Every lane of the warp runs the loop (the block has no lanes past its
  // end), so the votes below see the whole warp.
#pragma unroll 1
  for (int k = 0; k < n_tris && __any_sync(kAll, any); ++k) {
    const float4 v0 = s_tris[3 * k], e1 = s_tris[3 * k + 1], e2 = s_tris[3 * k + 2];
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      // s1 = d x e2
      const float s1x = dy[j] * e2.z - dz[j] * e2.y;
      const float s1y = dz[j] * e2.x - dx[j] * e2.z;
      const float s1z = dx[j] * e2.y - dy[j] * e2.x;
      const float divisor = s1x * e1.x + s1y * e1.y + s1z * e1.z;
      const float inv = 1.0f / (divisor == 0.0f ? 1.0f : divisor);
      const float sx = ox[j] - v0.x;
      const float sy = oy[j] - v0.y;
      const float sz = oz[j] - v0.z;
      const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
      // a closest-hit ray with t_best <= t_min (dead, or past the end) can
      // pass no t test, so only an any-hit ray's liveness is tested. Testing
      // it for closest hit too, so that a dead lane votes for no later
      // stage, measured slower on every Cornell wave, also on one with half
      // its lanes dead at random (1-9%; PERF.md): its SASS loop grew by 12
      // instructions
      const bool on_b1 = (!kAnyHit || live[j]) & (divisor != 0.0f) & (b1 >= 0.0f) &
                         (b1 <= 1.0f);
      if (!__any_sync(kAll, on_b1)) continue;
      // s2 = s x e1
      const float s2x = sy * e1.z - sz * e1.y;
      const float s2y = sz * e1.x - sx * e1.z;
      const float s2z = sx * e1.y - sy * e1.x;
      const float b2 = (dx[j] * s2x + dy[j] * s2y + dz[j] * s2z) * inv;
      const bool on_b2 = on_b1 & (b2 >= 0.0f) & (b1 + b2 <= 1.0f);
      if (!__any_sync(kAll, on_b2)) continue;
      const float t = (e2.x * s2x + e2.y * s2y + e2.z * s2z) * inv;
      if (on_b2 & (t > t_min[j]) & (t < t_best[j])) {
        t_best[j] = t;
        prim_best[j] = k;
        b1_best[j] = b1;
        b2_best[j] = b2;
        if (kAnyHit) live[j] = false;
      }
    }
    if (kAnyHit) {
      any = false;
#pragma unroll
      for (int j = 0; j < kRays; ++j) any = any || live[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = first + j * kThreads;
    if (r < n) {
      t_out[r] = t_best[j];
      prim_out[r] = prim_best[j];
      b1_out[r] = b1_best[j];
      b2_out[r] = b2_best[j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). tris is
// the (T,9) table [v0|e1|e2]. The caller checks shapes, types, devices and
// n_tris <= 1024 (48 KB of shared memory in 48-byte rows, the most a block
// may take without opting in).
extern "C" int grail_brute_intersect(const float* tris, int n_tris,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     float* t_out, int* prim_out,
                                     float* b1_out, float* b2_out, int n,
                                     int any_hit, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kRaysPerBlock - 1) / kRaysPerBlock);
  const size_t smem = sizeof(float4) * 3 * static_cast<size_t>(n_tris);
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
