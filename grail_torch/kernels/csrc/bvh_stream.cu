// BVH record-stream traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernels of grail/kernels/bvh_stream.py:
//   _make_kernel(False/True)      -> ordered traversal, closest / any hit
//   _make_skip_kernel(False/True) -> skip-link traversal, closest / any hit
// The TPU kernels stream one record per 128-ray sub-packet and decide the
// near child by the packet's majority direction. On the GPU the natural unit
// is the thread: one thread per ray, each walking the record table on its
// own, so the near child is decided by the ray's own direction sign (pbrt's
// dirIsNeg) and a ray stops as soon as its own walk ends.
//
// Table: 16 float fields per record (64 B), 11 used (see bvh_stream.py):
//   box: f0..2 bmin, f3..5 bmax, f9 = right_child_record*8 + axis
//   tri: f0..8 v0|e1|e2,          f9 = prim_id*8 + 4 + (run continues)
//   f10 = skip link (first record after this record's subtree, -1 = end).
// A thread reads fields 0..11 of its record as three aligned float4 loads.
//
// Traversals (the reference's conditions, per ray):
//   skip:    next = id+1 on a box hit or a triangle run that continues,
//            the skip link otherwise; no stack.
//   ordered: a box hit visits the near child first and pushes the other on
//            a per-thread stack of kStack entries in local memory (the host
//            checks the tree depth against it); a box miss or the end of a
//            triangle run pops (an empty stack ends the walk).
//   any hit: the first hit ends the walk; t is written as -3e37 with that
//            hit's prim, b1, b2 (the reference's "killed" ray).
// A miss writes t = tmax, prim = -1, b1 = b2 = 0. Arithmetic and compares
// follow the reference kernel term by term; built with --fmad=false, so the
// result equals the plain PyTorch version bit for bit.
//
// Bound: per visited record, 26 FP32 operations for a box (slab test)
// and 55 for a triangle (Möller-Trumbore), against 64 B of record read
// through L1/L2 (the 100k-triangle table is ~9 MB and stays in the 50 MB
// L2) and 48 B of ray I/O per ray from HBM. The record reads are dependent
// loads (the next id comes from the record), so a warp whose rays diverge
// waits on latency: this first version keeps the layout simple and relies
// on many resident warps (128 threads a block, no shared memory) to hide it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;       // bvh_stream.STACK
constexpr float kBig = 3.0e37f;

template <bool kAnyHit, bool kOrdered>
__global__ void __launch_bounds__(kThreads) bvh_stream_kernel(
    const float4* __restrict__ table, int n_recs,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = 1.0f / (fabsf(dx) < 1e-20f ? (dx < 0.0f ? -1e-20f : 1e-20f) : dx);
  const float iy = 1.0f / (fabsf(dy) < 1e-20f ? (dy < 0.0f ? -1e-20f : 1e-20f) : dy);
  const float iz = 1.0f / (fabsf(dz) < 1e-20f ? (dz < 0.0f ? -1e-20f : 1e-20f) : dz);
  const float t_min = tmin[r];
  float t_best = tmax[r];
  int prim_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;

  int stack[kOrdered ? kStack : 1];
  int sp = 0;
  int id = 0;
  while (id >= 0 && id < n_recs) {
    const float4* rec = table + 4 * id;
    const float4 fa = __ldg(rec), fb = __ldg(rec + 1), fc = __ldg(rec + 2);
    // fa = f0..3, fb = f4..7, fc = f8..11
    const int m = static_cast<int>(fc.y);
    int nxt;
    if (m & 4) {
      // triangle record: v0 = f0..2, e1 = f3..5, e2 = f6..8
      const float s1x = dy * fc.x - dz * fb.w;
      const float s1y = dz * fb.z - dx * fc.x;
      const float s1z = dx * fb.w - dy * fb.z;
      const float divisor = s1x * fa.w + s1y * fb.x + s1z * fb.y;
      const float dinv = 1.0f / (divisor == 0.0f ? 1.0f : divisor);
      const float sx = ox - fa.x;
      const float sy = oy - fa.y;
      const float sz = oz - fa.z;
      const float b1 = (sx * s1x + sy * s1y + sz * s1z) * dinv;
      const float s2x = sy * fb.y - sz * fb.x;
      const float s2y = sz * fa.w - sx * fb.y;
      const float s2z = sx * fb.x - sy * fa.w;
      const float b2 = (dx * s2x + dy * s2y + dz * s2z) * dinv;
      const float t = (fb.z * s2x + fb.w * s2y + fc.x * s2z) * dinv;
      if ((divisor != 0.0f) && (b1 >= 0.0f) && (b1 <= 1.0f) && (b2 >= 0.0f) &&
          (b1 + b2 <= 1.0f) && (t > t_min) && (t < t_best)) {
        prim_best = m >> 3;
        b1_best = b1;
        b2_best = b2;
        if (kAnyHit) {
          t_best = -kBig;
          break;
        }
        t_best = t;
      }
      if (m & 1) {
        nxt = id + 1;
      } else if (kOrdered) {
        nxt = sp > 0 ? stack[--sp] : -1;
      } else {
        nxt = static_cast<int>(fc.z);
      }
    } else {
      // box record: slab test against bmin = f0..2, bmax = f3..5
      const float tx0 = (fa.x - ox) * ix;
      const float tx1 = (fa.w - ox) * ix;
      const float ty0 = (fa.y - oy) * iy;
      const float ty1 = (fb.x - oy) * iy;
      const float tz0 = (fa.z - oz) * iz;
      const float tz1 = (fb.y - oz) * iz;
      const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
      const float far =
          fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) * 1.0000004f;
      const bool box_hit = (near <= far) && (far > t_min) && (near < t_best);
      if (kOrdered) {
        if (box_hit) {
          const int ax = m & 3;
          const bool near_right = (ax == 0 ? dx : (ax == 1 ? dy : dz)) < 0.0f;
          const int right = m >> 3;
          stack[sp++] = near_right ? id + 1 : right;
          nxt = near_right ? right : id + 1;
        } else {
          nxt = sp > 0 ? stack[--sp] : -1;
        }
      } else {
        nxt = box_hit ? id + 1 : static_cast<int>(fc.z);
      }
    }
    id = nxt;
  }
  t_out[r] = t_best;
  prim_out[r] = prim_best;
  b1_out[r] = b1_best;
  b2_out[r] = b2_best;
}

template <bool kAnyHit, bool kOrdered>
void launch(const float* table, int n_recs, const float* o, const float* d,
            const float* tmin, const float* tmax, float* t_out, int* prim_out,
            float* b1_out, float* b2_out, int n, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  bvh_stream_kernel<kAnyHit, kOrdered><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(table), n_recs, o, d, tmin, tmax, t_out,
      prim_out, b1_out, b2_out, n);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, types, devices, that `table` is 16-byte aligned (a torch
// allocation is), and that the tree depth fits kStack for the ordered kernel.
extern "C" int grail_bvh_stream(const float* table, int n_recs, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, float* t_out, int* prim_out,
                                float* b1_out, float* b2_out, int n, int any_hit,
                                int ordered, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ordered) {
    if (any_hit) {
      launch<true, true>(table, n_recs, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n, s);
    } else {
      launch<false, true>(table, n_recs, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n, s);
    }
  } else {
    if (any_hit) {
      launch<true, false>(table, n_recs, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n, s);
    } else {
      launch<false, false>(table, n_recs, o, d, tmin, tmax, t_out, prim_out, b1_out, b2_out, n, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
