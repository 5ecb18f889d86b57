// 4-wide BVH traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces, on the main path, the TPU kernels of grail/kernels/bvh_stream.py
//   _make_kernel(False)      (ordered closest hit: every binned closest-hit wave)
//   _make_skip_kernel(False) (skip-link closest hit: the tile-ordered camera
//                             wave)
//   _make_skip_kernel(True)  (skip-link any hit: every shadow wave)
// whose first CUDA versions (csrc/bvh_stream.cu) walk the reference's
// 64-byte record stream: one slab test per 64-B record, three float4 loads
// each, along a depth-19 binary tree in which every step's address comes
// from the previous load.
//
// The design:
//   - Nodes of a 4-wide tree (the binary SAH tree collapsed on the host,
//     native/bvh4_collapse.cpp), 128 B each, aligned to 128: one node fetch
//     is 8 independent float4 loads from one cache line and gives 4 slab
//     tests, and a root-to-leaf chain is about half as long.
//       float4 0..5: lo.x lo.y lo.z hi.x hi.y hi.z of the 4 slots (SoA)
//       int4   6:    child (node index >= 0, or ~first triangle of a leaf)
//       int4   7:    count (0 for a node, the leaf's triangle count)
//     An empty slot has lo = hi = +inf: no finite ray enters it.
//   - Triangles apart, 48 B each in leaf order: float4 v0|prim, e1|0,
//     e2|more, prim as int32 bits, more = 1 while the leaf goes on.
//   - The hit children are visited near first: sorted on the pair
//     (entry distance, slot) by a 5-exchange network, so ties go in slot
//     order and every correct sort gives one order. The others go on a
//     per-thread stack of one int an entry in shared memory (entry e of
//     thread i at [e][i]: conflict-free), farthest first. Its depth is the
//     host's bound for the tree (bvh4.py checks it against kStackMax).
//   - Persistent warps: the launch fills the card (SMs x resident blocks);
//     a warp takes its first 32 rays by its index and then the next 32 with
//     one atomicAdd on a counter when all its lanes are done, so a slow
//     warp does not hold its block's later rays, and the dead lanes the
//     dispatch sorts last retire whole warps at once. Kept because it beat
//     a one-ray-a-thread grid of the same kernel by 4% on both waves of the
//     mesh100k main path (timed in turns on the H100, PERF.md); the wrapper
//     always launches the fill.
//   - Any hit uses the same loop and ends at the first hit, writing
//     t = -3e37 with that hit's prim, b1, b2. A miss writes t = tmax,
//     prim = -1, b1 = b2 = 0.
//   - A root per ray (optional `roots`): a ray's first item is roots[i], a
//     node or a leaf ref, instead of node 0. This is the Hopper form of the
//     stream kernels' per-stream start records (`starts_ref`): the instanced
//     BLAS walk (kernels/instanced.py) gives each object-space ray its
//     object's root in one table that holds every object's BLAS, so rays
//     need no grouping by object, no sort and no lane masking. Without
//     roots (nullptr) every ray starts at node 0.
//
// What bounds it on the H100 (measured, PERF.md): not the bytes per visit
// nor the length of the load chain. The walk fetches a third of the records
// the stream walk visits and reads half its bytes, yet is only about 1.25x
// faster. Occupancy matters: a one-int stack entry (the leaf's range coded
// into the child ref and the triangle's `more` word) and child refs coded
// on the host each gained by freeing shared memory or registers. Fewer
// instructions a node, an early load of the child refs, a warp-cooperative
// node load through shared memory, refilling idle lanes from the counter and
// a while-while loop gained nothing or lost, and extra node loads cost
// little, so L1 load throughput is not it either. Under half of a warp's
// lanes are busy on average while its slowest lane walks on (chip_smoke.py
// prints the share).
//
// The camera wave: this walk takes it in half the skip kernel's time (0.28
// against 0.58 ms on the H100, PERF.md). A walk a warp was tried there
// against it in turns and lost, 0.58 against 0.28 ms: the warp's 32 rays (a
// 16x2 pixel block) shared one stack of (node, lane mask) entries, but their
// walks overlap too little on mesh100k at 256x256 (24.6 node fetches a
// warp, 2.4x a ray's; 44% of the lanes busy in a slab test), and each of
// its steps costs the warp a whole step while a per-ray warp overlaps its
// lanes' steps.
//
// The slab test and Moller-Trumbore are the record-stream kernel's term for
// term; built with --fmad=false and IEEE division, the result equals the
// plain PyTorch version (bvh4.py) bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStackMax = 64;    // bvh4.STACK_MAX: 32 KB of stack a block
constexpr float kBig = 3.0e37f;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ int pick(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// entry distance of one slot's box into *near; true on a hit
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float t_min, float t_best, float* near) {
  const float tx0 = (lx - ox) * ix;
  const float tx1 = (hx - ox) * ix;
  const float ty0 = (ly - oy) * iy;
  const float ty1 = (hy - oy) * iy;
  const float tz0 = (lz - oz) * iz;
  const float tz1 = (hz - oz) * iz;
  *near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float far =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) * 1.0000004f;
  return (*near <= far) && (far > t_min) && (*near < t_best);
}

// one exchange of the sorting network on (key, slot) pairs
__device__ __forceinline__ void order(float& ka, int& sa, float& kb, int& sb) {
  if (kb < ka || (kb == ka && sb < sa)) {
    const float k = ka;
    ka = kb;
    kb = k;
    const int s = sa;
    sa = sb;
    sb = s;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) bvh4_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const int* __restrict__ roots, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ b1_out,
    float* __restrict__ b2_out, int n, int stack, int* __restrict__ counter) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int* s_ref = smem + tid;                      // entry e at [e * kThreads]
  const int n_static = gridDim.x * kThreads;
  int base = (blockIdx.x * kThreads + tid) & ~31;
  while (base < n) {                            // warp-uniform
    const int r = base + lane;
    if (r < n) {
      const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
      const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
      const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
      const float t_min = tmin[r];
      float t_best = tmax[r];
      int prim_best = -1;
      float b1_best = 0.0f, b2_best = 0.0f;
      // the item in hand: node `ref` (ref >= 0) or the leaf whose first
      // triangle is ~ref (ref < 0)
      int ref = roots != nullptr ? __ldg(roots + r) : 0, sp = 0;
      while (true) {
        if (ref >= 0) {
          const float4* nd = nodes + 8 * ref;
          const float4 lx = __ldg(nd + 0), ly = __ldg(nd + 1), lz = __ldg(nd + 2);
          const float4 hx = __ldg(nd + 3), hy = __ldg(nd + 4), hz = __ldg(nd + 5);
          const int4 child = __ldg(reinterpret_cast<const int4*>(nd + 6));
          float k0, k1, k2, k3;
          const bool h0 = slab(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, ox, oy, oz,
                               ix, iy, iz, t_min, t_best, &k0);
          const bool h1 = slab(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, ox, oy, oz,
                               ix, iy, iz, t_min, t_best, &k1);
          const bool h2 = slab(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, ox, oy, oz,
                               ix, iy, iz, t_min, t_best, &k2);
          const bool h3 = slab(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, ox, oy, oz,
                               ix, iy, iz, t_min, t_best, &k3);
          const int hits = int(h0) + int(h1) + int(h2) + int(h3);
          if (hits > 0) {
            // misses sort last (a hit's entry distance is below t_best)
            k0 = h0 ? k0 : CUDART_INF_F;
            k1 = h1 ? k1 : CUDART_INF_F;
            k2 = h2 ? k2 : CUDART_INF_F;
            k3 = h3 ? k3 : CUDART_INF_F;
            int s0 = 0, s1 = 1, s2 = 2, s3 = 3;
            order(k0, s0, k1, s1);
            order(k2, s2, k3, s3);
            order(k0, s0, k2, s2);
            order(k1, s1, k3, s3);
            order(k1, s1, k2, s2);
            if (hits > 3) s_ref[kThreads * sp++] = pick(child, s3);
            if (hits > 2) s_ref[kThreads * sp++] = pick(child, s2);
            if (hits > 1) s_ref[kThreads * sp++] = pick(child, s1);
            ref = pick(child, s0);
            continue;
          }
        } else {
          bool stop = false;
          for (int j = ~ref;; ++j) {
            const float4* tr = tris + 3 * j;
            const float4 a = __ldg(tr), e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
            const float s1x = dy * e2.z - dz * e2.y;
            const float s1y = dz * e2.x - dx * e2.z;
            const float s1z = dx * e2.y - dy * e2.x;
            const float divisor = s1x * e1.x + s1y * e1.y + s1z * e1.z;
            const float dinv = 1.0f / (divisor == 0.0f ? 1.0f : divisor);
            const float sx = ox - a.x;
            const float sy = oy - a.y;
            const float sz = oz - a.z;
            const float b1 = (sx * s1x + sy * s1y + sz * s1z) * dinv;
            const float s2x = sy * e1.z - sz * e1.y;
            const float s2y = sz * e1.x - sx * e1.z;
            const float s2z = sx * e1.y - sy * e1.x;
            const float b2 = (dx * s2x + dy * s2y + dz * s2z) * dinv;
            const float t = (e2.x * s2x + e2.y * s2y + e2.z * s2z) * dinv;
            if ((divisor != 0.0f) && (b1 >= 0.0f) && (b1 <= 1.0f) && (b2 >= 0.0f) &&
                (b1 + b2 <= 1.0f) && (t > t_min) && (t < t_best)) {
              prim_best = __float_as_int(a.w);
              b1_best = b1;
              b2_best = b2;
              if (kAnyHit) {
                t_best = -kBig;
                stop = true;
                break;
              }
              t_best = t;
            }
            if (!(__float_as_int(e2.w) & 1)) break;   // the leaf's last triangle
          }
          if (kAnyHit && stop) break;
        }
        if (sp == 0) break;
        ref = s_ref[kThreads * --sp];
      }
      t_out[r] = t_best;
      prim_out[r] = prim_best;
      b1_out[r] = b1_best;
      b2_out[r] = b2_best;
    }
    int next = 0;
    if (lane == 0) next = n_static + atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, next, 0);
  }
}

size_t smem_bytes(int stack) { return sizeof(int) * kThreads * stack; }

}  // namespace

// Blocks of the kernel that fit on the current device at once (SMs x
// resident blocks) for a stack of `stack` entries, in *blocks; returns a
// CUDA error code (0 on success).
extern "C" int grail_bvh4_fill_blocks(int any_hit, int stack, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, any_hit ? bvh4_kernel<true> : bvh4_kernel<false>, kThreads,
        smem_bytes(stack));
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// Launches `blocks` blocks (grail_bvh4_fill_blocks's count) on `stream`;
// returns cudaGetLastError() (0 on success). The caller checks shapes,
// types, devices and alignment, that
// 1 <= stack <= kStackMax holds the tree's bound, and passes a zeroed int
// counter. roots: n first items (node index or ~first triangle), or
// nullptr to start every ray at node 0.
extern "C" int grail_bvh4(const float* nodes, const float* tris, const float* o,
                          const float* d, const float* tmin, const float* tmax,
                          const int* roots, float* t_out, int* prim_out, float* b1_out,
                          float* b2_out, int n, int any_hit, int stack,
                          int blocks, int* counter, void* stream) {
  if (n <= 0) return 0;
  if (stack < 1 || stack > kStackMax || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tr = reinterpret_cast<const float4*>(tris);
  if (any_hit) {
    bvh4_kernel<true><<<blocks, kThreads, smem_bytes(stack), s>>>(
        nd, tr, o, d, tmin, tmax, roots, t_out, prim_out, b1_out, b2_out, n, stack,
        counter);
  } else {
    bvh4_kernel<false><<<blocks, kThreads, smem_bytes(stack), s>>>(
        nd, tr, o, d, tmin, tmax, roots, t_out, prim_out, b1_out, b2_out, n, stack,
        counter);
  }
  return static_cast<int>(cudaGetLastError());
}
