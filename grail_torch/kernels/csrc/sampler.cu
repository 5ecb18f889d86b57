// The sampler's draws for Hopper (sm_90a): one call of core/rng.py's
// sample_1d or sample_2d, every lane, in one launch.
//
// Replaces no TPU kernel: the reference's draws are XLA-fused elementwise
// integer arithmetic. The plain PyTorch version (sample_1d_plain,
// sample_2d_plain) carries the 32-bit values in int64, masked back after
// every step, so a draw is a chain of 74 (a 1D ZERO_TWO draw) to 137 (2D)
// small launches, and a 2D ZERO_TWO draw also copies the Sobol XOR table to
// the card from pageable memory, a host wait. About 39 calls a megawave made
// the sampler the largest share of what the render's one host thread
// issued.
//
// Contract, as the plain version: lane l of the broadcast shape, seen as
// rows x cols (a 0-d or 1-D shape is one row), reads its pixel id, sample
// index and dimension each either as one 32-bit value or from a tensor of
// int64 or int32 at row * s0 + col * s1 elements (stride 0 on a broadcast
// axis), keeps their low 32 bits, and writes the plain version's float32
// draw; a 2D call writes its second draw n floats further on. Native
// uint32_t arithmetic wraps exactly as the masked int64 does. Where
// PyTorch rounds, the kernel rounds the same way: int -> float32 to
// nearest; a float32 tensor divided by a Python number on the card is a
// product with the number's float32 reciprocal (the wrapper passes it);
// HALTON's val + d * inv_bi is a float64 sum of an exact product, rounded
// once to float32; its % and // are floor division on the int32 view of
// the sample index. Built with --fmad=false, so no multiply-add is
// contracted.
//
// What bounds it on the H100: bytes. A lane reads 16 B (int64 pixel id and
// sample index; the dimension is most often one value) and writes 4 or 8:
// 21-25 MB at 1,048,576 lanes, 6.3-7.5 us at 3.35 TB/s. The hashing (two
// or four PCG rounds a draw, Sobol's bits in five register steps) costs
// less. One thread a lane in a grid-stride loop, reads of neighbouring
// lanes coalesced; nothing is copied from the host to the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
enum { kRandom = 0, kStratified = 1, kZeroTwo = 2, kHalton = 3 };

constexpr float kInvU32 = 2.3283064365386963e-10f;   // 2^-32, exact
constexpr float kOneMinusEps = 1.0f - 5.9604644775390625e-08f;   // 1 - 2^-24

// One of a draw's integer inputs: `value` for every lane, or a tensor.
struct Operand {
  const void* ptr;     // nullptr: value
  long long s0, s1;    // element strides over (row, col)
  uint32_t value;
  int is64;            // the tensor's elements are int64, else int32
};

// What a call fixes besides its operands (core/rng.py::_kernel_params).
// STRATIFIED: m0 = spp (1D) or sx, m1 = sy (2D), f0 and f1 their float32
// reciprocals. HALTON: m0 = base, m1 = its digits, f0 = 1/base in float32.
struct Params {
  uint32_t seed;
  int m0, m1;
  float f0, f1;
};

__device__ __forceinline__ uint32_t load(const Operand& o, long long r, long long c) {
  if (o.ptr == nullptr) return o.value;
  const long long i = r * o.s0 + c * o.s1;
  return o.is64 ? static_cast<uint32_t>(static_cast<const long long*>(o.ptr)[i])
                : static_cast<uint32_t>(static_cast<const int*>(o.ptr)[i]);
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return pcg_hash(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return hash_combine(hash_combine(a, b), c);
}

__device__ __forceinline__ float u32_to_float(uint32_t u) {
  return fminf(__uint2float_rn(u) * kInvU32, kOneMinusEps);
}

// pbrt's Sobol2 bits, the XOR of direction number v_k over the set bits k
// of n (v_0 = 1 << 31, v_{k+1} = v_k ^ v_k >> 1), in five steps: bit p
// from the top of v_k is C(k, p) mod 2, set where p's bits are a subset of
// k's (Lucas), so bit p from the top of the result is the XOR of n's bits
// k over every superset k of p. That superset transform over the five bits
// of a bit index is five shift-and-mask steps; the reversal puts index p
// at bit 31 - p. The same linear map over GF(2) as the reference's 32-step
// loop and the plain version's byte tables, so the same bits.
__device__ __forceinline__ uint32_t sobol2_bits(uint32_t n) {
  n ^= (n >> 1) & 0x55555555u;
  n ^= (n >> 2) & 0x33333333u;
  n ^= (n >> 4) & 0x0F0F0F0Fu;
  n ^= (n >> 8) & 0x00FF00FFu;
  n ^= (n >> 16) & 0x0000FFFFu;
  return __brev(n);
}

// rng.radical_inverse over the int32 view of the sample index
__device__ __forceinline__ float radical_inverse(int n, int base, int digits,
                                                 float inv_base) {
  float val = 0.0f;
  float inv_bi = inv_base;
  for (int k = 0; k < digits; ++k) {
    int q = n / base;
    int d = n - q * base;
    if (d < 0) {   // floor division, as PyTorch's % and //
      d += base;
      q -= 1;
    }
    val = static_cast<float>(static_cast<double>(val)
                             + static_cast<double>(d) * static_cast<double>(inv_bi));
    n = q;
    inv_bi = inv_bi * inv_base;
  }
  return fminf(val, kOneMinusEps);
}

// sample_1d_plain; p: pixel id ^ seed
template <int kKind>
__device__ __forceinline__ float draw1(const Params& prm, uint32_t p, uint32_t s,
                                       uint32_t d) {
  if (kKind == kRandom) return u32_to_float(hash3(p, s, d));
  if (kKind == kStratified) {
    const float jitter = u32_to_float(hash3(p, s, d));
    const uint32_t perm = (s + hash_combine(p, d)) % static_cast<uint32_t>(prm.m0);
    return fminf((static_cast<float>(perm) + jitter) * prm.f0, kOneMinusEps);
  }
  if (kKind == kZeroTwo) return u32_to_float(__brev(s) ^ hash3(p, d, 0xA511E9B3u));
  const float v = radical_inverse(static_cast<int>(s), prm.m0, prm.m1, prm.f0)
                  + u32_to_float(hash_combine(p, d));
  return v >= 1.0f ? v - 1.0f : v;
}

// sample_2d_plain
template <int kKind>
__device__ __forceinline__ void draw2(const Params& prm, uint32_t p, uint32_t s,
                                      uint32_t d, float* a, float* b) {
  if (kKind == kZeroTwo) {
    *a = u32_to_float(__brev(s) ^ hash3(p, d, 0xA511E9B3u));
    *b = u32_to_float(sobol2_bits(s) ^ hash3(p, d, 0x63D83595u));
  } else if (kKind == kStratified) {
    const uint32_t sx = static_cast<uint32_t>(prm.m0);
    const uint32_t perm = (s + hash_combine(p, d)) % (sx * static_cast<uint32_t>(prm.m1));
    const uint32_t d2 = d * 2u;
    const float jx = u32_to_float(hash3(p, s, d2));
    const float jy = u32_to_float(hash3(p, s, d2 + 1u));
    *a = fminf((static_cast<float>(perm % sx) + jx) * prm.f0, kOneMinusEps);
    *b = fminf((static_cast<float>(perm / sx) + jy) * prm.f1, kOneMinusEps);
  } else {   // two 1D draws at derived dims (HALTON in base 2)
    *a = draw1<kKind>(prm, p, s, d * 2u + 1000003u);
    *b = draw1<kKind>(prm, p, s, d * 2u + 1000033u);
  }
}

template <int kKind, bool kTwo>
__global__ void __launch_bounds__(kThreads) sampler_kernel(
    Params prm, Operand pix, Operand samp, Operand dim, long long cols, long long n,
    float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long l = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; l < n;
       l += step) {
    const long long r = cols == n ? 0 : l / cols;   // one row: no 64-bit divide
    const long long c = l - r * cols;
    const uint32_t p = load(pix, r, c) ^ prm.seed;
    const uint32_t s = load(samp, r, c);
    const uint32_t d = load(dim, r, c);
    if (kTwo) {
      float a, b;
      draw2<kKind>(prm, p, s, d, &a, &b);
      out[l] = a;
      out[n + l] = b;
    } else {
      out[l] = draw1<kKind>(prm, p, s, d);
    }
  }
}

using Kernel = void (*)(Params, Operand, Operand, Operand, long long, long long, float*);

// [kind][two]
const Kernel kKernels[4][2] = {
    {sampler_kernel<kRandom, false>, sampler_kernel<kRandom, true>},
    {sampler_kernel<kStratified, false>, sampler_kernel<kStratified, true>},
    {sampler_kernel<kZeroTwo, false>, sampler_kernel<kZeroTwo, true>},
    {sampler_kernel<kHalton, false>, sampler_kernel<kHalton, true>},
};

Operand operand(const void* ptr, long long s0, long long s1, unsigned value, int is64) {
  Operand o;
  o.ptr = ptr;
  o.s0 = s0;
  o.s1 = s1;
  o.value = value;
  o.is64 = is64;
  return o;
}

}  // namespace

extern "C" {

// One call: kind (rng.RANDOM .. HALTON), two (sample_2d), the call's
// Params, then for each of the pixel id, the sample index and the
// dimension a pointer (null: the value), its two element strides and its
// value; `wide`: bit k set where operand k's tensor is int64; the lanes'
// cols and count n; out: n floats (2n for sample_2d). Returns the CUDA
// error of the launch (0: launched; n == 0 launches nothing).
int grail_sampler(int kind, int two, unsigned seed, int m0, int m1, float f0, float f1,
                  const void* pix, long long pix_s0, long long pix_s1, unsigned pix_value,
                  const void* samp, long long samp_s0, long long samp_s1,
                  unsigned samp_value, const void* dim, long long dim_s0,
                  long long dim_s1, unsigned dim_value, int wide, long long cols,
                  long long n, float* out, void* stream) {
  if (kind < kRandom || kind > kHalton) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  if (cols <= 0 || n % cols != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.seed = seed;
  prm.m0 = m0;
  prm.m1 = m1;
  prm.f0 = f0;
  prm.f1 = f1;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kKernels[kind][two ? 1 : 0]<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      prm, operand(pix, pix_s0, pix_s1, pix_value, wide & 1),
      operand(samp, samp_s0, samp_s1, samp_value, (wide >> 1) & 1),
      operand(dim, dim_s0, dim_s1, dim_value, (wide >> 2) & 1), cols, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
