// The BSDF lobe stack for Hopper (sm_90a): one call of shade/bsdf.py's
// bsdf_f, bsdf_pdf or bsdf_sample, every lane, in one launch, and the
// vector-Jacobian product of that call in one more.
//
// Replaces no TPU kernel: the reference's BSDF stack is XLA-fused
// elementwise code. The plain PyTorch version (bsdf_f_plain,
// bsdf_pdf_plain, bsdf_sample_plain) evaluates every present lobe type
// under a mask for every slot, the Blinn lobe's Fresnel term both as a
// dielectric and as a conductor, and picks bsdf_sample's slot with an
// int64 `cumsum` over the slots: ~50 to ~260 small launches a call on a
// two-slot stack, the scan alone milliseconds of card time a call.
//
// Contract, as the plain version: lane l reads slot k's fields at
// l * s_lane + k * s_slot (+ c * s_chan for a colour) elements of each
// tensor, wo (and wi) at l * s_lane + c * s_chan, each uniform at
// l * s_lane, so expanded and strided operands are read where they lie.
// A slot whose type is not in `present` (a bit mask of the stack's types)
// gives nothing, as the plain version evaluates only the present types.
// bsdf_f sums the slots' values in slot order; bsdf_pdf averages the
// matching slots' pdfs (the delta lobes match only with
// include_specular); bsdf_sample picks the `which`-th matching slot with
// an int32 count (the scan's pick), samples its wi, evaluates f and pdf
// over the whole stack there, and gives a delta pick its value and
// 1/n_match. Only the lane's own lobe type and Fresnel kind are computed.
// A MEASURED slot reads row f1 of the scene's half-angle tables at the
// nearest cell (shade/measured.py::lookup), or without tables shades as a
// matte lobe of its albedo estimate S1.
//
// Arithmetic: the plain version's operations in its order, each rounded
// as PyTorch rounds it on the card: a Python number is its float32
// rounding (F32 below); `1.0 / x` is a reciprocal; `x / 2.0` a product
// with 0.5, and a tensor divided by any Python number a product with the
// number's float32 reciprocal; `x ** 5` is powf(x, 5); clamps, maximum and
// minimum pass a NaN on; sin, cos, tan, atan, acos, atan2, pow, sqrt and
// rsqrt are CUDA's float functions, as PyTorch's kernels call them. Built
// with --fmad=false, so no multiply-add is contracted. The half vector's
// `> 1e-9` test sums |wi + wo| in x, y, z order where PyTorch's reduction
// may take another; only a sum within an ulp of 1e-9 could tell them apart.
//
// Backward: the same code over dual numbers (a value and its derivative
// along one input), one pass a float input the caller wants a gradient of
// (a colour channel of a slot, an exponent, wo's x, ...), each pass's
// output derivatives dotted with the outputs' cotangents. Each operation's
// derivative is the one PyTorch's autograd takes, kinks included, so the
// gradients are the plain version's up to rounding: a clamp passes the
// slope where its bound holds with equality, |x| has slope 0 at 0, maximum
// and minimum split a tie, safe_sqrt has slope 0 at 0, and an integer cast
// or a comparison has none. Where the plain version's masked lanes would
// turn a zero cotangent into a NaN (0 times an infinite slope), a zero
// tangent or cotangent stays zero here.
//
// What bounds it on the H100: bytes. At K = 2 a lane reads its two slots'
// tags and fields (up to ~50 B), wo and wi or three uniforms (24 B), and
// bsdf_sample writes 30 B: ~80-100 B a lane, ~30 us at 1M lanes and
// 3.35 TB/s. One thread a lane; each reads the fields its slot types need
// and no other, and keeps the whole stack in registers. The backward
// repeats the lane's forward once a wanted input, so its compute grows
// with them: three colour channels of one slot are three passes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
enum { kF = 0, kPdf = 1, kSample = 2 };

// shade/bsdf.py's lobe and Fresnel tags
enum {
  NONE = 0, LAMBERT = 1, OREN_NAYAR = 2, BLINN = 3, ANISO = 4, SPEC_REFL = 5,
  SPEC_TRANS = 6, FRESNEL_BLEND = 7, LAMBERT_T = 8, BLINN_T = 9, MEASURED = 10
};
enum { FR_DIELECTRIC = 1, FR_CONDUCTOR = 2 };

// the operands, in the order of kernels/bsdf.py::OPERANDS
enum {
  OP_TYPE, OP_FR, OP_R, OP_S1, OP_S2, OP_F0, OP_F1, OP_F2, OP_WO, OP_WI, OP_U1, OP_U2,
  OP_UC, kOperands
};
constexpr int kMaxTables = 16;

// core/vecmath.py's constants; a Python number enters a float32 tensor's
// arithmetic as its float32 rounding
#define F32(x) static_cast<float>(x)
constexpr double kPi = 3.14159265358979323846;
constexpr double kInvPi = 0.31830988618379067154;
constexpr double kInvTwoPi = 0.15915494309189533577;

// One operand: a pointer and its element strides along the lane, the slot
// and the colour channel.
struct Operand {
  long long ptr, s_lane, s_slot, s_chan;
};

// One measured half-angle table: a contiguous (nh, nd, npd, 3) float32 tensor.
struct Table {
  long long ptr, nh, nd, npd;
};

// The argument block kernels/bsdf.py fills, word for word.
struct Args {
  long long n, k, present, include_specular, wide, n_tables;   // wide: bit 0 type, bit 1 fr int64
  Operand op[kOperands];
  Table table[kMaxTables];
  long long out_f, out_pdf, out_wi, out_specular, out_valid;
  // backward: the cotangents of f, pdf and wi (a null pointer: zero), and
  // each operand's gradient (null: not wanted), dense (N[, K][, 3]) float32
  Operand g_f, g_pdf, g_wi;
  long long grad[kOperands];
};

// ------------------------------------------------------------------ duals
struct Dual {
  float v, d;
  Dual() = default;
  __device__ Dual(float x) : v(x), d(0.0f) {}
  __device__ Dual(float x, float dx) : v(x), d(dx) {}
};

// d * slope, zero where d is (no 0 * inf NaN from a lane's untaken branch)
__device__ __forceinline__ float chain(float d, float slope) {
  return d == 0.0f ? 0.0f : d * slope;
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, chain(a.d, b.v) + chain(b.d, a.v)};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, chain(a.d, 1.0f / b.v) - chain(b.d, q / b.v)};
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

template <class T>
struct V3T {
  T x, y, z;
};
using V3 = V3T<float>;

template <class T>
__device__ __forceinline__ V3 val3(V3T<T> v) {
  return {val(v.x), val(v.y), val(v.z)};
}

// an input's value, with a tangent of 1 where it is the pass's seed
template <class T>
__device__ T seeded(float v, bool seed);
template <>
__device__ __forceinline__ float seeded<float>(float v, bool) { return v; }
template <>
__device__ __forceinline__ Dual seeded<Dual>(float v, bool seed) {
  return {v, seed ? 1.0f : 0.0f};
}

// --------------------------------------------- PyTorch's float operations
__device__ __forceinline__ float clamp_min(float v, float lo) {   // torch.clamp_min
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {   // torch.clamp_max
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {   // torch.clamp
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {   // torch.maximum
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {   // torch.minimum
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(clamp_min(x, 0.0f)); }
__device__ __forceinline__ float recip(float x) { return 1.0f / x; }   // 1.0 / tensor
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float vrsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ float vpow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ float vtan(float x) { return tanf(x); }
__device__ __forceinline__ float vatan(float x) { return atanf(x); }
__device__ __forceinline__ float vfloor(float x) { return floorf(x); }

// the same on duals, with autograd's derivatives
__device__ __forceinline__ Dual clamp_min(Dual v, float lo) {
  return {clamp_min(v.v, lo), v.v >= lo ? v.d : 0.0f};
}
__device__ __forceinline__ Dual clamp_max(Dual v, float hi) {
  return {clamp_max(v.v, hi), v.v <= hi ? v.d : 0.0f};
}
__device__ __forceinline__ Dual clamp(Dual v, float lo, float hi) {
  return {clamp(v.v, lo, hi), v.v >= lo && v.v <= hi ? v.d : 0.0f};
}
__device__ __forceinline__ Dual maximum(Dual a, Dual b) {
  const float d = a.v == b.v ? 0.5f * a.d + 0.5f * b.d
                             : (a.v < b.v ? 0.0f : a.d) + (a.v > b.v ? 0.0f : b.d);
  return {maximum(a.v, b.v), d};
}
__device__ __forceinline__ Dual minimum(Dual a, Dual b) {
  const float d = a.v == b.v ? 0.5f * a.d + 0.5f * b.d
                             : (a.v > b.v ? 0.0f : a.d) + (a.v < b.v ? 0.0f : b.d);
  return {minimum(a.v, b.v), d};
}
__device__ __forceinline__ Dual safe_sqrt(Dual x) {   // vecmath._SqrtClamped
  const float r = safe_sqrt(x.v);
  return {r, r > 0.0f ? x.d / (2.0f * r) : 0.0f};
}
__device__ __forceinline__ Dual recip(Dual x) {
  const float r = recip(x.v);
  return {r, chain(x.d, -(r * r))};
}
__device__ __forceinline__ Dual vabs(Dual x) {
  return {fabsf(x.v), x.v > 0.0f ? x.d : (x.v < 0.0f ? -x.d : 0.0f)};
}
__device__ __forceinline__ Dual vsqrt(Dual x) {
  const float r = sqrtf(x.v);
  return {r, chain(x.d, 1.0f / (2.0f * r))};
}
__device__ __forceinline__ Dual vrsqrt(Dual x) {
  const float r = rsqrtf(x.v);
  return {r, chain(x.d, -0.5f * (r * r * r))};
}
__device__ __forceinline__ Dual vpow(Dual x, Dual e) {
  const float r = powf(x.v, e.v);
  const float dx = e.v == 0.0f ? 0.0f : chain(x.d, e.v * powf(x.v, e.v - 1.0f));
  const float de = x.v == 0.0f && e.v >= 0.0f ? 0.0f : chain(e.d, r * logf(x.v));
  return {r, dx + de};
}
__device__ __forceinline__ Dual vsin(Dual x) { return {sinf(x.v), chain(x.d, cosf(x.v))}; }
__device__ __forceinline__ Dual vcos(Dual x) { return {cosf(x.v), chain(x.d, -sinf(x.v))}; }
__device__ __forceinline__ Dual vtan(Dual x) {
  const float r = tanf(x.v);
  return {r, chain(x.d, 1.0f + r * r)};
}
__device__ __forceinline__ Dual vatan(Dual x) {
  return {atanf(x.v), chain(x.d, 1.0f / (x.v * x.v + 1.0f))};
}
__device__ __forceinline__ Dual vfloor(Dual x) { return {floorf(x.v), 0.0f}; }

// ------------------------------------------------------------- operands
// The lane, and the input a backward pass seeds (op -1: none).
struct Lane {
  long long l;
  int op;
  long long k;
  int c;
};

__device__ __forceinline__ float raw(const Args& a, int op, long long l, long long k, int c) {
  const Operand& o = a.op[op];
  return reinterpret_cast<const float*>(o.ptr)[l * o.s_lane + k * o.s_slot + c * o.s_chan];
}

template <class T>
__device__ __forceinline__ T ld(const Args& a, const Lane& z, int op, long long k, int c = 0) {
  return seeded<T>(raw(a, op, z.l, k, c), z.op == op && z.k == k && z.c == c);
}

template <class T>
__device__ __forceinline__ V3T<T> ld3(const Args& a, const Lane& z, int op, long long k) {
  return {ld<T>(a, z, op, k, 0), ld<T>(a, z, op, k, 1), ld<T>(a, z, op, k, 2)};
}

__device__ __forceinline__ int ld_tag(const Args& a, int op, long long l, long long k) {
  const Operand& o = a.op[op];
  const long long i = l * o.s_lane + k * o.s_slot;
  return (a.wide >> op) & 1 ? static_cast<int>(reinterpret_cast<const long long*>(o.ptr)[i])
                            : reinterpret_cast<const int*>(o.ptr)[i];
}

// --------------------------------------------------------------- vectors
template <class T>
__device__ __forceinline__ T dot(V3T<T> a, V3T<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <class T>
__device__ __forceinline__ bool same_hemisphere(V3T<T> w, V3T<T> wp) {
  return val(w.z) * val(wp.z) > 0.0f;
}
template <class T>
__device__ __forceinline__ V3T<T> neg(V3T<T> v) { return {-v.x, -v.y, -v.z}; }
template <class T>
__device__ __forceinline__ V3T<T> flip_z(V3T<T> v) {   // BRDFToBTDF
  return {v.x, v.y, v.z * -1.0f};
}
template <class T>
__device__ __forceinline__ V3T<T> scale(V3T<T> v, T s) { return {v.x * s, v.y * s, v.z * s}; }

// _half_vector: normalize(wi + wo) and whether |wi + wo| sums above 1e-9
template <class T>
__device__ __forceinline__ V3T<T> half_vector(V3T<T> wo, V3T<T> wi, bool* ok) {
  const V3T<T> v = {wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
  *ok = fabsf(val(v.x)) + fabsf(val(v.y)) + fabsf(val(v.z)) > F32(1e-9);
  return scale(v, vrsqrt(clamp_min(dot(v, v), F32(1e-30))));
}

// -wo + 2 (wo . wh) wh
template <class T>
__device__ __forceinline__ V3T<T> reflect_about(V3T<T> wo, V3T<T> wh) {
  const T d2 = 2.0f * dot(wo, wh);
  return {-wo.x + d2 * wh.x, -wo.y + d2 * wh.y, -wo.z + d2 * wh.z};
}

// ----------------------------------------------------------------- Fresnel
template <class T>
__device__ T fr_dielectric(T cosi, T eta_t) {   // eta_i = 1
  cosi = clamp(cosi, -1.0f, 1.0f);
  const bool entering = val(cosi) > 0.0f;
  const T ei = entering ? T(1.0f) : eta_t;
  const T et = entering ? eta_t : T(1.0f);
  const T sint = ei / et * safe_sqrt(1.0f - cosi * cosi);
  const T cost = safe_sqrt(1.0f - sint * sint);
  const T aci = vabs(cosi);
  const T rparl = (et * aci - ei * cost) / clamp_min(et * aci + ei * cost, F32(1e-12));
  const T rperp = (ei * aci - et * cost) / clamp_min(ei * aci + et * cost, F32(1e-12));
  const T fr = 0.5f * (rparl * rparl + rperp * rperp);
  return val(sint) >= 1.0f ? T(1.0f) : fr;
}

template <class T>
__device__ T fr_conductor(T aci, T eta, T k) {   // aci = |cos|
  const T tmp = (eta * eta + k * k) * aci * aci;
  const T rparl2 = (tmp - 2.0f * eta * aci + 1.0f)
                   / clamp_min(tmp + 2.0f * eta * aci + 1.0f, F32(1e-12));
  const T tmp_f = eta * eta + k * k;
  const T rperp2 = (tmp_f - 2.0f * eta * aci + aci * aci)
                   / clamp_min(tmp_f + 2.0f * eta * aci + aci * aci, F32(1e-12));
  return (rparl2 + rperp2) * 0.5f;
}

// lobe_fresnel, for the lane's own Fresnel kind only
template <class T>
__device__ V3T<T> lobe_fresnel(const Args& a, const Lane& z, long long k, T cosi) {
  const int kind = ld_tag(a, OP_FR, z.l, k);
  if (kind == FR_DIELECTRIC) {
    const T f = fr_dielectric(cosi, ld<T>(a, z, OP_F2, k));
    return {f, f, f};
  }
  if (kind == FR_CONDUCTOR) {
    const V3T<T> eta = ld3<T>(a, z, OP_S1, k), kk = ld3<T>(a, z, OP_S2, k);
    const T c = vabs(cosi);
    return {fr_conductor(c, eta.x, kk.x), fr_conductor(c, eta.y, kk.y),
            fr_conductor(c, eta.z, kk.z)};
  }
  return {T(1.0f), T(1.0f), T(1.0f)};
}

// -------------------------------------------------------------- microfacets
template <class T>
__device__ __forceinline__ T blinn_d(V3T<T> wh, T e) {
  return (e + 2.0f) * F32(kInvTwoPi) * vpow(clamp_min(vabs(wh.z), F32(1e-6)), e);
}

template <class T>
__device__ __forceinline__ T blinn_pdf_wh_to_wi(V3T<T> wo, V3T<T> wh, T e) {
  const T pdf_wh = (e + 1.0f) * vpow(clamp_min(vabs(wh.z), F32(1e-6)), e) * F32(kInvTwoPi);
  return pdf_wh / (4.0f * clamp_min(vabs(dot(wo, wh)), F32(1e-6)));
}

template <class T>
__device__ T aniso_d(V3T<T> wh, T ex, T ey) {
  const T ct = vabs(wh.z);
  const T d = clamp_min(1.0f - ct * ct, 0.0f);
  const bool flat = val(d) == 0.0f;
  const T e = (ex * wh.x * wh.x + ey * wh.y * wh.y) / (flat ? T(1.0f) : d);
  const T v = vsqrt((ex + 2.0f) * (ey + 2.0f)) * F32(kInvTwoPi)
              * vpow(clamp_min(ct, F32(1e-6)), e);
  return flat ? T(0.0f) : v;
}

template <class T>
__device__ __forceinline__ T aniso_pdf_wh_to_wi(V3T<T> wo, V3T<T> wh, T ex, T ey) {
  return aniso_d(wh, ex, ey) / (4.0f * clamp_min(vabs(dot(wo, wh)), F32(1e-6)));
}

template <class T>
__device__ __forceinline__ T torrance_sparrow_g(V3T<T> wo, V3T<T> wi, V3T<T> wh) {
  const T ndotwh = vabs(wh.z);
  const T wodotwh = clamp_min(vabs(dot(wo, wh)), F32(1e-6));
  return clamp_max(minimum(2.0f * ndotwh * vabs(wo.z) / wodotwh,
                           2.0f * ndotwh * vabs(wi.z) / wodotwh), 1.0f);
}

template <class T>
__device__ V3T<T> blinn_sample_wh(V3T<T> wo, T u1, T u2, T e) {
  const T costheta = vpow(clamp_min(u1, F32(1e-12)), recip(e + 1.0f));
  const T sintheta = safe_sqrt(1.0f - costheta * costheta);
  const T phi = u2 * 2.0f * F32(kPi);
  const V3T<T> wh = {sintheta * vcos(phi), sintheta * vsin(phi), costheta};
  return same_hemisphere(wo, wh) ? wh : neg(wh);
}

template <class T>
__device__ V3T<T> aniso_sample_wh(V3T<T> wo, T u1, T u2, T ex, T ey) {
  const T q = vfloor(u1 * 4.0f);
  const T phi_q = vatan(vsqrt((ex + 1.0f) / (ey + 1.0f))
                        * vtan(F32(kPi) * (u1 * 4.0f - q) * 0.5f));
  const T cosphi = vcos(phi_q), sinphi = vsin(phi_q);
  const T costheta = vpow(clamp_min(u2, F32(1e-12)),
                          recip(ex * cosphi * cosphi + ey * sinphi * sinphi + 1.0f));
  const float qv = val(q);
  const T phi = qv == 0.0f ? phi_q
                : qv == 1.0f ? F32(kPi) - phi_q
                : qv == 2.0f ? phi_q + F32(kPi)
                             : F32(2.0 * kPi) - phi_q;
  const T sintheta = safe_sqrt(1.0f - costheta * costheta);
  const V3T<T> wh = {sintheta * vcos(phi), sintheta * vsin(phi), costheta};
  return same_hemisphere(wo, wh) ? wh : neg(wh);
}

// montecarlo.cosine_sample_hemisphere (Shirley-Chiu's concentric disk)
template <class T>
__device__ V3T<T> cosine_sample_hemisphere(T u1, T u2) {
  const T sx = 2.0f * u1 - 1.0f;
  const T sy = 2.0f * u2 - 1.0f;
  const bool zero = val(sx) == 0.0f && val(sy) == 0.0f;
  const bool use_x = fabsf(val(sx)) > fabsf(val(sy));
  const T r = use_x ? sx : sy;
  const T theta = use_x ? F32(kPi / 4.0) * (sy / (val(sx) == 0.0f ? T(1.0f) : sx))
                        : F32(kPi / 2.0) - F32(kPi / 4.0) * (sx / (val(sy) == 0.0f ? T(1.0f) : sy));
  const T dx = zero ? T(0.0f) : r * vcos(theta);
  const T dy = zero ? T(0.0f) : r * vsin(theta);
  return {dx, dy, vsqrt(clamp_min(1.0f - dx * dx - dy * dy, 0.0f))};
}

// ---------------------------------------------------------- measured tables
// measured.lookup: row `row` of the tables at the nearest cell of (wo, wi)'s
// half and difference angles (_halfdiff_coords, the sqrt warp on
// theta_half); zero for a row past the tables. Its value has no derivative
// in the directions (a cell index), as in the plain version.
__device__ V3 measured_lookup(const Args& a, float row, V3 wo, V3 wi) {
  const int gi = static_cast<int>(row);
  if (gi < 0 || gi >= a.n_tables) return {0.0f, 0.0f, 0.0f};
  const V3 v = {wo.x + wi.x, wo.y + wi.y, wo.z + wi.z};
  const float r = rsqrtf(clamp_min(dot(v, v), F32(1e-30)));
  const V3 wh = {v.x * r, v.y * r, v.z * r};
  const float th = acosf(clamp(wh.z, -1.0f, 1.0f));
  const float ph = atan2f(wh.y, wh.x);
  const float cph = cosf(ph), sph = sinf(ph);
  const float x1 = cph * wi.x + sph * wi.y;
  const float y1 = -sph * wi.x + cph * wi.y;
  const float ct = cosf(th), st = sinf(th);
  const float xd = ct * x1 - st * wi.z;
  const float zd = st * x1 + ct * wi.z;
  const float td = acosf(clamp(zd, -1.0f, 1.0f));
  float pd = atan2f(y1, xd);
  pd = pd < 0.0f ? pd + F32(kPi) : pd;
  const Table& t = a.table[gi];
  const int nh = static_cast<int>(t.nh), nd = static_cast<int>(t.nd);
  const int npd = static_cast<int>(t.npd);
  const float inv_half_pi = 1.0f / F32(kPi / 2.0), inv_pi = 1.0f / F32(kPi);
  const int ih = min(max(static_cast<int>(sqrtf(clamp_min(th * inv_half_pi, 0.0f))
                                          * static_cast<float>(nh)), 0), nh - 1);
  const int id = min(max(static_cast<int>(td * inv_half_pi * static_cast<float>(nd)), 0),
                     nd - 1);
  const int ip = min(max(static_cast<int>(pd * inv_pi * static_cast<float>(npd)), 0),
                     npd - 1);
  const float* cell = reinterpret_cast<const float*>(t.ptr)
                      + 3 * ((static_cast<long long>(ih) * nd + id) * npd + ip);
  return {cell[0], cell[1], cell[2]};
}

// ------------------------------------------------------------ one lobe slot
__device__ __forceinline__ bool in_present(const Args& a, int t) {
  return t >= 0 && t < 32 && ((a.present >> t) & 1);
}

// oren_nayar_f's scalar factor (A + B max(0, cos dphi) sin(alpha) tan(beta))
template <class T>
__device__ T oren_nayar(V3T<T> wo, V3T<T> wi, T sigma) {
  const T sigma2 = sigma * sigma;
  const T A = 1.0f - sigma2 / (2.0f * (sigma2 + F32(0.33)));
  const T B = F32(0.45) * sigma2 / (sigma2 + F32(0.09));
  const T sinthetai = safe_sqrt(1.0f - wi.z * wi.z);
  const T sinthetao = safe_sqrt(1.0f - wo.z * wo.z);
  const bool ok_i = val(sinthetai) > F32(1e-4);
  const bool ok_o = val(sinthetao) > F32(1e-4);
  const T cosdphi = (wi.x * wo.x + wi.y * wo.y)
                    / ((ok_i ? sinthetai : T(1.0f)) * (ok_o ? sinthetao : T(1.0f)));
  const T maxcos = ok_i && ok_o ? clamp_min(cosdphi, 0.0f) : T(0.0f);
  const T sinalpha = maximum(sinthetai, sinthetao);
  const T tanbeta = minimum(sinthetai, sinthetao)
                    / clamp_min(minimum(vabs(wi.z), vabs(wo.z)), F32(1e-6));
  return A + B * maxcos * sinalpha * tanbeta;
}

// lobe_f of slot k, type t: its BRDF value at (wo, wi); delta lobes give 0
template <class T>
__device__ V3T<T> slot_f(const Args& a, const Lane& z, long long k, int t, V3T<T> wo,
                         V3T<T> wi) {
  const V3T<T> zero = {T(0.0f), T(0.0f), T(0.0f)};
  if (!in_present(a, t)) return zero;
  const bool reflect = same_hemisphere(wo, wi);
  const T aci = vabs(wi.z), aco = vabs(wo.z);
  switch (t) {
    case LAMBERT:
    case LAMBERT_T: {
      if (reflect != (t == LAMBERT)) return zero;
      return scale(ld3<T>(a, z, OP_R, k), T(F32(kInvPi)));
    }
    case MEASURED: {
      if (!reflect) return zero;
      if (a.n_tables == 0) return scale(ld3<T>(a, z, OP_S1, k), T(F32(kInvPi)));
      const V3 m = measured_lookup(a, raw(a, OP_F1, z.l, k, 0), val3(wo), val3(wi));
      const V3T<T> R = ld3<T>(a, z, OP_R, k);
      return {R.x * m.x, R.y * m.y, R.z * m.z};
    }
    case OREN_NAYAR: {
      if (!reflect) return zero;
      const V3T<T> R = ld3<T>(a, z, OP_R, k);
      const T s = oren_nayar(wo, wi, ld<T>(a, z, OP_F0, k));
      return {R.x * F32(kInvPi) * s, R.y * F32(kInvPi) * s, R.z * F32(kInvPi) * s};
    }
    case BLINN:
    case ANISO:
    case FRESNEL_BLEND: {
      bool wh_ok;
      const V3T<T> wh = half_vector(wo, wi, &wh_ok);
      if (!(reflect && wh_ok && val(aci) > F32(1e-6) && val(aco) > F32(1e-6))) return zero;
      const T cosh = dot(wi, wh);
      const V3T<T> R = ld3<T>(a, z, OP_R, k);
      const T f0 = ld<T>(a, z, OP_F0, k);
      if (t == FRESNEL_BLEND) {
        // Ashikhmin-Shirley: a diffuse base under a glossy coat
        const V3T<T> Rs = ld3<T>(a, z, OP_S1, k);
        const T f1 = ld<T>(a, z, OP_F1, k);
        const T x = (1.0f - vpow(1.0f - 0.5f * aci, T(5.0f)))
                    * (1.0f - vpow(1.0f - 0.5f * aco, T(5.0f)));
        const T spec_denom = clamp_min(4.0f * vabs(cosh) * maximum(aci, aco), F32(1e-6));
        const T ds = aniso_d(wh, f0, f1) / spec_denom;
        const T p5 = vpow(clamp(1.0f - cosh, 0.0f, 1.0f), T(5.0f));
        const float c = F32(28.0 / (23.0 * kPi));
        return {c * R.x * (1.0f - Rs.x) * x + ds * (Rs.x + p5 * (1.0f - Rs.x)),
                c * R.y * (1.0f - Rs.y) * x + ds * (Rs.y + p5 * (1.0f - Rs.y)),
                c * R.z * (1.0f - Rs.z) * x + ds * (Rs.z + p5 * (1.0f - Rs.z))};
      }
      const T denom = clamp_min(4.0f * aci * aco, F32(1e-6));
      const V3T<T> F = lobe_fresnel(a, z, k, cosh);
      const T G = torrance_sparrow_g(wo, wi, wh);
      const T d = t == BLINN ? blinn_d(wh, f0) : aniso_d(wh, f0, ld<T>(a, z, OP_F1, k));
      const T s = d * G / denom;
      return {R.x * F.x * s, R.y * F.y * s, R.z * F.z * s};
    }
    case BLINN_T: {
      // the BRDF at wi mirrored into wo's hemisphere (BRDFToBTDF)
      const V3T<T> wi_m = flip_z(wi);
      bool wh_ok;
      const V3T<T> wh = half_vector(wo, wi_m, &wh_ok);
      if (!(!reflect && wh_ok && val(aci) > F32(1e-6) && val(aco) > F32(1e-6))) return zero;
      const V3T<T> R = ld3<T>(a, z, OP_R, k);
      const V3T<T> F = lobe_fresnel(a, z, k, dot(wi_m, wh));
      const T G = torrance_sparrow_g(wo, wi_m, wh);
      const T denom = clamp_min(4.0f * aci * aco, F32(1e-6));
      const T s = blinn_d(wh, ld<T>(a, z, OP_F0, k)) * G / denom;
      return {R.x * F.x * s, R.y * F.y * s, R.z * F.z * s};
    }
    default:
      return zero;
  }
}

// lobe_pdf of slot k, type t
template <class T>
__device__ T slot_pdf(const Args& a, const Lane& z, long long k, int t, V3T<T> wo, V3T<T> wi) {
  if (!in_present(a, t)) return T(0.0f);
  const bool reflect = same_hemisphere(wo, wi);
  const T cos_pdf = vabs(wi.z) * F32(kInvPi);
  switch (t) {
    case LAMBERT:
    case OREN_NAYAR:
    case MEASURED:
      return reflect ? cos_pdf : T(0.0f);
    case LAMBERT_T:
      return reflect ? T(0.0f) : cos_pdf;
    case BLINN:
    case ANISO:
    case FRESNEL_BLEND: {
      bool wh_ok;
      const V3T<T> wh = half_vector(wo, wi, &wh_ok);
      if (!(reflect && wh_ok)) return T(0.0f);
      const T f0 = ld<T>(a, z, OP_F0, k);
      if (t == BLINN) return blinn_pdf_wh_to_wi(wo, wh, f0);
      const T p = aniso_pdf_wh_to_wi(wo, wh, f0, ld<T>(a, z, OP_F1, k));
      return t == ANISO ? p : 0.5f * (cos_pdf + p);
    }
    case BLINN_T: {
      bool wh_ok;
      const V3T<T> wh = half_vector(wo, flip_z(wi), &wh_ok);
      return !reflect && wh_ok ? blinn_pdf_wh_to_wi(wo, wh, ld<T>(a, z, OP_F0, k)) : T(0.0f);
    }
    default:
      return T(0.0f);
  }
}

// lobe_sample_wi of slot k, type t: wi and whether it is a valid sample
template <class T>
__device__ bool slot_sample_wi(const Args& a, const Lane& z, long long k, int t, V3T<T> wo,
                               T u1, T u2, V3T<T>* wi) {
  *wi = {T(0.0f), T(0.0f), T(0.0f)};
  if (!in_present(a, t)) return false;
  const float side = val(wo.z) > 0.0f ? 1.0f : -1.0f;   // onto wo's hemisphere
  switch (t) {
    case LAMBERT:
    case OREN_NAYAR:
    case MEASURED:
    case LAMBERT_T: {
      const V3T<T> c = cosine_sample_hemisphere(u1, u2);
      const V3T<T> cand = {c.x * 1.0f, c.y * 1.0f, c.z * side};
      *wi = t == LAMBERT_T ? neg(cand) : cand;
      return true;
    }
    case BLINN:
    case BLINN_T: {
      const V3T<T> cand = reflect_about(wo, blinn_sample_wh(wo, u1, u2, ld<T>(a, z, OP_F0, k)));
      *wi = t == BLINN ? cand : flip_z(cand);
      return same_hemisphere(wo, cand);
    }
    case ANISO: {
      const V3T<T> cand = reflect_about(
          wo, aniso_sample_wh(wo, u1, u2, ld<T>(a, z, OP_F0, k), ld<T>(a, z, OP_F1, k)));
      *wi = cand;
      return same_hemisphere(wo, cand);
    }
    case FRESNEL_BLEND: {
      // the cosine for u1 < 0.5, the distribution otherwise
      if (val(u1) < 0.5f) {
        const V3T<T> c = cosine_sample_hemisphere(2.0f * u1, u2);
        *wi = {c.x * 1.0f, c.y * 1.0f, c.z * side};
        return true;
      }
      const V3T<T> cand = reflect_about(
          wo, aniso_sample_wh(wo, 2.0f * (u1 - 0.5f), u2, ld<T>(a, z, OP_F0, k),
                              ld<T>(a, z, OP_F1, k)));
      *wi = cand;
      return same_hemisphere(wo, cand);
    }
    case SPEC_REFL:
      *wi = {-wo.x, -wo.y, wo.z};
      return true;
    case SPEC_TRANS: {
      const T f2 = ld<T>(a, z, OP_F2, k);
      const bool entering = val(wo.z) > 0.0f;
      const T eta = (entering ? T(1.0f) : f2) / (entering ? f2 : T(1.0f));
      const T sint2 = eta * eta * clamp_min(1.0f - wo.z * wo.z, 0.0f);
      const T cost = safe_sqrt(1.0f - sint2);
      *wi = {eta * -wo.x, eta * -wo.y, entering ? -cost : cost};
      return val(sint2) < 1.0f;
    }
    default:
      return false;
  }
}

// lobe_specular_value of slot k, type t: a delta lobe's value
template <class T>
__device__ V3T<T> slot_specular_value(const Args& a, const Lane& z, long long k, int t,
                                      V3T<T> wo, V3T<T> wi) {
  const T aci = clamp_min(vabs(wi.z), F32(1e-6));
  if (t == SPEC_REFL && in_present(a, SPEC_REFL)) {
    const V3T<T> F = lobe_fresnel(a, z, k, wo.z), R = ld3<T>(a, z, OP_R, k);
    return {F.x * R.x / aci, F.y * R.y / aci, F.z * R.z / aci};
  }
  if (t == SPEC_TRANS && in_present(a, SPEC_TRANS)) {
    const T f2 = ld<T>(a, z, OP_F2, k);
    const T fr = fr_dielectric(wo.z, f2);
    const bool entering = val(wo.z) > 0.0f;
    const T ei = entering ? T(1.0f) : f2;
    const T et = entering ? f2 : T(1.0f);
    const T s = ei * ei / (et * et) * (1.0f - fr);
    const V3T<T> R = ld3<T>(a, z, OP_R, k);
    return {s * R.x / aci, s * R.y / aci, s * R.z / aci};
  }
  return {T(0.0f), T(0.0f), T(0.0f)};
}

// ------------------------------------------------------------------ the stack
__device__ __forceinline__ bool is_specular(int t) { return t == SPEC_REFL || t == SPEC_TRANS; }

__device__ __forceinline__ bool matches(const Args& a, int t) {
  return t != NONE && (a.include_specular || !is_specular(t));
}

// bsdf_f: the slots' values summed in slot order
template <class T>
__device__ V3T<T> stack_f(const Args& a, const Lane& z, V3T<T> wo, V3T<T> wi) {
  V3T<T> total = {T(0.0f), T(0.0f), T(0.0f)};
  for (long long k = 0; k < a.k; ++k) {
    const V3T<T> v = slot_f(a, z, k, ld_tag(a, OP_TYPE, z.l, k), wo, wi);
    total = {total.x + v.x, total.y + v.y, total.z + v.z};
  }
  return total;
}

// bsdf_pdf: the matching slots' mean pdf
template <class T>
__device__ T stack_pdf(const Args& a, const Lane& z, V3T<T> wo, V3T<T> wi) {
  T total = 0.0f;
  float n = 0.0f;
  for (long long k = 0; k < a.k; ++k) {
    const int t = ld_tag(a, OP_TYPE, z.l, k);
    if (matches(a, t)) {
      total = total + slot_pdf(a, z, k, t, wo, wi);
      n = n + 1.0f;
    }
  }
  return n > 0.0f ? total / clamp_min(n, 1.0f) : T(0.0f);
}

// One call's outputs on one lane.
template <class T>
struct Out {
  V3T<T> f, wi;
  T pdf;
  bool specular, valid;
};

template <int kRoute, class T>
__device__ Out<T> evaluate(const Args& a, const Lane& z) {
  Out<T> o;
  const V3T<T> wo = ld3<T>(a, z, OP_WO, 0);
  if (kRoute == kF) {
    o.f = stack_f(a, z, wo, ld3<T>(a, z, OP_WI, 0));
    return o;
  }
  if (kRoute == kPdf) {
    o.pdf = stack_pdf(a, z, wo, ld3<T>(a, z, OP_WI, 0));
    return o;
  }
  // bsdf_sample: the `which`-th matching slot, counted (the plain
  // version's cumsum pick; slot 0 where none matches)
  int n_match = 0;
  for (long long k = 0; k < a.k; ++k) n_match += matches(a, ld_tag(a, OP_TYPE, z.l, k));
  const float uc = raw(a, OP_UC, z.l, 0, 0);
  const int which = min(static_cast<int>(uc * static_cast<float>(n_match)), max(n_match - 1, 0));
  long long slot = 0;
  for (long long k = 0, seen = 0; k < a.k; ++k) {
    if (!matches(a, ld_tag(a, OP_TYPE, z.l, k))) continue;
    if (seen++ == which) {
      slot = k;
      break;
    }
  }
  const int t = ld_tag(a, OP_TYPE, z.l, slot);
  const bool valid = slot_sample_wi(a, z, slot, t, wo, ld<T>(a, z, OP_U1, 0),
                                    ld<T>(a, z, OP_U2, 0), &o.wi)
                     && n_match > 0;
  o.f = stack_f(a, z, wo, o.wi);
  o.pdf = stack_pdf(a, z, wo, o.wi);
  o.specular = is_specular(t);
  if (o.specular && (in_present(a, SPEC_REFL) || in_present(a, SPEC_TRANS))) {
    // a delta pick carries its lobe's value and pdf 1/n_match
    o.f = slot_specular_value(a, z, slot, t, wo, o.wi);
    o.pdf = recip(clamp_min(static_cast<float>(n_match), 1.0f));
  }
  o.valid = valid && val(o.pdf) > 0.0f;
  return o;
}

__device__ __forceinline__ void store3(long long ptr, long long l, V3 v) {
  float* out = reinterpret_cast<float*>(ptr) + 3 * l;
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads) bsdf_kernel(const Args a) {
  const long long l = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= a.n) return;
  const Out<float> o = evaluate<kRoute, float>(a, Lane{l, -1, 0, 0});
  if (kRoute != kPdf) store3(a.out_f, l, o.f);
  if (kRoute != kF) reinterpret_cast<float*>(a.out_pdf)[l] = o.pdf;
  if (kRoute == kSample) {
    store3(a.out_wi, l, o.wi);
    reinterpret_cast<uint8_t*>(a.out_specular)[l] = o.specular;
    reinterpret_cast<uint8_t*>(a.out_valid)[l] = o.valid;
  }
}

// a cotangent's component c on lane l, zero where the output has none
__device__ __forceinline__ float cot(const Operand& g, long long l, int c) {
  return g.ptr ? reinterpret_cast<const float*>(g.ptr)[l * g.s_lane + c * g.s_chan] : 0.0f;
}

// The vector-Jacobian product: for each wanted float input of the lane,
// one dual pass seeded there, its outputs' derivatives dotted with their
// cotangents, written to the input's dense gradient.
template <int kRoute>
__global__ void __launch_bounds__(kThreads) bsdf_backward(const Args a) {
  const long long l = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= a.n) return;
  const V3 gf = {cot(a.g_f, l, 0), cot(a.g_f, l, 1), cot(a.g_f, l, 2)};
  const V3 gwi = {cot(a.g_wi, l, 0), cot(a.g_wi, l, 1), cot(a.g_wi, l, 2)};
  const float gpdf = cot(a.g_pdf, l, 0);
  for (int op = OP_R; op < kOperands; ++op) {
    if (!a.grad[op]) continue;
    const long long slots = op < OP_WO ? a.k : 1;
    const int chans = op == OP_R || op == OP_S1 || op == OP_S2 || op == OP_WO || op == OP_WI
                      ? 3 : 1;
    float* out = reinterpret_cast<float*>(a.grad[op]) + l * slots * chans;
    for (long long k = 0; k < slots; ++k) {
      for (int c = 0; c < chans; ++c) {
        const Out<Dual> o = evaluate<kRoute, Dual>(a, Lane{l, op, k, c});
        float g = 0.0f;
        if (kRoute != kPdf)
          g = g + chain(gf.x, o.f.x.d) + chain(gf.y, o.f.y.d) + chain(gf.z, o.f.z.d);
        if (kRoute != kF) g = g + chain(gpdf, o.pdf.d);
        if (kRoute == kSample)
          g = g + chain(gwi.x, o.wi.x.d) + chain(gwi.y, o.wi.y.d) + chain(gwi.z, o.wi.z.d);
        out[k * chans + c] = g;
      }
    }
  }
}

using Kernel = void (*)(Args);
const Kernel kKernels[2][3] = {{bsdf_kernel<kF>, bsdf_kernel<kPdf>, bsdf_kernel<kSample>},
                               {bsdf_backward<kF>, bsdf_backward<kPdf>,
                                bsdf_backward<kSample>}};

}  // namespace

extern "C" {

// One call: route (0 bsdf_f, 1 bsdf_pdf, 2 bsdf_sample), backward (0 the
// call, 1 its vector-Jacobian product) and the argument block (`words`
// long longs, struct Args). Returns the CUDA error of the launch (0:
// launched; no lanes launch nothing).
int grail_bsdf(int route, int backward, const long long* block, long long words,
               void* stream) {
  if (route < kF || route > kSample || backward < 0 || backward > 1
      || words * 8 != static_cast<long long>(sizeof(Args)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(&a, block, sizeof(Args));
  if (a.n <= 0) return 0;
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  kKernels[backward][route]<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
