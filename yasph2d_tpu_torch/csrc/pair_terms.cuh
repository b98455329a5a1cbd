// Pair terms and epilogues shared by the pair kernels K1 (csrc/pair_reduce.cu,
// plane layout; also K7, the ctx-pass probe) and K3 and K5
// (csrc/tile_pair_reduce.cu, slot-major layout; K5 with per-view sums).
//
// A term functor adds one valid pair to its f32 accumulators:
//   Term::term(acc, d, r_sq, r, qv, sv, c, scalar)
// with d = (x_j - x_i, y_j - y_i) packed, qv the query slot's NQV values and
// sv the source slot's NSV values (both loaded by the kernel), c the constants
// and `scalar` the call's one scalar (dt or the correction scale), all in the
// math mode's types (below). A post functor maps the NACC accumulators of a
// live query to its NOUT outputs (K1 only):
//   Post::post(out, acc, pv, c, scalar)
// with pv the query slot's NPOST epilogue values.
//
// Every formula is written in the JAX package's operation order; the kernels
// are built with -fmad=false and without fast math, so each f32 operation is
// rounded as in the plain PyTorch twins (ops/pair_reduce.py,
// ops/sm_pair_reduce.py, ops/pallas_pair.py) and the JAX package. The JAX
// package has two orders: its slot-major closures scale the gradient
// coefficient first ((dvx dx + dvy dy) gc), its XLA closures form the gradient
// vector gc * (dx, dy) first (dvx (gc dx) + dvy (gc dy), (gc dx) m). The
// *XlaTerm functors follow the second. The terms that carry viscosity
// (ViscTerm, WcsphForcesTerm, WcsphForcesXlaTerm) take its coefficient as a
// template parameter: XsphCoef or PhysCoef, one statement each.
//
// Math modes (template parameter M of the helpers and of the terms K5 takes),
// each a set of operations on its value type T and its packed pair type T2
// (M::add, sub, mul, neg, div, sqrt, jmin, jmax; add2, sub2, mul2 on pairs;
// sum, a pair's x + y), so that each term is written once:
// - F32Math: T = float, T2 = float2, every operation the f32 operation as
//   written, so the f32 forms of K1, K3, K5 and K7 compute what they did.
// - Bf16Math, K5's bf16 mode: the JAX package's XLA dense_grid.pair_reduce
//   with pair_dtype "bfloat16" (ops/pallas_pair.py lists its operations'
//   dtypes), whose every operation is a bf16 operation, round to nearest even.
//   T = __nv_bfloat16 and T2 = __nv_bfloat162, and +, -, x are Hopper's own
//   bf16 instructions (HADD2, HMUL2 .BF16, two lanes at once on a pair), with
//   the _rn intrinsics, which the compiler never fuses into a multiply-add:
//   an FMA rounds once where JAX rounds twice. They give the bits of the f32
//   operation rounded to bf16 (the twin's `_rd`, torch's bf16 operations):
//   for +, -, x, / and sqrt of bf16 operands, rounding the exact result to
//   f32 (24 bits) and then to bf16 (8) is rounding it to bf16 once, since
//   24 >= 2 * 8 + 2 (tests/test_torch_bf16_rounding.py). Division and sqrt
//   stay f32 operations followed by one rounding (the bf16 intrinsics for
//   them may be approximate). jmin and jmax take bf16 min / max with NaN
//   propagation: their second operand is a constant and their first is never
//   -0 here (h - r and h^2 - r^2 of a valid pair round to +0 at worst).
//   The constants arrive rounded to bf16 (ops/pallas_pair.py bf16_consts,
//   PairConstsBf16), as JAX rounds its weakly typed Python floats, except
//   f32(mu m) of PhysCoef: the JAX model makes it an f32 array, which promotes
//   the operations after it to f32 (Coef::PROMOTES; they are f32 operations
//   on M::f of the bf16 values).
// The accumulators are f32 in both modes: each term adds M::f of its values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct PairConsts {
  float radius_sq;    // h^2 rounded to f32
  float w_h_inv;      // Wendland quintic C2: 1/h, 28/(pi h^2), 140/(pi h^4)
  float w_norm;
  float w_norm_grad;
  float p6_hsq;       // Poly6 of the XSPH viscosity: h^2, 4/(pi h^8)
  float p6_norm;
  float xsph_coef;    // f32(epsilon * m)
  float mass;         // particle mass m
  float w0;           // W(0), the density self-contribution
  float rho0;         // rest density
  float alpha_eps;    // DFSPH alpha denominator floor
  float gx, gy;       // gravity
  float d6_hsq;       // Poly6 density kernel (WCSPH): h^2, 4/(pi h^8)
  float d6_norm;
  float sp_h;         // Spiky pressure kernel (WCSPH): h, 10/(pi h^5), 30/(pi h^5)
  float sp_norm;
  float sp_norm_grad;
  float bff;          // Monaghan-Kajtar boundary force factor (WCSPH)
  float mu_m;         // physical viscosity: f32(mu * m), and the Viscosity
  float vl_h;         // kernel's laplacian h and 360/(29 pi h^5), each f32
  float vl_norm;
};

// The bf16 mode's constants: PairConsts' fields that bf16 operations read, as
// bf16 (the caller rounded them), and f32(mu m), an f32 operand in JAX too
struct PairConstsBf16 {
  __nv_bfloat16 w_h_inv, w_norm, w_norm_grad, p6_hsq, p6_norm, xsph_coef, mass, d6_hsq,
      d6_norm, sp_h, sp_norm, sp_norm_grad, bff, vl_h, vl_norm;
  float mu_m;
};
// on the host: the launcher converts the f32 constants once (exact: they are
// bf16 values already)
inline PairConstsBf16 bf16_consts_of(const PairConsts& c) {
  PairConstsBf16 b;
  b.w_h_inv = __float2bfloat16_rn(c.w_h_inv);
  b.w_norm = __float2bfloat16_rn(c.w_norm);
  b.w_norm_grad = __float2bfloat16_rn(c.w_norm_grad);
  b.p6_hsq = __float2bfloat16_rn(c.p6_hsq);
  b.p6_norm = __float2bfloat16_rn(c.p6_norm);
  b.xsph_coef = __float2bfloat16_rn(c.xsph_coef);
  b.mass = __float2bfloat16_rn(c.mass);
  b.d6_hsq = __float2bfloat16_rn(c.d6_hsq);
  b.d6_norm = __float2bfloat16_rn(c.d6_norm);
  b.sp_h = __float2bfloat16_rn(c.sp_h);
  b.sp_norm = __float2bfloat16_rn(c.sp_norm);
  b.sp_norm_grad = __float2bfloat16_rn(c.sp_norm_grad);
  b.bff = __float2bfloat16_rn(c.bff);
  b.vl_h = __float2bfloat16_rn(c.vl_h);
  b.vl_norm = __float2bfloat16_rn(c.vl_norm);
  b.mu_m = c.mu_m;
  return b;
}

static constexpr float MIN_DISTANCE_SQ = 1.0e-10f;
static constexpr float DIVISION_EPSILON = 1.0e-10f;

// jnp.maximum / jnp.minimum semantics for a NaN first operand (fmaxf would
// drop it); the second operand is always a constant here
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

struct F32Math {
  static constexpr bool BF16 = false;
  using T = float;
  using T2 = float2;
  using Consts = PairConsts;
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T sub(T a, T b) { return a - b; }
  __device__ static T mul(T a, T b) { return a * b; }
  __device__ static T neg(T a) { return -a; }
  __device__ static T div(T a, T b) { return a / b; }
  __device__ static T sqrt(T a) { return sqrtf(a); }
  __device__ static T jmin(T a, T b) { return ::jmin(a, b); }
  __device__ static T jmax(T a, T b) { return ::jmax(a, b); }
  __device__ static T2 add2(T2 a, T2 b) { return make_float2(a.x + b.x, a.y + b.y); }
  __device__ static T2 sub2(T2 a, T2 b) { return make_float2(a.x - b.x, a.y - b.y); }
  __device__ static T2 mul2(T2 a, T2 b) { return make_float2(a.x * b.x, a.y * b.y); }
  __device__ static T2 splat(T a) { return make_float2(a, a); }
  __device__ static T2 pair(T a, T b) { return make_float2(a, b); }
  __device__ static T sum(T2 a) { return a.x + a.y; }
  __device__ static float f(T a) { return a; }
  __device__ static float2 f2(T2 a) { return a; }
  __device__ static T k(float x) { return x; }  // a literal constant
};

struct Bf16Math {
  static constexpr bool BF16 = true;
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  using Consts = PairConstsBf16;
  __device__ static T add(T a, T b) { return __hadd_rn(a, b); }
  __device__ static T sub(T a, T b) { return __hsub_rn(a, b); }
  __device__ static T mul(T a, T b) { return __hmul_rn(a, b); }
  __device__ static T neg(T a) { return __hneg(a); }
  __device__ static T div(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) / __bfloat162float(b));
  }
  __device__ static T sqrt(T a) { return __float2bfloat16_rn(sqrtf(__bfloat162float(a))); }
  __device__ static T jmin(T a, T b) { return __hmin_nan(a, b); }
  __device__ static T jmax(T a, T b) { return __hmax_nan(a, b); }
  __device__ static T2 add2(T2 a, T2 b) { return __hadd2_rn(a, b); }
  __device__ static T2 sub2(T2 a, T2 b) { return __hsub2_rn(a, b); }
  __device__ static T2 mul2(T2 a, T2 b) { return __hmul2_rn(a, b); }
  __device__ static T2 splat(T a) { return __bfloat162bfloat162(a); }
  __device__ static T2 pair(T a, T b) { return __halves2bfloat162(a, b); }
  __device__ static T sum(T2 a) { return __hadd_rn(__low2bfloat16(a), __high2bfloat16(a)); }
  __device__ static float f(T a) { return __bfloat162float(a); }
  __device__ static float2 f2(T2 a) { return __bfloat1622float2(a); }
  // a literal constant rounded to bf16 (nearest even) by integer operations
  // that the compiler folds
  __device__ static T k(float x) {
    const unsigned u = __float_as_uint(x);
    return __ushort_as_bfloat16((unsigned short)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16));
  }
};

// WendlandQuinticC2.evaluate / gradient_coefficient (smoothing_kernels.py)
template <class M = F32Math>
__device__ __forceinline__ typename M::T wendland_w(typename M::T r,
                                                    const typename M::Consts& c) {
  using T = typename M::T;
  const T q = M::jmin(M::mul(r, c.w_h_inv), M::k(1.0f));
  const T omq = M::sub(M::k(1.0f), q);
  const T omq_sq = M::mul(omq, omq);
  return M::mul(M::mul(M::mul(c.w_norm, omq_sq), omq_sq), M::add(q, M::k(0.25f)));
}
template <class M = F32Math>
__device__ __forceinline__ typename M::T wendland_gc(typename M::T r,
                                                     const typename M::Consts& c) {
  using T = typename M::T;
  const T q = M::jmin(M::mul(r, c.w_h_inv), M::k(1.0f));
  const T omq = M::sub(M::k(1.0f), q);
  return M::mul(M::mul(M::mul(c.w_norm_grad, omq), omq), omq);
}
// Poly6.evaluate with the given h^2 and normaliser
template <class M = F32Math>
__device__ __forceinline__ typename M::T poly6_w(typename M::T r_sq, typename M::T hsq,
                                                 typename M::T norm) {
  using T = typename M::T;
  const T dsq = M::jmax(M::sub(hsq, r_sq), M::k(0.0f));
  return M::mul(M::mul(M::mul(norm, dsq), dsq), dsq);
}
// Spiky.evaluate / gradient_coefficient
template <class M = F32Math>
__device__ __forceinline__ typename M::T spiky_w(typename M::T r, const typename M::Consts& c) {
  using T = typename M::T;
  const T hsubr = M::jmax(M::sub(c.sp_h, r), M::k(0.0f));
  return M::mul(M::mul(M::mul(c.sp_norm, hsubr), hsubr), hsubr);
}
template <class M = F32Math>
__device__ __forceinline__ typename M::T spiky_gc(typename M::T r,
                                                  const typename M::Consts& c) {
  using T = typename M::T;
  const T hsubr = M::jmax(M::sub(c.sp_h, r), M::k(0.0f));
  return M::div(M::mul(M::mul(c.sp_norm_grad, hsubr), hsubr),
                M::add(r, M::k(DIVISION_EPSILON)));
}

// The viscosity coefficients c of a pair (acceleration c (v_j - v_i)), the
// template parameter of the terms that carry viscosity. PROMOTES: the JAX
// coefficient is f32 in a bf16 pass, and so are the operations it feeds;
// `visc` is c (v_j - v_i) for the packed difference dv, as f32.
struct XsphCoef {  // XSPHViscosityModel.viscous_coefficient: eps m W_poly6 / (rho_j dt)
  static constexpr bool PROMOTES = false;
  template <class M = F32Math>
  __device__ static typename M::T coef(typename M::T r_sq, typename M::T r,
                                       typename M::T rho_j, typename M::T dt,
                                       const typename M::Consts& c) {
    return M::div(M::mul(c.xsph_coef, poly6_w<M>(r_sq, c.p6_hsq, c.p6_norm)),
                  M::mul(rho_j, dt));
  }
  template <class M>
  __device__ static typename M::T2 visc(typename M::T vc, typename M::T2 dv) {
    return M::mul2(M::splat(vc), dv);
  }
};
// PhysicalViscosityModel.viscous_coefficient: f32(mu m) lap W_visc(r) / rho_j,
// lap W_visc(r) = norm_lapl (h - r), no clamp (the pair test bounds r); the
// laplacian in the pass's math, f32(mu m) and what follows in f32
struct PhysCoef {
  static constexpr bool PROMOTES = true;
  template <class M = F32Math>
  __device__ static float coef(typename M::T r_sq, typename M::T r, typename M::T rho_j,
                               typename M::T dt, const typename M::Consts& c) {
    return (c.mu_m * M::f(M::mul(c.vl_norm, M::sub(c.vl_h, r)))) / M::f(rho_j);
  }
  template <class M>
  __device__ static float2 visc(float vc, typename M::T2 dv) {
    const float2 d = M::f2(dv);
    return make_float2(vc * d.x, vc * d.y);
  }
};

// ---------------------------------------------------------------- terms

// the packed pair (v[i], v[i + 1]) of a slot's values
template <class M>
__device__ __forceinline__ typename M::T2 vpair(const typename M::T* v, int i) {
  return M::pair(v[i], v[i + 1]);
}
// a pair as f32, from either mode (a promoted viscosity term is f32 already)
__device__ __forceinline__ float2 as_f32(float2 v) { return v; }
__device__ __forceinline__ float2 as_f32(__nv_bfloat162 v) { return __bfloat1622float2(v); }

struct CtxTerm {  // W, m grad W (x, y), |m grad W|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float2 d, float r_sq, float r, const float* qv,
                              const float* sv, const PairConsts& c, float scalar) {
    const float w = wendland_w(r, c);
    const float mgc = wendland_gc(r, c) * c.mass;
    const float gx = mgc * d.x;
    const float gy = mgc * d.y;
    acc[0] += w;
    acc[1] += gx;
    acc[2] += gy;
    acc[3] += gx * gx + gy * gy;
    acc[4] += 1.0f;
  }
};

template <class Coef, class M = F32Math>
struct ViscTerm {  // c (v_j - v_i); qv vx vy, sv vx vy rho, scalar dt
  static constexpr int NQV = 2, NSV = 3, NACC = 2;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const auto vc = Coef::template coef<M>(r_sq, r, sv[2], scalar, c);
    const float2 v = as_f32(Coef::template visc<M>(vc, M::sub2(vpair<M>(sv, 0),
                                                                vpair<M>(qv, 0))));
    acc[0] += v.x;
    acc[1] += v.y;
  }
};

struct DivTerm {  // (v_i - v_j) . grad W
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  __device__ static void term(float* acc, float2 d, float r_sq, float r, const float* qv,
                              const float* sv, const PairConsts& c, float scalar) {
    const float gc = wendland_gc(r, c);
    acc[0] += ((qv[0] - sv[0]) * d.x + (qv[1] - sv[1]) * d.y) * gc;
  }
};

struct CorrTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  __device__ static void term(float* acc, float2 d, float r_sq, float r, const float* qv,
                              const float* sv, const PairConsts& c, float scalar) {
    const float kk = (qv[0] + sv[0]) * wendland_gc(r, c);
    acc[0] += kk * d.x;
    acc[1] += kk * d.y;
  }
};

template <class M>
struct WcsphDensityTermT {  // Poly6 W (models/wcsph_dense.py density pass)
  static constexpr int NQV = 0, NSV = 0, NACC = 1;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    acc[0] += M::f(poly6_w<M>(r_sq, c.d6_hsq, c.d6_norm));
  }
};
using WcsphDensityTerm = WcsphDensityTermT<F32Math>;

template <class M>
struct WcsphStatTermT {  // boundary pass: Poly6 W, Monaghan-Kajtar c (dx, dy)
  static constexpr int NQV = 0, NSV = 0, NACC = 3;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const T wb = spiky_w<M>(r, c);
    const T cf = M::div(M::mul(M::neg(c.bff), wb), r_sq);
    acc[0] += M::f(poly6_w<M>(r_sq, c.d6_hsq, c.d6_norm));
    const float2 f = M::f2(M::mul2(M::splat(cf), d));
    acc[1] += f.x;
    acc[2] += f.y;
  }
};
using WcsphStatTerm = WcsphStatTermT<F32Math>;

template <class Coef>
struct WcsphForcesTerm {  // symmetric pressure + viscosity; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  __device__ static void term(float* acc, float2 d, float r_sq, float r, const float* qv,
                              const float* sv, const PairConsts& c, float scalar) {
    const float coef = (-c.mass * (qv[0] + sv[0])) / ((2.0f * qv[1]) * sv[1]);
    const float gc = coef * spiky_gc(r, c);
    const float vc = Coef::coef(r_sq, r, sv[1], scalar, c);
    acc[0] += gc * d.x + vc * (sv[2] - qv[2]);
    acc[1] += gc * d.y + vc * (sv[3] - qv[3]);
  }
};

// The XLA closures' order (models/dfsph_dense.py terms/div/corr,
// models/wcsph_dense.py dyn_forces): the gradient is the vector gc (dx, dy),
// and each (x, y) pair of a term is one packed operation.

template <class M = F32Math>
struct CtxXlaTerm {  // W, (grad W) m (x, y), |(grad W) m|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const T w = wendland_w<M>(r, c);
    const T gc = wendland_gc<M>(r, c);
    const typename M::T2 g = M::mul2(M::mul2(M::splat(gc), d), M::splat(c.mass));
    const float2 gf = M::f2(g);
    acc[0] += M::f(w);
    acc[1] += gf.x;
    acc[2] += gf.y;
    acc[3] += M::f(M::sum(M::mul2(g, g)));
    acc[4] += 1.0f;
  }
};

template <class M = F32Math>
struct DivXlaTerm {  // sum((v_i - v_j) * grad W)
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const T gc = wendland_gc<M>(r, c);
    acc[0] += M::f(M::sum(M::mul2(M::sub2(vpair<M>(qv, 0), vpair<M>(sv, 0)),
                                  M::mul2(M::splat(gc), d))));
  }
};

template <class M = F32Math>
struct CorrXlaTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const T kk = M::add(qv[0], sv[0]);
    const T gc = wendland_gc<M>(r, c);
    const float2 f = M::f2(M::mul2(M::splat(kk), M::mul2(M::splat(gc), d)));
    acc[0] += f.x;
    acc[1] += f.y;
  }
};

template <class Coef, class M = F32Math>
struct WcsphForcesXlaTerm {  // coef grad W_spiky + viscosity; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  using T = typename M::T;
  __device__ static void term(float* acc, typename M::T2 d, T r_sq, T r, const T* qv,
                              const T* sv, const typename M::Consts& c, T scalar) {
    const T coef = M::div(M::mul(M::neg(c.mass), M::add(qv[0], sv[0])),
                          M::mul(M::mul(M::k(2.0f), qv[1]), sv[1]));
    const T gc = spiky_gc<M>(r, c);
    const auto vc = Coef::template coef<M>(r_sq, r, sv[1], scalar, c);
    const typename M::T2 p = M::mul2(M::splat(coef), M::mul2(M::splat(gc), d));
    const auto v = Coef::template visc<M>(vc, M::sub2(vpair<M>(sv, 2), vpair<M>(qv, 2)));
    float2 f;
    if constexpr (Coef::PROMOTES) {  // the bf16 pressure term plus the f32 viscosity, in f32
      const float2 pf = M::f2(p);
      f = make_float2(pf.x + v.x, pf.y + v.y);
    } else {
      f = M::f2(M::add2(p, v));
    }
    acc[0] += f.x;
    acc[1] += f.y;
  }
};

// The ctx-pass probe's own statement (K7; tools/probe_pallas_slotmajor.py
// :42-62 of the JAX package): q = r f32(1/h), (1-q)^4 = (x x)(x x) and
// (1-q)^3 = x (x x) as lax.integer_pow multiplies, w = (norm_w x^4)(q + 0.25),
// g = ((m norm_g x^3) dx, ...). c.w_h_inv, c.w_norm, c.w_norm_grad and c.mass
// hold the probe's f32(1/h), f32(28/(pi h^2)), f32(140/(pi h^4)) and f32(m).
struct ProbeCtxTerm {  // W, m grad W (x, y), |m grad W|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float2 d, float r_sq, float r, const float* qv,
                              const float* sv, const PairConsts& c, float scalar) {
    const float q = r * c.w_h_inv;
    const float omq = jmax(1.0f - q, 0.0f);
    const float omq2 = omq * omq;
    const float w = (c.w_norm * (omq2 * omq2)) * (q + 0.25f);
    const float mc = c.mass * (c.w_norm_grad * (omq * omq2));
    const float gx = mc * d.x;
    const float gy = mc * d.y;
    acc[0] += w;
    acc[1] += gx;
    acc[2] += gy;
    acc[3] += gx * gx + gy * gy;
    acc[4] += 1.0f;
  }
};

// ---------------------------------------------------------------- posts

template <int N>
struct NoPost {
  static constexpr int NPOST = 0, NOUT = N;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    for (int k = 0; k < N; ++k) out[k] = acc[k];
  }
};

struct CtxPost {  // density, alpha, neighbour total; pv = the 5 boundary sums
  static constexpr int NPOST = 5, NOUT = 3;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    const float dens = jmax(c.mass * ((c.w0 + acc[0]) + pv[0]), c.rho0);
    const float vx = acc[1] + pv[1];
    const float vy = acc[2] + pv[2];
    const float denom = (((vx * vx) + (vy * vy)) + acc[3]) + pv[3];
    out[0] = dens;
    out[1] = 1.0f / jmax(denom, c.alpha_eps);
    out[2] = acc[4] + pv[4];
  }
};

struct GravityPost {
  static constexpr int NPOST = 0, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    out[0] = acc[0] + c.gx;
    out[1] = acc[1] + c.gy;
  }
};

struct ErrKiPost {  // density error and k_i; pv = vx vy sgx sgy dens alpha
  static constexpr int NPOST = 6, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    const float delta = acc[0] + (pv[0] * pv[2] + pv[1] * pv[3]);
    const float err = jmax(pv[4] + (delta * c.mass) * scalar, c.rho0) - c.rho0;
    out[0] = err;
    out[1] = err * pv[5];
  }
};

struct DeltaKiPost {  // divergence and k_i; pv = vx vy sgx sgy nt alpha
  static constexpr int NPOST = 6, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    float delta = (acc[0] + (pv[0] * pv[2] + pv[1] * pv[3])) * c.mass;
    delta = jmax(delta, 0.0f);
    // particle-deficiency guard (<9 total neighbours, dfsph.rs:260-264)
    if (pv[4] < 9.0f) delta = 0.0f;
    out[0] = delta;
    out[1] = delta * pv[5];
  }
};

struct VUpdatePost {  // v - scale (corr + k sum_grad_stat); pv = vx vy k sgx sgy
  static constexpr int NPOST = 5, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const float* pv,
                              const PairConsts& c, float scalar) {
    out[0] = pv[0] - scalar * (acc[0] + pv[2] * pv[3]);
    out[1] = pv[1] - scalar * (acc[1] + pv[2] * pv[4]);
  }
};
