// Pair terms and epilogues shared by the pair kernels K1 (csrc/pair_reduce.cu,
// plane layout; also K7, the ctx-pass probe) and K3 and K5
// (csrc/tile_pair_reduce.cu, slot-major layout; K5 with per-view sums).
//
// A term functor adds one valid pair to its accumulators:
//   Term::term(acc, dx, dy, r_sq, r, qv, sv, c, scalar)
// with dx = x_j - x_i, qv the query slot's NQV values and sv the source slot's
// NSV values (both loaded by the kernel), c the f32 constants and `scalar` the
// call's one f32 scalar (dt or the correction scale). A post functor maps the
// NACC accumulators of a live query to its NOUT outputs (K1 only):
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
// Math modes (template parameter M of the helpers and of the terms K5 takes):
// F32Math, every operation in f32 as written; Bf16Math, K5's bf16 mode, the
// JAX package's XLA dense_grid.pair_reduce with pair_dtype "bfloat16"
// (ops/pallas_pair.py lists its operations' dtypes): each operation's f32
// result rounded to bf16 (M::r, round to nearest even), which is the bits of
// the JAX bf16 operation and of torch's bf16 elementwise operations. The
// constants arrive rounded to bf16 (ops/pallas_pair.py bf16_consts), as JAX
// rounds its weakly typed Python floats, except f32(mu m) of PhysCoef: the
// JAX model makes it an f32 array, which promotes the operations after it to
// f32 (Coef::PROMOTES; their M is then F32Math). In F32Math M::r is the
// identity, so the f32 forms compute what they did.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

static constexpr float MIN_DISTANCE_SQ = 1.0e-10f;
static constexpr float DIVISION_EPSILON = 1.0e-10f;

struct F32Math {
  static constexpr bool BF16 = false;
  __device__ static float r(float x) { return x; }
};
struct Bf16Math {
  static constexpr bool BF16 = true;
  __device__ static float r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// jnp.maximum / jnp.minimum semantics for a NaN first operand (fmaxf would
// drop it); the second operand is always a constant here
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// WendlandQuinticC2.evaluate / gradient_coefficient (smoothing_kernels.py)
template <class M = F32Math>
__device__ __forceinline__ float wendland_w(float r, const PairConsts& c) {
  const float q = jmin(M::r(r * c.w_h_inv), 1.0f);
  const float omq = M::r(1.0f - q);
  const float omq_sq = M::r(omq * omq);
  return M::r(M::r(M::r(c.w_norm * omq_sq) * omq_sq) * M::r(q + 0.25f));
}
template <class M = F32Math>
__device__ __forceinline__ float wendland_gc(float r, const PairConsts& c) {
  const float q = jmin(M::r(r * c.w_h_inv), 1.0f);
  const float omq = M::r(1.0f - q);
  return M::r(M::r(M::r(c.w_norm_grad * omq) * omq) * omq);
}
// Poly6.evaluate with the given h^2 and normaliser
template <class M = F32Math>
__device__ __forceinline__ float poly6_w(float r_sq, float hsq, float norm) {
  const float dsq = jmax(M::r(hsq - r_sq), 0.0f);
  return M::r(M::r(M::r(norm * dsq) * dsq) * dsq);
}
// Spiky.evaluate / gradient_coefficient
template <class M = F32Math>
__device__ __forceinline__ float spiky_w(float r, const PairConsts& c) {
  const float hsubr = jmax(M::r(c.sp_h - r), 0.0f);
  return M::r(M::r(M::r(c.sp_norm * hsubr) * hsubr) * hsubr);
}
template <class M = F32Math>
__device__ __forceinline__ float spiky_gc(float r, const PairConsts& c) {
  const float hsubr = jmax(M::r(c.sp_h - r), 0.0f);
  return M::r(M::r(M::r(c.sp_norm_grad * hsubr) * hsubr) /
              M::r(r + M::r(DIVISION_EPSILON)));
}

// The viscosity coefficients c of a pair (acceleration c (v_j - v_i)), the
// template parameter of the terms that carry viscosity. PROMOTES: the JAX
// coefficient is f32 in a bf16 pass, and so are the operations it feeds.
struct XsphCoef {  // XSPHViscosityModel.viscous_coefficient: eps m W_poly6 / (rho_j dt)
  static constexpr bool PROMOTES = false;
  template <class M = F32Math>
  __device__ static float coef(float r_sq, float r, float rho_j, float dt,
                            const PairConsts& c) {
    return M::r(M::r(c.xsph_coef * poly6_w<M>(r_sq, c.p6_hsq, c.p6_norm)) /
                M::r(rho_j * dt));
  }
};
// PhysicalViscosityModel.viscous_coefficient: f32(mu m) lap W_visc(r) / rho_j,
// lap W_visc(r) = norm_lapl (h - r), no clamp (the pair test bounds r); the
// laplacian in the pass's math, f32(mu m) and what follows in f32
struct PhysCoef {
  static constexpr bool PROMOTES = true;
  template <class M = F32Math>
  __device__ static float coef(float r_sq, float r, float rho_j, float dt,
                            const PairConsts& c) {
    return (c.mu_m * M::r(c.vl_norm * M::r(c.vl_h - r))) / rho_j;
  }
};
// the math of the operations after a coefficient of `Coef` in mode M
template <class Coef, class M>
using AfterCoef = std::conditional_t<Coef::PROMOTES, F32Math, M>;

// ---------------------------------------------------------------- terms

struct CtxTerm {  // W, m grad W (x, y), |m grad W|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float w = wendland_w(r, c);
    const float mgc = wendland_gc(r, c) * c.mass;
    const float gx = mgc * dx;
    const float gy = mgc * dy;
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
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    using MC = AfterCoef<Coef, M>;
    const float vc = Coef::template coef<M>(r_sq, r, sv[2], scalar, c);
    acc[0] += MC::r(vc * M::r(sv[0] - qv[0]));
    acc[1] += MC::r(vc * M::r(sv[1] - qv[1]));
  }
};

struct DivTerm {  // (v_i - v_j) . grad W
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float gc = wendland_gc(r, c);
    acc[0] += ((qv[0] - sv[0]) * dx + (qv[1] - sv[1]) * dy) * gc;
  }
};

struct CorrTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float kk = (qv[0] + sv[0]) * wendland_gc(r, c);
    acc[0] += kk * dx;
    acc[1] += kk * dy;
  }
};

template <class M>
struct WcsphDensityTermT {  // Poly6 W (models/wcsph_dense.py density pass)
  static constexpr int NQV = 0, NSV = 0, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    acc[0] += poly6_w<M>(r_sq, c.d6_hsq, c.d6_norm);
  }
};
using WcsphDensityTerm = WcsphDensityTermT<F32Math>;

template <class M>
struct WcsphStatTermT {  // boundary pass: Poly6 W, Monaghan-Kajtar c (dx, dy)
  static constexpr int NQV = 0, NSV = 0, NACC = 3;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float wb = spiky_w<M>(r, c);
    const float cf = M::r(M::r(-c.bff * wb) / r_sq);
    acc[0] += poly6_w<M>(r_sq, c.d6_hsq, c.d6_norm);
    acc[1] += M::r(cf * dx);
    acc[2] += M::r(cf * dy);
  }
};
using WcsphStatTerm = WcsphStatTermT<F32Math>;

template <class Coef>
struct WcsphForcesTerm {  // symmetric pressure + viscosity; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float coef = (-c.mass * (qv[0] + sv[0])) / ((2.0f * qv[1]) * sv[1]);
    const float gc = coef * spiky_gc(r, c);
    const float vc = Coef::coef(r_sq, r, sv[1], scalar, c);
    acc[0] += gc * dx + vc * (sv[2] - qv[2]);
    acc[1] += gc * dy + vc * (sv[3] - qv[3]);
  }
};

// The XLA closures' order (models/dfsph_dense.py terms/div/corr,
// models/wcsph_dense.py dyn_forces): the gradient is the vector gc (dx, dy).

template <class M = F32Math>
struct CtxXlaTerm {  // W, (grad W) m (x, y), |(grad W) m|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float w = wendland_w<M>(r, c);
    const float gc = wendland_gc<M>(r, c);
    const float gx = M::r(M::r(gc * dx) * c.mass);
    const float gy = M::r(M::r(gc * dy) * c.mass);
    acc[0] += w;
    acc[1] += gx;
    acc[2] += gy;
    acc[3] += M::r(M::r(gx * gx) + M::r(gy * gy));
    acc[4] += 1.0f;
  }
};

template <class M = F32Math>
struct DivXlaTerm {  // sum((v_i - v_j) * grad W)
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float gc = wendland_gc<M>(r, c);
    acc[0] += M::r(M::r(M::r(qv[0] - sv[0]) * M::r(gc * dx)) +
                   M::r(M::r(qv[1] - sv[1]) * M::r(gc * dy)));
  }
};

template <class M = F32Math>
struct CorrXlaTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float kk = M::r(qv[0] + sv[0]);
    const float gc = wendland_gc<M>(r, c);
    acc[0] += M::r(kk * M::r(gc * dx));
    acc[1] += M::r(kk * M::r(gc * dy));
  }
};

template <class Coef, class M = F32Math>
struct WcsphForcesXlaTerm {  // coef grad W_spiky + viscosity; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    using MC = AfterCoef<Coef, M>;
    const float coef =
        M::r(M::r(-c.mass * M::r(qv[0] + sv[0])) / M::r(M::r(2.0f * qv[1]) * sv[1]));
    const float gc = spiky_gc<M>(r, c);
    const float vc = Coef::template coef<M>(r_sq, r, sv[1], scalar, c);
    acc[0] += MC::r(M::r(coef * M::r(gc * dx)) + MC::r(vc * M::r(sv[2] - qv[2])));
    acc[1] += MC::r(M::r(coef * M::r(gc * dy)) + MC::r(vc * M::r(sv[3] - qv[3])));
  }
};

// The ctx-pass probe's own statement (K7; tools/probe_pallas_slotmajor.py
// :42-62 of the JAX package): q = r f32(1/h), (1-q)^4 = (x x)(x x) and
// (1-q)^3 = x (x x) as lax.integer_pow multiplies, w = (norm_w x^4)(q + 0.25),
// g = ((m norm_g x^3) dx, ...). c.w_h_inv, c.w_norm, c.w_norm_grad and c.mass
// hold the probe's f32(1/h), f32(28/(pi h^2)), f32(140/(pi h^4)) and f32(m).
struct ProbeCtxTerm {  // W, m grad W (x, y), |m grad W|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float q = r * c.w_h_inv;
    const float omq = jmax(1.0f - q, 0.0f);
    const float omq2 = omq * omq;
    const float w = (c.w_norm * (omq2 * omq2)) * (q + 0.25f);
    const float mc = c.mass * (c.w_norm_grad * (omq * omq2));
    const float gx = mc * dx;
    const float gy = mc * dy;
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
