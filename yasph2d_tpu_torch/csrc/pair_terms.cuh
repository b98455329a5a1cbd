// Pair terms and epilogues shared by the pair kernels K1 (csrc/pair_reduce.cu,
// plane layout), K3 (csrc/sm_pair_reduce.cu, slot-major layout) and K5
// (csrc/tile_pair_reduce.cu, slot-major layout, per-view sums).
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
// *XlaTerm functors follow the second.

#pragma once

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
};

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

// WendlandQuinticC2.evaluate / gradient_coefficient (smoothing_kernels.py)
__device__ __forceinline__ float wendland_w(float r, const PairConsts& c) {
  const float q = jmin(r * c.w_h_inv, 1.0f);
  const float omq = 1.0f - q;
  const float omq_sq = omq * omq;
  return ((c.w_norm * omq_sq) * omq_sq) * (q + 0.25f);
}
__device__ __forceinline__ float wendland_gc(float r, const PairConsts& c) {
  const float q = jmin(r * c.w_h_inv, 1.0f);
  const float omq = 1.0f - q;
  return ((c.w_norm_grad * omq) * omq) * omq;
}
// Poly6.evaluate with the given h^2 and normaliser
__device__ __forceinline__ float poly6_w(float r_sq, float hsq, float norm) {
  const float dsq = jmax(hsq - r_sq, 0.0f);
  return ((norm * dsq) * dsq) * dsq;
}
// Spiky.evaluate / gradient_coefficient
__device__ __forceinline__ float spiky_w(float r, const PairConsts& c) {
  const float hsubr = jmax(c.sp_h - r, 0.0f);
  return ((c.sp_norm * hsubr) * hsubr) * hsubr;
}
__device__ __forceinline__ float spiky_gc(float r, const PairConsts& c) {
  const float hsubr = jmax(c.sp_h - r, 0.0f);
  return ((c.sp_norm_grad * hsubr) * hsubr) / (r + DIVISION_EPSILON);
}
// XSPHViscosityModel.viscous_coefficient: eps m W_poly6 / (rho_j dt)
__device__ __forceinline__ float xsph_c(float r_sq, float rho_j, float dt,
                                        const PairConsts& c) {
  return (c.xsph_coef * poly6_w(r_sq, c.p6_hsq, c.p6_norm)) / (rho_j * dt);
}

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

struct ViscTerm {  // XSPH: c (v_j - v_i); qv vx vy, sv vx vy rho, scalar dt
  static constexpr int NQV = 2, NSV = 3, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float vc = xsph_c(r_sq, sv[2], scalar, c);
    acc[0] += vc * (sv[0] - qv[0]);
    acc[1] += vc * (sv[1] - qv[1]);
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

struct WcsphDensityTerm {  // Poly6 W (models/wcsph_dense.py density pass)
  static constexpr int NQV = 0, NSV = 0, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    acc[0] += poly6_w(r_sq, c.d6_hsq, c.d6_norm);
  }
};

struct WcsphStatTerm {  // boundary pass: Poly6 W, Monaghan-Kajtar c (dx, dy)
  static constexpr int NQV = 0, NSV = 0, NACC = 3;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float wb = spiky_w(r, c);
    const float cf = (-c.bff * wb) / r_sq;
    acc[0] += poly6_w(r_sq, c.d6_hsq, c.d6_norm);
    acc[1] += cf * dx;
    acc[2] += cf * dy;
  }
};

struct WcsphForcesTerm {  // symmetric pressure + XSPH; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float coef = (-c.mass * (qv[0] + sv[0])) / ((2.0f * qv[1]) * sv[1]);
    const float gc = coef * spiky_gc(r, c);
    const float vc = xsph_c(r_sq, sv[1], scalar, c);
    acc[0] += gc * dx + vc * (sv[2] - qv[2]);
    acc[1] += gc * dy + vc * (sv[3] - qv[3]);
  }
};

// The XLA closures' order (models/dfsph_dense.py terms/div/corr,
// models/wcsph_dense.py dyn_forces): the gradient is the vector gc (dx, dy).

struct CtxXlaTerm {  // W, (grad W) m (x, y), |(grad W) m|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float w = wendland_w(r, c);
    const float gc = wendland_gc(r, c);
    const float gx = (gc * dx) * c.mass;
    const float gy = (gc * dy) * c.mass;
    acc[0] += w;
    acc[1] += gx;
    acc[2] += gy;
    acc[3] += gx * gx + gy * gy;
    acc[4] += 1.0f;
  }
};

struct DivXlaTerm {  // sum((v_i - v_j) * grad W)
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float gc = wendland_gc(r, c);
    acc[0] += (qv[0] - sv[0]) * (gc * dx) + (qv[1] - sv[1]) * (gc * dy);
  }
};

struct CorrXlaTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float kk = qv[0] + sv[0];
    const float gc = wendland_gc(r, c);
    acc[0] += kk * (gc * dx);
    acc[1] += kk * (gc * dy);
  }
};

struct WcsphForcesXlaTerm {  // coef grad W_spiky + XSPH; qv, sv = p rho vx vy; dt
  static constexpr int NQV = 4, NSV = 4, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const float* sv, const PairConsts& c,
                              float scalar) {
    const float coef = (-c.mass * (qv[0] + sv[0])) / ((2.0f * qv[1]) * sv[1]);
    const float gc = spiky_gc(r, c);
    const float vc = xsph_c(r_sq, sv[1], scalar, c);
    acc[0] += coef * (gc * dx) + vc * (sv[2] - qv[2]);
    acc[1] += coef * (gc * dy) + vc * (sv[3] - qv[3]);
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
