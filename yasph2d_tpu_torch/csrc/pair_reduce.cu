// K1: masked pair reduction over each query slot's 3x3 cell neighbourhood.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py pf_pair_reduce
// (body _pf_kernel). For every live query slot (p, y, x) it sums
// term(dx, dy, r_sq, r, ...) over the source slots of the 3x3 cells around
// (y, x), in the TPU kernel's exact accumulation order (dyv, dxv, sp), then
// maps the accumulators through an elementwise epilogue (post). A pair counts
// when the source is live and 1e-10 < r_sq <= h^2; a dead query writes zeros.
//
// Layout: planes (L, P, ny, nx) f32 and masks (P, ny, nx) bool, unpadded. One
// thread per query slot, x fastest, so a warp reads 32 neighbouring cells of
// one slot plane and its loads coalesce.
//
// Masking skips invalid candidates (a branch), never multiplies them by 0:
// XSPH divides by rho_j * dt and a dead source slot may hold rho_j = 0 there,
// and NaN * 0 is NaN (the same reason the TPU kernel selects with jnp.where).
//
// Source liveness comes from the source mask plane, not from a sentinel
// position: the resident position planes keep whatever a dead slot last held,
// so a sentinel would need a masked copy of both position planes per rebuild,
// while the mask costs one byte per candidate and lets a dead candidate skip
// its position loads.
//
// What bounds it on the H100: memory latency. Per live query it touches 9
// cells x Ps source slots of mask bytes and the positions/values of the live
// ones, a gather-and-FMA loop with little arithmetic per byte and no reuse
// across threads beyond what L1/L2 catch. No shared-memory tiling, TMA or
// wgmma yet: this is the simple, right first version.
//
// Build: see yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): every f32 operation below is rounded as in the plain PyTorch twin
// (yasph2d_tpu_torch/ops/pair_reduce.py pair_reduce_ref) and the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PLANES 8

struct PairConsts {
  float radius_sq;    // h^2 rounded to f32
  float w_h_inv;      // Wendland quintic C2: 1/h, 28/(pi h^2), 140/(pi h^4)
  float w_norm;
  float w_norm_grad;
  float p6_hsq;       // Poly6 (XSPH): h^2, 4/(pi h^8)
  float p6_norm;
  float xsph_coef;    // f32(epsilon * m)
  float mass;         // particle mass m
  float w0;           // W(0), the density self-contribution
  float rho0;         // rest density
  float alpha_eps;    // DFSPH alpha denominator floor
  float gx, gy;       // gravity
};

struct Planes {
  const float* p[MAX_PLANES];
};

struct Args {
  const float* q_pos;    // (2, P, ny, nx)
  const bool* q_mask;    // (P, ny, nx)
  const float* s_pos;    // (2, Ps, ny, nx)
  const bool* s_mask;    // (Ps, ny, nx)
  Planes qv;             // query-side value planes, (P, ny, nx) each
  Planes sv;             // source-side value planes, (Ps, ny, nx) each
  Planes post;           // epilogue planes, (P, ny, nx) each
  float* out;            // (n_out, P, ny, nx)
  int P, Ps, ny, nx;
  float scalar;          // dt or the correction scale, as f32
  PairConsts c;
};

static constexpr float MIN_DISTANCE_SQ = 1.0e-10f;

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
// Poly6.evaluate
__device__ __forceinline__ float poly6_w(float r_sq, const PairConsts& c) {
  const float dsq = jmax(c.p6_hsq - r_sq, 0.0f);
  return ((c.p6_norm * dsq) * dsq) * dsq;
}

// ---------------------------------------------------------------- terms
// term(acc, dx, dy, r_sq, r, qv, a, sidx): add one valid pair to acc

struct CtxTerm {  // W, m grad W (x, y), |m grad W|^2, count
  static constexpr int NQV = 0, NSV = 0, NACC = 5;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const Args& a, int sidx) {
    const float w = wendland_w(r, a.c);
    const float mgc = wendland_gc(r, a.c) * a.c.mass;
    const float gx = mgc * dx;
    const float gy = mgc * dy;
    acc[0] += w;
    acc[1] += gx;
    acc[2] += gy;
    acc[3] += gx * gx + gy * gy;
    acc[4] += 1.0f;
  }
};

struct ViscTerm {  // XSPH: c (v_j - v_i), c = eps m W_poly6 / (rho_j dt)
  static constexpr int NQV = 2, NSV = 3, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const Args& a, int sidx) {
    const float svx = a.sv.p[0][sidx];
    const float svy = a.sv.p[1][sidx];
    const float rho = a.sv.p[2][sidx];
    const float c = (a.c.xsph_coef * poly6_w(r_sq, a.c)) / (rho * a.scalar);
    acc[0] += c * (svx - qv[0]);
    acc[1] += c * (svy - qv[1]);
  }
};

struct DivTerm {  // (v_i - v_j) . grad W
  static constexpr int NQV = 2, NSV = 2, NACC = 1;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const Args& a, int sidx) {
    const float gc = wendland_gc(r, a.c);
    acc[0] += ((qv[0] - a.sv.p[0][sidx]) * dx + (qv[1] - a.sv.p[1][sidx]) * dy) * gc;
  }
};

struct CorrTerm {  // (k_i + k_j) grad W
  static constexpr int NQV = 1, NSV = 1, NACC = 2;
  __device__ static void term(float* acc, float dx, float dy, float r_sq, float r,
                              const float* qv, const Args& a, int sidx) {
    const float kk = (qv[0] + a.sv.p[0][sidx]) * wendland_gc(r, a.c);
    acc[0] += kk * dx;
    acc[1] += kk * dy;
  }
};

// ---------------------------------------------------------------- posts
// post(out, acc, a, idx): epilogue of one live query slot

template <int N>
struct NoPost {
  static constexpr int NPOST = 0, NOUT = N;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    for (int k = 0; k < N; ++k) out[k] = acc[k];
  }
};

struct CtxPost {  // density, alpha, neighbour total from dyn + stat sums
  static constexpr int NPOST = 5, NOUT = 3;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    const float s0 = a.post.p[0][idx], s1 = a.post.p[1][idx], s2 = a.post.p[2][idx];
    const float s3 = a.post.p[3][idx], s4 = a.post.p[4][idx];
    const float dens = jmax(a.c.mass * ((a.c.w0 + acc[0]) + s0), a.c.rho0);
    const float vx = acc[1] + s1;
    const float vy = acc[2] + s2;
    const float denom = (((vx * vx) + (vy * vy)) + acc[3]) + s3;
    out[0] = dens;
    out[1] = 1.0f / jmax(denom, a.c.alpha_eps);
    out[2] = acc[4] + s4;
  }
};

struct GravityPost {
  static constexpr int NPOST = 0, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    out[0] = acc[0] + a.c.gx;
    out[1] = acc[1] + a.c.gy;
  }
};

struct ErrKiPost {  // density error and k_i; post planes vx vy sgx sgy dens alpha
  static constexpr int NPOST = 6, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    const float vx = a.post.p[0][idx], vy = a.post.p[1][idx];
    const float sgx = a.post.p[2][idx], sgy = a.post.p[3][idx];
    const float dens = a.post.p[4][idx], alpha = a.post.p[5][idx];
    const float delta = acc[0] + (vx * sgx + vy * sgy);
    const float err = jmax(dens + (delta * a.c.mass) * a.scalar, a.c.rho0) - a.c.rho0;
    out[0] = err;
    out[1] = err * alpha;
  }
};

struct DeltaKiPost {  // divergence and k_i; post planes vx vy sgx sgy nt alpha
  static constexpr int NPOST = 6, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    const float vx = a.post.p[0][idx], vy = a.post.p[1][idx];
    const float sgx = a.post.p[2][idx], sgy = a.post.p[3][idx];
    const float nt = a.post.p[4][idx], alpha = a.post.p[5][idx];
    float delta = (acc[0] + (vx * sgx + vy * sgy)) * a.c.mass;
    delta = jmax(delta, 0.0f);
    // particle-deficiency guard (<9 total neighbours, dfsph.rs:260-264)
    if (nt < 9.0f) delta = 0.0f;
    out[0] = delta;
    out[1] = delta * alpha;
  }
};

struct VUpdatePost {  // v - scale (corr + k sum_grad_stat); post vx vy k sgx sgy
  static constexpr int NPOST = 5, NOUT = 2;
  __device__ static void post(float* out, const float* acc, const Args& a, int idx) {
    const float vx = a.post.p[0][idx], vy = a.post.p[1][idx];
    const float kp = a.post.p[2][idx];
    const float sgx = a.post.p[3][idx], sgy = a.post.p[4][idx];
    const float s = a.scalar;
    out[0] = vx - s * (acc[0] + kp * sgx);
    out[1] = vy - s * (acc[1] + kp * sgy);
  }
};

// ---------------------------------------------------------------- kernel

template <class Term, class Post>
__global__ void __launch_bounds__(256) pair_reduce_kernel(const Args a) {
  const int plane = a.ny * a.nx;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.P * plane) return;

  float out[Post::NOUT];
  if (!a.q_mask[idx]) {
    for (int k = 0; k < Post::NOUT; ++k) out[k] = 0.0f;
  } else {
    const int cell = idx % plane;
    const int y = cell / a.nx;
    const int x = cell - y * a.nx;
    const float qx = a.q_pos[idx];
    const float qy = a.q_pos[a.P * plane + idx];
    float qv[Term::NQV > 0 ? Term::NQV : 1];
    for (int k = 0; k < Term::NQV; ++k) qv[k] = a.qv.p[k][idx];
    float acc[Term::NACC];
    for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
    const int s_comp = a.Ps * plane;  // offset of the source y plane

    for (int dyv = 0; dyv < 3; ++dyv) {
      const int sy = y + dyv - 1;
      if (sy < 0 || sy >= a.ny) continue;
      for (int dxv = 0; dxv < 3; ++dxv) {
        const int sx = x + dxv - 1;
        if (sx < 0 || sx >= a.nx) continue;
        const int scell = sy * a.nx + sx;
        for (int sp = 0; sp < a.Ps; ++sp) {
          const int sidx = sp * plane + scell;
          if (!a.s_mask[sidx]) continue;
          const float dx = a.s_pos[sidx] - qx;
          const float dy = a.s_pos[s_comp + sidx] - qy;
          const float r_sq = dx * dx + dy * dy;
          if (!(r_sq <= a.c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
          Term::term(acc, dx, dy, r_sq, sqrtf(r_sq), qv, a, sidx);
        }
      }
    }
    Post::post(out, acc, a, idx);
  }
  const int n = a.P * plane;
  for (int k = 0; k < Post::NOUT; ++k) a.out[k * n + idx] = out[k];
}

template <class Term, class Post>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* planes, int n_planes,
                  void* out, int P, int Ps, int ny, int nx, float scalar,
                  const PairConsts* consts, void* stream) {
  if (n_planes != Term::NQV + Term::NSV + Post::NPOST) return (int)cudaErrorInvalidValue;
  Args a;
  a.q_pos = static_cast<const float*>(q_pos);
  a.q_mask = static_cast<const bool*>(q_mask);
  a.s_pos = static_cast<const float*>(s_pos);
  a.s_mask = static_cast<const bool*>(s_mask);
  int j = 0;
  for (int k = 0; k < MAX_PLANES; ++k) a.qv.p[k] = a.sv.p[k] = a.post.p[k] = nullptr;
  for (int k = 0; k < Term::NQV; ++k) a.qv.p[k] = static_cast<const float*>(planes[j++]);
  for (int k = 0; k < Term::NSV; ++k) a.sv.p[k] = static_cast<const float*>(planes[j++]);
  for (int k = 0; k < Post::NPOST; ++k) a.post.p[k] = static_cast<const float*>(planes[j++]);
  a.out = static_cast<float*>(out);
  a.P = P;
  a.Ps = Ps;
  a.ny = ny;
  a.nx = nx;
  a.scalar = scalar;
  a.c = *consts;
  const long n = (long)P * ny * nx;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads);
    pair_reduce_kernel<Term, Post>
        <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

#define PAIR_LAUNCHER(NAME, TERM, POST)                                             \
  extern "C" int pair_reduce_##NAME(                                                \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask, \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,    \
      int nx, float scalar, const PairConsts* consts, void* stream) {               \
    return launch<TERM, POST>(q_pos, q_mask, s_pos, s_mask, planes, n_planes, out,  \
                              P, Ps, ny, nx, scalar, consts, stream);               \
  }

// the six call forms of the DFSPH plane step (models/dfsph_plane.py)
PAIR_LAUNCHER(ctx, CtxTerm, NoPost<5>)            // fluid -> boundary ctx sums
PAIR_LAUNCHER(ctx_post, CtxTerm, CtxPost)         // fused fluid ctx pass
PAIR_LAUNCHER(visc_gravity, ViscTerm, GravityPost)
PAIR_LAUNCHER(err_ki, DivTerm, ErrKiPost)
PAIR_LAUNCHER(delta_ki, DivTerm, DeltaKiPost)
PAIR_LAUNCHER(corr_v, CorrTerm, VUpdatePost)
