// K1: masked pair reduction over each query slot's 3x3 cell neighbourhood.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py pf_pair_reduce
// (body _pf_kernel). For every live query slot (p, y, x) it sums
// term(dx, dy, r_sq, r, ...) over the source slots of the 3x3 cells around
// (y, x), in the TPU kernel's exact accumulation order (dyv, dxv, sp), then
// maps the accumulators through an elementwise epilogue (post). A pair counts
// when the source is live and 1e-10 < r_sq <= h^2; a dead query writes zeros.
// The term and post functors live in csrc/pair_terms.cuh, shared with K3.
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
// Operand modes (template parameter Ops). F32Ops: positions and values f32,
// read as they are. Bf16Ops, the TPU kernel's `rebase_cell` mode under
// DenseGridConfig.pair_dtype = "bfloat16": positions are bf16 offsets from
// the slot's cell centre (built once per rebuild, ops/planes.plane_geom), read
// at half the bytes and upcast; dx = (x_j - x_i) + delta[dxv] with delta =
// (-h, 0, +h) rounded to f32 once, added on every view as the TPU kernel does,
// dy likewise. Value planes stay f32 in memory and are rounded to bf16 at load
// (__float2bfloat16_rn, round to nearest even, the bits of JAX's
// .astype(bfloat16)) and upcast: the step then needs no cast launch per pass,
// which matters where it is host-bound. Epilogue planes stay exact f32. All
// math and accumulation are f32 in both modes.
//
// Build: see yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): every f32 operation is rounded as in the plain PyTorch twin
// (yasph2d_tpu_torch/ops/pair_reduce.py pair_reduce_ref) and the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_terms.cuh"

#define MAX_PLANES 8

struct Planes {
  const float* p[MAX_PLANES];
};

struct F32Ops {
  using Pos = float;
  static constexpr bool REBASED = false;
  __device__ static float pos(const float* p, int i) { return p[i]; }
  __device__ static float val(const float* p, int i) { return p[i]; }
};

struct Bf16Ops {
  using Pos = __nv_bfloat16;
  static constexpr bool REBASED = true;
  __device__ static float pos(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }
  __device__ static float val(const float* p, int i) {
    return __bfloat162float(__float2bfloat16_rn(p[i]));
  }
};

template <class Ops>
struct Args {
  const typename Ops::Pos* q_pos;  // (2, P, ny, nx)
  const bool* q_mask;              // (P, ny, nx)
  const typename Ops::Pos* s_pos;  // (2, Ps, ny, nx)
  const bool* s_mask;              // (Ps, ny, nx)
  Planes qv;                       // query-side value planes, (P, ny, nx) each
  Planes sv;                       // source-side value planes, (Ps, ny, nx) each
  Planes post;                     // epilogue planes, (P, ny, nx) each, exact f32
  float* out;                      // (n_out, P, ny, nx)
  int P, Ps, ny, nx;
  float scalar;                    // dt or the correction scale, as f32
  float cell;                      // Bf16Ops: the cell size h as f32
  PairConsts c;
};

// ---------------------------------------------------------------- kernel

template <class Ops, class Term, class Post>
__global__ void __launch_bounds__(256) pair_reduce_kernel(const Args<Ops> a) {
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
    const float qx = Ops::pos(a.q_pos, idx);
    const float qy = Ops::pos(a.q_pos, a.P * plane + idx);
    float qv[Term::NQV > 0 ? Term::NQV : 1];
    for (int k = 0; k < Term::NQV; ++k) qv[k] = Ops::val(a.qv.p[k], idx);
    float acc[Term::NACC];
    for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
    const int s_comp = a.Ps * plane;  // offset of the source y plane
    const float delta[3] = {-a.cell, 0.0f, a.cell};

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
          float dx = Ops::pos(a.s_pos, sidx) - qx;
          float dy = Ops::pos(a.s_pos, s_comp + sidx) - qy;
          if (Ops::REBASED) {
            dx = dx + delta[dxv];
            dy = dy + delta[dyv];
          }
          const float r_sq = dx * dx + dy * dy;
          if (!(r_sq <= a.c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
          float sv[Term::NSV > 0 ? Term::NSV : 1];
          for (int k = 0; k < Term::NSV; ++k) sv[k] = Ops::val(a.sv.p[k], sidx);
          Term::term(acc, dx, dy, r_sq, sqrtf(r_sq), qv, sv, a.c, a.scalar);
        }
      }
    }
    float pv[Post::NPOST > 0 ? Post::NPOST : 1];
    for (int k = 0; k < Post::NPOST; ++k) pv[k] = a.post.p[k][idx];
    Post::post(out, acc, pv, a.c, a.scalar);
  }
  const int n = a.P * plane;
  for (int k = 0; k < Post::NOUT; ++k) a.out[k * n + idx] = out[k];
}

template <class Ops, class Term, class Post>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* planes, int n_planes,
                  void* out, int P, int Ps, int ny, int nx, float scalar, float cell,
                  const PairConsts* consts, void* stream) {
  if (n_planes != Term::NQV + Term::NSV + Post::NPOST) return (int)cudaErrorInvalidValue;
  using Pos = typename Ops::Pos;
  Args<Ops> a;
  a.q_pos = static_cast<const Pos*>(q_pos);
  a.q_mask = static_cast<const bool*>(q_mask);
  a.s_pos = static_cast<const Pos*>(s_pos);
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
  a.cell = cell;
  a.c = *consts;
  const long n = (long)P * ny * nx;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads);
    pair_reduce_kernel<Ops, Term, Post>
        <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

// one launcher per (form, operand mode): pair_reduce_NAME (f32) and
// pair_reduce_NAME_bf16, which also takes the f32 cell size
#define PAIR_LAUNCHER(NAME, TERM, POST)                                             \
  extern "C" int pair_reduce_##NAME(                                                \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask, \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,    \
      int nx, float scalar, const PairConsts* consts, void* stream) {               \
    return launch<F32Ops, TERM, POST>(q_pos, q_mask, s_pos, s_mask, planes,         \
                                      n_planes, out, P, Ps, ny, nx, scalar, 0.0f,   \
                                      consts, stream);                              \
  }                                                                                 \
  extern "C" int pair_reduce_##NAME##_bf16(                                         \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask, \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,    \
      int nx, float scalar, float cell, const PairConsts* consts, void* stream) {   \
    return launch<Bf16Ops, TERM, POST>(q_pos, q_mask, s_pos, s_mask, planes,        \
                                       n_planes, out, P, Ps, ny, nx, scalar, cell,  \
                                       consts, stream);                             \
  }

// the six call forms of the DFSPH plane step (models/dfsph_plane.py)
PAIR_LAUNCHER(ctx, CtxTerm, NoPost<5>)            // fluid -> boundary ctx sums
PAIR_LAUNCHER(ctx_post, CtxTerm, CtxPost)         // fused fluid ctx pass
PAIR_LAUNCHER(visc_gravity, ViscTerm, GravityPost)
PAIR_LAUNCHER(err_ki, DivTerm, ErrKiPost)
PAIR_LAUNCHER(delta_ki, DivTerm, DeltaKiPost)
PAIR_LAUNCHER(corr_v, CorrTerm, VUpdatePost)
// the three call forms of the WCSPH plane step (models/wcsph_plane.py)
PAIR_LAUNCHER(wcsph_density, WcsphDensityTerm, NoPost<1>)  // Poly6 density
PAIR_LAUNCHER(wcsph_stat, WcsphStatTerm, NoPost<3>)        // boundary density + force
PAIR_LAUNCHER(wcsph_forces, WcsphForcesTerm, NoPost<2>)    // pressure + XSPH
