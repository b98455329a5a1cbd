// K3: masked pair reduction over each query slot's 3x3 cell neighbourhood, in
// the padded slot-major layout of the solver carry.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py sm_pair_reduce
// (body _sm_kernel). For every live query slot (y, x, p) it sums
// term(dx, dy, r_sq, r, ...) over the source slots of the 3x3 cells around
// (y, x), in the TPU kernel's accumulation order (dyv, dxv, sp). A pair counts
// when the query and the source are live and 1e-10 < r_sq <= h^2; a dead
// query writes zeros. No epilogue. The term functors are K1's
// (csrc/pair_terms.cuh).
//
// Layout: the carry is read in place, with no transpose into planes: positions
// (ny, nx, P, 2) f32 read as float2, masks (ny, nx, P) bool, and each value as
// a pointer and an element stride, so that a scalar (ny, nx, P) has stride 1
// and the two components of an interleaved vector (ny, nx, P, 2) are
// (base, 2) and (base + 1, 2). The source space may have Ps != P slots (the
// boundary). The output is (ny, nx, P, n_out), vector-last like the carry.
// The TPU kernel's band blocking, source windows and skip flags exist for
// Mosaic and are not needed here.
//
// One thread per query slot, p fastest: the threads of a cell read the same Ps
// contiguous source slots of each neighbour cell, which L1 serves once.
//
// Masking skips invalid candidates (a branch), never multiplies them by 0:
// the XSPH term divides by rho_j * dt, which a dead slot may hold as 0.
//
// What bounds it on the H100: memory latency, as K1: per live query 9 x Ps
// mask bytes and the positions and values of the live candidates, little
// arithmetic per byte. No shared-memory tiling, TMA or wgmma yet. At the 100k
// WCSPH state (NVIDIA H100 80GB HBM3, 700 W) the forces form takes 71-73 us
// against K1's 41-55 us for the same terms: a warp here spans the live and
// dead slots of ~4.6 cells, and the 64-bit index arithmetic holds 71
// registers against K1's 38.
//
// Build: yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): every f32 operation is rounded as in the plain PyTorch twin
// (yasph2d_tpu_torch/ops/sm_pair_reduce.py sm_pair_reduce_ref).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_terms.cuh"

#define MAX_VALS 8

struct Vals {
  const float* p[MAX_VALS];  // element i of value k at p[k][i * stride[k]]
  int stride[MAX_VALS];
};

struct SmArgs {
  const float2* q_pos;   // (ny, nx, P)
  const bool* q_mask;    // (ny, nx, P)
  const float2* s_pos;   // (ny, nx, Ps)
  const bool* s_mask;    // (ny, nx, Ps)
  Vals qv;               // query values over (ny, nx, P)
  Vals sv;               // source values over (ny, nx, Ps)
  float* out;            // (ny, nx, P, n_out)
  int P, Ps, ny, nx;
  float scalar;          // dt, as f32
  PairConsts c;
};

template <class Term>
__global__ void __launch_bounds__(256) sm_pair_reduce_kernel(const SmArgs a) {
  const long n = (long)a.ny * a.nx * a.P;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;

  float acc[Term::NACC];
  for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
  if (a.q_mask[idx]) {
    const int cell = (int)(idx / a.P);
    const int y = cell / a.nx;
    const int x = cell - y * a.nx;
    const float2 q = a.q_pos[idx];
    float qv[Term::NQV > 0 ? Term::NQV : 1];
    for (int k = 0; k < Term::NQV; ++k) qv[k] = a.qv.p[k][idx * a.qv.stride[k]];

    for (int dyv = 0; dyv < 3; ++dyv) {
      const int sy = y + dyv - 1;
      if (sy < 0 || sy >= a.ny) continue;
      for (int dxv = 0; dxv < 3; ++dxv) {
        const int sx = x + dxv - 1;
        if (sx < 0 || sx >= a.nx) continue;
        const long base = ((long)sy * a.nx + sx) * a.Ps;
        for (int sp = 0; sp < a.Ps; ++sp) {
          const long sidx = base + sp;
          if (!a.s_mask[sidx]) continue;
          const float2 s = a.s_pos[sidx];
          const float dx = s.x - q.x;
          const float dy = s.y - q.y;
          const float r_sq = dx * dx + dy * dy;
          if (!(r_sq <= a.c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
          float sv[Term::NSV > 0 ? Term::NSV : 1];
          for (int k = 0; k < Term::NSV; ++k) sv[k] = a.sv.p[k][sidx * a.sv.stride[k]];
          Term::term(acc, dx, dy, r_sq, sqrtf(r_sq), qv, sv, a.c, a.scalar);
        }
      }
    }
  }
  for (int k = 0; k < Term::NACC; ++k) a.out[idx * Term::NACC + k] = acc[k];
}

template <class Term>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* vals, const int* strides,
                  int n_vals, void* out, int P, int Ps, int ny, int nx, float scalar,
                  const PairConsts* consts, void* stream) {
  if (n_vals != Term::NQV + Term::NSV) return (int)cudaErrorInvalidValue;
  SmArgs a;
  a.q_pos = static_cast<const float2*>(q_pos);
  a.q_mask = static_cast<const bool*>(q_mask);
  a.s_pos = static_cast<const float2*>(s_pos);
  a.s_mask = static_cast<const bool*>(s_mask);
  for (int k = 0; k < MAX_VALS; ++k) {
    a.qv.p[k] = a.sv.p[k] = nullptr;
    a.qv.stride[k] = a.sv.stride[k] = 0;
  }
  int j = 0;
  for (int k = 0; k < Term::NQV; ++k, ++j) {
    a.qv.p[k] = static_cast<const float*>(vals[j]);
    a.qv.stride[k] = strides[j];
  }
  for (int k = 0; k < Term::NSV; ++k, ++j) {
    a.sv.p[k] = static_cast<const float*>(vals[j]);
    a.sv.stride[k] = strides[j];
  }
  a.out = static_cast<float*>(out);
  a.P = P;
  a.Ps = Ps;
  a.ny = ny;
  a.nx = nx;
  a.scalar = scalar;
  a.c = *consts;
  const long n = (long)ny * nx * P;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads);
    sm_pair_reduce_kernel<Term>
        <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

#define SM_PAIR_LAUNCHER(NAME, TERM)                                                 \
  extern "C" int sm_pair_reduce_##NAME(                                              \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,  \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,     \
      int Ps, int ny, int nx, float scalar, const PairConsts* consts, void* stream) { \
    return launch<TERM>(q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out,    \
                        P, Ps, ny, nx, scalar, consts, stream);                      \
  }

// the three call forms of the WCSPH padded step (models/wcsph_dense.py)
SM_PAIR_LAUNCHER(wcsph_density, WcsphDensityTerm)  // Poly6 density
SM_PAIR_LAUNCHER(wcsph_stat, WcsphStatTerm)        // boundary density + force
SM_PAIR_LAUNCHER(wcsph_forces, WcsphForcesTerm)    // pressure + XSPH
