// K5: masked pair reduction over each query slot's 3x3 cell neighbourhood, in
// the padded slot-major layout, on cell tiles staged in shared memory.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_pair.py pallas_pair_reduce
// (body _kernel), the first-generation pair kernel behind the JAX package's
// DenseGridConfig.use_pallas and the drop-in for its XLA dense_grid.pair_reduce.
// For every live query slot (y, x, p) it sums term(dx, dy, r_sq, r, ...) over
// the source slots of the 3x3 cells around (y, x): each view's Ps candidates in
// sp order into a view sum, then the view sums in (dyv, dxv) order, which is
// the TPU kernel's grouping (a per-view jnp.sum over the candidate axis, then
// accs + contribs). A pair counts when the query and the source are live and
// 1e-10 < r_sq <= h^2; a dead query writes zeros. No epilogue. The term
// functors are in csrc/pair_terms.cuh; the forms of the DFSPH and WCSPH
// padded steps follow the JAX package's XLA closures.
//
// Layout: positions (ny, nx, P, 2) f32 read as float2, masks (ny, nx, P) bool,
// values as a pointer and an element stride per component (as K3), output
// (ny, nx, P, n_out). The source space may have Ps != P slots (the boundary).
//
// Design: one thread block per BR x BC cell tile. The block first stages its
// haloed (BR+2) x (BC+2) x Ps source tile in shared memory, positions as
// float2, each source value component as a plane and the mask bytes last;
// cells outside the grid stage as dead, so the ragged edge tiles need no
// padded copy of the inputs (the TPU kernel pads and materialises overlapping
// source blocks because its blocks cannot overlap). Then each thread takes
// query slots of the tile (p fastest) and loops over the 9 views x Ps from
// shared memory. A tile without a live query skips the staging and writes
// zeros: most of the dam-break grid is air. Shared memory grows with Ps and
// the number of source values, so the wrapper (ops/pallas_pair.py) picks the
// tile for the launch to fit and refuses one that cannot fit even one cell
// column. It also sizes the block to one thread per query slot (BR x BC x P,
// up to 512): at 100k only the tiles that hold fluid do work, and the first
// design, 256 threads looping over 8 x 32 x 7 tiles, left most of the card
// idle; 8 x 8 x 7 tiles of 448 threads fill it (tools/tile_sweep.py).
//
// Masking skips invalid candidates (a branch), never multiplies them by 0:
// dead sources may hold rho = 0, and the XSPH term divides by it.
//
// What bounds it on the H100: device-memory bytes. Each input is read from
// device memory once per tile plus a one-cell halo ((BR+2)(BC+2)/(BR BC) =
// 1.56x the source bytes at 8 x 8), each output written once; per live pair
// it does some 10-30 f32 operations, far below the FP32 rate. In practice
// latency limits it, as K3: the staging pass, a barrier, then 9 x Ps serial
// shared-memory candidates per thread, with the dead query slots of a warp
// idle; no TMA or warp specialisation yet.
//
// Build: yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): each term is rounded as in the plain PyTorch twin
// (yasph2d_tpu_torch/ops/pallas_pair.py pallas_pair_reduce_ref), whose Ps sum
// is torch.sum, so kernel and twin agree to f32 summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_terms.cuh"

#define TILE_MAX_VALS 8
#define TILE_MAX_THREADS 1024

struct TileVals {
  const float* p[TILE_MAX_VALS];  // element i of value k at p[k][i * stride[k]]
  int stride[TILE_MAX_VALS];
};

struct TileArgs {
  const float2* q_pos;  // (ny, nx, P)
  const bool* q_mask;   // (ny, nx, P)
  const float2* s_pos;  // (ny, nx, Ps)
  const bool* s_mask;   // (ny, nx, Ps)
  TileVals qv;          // query values over (ny, nx, P)
  TileVals sv;          // source values over (ny, nx, Ps)
  float* out;           // (ny, nx, P, n_out)
  int P, Ps, ny, nx;
  int br, bc;           // cell tile
  float scalar;         // dt, as f32
  PairConsts c;
};

template <int NSV>
__host__ __device__ inline size_t tile_smem_bytes(int br, int bc, int Ps) {
  return (size_t)(br + 2) * (bc + 2) * Ps * (sizeof(float2) + NSV * sizeof(float) + 1);
}

template <class Term>
__global__ void __launch_bounds__(TILE_MAX_THREADS) tile_pair_reduce_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hc = a.bc + 2;
  const int n_src = (a.br + 2) * hc * a.Ps;
  float2* t_pos = reinterpret_cast<float2*>(smem);
  float* t_val = reinterpret_cast<float*>(t_pos + n_src);  // NSV planes of n_src
  unsigned char* t_mask = reinterpret_cast<unsigned char*>(t_val + Term::NSV * n_src);

  const int y0 = blockIdx.y * a.br;
  const int x0 = blockIdx.x * a.bc;
  const int n_q = a.br * a.bc * a.P;

  // does the tile hold a live query slot?
  int live = 0;
  for (int t = threadIdx.x; t < n_q && !live; t += blockDim.x) {
    const int cell = t / a.P;
    const int qy = y0 + cell / a.bc;
    const int qx = x0 + cell % a.bc;
    if (qy < a.ny && qx < a.nx) live = a.q_mask[((long)qy * a.nx + qx) * a.P + t % a.P];
  }
  const bool any_live = __syncthreads_or(live);

  if (any_live) {
    // stage the haloed source tile; cells outside the grid are dead
    for (int t = threadIdx.x; t < n_src; t += blockDim.x) {
      const int cell = t / a.Ps;
      const int ly = cell / hc;
      const int gy = y0 + ly - 1;
      const int gx = x0 + (cell - ly * hc) - 1;
      unsigned char m = 0;
      if (gy >= 0 && gy < a.ny && gx >= 0 && gx < a.nx) {
        const long sidx = ((long)gy * a.nx + gx) * a.Ps + t % a.Ps;
        m = a.s_mask[sidx];
        if (m) {
          t_pos[t] = a.s_pos[sidx];
          for (int k = 0; k < Term::NSV; ++k)
            t_val[k * n_src + t] = a.sv.p[k][sidx * a.sv.stride[k]];
        }
      }
      t_mask[t] = m;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < n_q; t += blockDim.x) {
    const int cell = t / a.P;
    const int ly = cell / a.bc;
    const int lx = cell - ly * a.bc;
    const int qy = y0 + ly;
    const int qx = x0 + lx;
    if (qy >= a.ny || qx >= a.nx) continue;
    const long idx = ((long)qy * a.nx + qx) * a.P + t % a.P;

    float acc[Term::NACC];
    for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
    if (any_live && a.q_mask[idx]) {
      const float2 q = a.q_pos[idx];
      float qv[Term::NQV > 0 ? Term::NQV : 1];
      for (int k = 0; k < Term::NQV; ++k) qv[k] = a.qv.p[k][idx * a.qv.stride[k]];

      for (int dyv = 0; dyv < 3; ++dyv) {
        for (int dxv = 0; dxv < 3; ++dxv) {
          float view[Term::NACC];
          for (int k = 0; k < Term::NACC; ++k) view[k] = 0.0f;
          const int base = ((ly + dyv) * hc + (lx + dxv)) * a.Ps;
          for (int sp = 0; sp < a.Ps; ++sp) {
            const int s = base + sp;
            if (!t_mask[s]) continue;
            const float2 src = t_pos[s];
            const float dx = src.x - q.x;
            const float dy = src.y - q.y;
            const float r_sq = dx * dx + dy * dy;
            if (!(r_sq <= a.c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
            float sv[Term::NSV > 0 ? Term::NSV : 1];
            for (int k = 0; k < Term::NSV; ++k) sv[k] = t_val[k * n_src + s];
            Term::term(view, dx, dy, r_sq, sqrtf(r_sq), qv, sv, a.c, a.scalar);
          }
          for (int k = 0; k < Term::NACC; ++k) acc[k] += view[k];
        }
      }
    }
    for (int k = 0; k < Term::NACC; ++k) a.out[idx * Term::NACC + k] = acc[k];
  }
}

template <class Term>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* vals, const int* strides,
                  int n_vals, void* out, int P, int Ps, int ny, int nx, int br, int bc,
                  int threads, float scalar, const PairConsts* consts, void* stream) {
  if (n_vals != Term::NQV + Term::NSV || br < 1 || bc < 1 || threads < 32 ||
      threads > TILE_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  TileArgs a;
  a.q_pos = static_cast<const float2*>(q_pos);
  a.q_mask = static_cast<const bool*>(q_mask);
  a.s_pos = static_cast<const float2*>(s_pos);
  a.s_mask = static_cast<const bool*>(s_mask);
  for (int k = 0; k < TILE_MAX_VALS; ++k) {
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
  a.br = br;
  a.bc = bc;
  a.scalar = scalar;
  a.c = *consts;
  if ((long)ny * nx * P == 0) return (int)cudaSuccess;
  const size_t smem = tile_smem_bytes<Term::NSV>(br, bc, Ps);
  cudaError_t err = cudaFuncSetAttribute(tile_pair_reduce_kernel<Term>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + bc - 1) / bc, (ny + br - 1) / br);
  tile_pair_reduce_kernel<Term>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#define TILE_PAIR_LAUNCHER(NAME, TERM)                                                \
  extern "C" int tile_pair_reduce_##NAME(                                             \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,   \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,      \
      int Ps, int ny, int nx, int br, int bc, int threads, float scalar,              \
      const PairConsts* consts, void* stream) {                                       \
    return launch<TERM>(q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out, P,  \
                        Ps, ny, nx, br, bc, threads, scalar, consts, stream);         \
  }

// the DFSPH padded step's four forms (models/dfsph_dense.py, XLA closures)
TILE_PAIR_LAUNCHER(dfsph_ctx, CtxXlaTerm)    // ctx sums, fluid and boundary
TILE_PAIR_LAUNCHER(dfsph_div, DivXlaTerm)    // velocity divergence
TILE_PAIR_LAUNCHER(dfsph_corr, CorrXlaTerm)  // k-correction
TILE_PAIR_LAUNCHER(dfsph_visc, ViscTerm)     // XSPH viscosity
// the WCSPH padded step's three forms (models/wcsph_dense.py, XLA closures)
TILE_PAIR_LAUNCHER(wcsph_density, WcsphDensityTerm)    // Poly6 density
TILE_PAIR_LAUNCHER(wcsph_stat, WcsphStatTerm)          // boundary density + force
TILE_PAIR_LAUNCHER(wcsph_forces, WcsphForcesXlaTerm)   // pressure + XSPH
