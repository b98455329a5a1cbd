// K5's and K3's launchers on one device: the C interface that
// ops/pallas_pair.py and ops/sm_pair_reduce.py load with ctypes. The kernel,
// its design and what bounds it: csrc/tile_pair_reduce.cuh.

#include "tile_pair_reduce.cuh"

// one launcher per form: PREFIX_NAME, K5 (tile_pair_reduce_) or K3
// (sm_pair_reduce_), each with the same arguments; gate and gate_i are a
// pressure loop's state and the launch's iteration (csrc/tile_pair_reduce.cuh
// TileArgs), null and 0 for an ungated launch
#define TILE_PAIR_LAUNCHER(PREFIX, NAME, TERM, PER_VIEW)                              \
  extern "C" int PREFIX##_##NAME(                                                     \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,   \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,      \
      int Ps, int ny, int nx, int ty, int tx, int threads, int q_round, int smem,     \
      float scalar, const void* gate, int gate_i, const PairConsts* consts,           \
      void* stream) {                                                                 \
    return launch<TERM, PER_VIEW>(q_pos, q_mask, s_pos, s_mask, vals, strides,        \
                                  n_vals, out, P, Ps, ny, nx, ty, tx, threads,        \
                                  q_round, smem, scalar, gate, gate_i, consts, stream); \
  }

// K5 (csrc/tile_pair_reduce.cuh K5_PAIR_FORMS, the JAX XLA closures):
// tile_pair_reduce_NAME in f32, and tile_pair_reduce_NAME_bf16, the bf16 math
// mode, which also takes the grid's origin, cell size and first global row
#define K5_LAUNCHERS(NAME, TERM)                                                      \
  TILE_PAIR_LAUNCHER(tile_pair_reduce, NAME, TERM<F32Math>, true)                     \
  extern "C" int tile_pair_reduce_##NAME##_bf16(                                      \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,   \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,      \
      int Ps, int ny, int nx, int ty, int tx, int threads, int q_round, int smem,     \
      float scalar, float ox, float oy, float cell, int row0, const void* gate,       \
      int gate_i, const PairConsts* consts, void* stream) {                           \
    return launch<TERM<Bf16Math>, true, false, Bf16Math>(                             \
        q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out, P, Ps, ny, nx, ty,  \
        tx, threads, q_round, smem, scalar, gate, gate_i, consts, stream, nullptr,    \
        nullptr, nullptr, Rebase{ox, oy, cell, row0});                                \
  }

K5_PAIR_FORMS(K5_LAUNCHERS)

// K3: the WCSPH padded step's three forms (models/wcsph_dense.py)
TILE_PAIR_LAUNCHER(sm_pair_reduce, wcsph_density, WcsphDensityTerm, false)  // Poly6 density
TILE_PAIR_LAUNCHER(sm_pair_reduce, wcsph_stat, WcsphStatTerm, false)        // boundary
TILE_PAIR_LAUNCHER(sm_pair_reduce, wcsph_forces, WcsphForcesTerm<XsphCoef>, false)  // + XSPH
// K3: the DFSPH padded step's five forms (models/dfsph_dense.py); the
// boundary ctx pass is an XLA pair_reduce in the JAX package, so it takes the
// XLA closure's operation order
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_ctx, CtxTerm, false)        // W, m grad W, |.|^2, count
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_stat, CtxXlaTerm<>, false)  // the same, to the boundary
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_div, DivTerm, false)        // velocity divergence
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_corr, CorrTerm, false)      // k-correction
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_visc, ViscTerm<XsphCoef>, false)  // XSPH viscosity
// K3: the physical viscosity forms of both padded steps (PhysicalViscosityModel)
TILE_PAIR_LAUNCHER(sm_pair_reduce, dfsph_visc_phys, ViscTerm<PhysCoef>, false)
TILE_PAIR_LAUNCHER(sm_pair_reduce, wcsph_forces_phys, WcsphForcesTerm<PhysCoef>, false)
