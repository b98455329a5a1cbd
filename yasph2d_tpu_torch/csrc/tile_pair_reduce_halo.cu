// K5's halo-form launchers, for spatial sharding over cell rows: the kernel of
// csrc/tile_pair_reduce.cuh in K5's sum order with HALO set, so that source
// rows -1 and ny are read from the neighbouring shards' rows (h_pos
// (2, nx, Ps) float2, h_mask (2, nx, Ps) and one (2, nx, Ps) row pair per
// source value component, row -1 at index 0) instead of being dead. Its JAX
// counterpart under sharding is the XLA dense_grid.pair_reduce with its
// halo2d_multi exchange (the Pallas kernel of yasph2d_tpu/ops/pallas_pair.py,
// which this kernel replaces on one device, only pads zeros there). Built by
// its own nvcc process beside csrc/tile_pair_reduce.cu.

#include "tile_pair_reduce.cuh"

// tile_pair_reduce_NAME_halo: the arguments of tile_pair_reduce_NAME, with
// the halo rows' positions, mask and source value pointers before the gate;
// and
// tile_pair_reduce_NAME_bf16_halo, the bf16 math mode, whose rebase
// arguments (origin, cell size, the shard's first global row) follow the
// scalar as in tile_pair_reduce_NAME_bf16
#define TILE_HALO_LAUNCHERS(NAME, TERM)                                                \
  extern "C" int tile_pair_reduce_##NAME##_halo(                                       \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,    \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,       \
      int Ps, int ny, int nx, int ty, int tx, int threads, int q_round, int smem,      \
      float scalar, const void* h_pos, const void* h_mask, const void* const* h_vals,  \
      const void* gate, int gate_i, const PairConsts* consts, void* stream) {          \
    return launch<TERM<F32Math>, true, true>(q_pos, q_mask, s_pos, s_mask, vals,       \
                                             strides, n_vals, out, P, Ps, ny, nx, ty,  \
                                             tx, threads, q_round, smem, scalar, gate, \
                                             gate_i, consts, stream, h_pos, h_mask,    \
                                             h_vals);                                  \
  }                                                                                    \
  extern "C" int tile_pair_reduce_##NAME##_bf16_halo(                                  \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,    \
      const void* const* vals, const int* strides, int n_vals, void* out, int P,       \
      int Ps, int ny, int nx, int ty, int tx, int threads, int q_round, int smem,      \
      float scalar, float ox, float oy, float cell, int row0, const void* h_pos,       \
      const void* h_mask, const void* const* h_vals, const void* gate, int gate_i,     \
      const PairConsts* consts, void* stream) {                                        \
    return launch<TERM<Bf16Math>, true, true, Bf16Math>(                               \
        q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out, P, Ps, ny, nx, ty,   \
        tx, threads, q_round, smem, scalar, gate, gate_i, consts, stream, h_pos,       \
        h_mask, h_vals, Rebase{ox, oy, cell, row0});                                   \
  }

// the forms of the padded K5 route (csrc/tile_pair_reduce.cu's K5 launchers)
K5_PAIR_FORMS(TILE_HALO_LAUNCHERS)
