// K1's halo-form launchers, for spatial sharding over cell rows: the kernel of
// csrc/pair_reduce.cuh with HALO set, so that source rows -1 and ny are read
// from the neighbouring shards' rows (h_pos (2, Ps, 2, nx), h_mask
// (Ps, 2, nx) and one (Ps, 2, nx) row pair per source value plane, row -1 at
// index 0) instead of being dead. Replaces the TPU kernel
// yasph2d_tpu/ops/pallas_slotmajor.py pf_pair_reduce on its halo-exchanged
// source windows (_pf_halo, _pf_block_source(halo=...)). Built by its own nvcc
// process beside csrc/pair_reduce.cu.

#include "pair_reduce.cuh"

// pair_reduce_NAME_halo (f32) and pair_reduce_NAME_bf16_halo, which also takes
// the f32 cell size
#define PAIR_HALO_LAUNCHER(NAME, TERM, POST)                                           \
  extern "C" int pair_reduce_##NAME##_halo(                                            \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,    \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,       \
      int nx, int ty, int tx, int threads, int smem, float scalar, const void* h_pos,  \
      const void* h_mask, const void* const* h_planes, const PairConsts* consts,       \
      void* stream) {                                                                  \
    return launch<F32Ops, TERM, POST, true>(q_pos, q_mask, s_pos, s_mask, planes,      \
                                            n_planes, out, P, Ps, ny, nx, ty, tx,      \
                                            threads, smem, scalar, 0.0f, consts,       \
                                            stream, h_pos, h_mask, h_planes);          \
  }                                                                                    \
  extern "C" int pair_reduce_##NAME##_bf16_halo(                                       \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,    \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,       \
      int nx, int ty, int tx, int threads, int smem, float scalar, float cell,         \
      const void* h_pos, const void* h_mask, const void* const* h_planes,              \
      const PairConsts* consts, void* stream) {                                        \
    return launch<Bf16Ops, TERM, POST, true>(q_pos, q_mask, s_pos, s_mask, planes,     \
                                             n_planes, out, P, Ps, ny, nx, ty, tx,     \
                                             threads, smem, scalar, cell, consts,      \
                                             stream, h_pos, h_mask, h_planes);         \
  }

K1_PAIR_FORMS(PAIR_HALO_LAUNCHER)
