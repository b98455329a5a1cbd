// K1's launchers on one device, and K7's: the C interface that
// ops/pair_reduce.py and tools/probe_pallas_slotmajor.py load with ctypes. The
// kernel, its design and what bounds it: csrc/pair_reduce.cuh.

#include "pair_reduce.cuh"

// one launcher per (form, operand mode): pair_reduce_NAME (f32) and
// pair_reduce_NAME_bf16, which also takes the f32 cell size
#define PAIR_LAUNCHER(NAME, TERM, POST)                                               \
  extern "C" int pair_reduce_##NAME(                                                  \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,   \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,      \
      int nx, int ty, int tx, int threads, int smem, float scalar,                    \
      const PairConsts* consts, void* stream) {                                       \
    return launch<F32Ops, TERM, POST>(q_pos, q_mask, s_pos, s_mask, planes,           \
                                      n_planes, out, P, Ps, ny, nx, ty, tx, threads,  \
                                      smem, scalar, 0.0f, consts, stream);            \
  }                                                                                   \
  extern "C" int pair_reduce_##NAME##_bf16(                                           \
      const void* q_pos, const void* q_mask, const void* s_pos, const void* s_mask,   \
      const void* const* planes, int n_planes, void* out, int P, int Ps, int ny,      \
      int nx, int ty, int tx, int threads, int smem, float scalar, float cell,        \
      const PairConsts* consts, void* stream) {                                       \
    return launch<Bf16Ops, TERM, POST>(q_pos, q_mask, s_pos, s_mask, planes,          \
                                       n_planes, out, P, Ps, ny, nx, ty, tx, threads, \
                                       smem, scalar, cell, consts, stream);           \
  }

K1_PAIR_FORMS(PAIR_LAUNCHER)

// K7, the ctx-pass probe: its planes q (3, P, ny, nx) and s (3, Ps, ny, nx) =
// x, y and the mask as 0/1, read in place; out (5, P, ny, nx); consts holds
// the probe's constants (pair_terms.cuh ProbeCtxTerm)
extern "C" int probe_ctx(const void* q, const void* s, void* out, int P, int Ps, int ny,
                         int nx, int ty, int tx, int threads, int smem,
                         const PairConsts* consts, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(s);
  const long plane = (long)ny * nx;
  return launch<ProbeOps, ProbeCtxTerm, NoPost<5>>(
      qf, qf + 2 * P * plane, sf, sf + 2 * Ps * plane, nullptr, 0, out, P, Ps, ny, nx, ty,
      tx, threads, smem, 0.0f, 0.0f, consts, stream);
}
