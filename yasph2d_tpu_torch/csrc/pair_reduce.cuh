// K1: masked pair reduction over each query slot's 3x3 cell neighbourhood.
//
// The kernel and its launch; the C launchers are csrc/pair_reduce.cu (one
// device) and csrc/pair_reduce_halo.cu (the halo form under sharding), each
// built by its own nvcc process.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py pf_pair_reduce
// (body _pf_kernel). For every live query slot (p, y, x) it sums
// term(dx, dy, r_sq, r, ...) over the source slots of the 3x3 cells around
// (y, x), in the TPU kernel's exact accumulation order (dyv, dxv, sp), then
// maps the accumulators through an elementwise epilogue (post). A pair counts
// when the source is live and 1e-10 < r_sq <= h^2; a dead query writes zeros.
// The term and post functors live in csrc/pair_terms.cuh, shared with K3/K5.
//
// Layout: planes (L, P, ny, nx) f32 and masks (P, ny, nx) bool, unpadded.
//
// K7, the ctx-pass probe, is this kernel too: it replaces the TPU kernel
// tools/probe_pallas_slotmajor.py ctx_pass_slotmajor (body ctx_pass_kernel)
// with the probe's own Wendland statement (pair_terms.cuh ProbeCtxTerm), no
// post, and the probe's planes read in place (operand mode ProbeOps): query
// (3, P, ny, nx) and source (3, Ps, ny, nx) f32 = x, y and the mask as 0/1,
// the mask read from plane 2 as > 0; output (5, P, ny, nx). Cells off the
// grid are absent (the TPU probe's zero halo ring adds +0.0, which leaves
// every sum as it is).
//
// Masking skips invalid candidates (a branch), never multiplies them by 0:
// both viscosity coefficients divide by rho_j (XSPH by rho_j * dt) and a dead
// source slot may hold rho_j = 0 there,
// and NaN * 0 is NaN (the same reason the TPU kernel selects with jnp.where).
// Source liveness comes from the source mask plane, not from a sentinel
// position: the resident position planes keep whatever a dead slot last held.
//
// Design (one block per TY x TX cell tile, both powers of two; TY, TX, the
// block's threads and its dynamic shared memory come from ops/pair_reduce.py
// tile_shape):
//  1. Live queries on every lane. The block counts the live query slots of
//     its tile (all P planes, slot order (p, ly, lx), x fastest; TY x TX a
//     power of two each, so a slot index decodes by shifts) with warp ballots,
//     every mask load of a thread issued together, and in the same pass each
//     dead slot writes its zeros, coalesced; per-warp offsets from one barrier
//     place the ascending list of live slots in shared memory. A tile without
//     a live query (most of a dam-break grid is air) stops there and stages
//     nothing.
//  2. Cell tiles in shared memory. One thread per cell of the haloed
//     (TY+2) x (TX+2) tile loads the cell's Ps mask bytes, positions (f32, or
//     the bf16 geometry's) and source values (rounded to bf16 at load in bf16
//     mode), with every load of a chunk of slots issued before the first is
//     used, and stages them; cells off the grid stage as dead, so ragged tiles
//     need no padded copy. One barrier.
//  3. Per-cell live lists. The staging thread also forms the cell's live
//     source slots as W = ceil(Ps / 32) 32-bit words (bit sp % 32 of word
//     sp / 32 is slot sp). Each live query thread walks its 9 cells' words,
//     lowest bit first: the candidates are exactly the live ones, in (dyv,
//     dxv, ascending sp) order, so dead candidates cost nothing and no result
//     changes. This is the Hopper counterpart of the JAX kernel's per-view
//     slot bounds. W = 1 (Ps <= 32, the bench scenes) is its own
//     instantiation (template parameter WIDE false), with W a constant.
// Each query accumulates in one thread in the order above and applies the
// same post, so the kernel stays bit-equal to its twin on the card in both
// operand modes.
//
// Halo form (template parameter HALO, args HaloArgs), for spatial sharding
// over cell rows (parallel/shard_plane.py): the staged tile's rows -1 and ny,
// dead cells on one device, are read from two halo rows of every source
// plane (positions, mask, values), the neighbouring shards' edge rows that
// the caller exchanged; at the ends of the mesh they arrive dead. The TPU
// kernel reads them from its halo-exchanged source windows (_pf_halo,
// _pf_block_source(halo=...)). Nothing else changes, so a shard's rows are
// bit-equal to the one-device output's. The flag is a template parameter and
// the one-device kernels keep their parameter struct, so their code is what
// it was (one run-time argument in the staging cost visc_gravity ~4%).
//
// What bounds it on the H100 (tools/k1_phases.py, which times copies cut
// after each phase): at 100k, of ~24 us per loop form ~15 are the scan of all
// P x ny x nx query slots and the dead slots' zeros, ~1 the staging and ~7
// the candidate loops; the scan is bound by each block's mask-load latency
// and barrier, not by its bytes, so it shrinks with fewer, wider tiles, while
// the loops want more threads per busy tile: tile_shape widens the tile only
// on large grids. The loops are issue-bound: each query sums its candidates
// serially in one thread (the order the twin's bits require), the lanes of a
// warp run as long as their longest list, and IEEE sqrt and division cost
// tens of instructions a pair. The first version, one thread per query slot,
// read 9 x Ps mask bytes and the live candidates' positions from L1/L2 per
// live query and idled the lanes of the 91.5% dead slots at 100k; here dead
// queries and dead candidates never reach the loop, air tiles stage nothing,
// and the loop reads shared memory.
//
// Operand modes (template parameter Ops). F32Ops: positions and values f32,
// read as they are, masks bool. ProbeOps (K7): F32Ops with f32 mask planes,
// live where > 0. Bf16Ops, the TPU kernel's `rebase_cell` mode under
// DenseGridConfig.pair_dtype = "bfloat16": positions are bf16 offsets from
// the slot's cell centre (built once per rebuild, ops/planes.plane_geom), read
// at half the bytes and upcast; dx = (x_j - x_i) + delta[dxv] with delta =
// (-h, 0, +h) rounded to f32 once, added on every view as the TPU kernel does,
// dy likewise. Value planes stay f32 in memory and are rounded to bf16 at load
// (__float2bfloat16_rn, round to nearest even, the bits of JAX's
// .astype(bfloat16)) and staged as bf16; the step then needs no cast launch per
// pass. Epilogue planes stay exact f32. All math and accumulation are f32 in
// both modes.
//
// Build: see yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): every f32 operation is rounded as in the plain PyTorch twin
// (yasph2d_tpu_torch/ops/pair_reduce.py pair_reduce_ref) and the JAX package.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pair_terms.cuh"

#define MAX_PLANES 8
#define K1_MAX_THREADS 256
#define K1_MIN_BLOCKS 4         // blocks per SM the registers must allow (<= 64 each)
#define K1_STAGE_CHUNK 4        // source slots whose loads are issued together
#define K1_MASK_CHUNKS 8        // query-mask chunks whose loads are issued together

struct Planes {
  const float* p[MAX_PLANES];
};

struct F32Ops {
  using Pos = float;
  using Val = float;            // a staged source value
  using Mask = unsigned char;   // a bool mask plane
  static constexpr bool REBASED = false;
  __device__ static bool live(unsigned char m) { return m != 0; }
  __device__ static float pos(const float* p, int i) { return p[i]; }
  __device__ static float val(const float* p, int i) { return p[i]; }
  __device__ static float load_pos(const float* p, int i) { return __ldg(p + i); }
  __device__ static Val stage_val(float v) { return v; }
  __device__ static float up(float v) { return v; }
};

struct Bf16Ops {
  using Pos = __nv_bfloat16;
  using Val = __nv_bfloat16;
  using Mask = unsigned char;
  static constexpr bool REBASED = true;
  __device__ static bool live(unsigned char m) { return m != 0; }
  __device__ static float pos(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }
  __device__ static float val(const float* p, int i) {
    return __bfloat162float(__float2bfloat16_rn(p[i]));
  }
  __device__ static __nv_bfloat16 load_pos(const __nv_bfloat16* p, int i) {
    return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i));
  }
  __device__ static Val stage_val(float v) { return __float2bfloat16_rn(v); }
  __device__ static float up(__nv_bfloat16 v) { return __bfloat162float(v); }
};

struct ProbeOps : F32Ops {  // K7: the mask is plane 2 of the probe's planes, 0/1
  using Mask = float;
  __device__ static bool live(float m) { return m > 0.0f; }
};

template <class T>
struct alignas(2 * sizeof(T)) Pos2 {
  T x, y;
};

template <class Ops>
struct Args {
  const typename Ops::Pos* q_pos;    // (2, P, ny, nx)
  const typename Ops::Mask* q_mask;  // (P, ny, nx)
  const typename Ops::Pos* s_pos;    // (2, Ps, ny, nx)
  const typename Ops::Mask* s_mask;  // (Ps, ny, nx)
  Planes qv;                       // query-side value planes, (P, ny, nx) each
  Planes sv;                       // source-side value planes, (Ps, ny, nx) each
  Planes post;                     // epilogue planes, (P, ny, nx) each, exact f32
  float* out;                      // (n_out, P, ny, nx)
  int P, Ps, ny, nx;
  int ty, tx;                      // cell tile, powers of two
  int lg_ty, lg_tx;                // their log2: slot indices decode by shifts
  float scalar;                    // dt or the correction scale, as f32
  float cell;                      // Bf16Ops: the cell size h as f32
  PairConsts c;
  int W;                           // live words per source cell, ceil(Ps / 32)
};

// the halo form's arguments: source rows -1 (index 0) and ny (index 1)
template <class Ops>
struct HaloArgs : Args<Ops> {
  const typename Ops::Pos* h_pos;    // (2, Ps, 2, nx)
  const typename Ops::Mask* h_mask;  // (Ps, 2, nx)
  Planes hv;                         // the source value planes' rows, (Ps, 2, nx) each
};

template <class Ops, bool HALO>
using KernelArgs = std::conditional_t<HALO, HaloArgs<Ops>, Args<Ops>>;

// ---------------------------------------------------------------- shared memory

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of one block's shared-memory regions; ops/pair_reduce.py
// smem_bytes computes the same total.
struct SmemLayout {
  size_t pos, val, bits, qlist, warps, total;
  // W: live words a cell, ceil(Ps / 32); the one-word kernel passes a
  // constant 1, so that its offsets and code are those of a one-word layout
  __host__ __device__ SmemLayout(int ty, int tx, int P, int Ps, int nsv, int operand_bytes,
                                 int W) {
    const size_t hc = (size_t)(ty + 2) * (tx + 2);
    pos = 0;                                                      // Pos2 [Ps][hc]
    val = pos + align16(hc * Ps * 2 * operand_bytes);             // Val [nsv][Ps][hc]
    bits = val + align16(hc * Ps * nsv * operand_bytes);          // uint32 [hc][W]
    qlist = bits + align16(hc * W * sizeof(unsigned));            // uint16 [ty tx P]
    warps = qlist + align16((size_t)ty * tx * P * sizeof(uint16_t));  // int [32]
    total = warps + 32 * sizeof(int);
  }
};

// ---------------------------------------------------------------- kernel

// WIDE: Ps > 32, W live words a cell; else one word (W = 1 a constant).
// HALO: source rows -1 and ny from the halo rows
template <class Ops, class Term, class Post, bool WIDE, bool HALO>
__global__ void __launch_bounds__(K1_MAX_THREADS, K1_MIN_BLOCKS)
    pair_reduce_kernel(const KernelArgs<Ops, HALO> a) {
  using Pos = typename Ops::Pos;
  using Val = typename Ops::Val;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = WIDE ? a.W : 1;
  const SmemLayout L(a.ty, a.tx, a.P, a.Ps, Term::NSV, (int)sizeof(Pos), W);
  Pos2<Pos>* t_pos = reinterpret_cast<Pos2<Pos>*>(smem + L.pos);
  Val* t_val = reinterpret_cast<Val*>(smem + L.val);
  unsigned* t_bits = reinterpret_cast<unsigned*>(smem + L.bits);
  uint16_t* t_q = reinterpret_cast<uint16_t*>(smem + L.qlist);
  int* t_warp = reinterpret_cast<int*>(smem + L.warps);

  const int plane = a.ny * a.nx;
  const int n = a.P * plane;  // stride between output planes
  const int y0 = blockIdx.y * a.ty;
  const int x0 = blockIdx.x * a.tx;
  const int hx = a.tx + 2;
  const int hc = (a.ty + 2) * hx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // 1. live query slots of the tile: slot i = (p * ty + ly) * tx + lx; each
  // warp takes a contiguous range of whole 32-slot chunks
  const int n_tq = a.ty * a.tx * a.P;
  const int span = (n_tq + n_warps * 32 - 1) / (n_warps * 32) * 32;
  const int lo = warp * span;
  auto slot_index = [&](int i) -> int {  // global index of slot i, -1 off the grid
    const int lx = i & (a.tx - 1);
    const int r = i >> a.lg_tx;
    const int ly = r & (a.ty - 1);
    const int p = r >> a.lg_ty;
    const int y = y0 + ly;
    const int x = x0 + lx;
    return (i < n_tq && y < a.ny && x < a.nx) ? p * plane + y * a.nx + x : -1;
  };
  // the warp's slots in groups of K1_MASK_CHUNKS chunks, every mask load of
  // a group issued before the first ballot
  auto live_group = [&](int g, bool* live, int* idx) {
#pragma unroll
    for (int r = 0; r < K1_MASK_CHUNKS; ++r) {
      const int i = lo + g + r * 32 + lane;
      idx[r] = g + r * 32 < span ? slot_index(i) : -1;
      live[r] = idx[r] >= 0 && Ops::live(__ldg(a.q_mask + idx[r]));
    }
  };
  // first pass: count the live slots and write the dead ones' zeros; the live
  // bits of the first group stay in a register for the second pass
  int count = 0;
  unsigned first = 0u;
  for (int g = 0; g < span; g += K1_MASK_CHUNKS * 32) {
    bool live[K1_MASK_CHUNKS];
    int idx[K1_MASK_CHUNKS];
    live_group(g, live, idx);
#pragma unroll
    for (int r = 0; r < K1_MASK_CHUNKS; ++r) {
      count += __popc(__ballot_sync(0xffffffffu, live[r]));
      if (live[r]) {
        if (g == 0) first |= 1u << r;
      } else if (idx[r] >= 0) {
        for (int k = 0; k < Post::NOUT; ++k) a.out[k * n + idx[r]] = 0.0f;
      }
    }
  }
  if (lane == 0) t_warp[warp] = count;
  __syncthreads();
  // exclusive offset of this warp and the tile's total, from the warp counts
  const int mine = lane < n_warps ? t_warp[lane] : 0;
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  const int n_live = __shfl_sync(0xffffffffu, incl, 31);
  // second pass: the ascending list of live slots
  int next = __shfl_sync(0xffffffffu, incl - mine, warp);
  for (int g = 0; g < span; g += K1_MASK_CHUNKS * 32) {
    bool live[K1_MASK_CHUNKS];
    int idx[K1_MASK_CHUNKS];
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < K1_MASK_CHUNKS; ++r) live[r] = (first >> r) & 1u;
    } else {
      live_group(g, live, idx);  // from L1
    }
#pragma unroll
    for (int r = 0; r < K1_MASK_CHUNKS; ++r) {
      const unsigned ballot = __ballot_sync(0xffffffffu, live[r]);
      if (live[r])
        t_q[next + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)(lo + g + r * 32 + lane);
      next += __popc(ballot);
    }
  }
  if (n_live == 0) return;  // uniform across the block: an air tile

  // 2. stage the haloed source tile, one thread per cell, and 3. its live list
  // (the one-device kernels keep this code as it was, statement for
  // statement, so that their SASS does not change; HALO stages rows -1 and
  // ny from the halo rows through the same loads)

  if constexpr (HALO) {
    // stage cell c's Ps source slots from planes whose slots lie `stride` apart,
    // slot 0 at index g0: the grid's planes, or a halo row's
    auto stage = [&](int c, unsigned& bits, const typename Ops::Mask* s_mask, const Pos* s_pos,
                     const Planes& sv, int stride, int g0) {
      for (int sp0 = 0; sp0 < a.Ps; sp0 += K1_STAGE_CHUNK) {
        typename Ops::Mask m[K1_STAGE_CHUNK];
        Pos px[K1_STAGE_CHUNK], py[K1_STAGE_CHUNK];
        float v[K1_STAGE_CHUNK][Term::NSV > 0 ? Term::NSV : 1];
#pragma unroll
        for (int u = 0; u < K1_STAGE_CHUNK; ++u) {
          const int sp = sp0 + u;
          if (sp < a.Ps) {
            const int g = sp * stride + g0;
            m[u] = __ldg(s_mask + g);
            px[u] = Ops::load_pos(s_pos, g);
            py[u] = Ops::load_pos(s_pos, a.Ps * stride + g);
#pragma unroll
            for (int k = 0; k < Term::NSV; ++k) v[u][k] = __ldg(sv.p[k] + g);
          }
        }
#pragma unroll
        for (int u = 0; u < K1_STAGE_CHUNK; ++u) {
          const int sp = sp0 + u;
          if (sp < a.Ps) {
            const int s = sp * hc + c;
            t_pos[s] = Pos2<Pos>{px[u], py[u]};
#pragma unroll
            for (int k = 0; k < Term::NSV; ++k)
              t_val[k * a.Ps * hc + s] = Ops::stage_val(v[u][k]);
            bits |= (Ops::live(m[u]) ? 1u : 0u) << (WIDE ? (sp & 31) : sp);
          }
        }
        // a full word (K1_STAGE_CHUNK divides 32)
        if (WIDE && ((sp0 + K1_STAGE_CHUNK) & 31) == 0) {
          t_bits[c * W + (sp0 >> 5)] = bits;
          bits = 0u;
        }
      }
    };
    for (int c = tid; c < hc; c += blockDim.x) {
      const int hy = c / hx;
      const int gy = y0 + hy - 1;
      const int gx = x0 + (c - hy * hx) - 1;
      const bool on_grid = gy >= 0 && gy < a.ny && gx >= 0 && gx < a.nx;
      unsigned bits = 0u;
      if (on_grid) stage(c, bits, a.s_mask, a.s_pos, a.sv, plane, gy * a.nx + gx);
      bool staged = on_grid;
      // rows -1 and ny: the neighbouring shards' edge rows
      if (!on_grid && gx >= 0 && gx < a.nx && (gy == -1 || gy == a.ny)) {
        stage(c, bits, a.h_mask, a.h_pos, a.hv, 2 * a.nx, (gy < 0 ? 0 : a.nx) + gx);
        staged = true;
      }
      if (!WIDE) {
        t_bits[c] = bits;  // cells off the grid are dead
      } else {
        // the last, partial word; every word of a cell off the grid is dead
        for (int w = staged ? a.Ps >> 5 : 0; w < W; ++w) {
          t_bits[c * W + w] = bits;
          bits = 0u;
        }
      }
    }
  } else {
    for (int c = tid; c < hc; c += blockDim.x) {
      const int hy = c / hx;
      const int gy = y0 + hy - 1;
      const int gx = x0 + (c - hy * hx) - 1;
      const bool on_grid = gy >= 0 && gy < a.ny && gx >= 0 && gx < a.nx;
      unsigned bits = 0u;
      if (on_grid) {
        const int g0 = gy * a.nx + gx;
        for (int sp0 = 0; sp0 < a.Ps; sp0 += K1_STAGE_CHUNK) {
          typename Ops::Mask m[K1_STAGE_CHUNK];
          Pos px[K1_STAGE_CHUNK], py[K1_STAGE_CHUNK];
          float v[K1_STAGE_CHUNK][Term::NSV > 0 ? Term::NSV : 1];
#pragma unroll
          for (int u = 0; u < K1_STAGE_CHUNK; ++u) {
            const int sp = sp0 + u;
            if (sp < a.Ps) {
              const int g = sp * plane + g0;
              m[u] = __ldg(a.s_mask + g);
              px[u] = Ops::load_pos(a.s_pos, g);
              py[u] = Ops::load_pos(a.s_pos, a.Ps * plane + g);
#pragma unroll
              for (int k = 0; k < Term::NSV; ++k) v[u][k] = __ldg(a.sv.p[k] + g);
            }
          }
#pragma unroll
          for (int u = 0; u < K1_STAGE_CHUNK; ++u) {
            const int sp = sp0 + u;
            if (sp < a.Ps) {
              const int s = sp * hc + c;
              t_pos[s] = Pos2<Pos>{px[u], py[u]};
#pragma unroll
              for (int k = 0; k < Term::NSV; ++k)
                t_val[k * a.Ps * hc + s] = Ops::stage_val(v[u][k]);
              bits |= (Ops::live(m[u]) ? 1u : 0u) << (WIDE ? (sp & 31) : sp);
            }
          }
          // a full word (K1_STAGE_CHUNK divides 32)
          if (WIDE && ((sp0 + K1_STAGE_CHUNK) & 31) == 0) {
            t_bits[c * W + (sp0 >> 5)] = bits;
            bits = 0u;
          }
        }
      }
      if (!WIDE) {
        t_bits[c] = bits;  // cells off the grid are dead
      } else {
        // the last, partial word; every word of a cell off the grid is dead
        for (int w = on_grid ? a.Ps >> 5 : 0; w < W; ++w) {
          t_bits[c * W + w] = bits;
          bits = 0u;
        }
      }
    }
  }
  __syncthreads();

  // the live queries, one per thread, in slot order
  const float delta[3] = {-a.cell, 0.0f, a.cell};
  for (int j = tid; j < n_live; j += blockDim.x) {
    const int i = t_q[j];
    const int lx = i & (a.tx - 1);
    const int r = i >> a.lg_tx;
    const int ly = r & (a.ty - 1);
    const int idx = (r >> a.lg_ty) * plane + (y0 + ly) * a.nx + (x0 + lx);
    const float qx = Ops::pos(a.q_pos, idx);
    const float qy = Ops::pos(a.q_pos, n + idx);
    float qv[Term::NQV > 0 ? Term::NQV : 1];
    for (int k = 0; k < Term::NQV; ++k) qv[k] = Ops::val(a.qv.p[k], idx);
    float acc[Term::NACC];
    for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
    for (int dyv = 0; dyv < 3; ++dyv) {
      for (int dxv = 0; dxv < 3; ++dxv) {
        const int c = (ly + dyv) * hx + (lx + dxv);
        for (int w = 0; w < W; ++w) {
          for (unsigned bits = t_bits[c * W + w]; bits != 0u; bits &= bits - 1u) {
            const int s = (32 * w + __ffs(bits) - 1) * hc + c;
            const Pos2<Pos> src = t_pos[s];
            float dx = Ops::up(src.x) - qx;
            float dy = Ops::up(src.y) - qy;
            if (Ops::REBASED) {
              dx = dx + delta[dxv];
              dy = dy + delta[dyv];
            }
            const float r_sq = dx * dx + dy * dy;
            if (!(r_sq <= a.c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
            float sv[Term::NSV > 0 ? Term::NSV : 1];
            for (int k = 0; k < Term::NSV; ++k) sv[k] = Ops::up(t_val[k * a.Ps * hc + s]);
            Term::term(acc, make_float2(dx, dy), r_sq, sqrtf(r_sq), qv, sv, a.c, a.scalar);
          }
        }
      }
    }
    float pv[Post::NPOST > 0 ? Post::NPOST : 1];
    for (int k = 0; k < Post::NPOST; ++k) pv[k] = a.post.p[k][idx];
    float out[Post::NOUT];
    Post::post(out, acc, pv, a.c, a.scalar);
    for (int k = 0; k < Post::NOUT; ++k) a.out[k * n + idx] = out[k];
  }
}

// HALO: h_pos, h_mask and h_planes (Term::NSV pointers) are the halo rows
template <class Ops, class Term, class Post, bool HALO = false>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* planes, int n_planes,
                  void* out, int P, int Ps, int ny, int nx, int ty, int tx, int threads,
                  int smem, float scalar, float cell, const PairConsts* consts,
                  void* stream, const void* h_pos = nullptr, const void* h_mask = nullptr,
                  const void* const* h_planes = nullptr) {
  using Pos = typename Ops::Pos;
  if (n_planes != Term::NQV + Term::NSV + Post::NPOST || ty < 1 || tx < 1 ||
      (ty & (ty - 1)) || (tx & (tx - 1)) || threads < 32 || threads > K1_MAX_THREADS ||
      threads % 32 || Ps < 1 || (long)ty * tx * P > 65536 ||
      (size_t)smem !=
          SmemLayout(ty, tx, P, Ps, Term::NSV, (int)sizeof(Pos), (Ps + 31) / 32).total)
    return (int)cudaErrorInvalidValue;
  KernelArgs<Ops, HALO> a;
  a.q_pos = static_cast<const Pos*>(q_pos);
  a.q_mask = static_cast<const typename Ops::Mask*>(q_mask);
  a.s_pos = static_cast<const Pos*>(s_pos);
  a.s_mask = static_cast<const typename Ops::Mask*>(s_mask);
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
  a.ty = ty;
  a.tx = tx;
  a.lg_ty = __builtin_ctz(ty);
  a.lg_tx = __builtin_ctz(tx);
  a.W = (Ps + 31) / 32;
  a.scalar = scalar;
  a.cell = cell;
  a.c = *consts;
  if constexpr (HALO) {
    a.h_pos = static_cast<const Pos*>(h_pos);
    a.h_mask = static_cast<const typename Ops::Mask*>(h_mask);
    for (int k = 0; k < MAX_PLANES; ++k)
      a.hv.p[k] = k < Term::NSV ? static_cast<const float*>(h_planes[k]) : nullptr;
  }
  if ((long)P * ny * nx == 0) return (int)cudaSuccess;
  void (*kernel)(const KernelArgs<Ops, HALO>) =
      a.W == 1 ? pair_reduce_kernel<Ops, Term, Post, false, HALO>
               : pair_reduce_kernel<Ops, Term, Post, true, HALO>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K1's call forms, as X(NAME, TERM, POST) for the launcher macros of
// csrc/pair_reduce.cu and csrc/pair_reduce_halo.cu
#define K1_PAIR_FORMS(X)                                                   \
  /* the six call forms of the DFSPH plane step (models/dfsph_plane.py) */ \
  X(ctx, CtxTerm, NoPost<5>)       /* fluid -> boundary ctx sums */        \
  X(ctx_post, CtxTerm, CtxPost)    /* fused fluid ctx pass */              \
  X(visc_gravity, ViscTerm<XsphCoef>, GravityPost)                         \
  X(err_ki, DivTerm, ErrKiPost)                                            \
  X(delta_ki, DivTerm, DeltaKiPost)                                        \
  X(corr_v, CorrTerm, VUpdatePost)                                         \
  /* their passes without an epilogue: the unfused plane step (the JAX */  \
  /* fuse_loop_elementwise False), its glue in torch */                    \
  X(visc, ViscTerm<XsphCoef>, NoPost<2>)                                   \
  X(div, DivTerm, NoPost<1>)                                               \
  X(corr, CorrTerm, NoPost<2>)                                             \
  /* the three call forms of the WCSPH plane step (models/wcsph_plane.py) */ \
  X(wcsph_density, WcsphDensityTerm, NoPost<1>)  /* Poly6 density */      \
  X(wcsph_stat, WcsphStatTerm, NoPost<3>)  /* boundary density + force */  \
  X(wcsph_forces, WcsphForcesTerm<XsphCoef>, NoPost<2>)                    \
  /* the physical viscosity forms of both steps (PhysicalViscosityModel) */ \
  X(visc_gravity_phys, ViscTerm<PhysCoef>, GravityPost)                    \
  X(wcsph_forces_phys, WcsphForcesTerm<PhysCoef>, NoPost<2>)               \
  X(visc_phys, ViscTerm<PhysCoef>, NoPost<2>)
