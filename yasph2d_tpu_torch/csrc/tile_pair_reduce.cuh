// K5 and K3: masked pair reduction over each query slot's 3x3 cell
// neighbourhood, in the padded slot-major layout, on cell tiles staged in
// shared memory. One kernel template, two sum orders (a template parameter).
// This header holds the kernel and its launch; csrc/tile_pair_reduce.cu (one
// device) and csrc/tile_pair_reduce_halo.cu (K5's halo form under sharding)
// hold the C launchers, each built by its own nvcc process.
//
// K5 (per view) replaces the TPU kernel yasph2d_tpu/ops/pallas_pair.py
// pallas_pair_reduce (body _kernel), the first-generation pair kernel behind
// the JAX package's DenseGridConfig.use_pallas and the drop-in for its XLA
// dense_grid.pair_reduce: each view's Ps candidates in sp order into a view
// sum, then the view sums in (dyv, dxv) order, which is the TPU kernel's
// grouping (a per-view jnp.sum over the candidate axis, then accs + contribs).
// Its forms follow the JAX package's XLA closures (the *XlaTerm functors).
//
// K3 (per candidate) replaces the TPU kernel
// yasph2d_tpu/ops/pallas_slotmajor.py sm_pair_reduce (body _sm_kernel): every
// candidate's term straight into the accumulators, in (dyv, dxv, sp) order,
// which is the TPU kernel's accumulation order. Its forms follow the JAX
// package's slot-major closures (K1's term functors), and its boundary ctx
// pass (dfsph_stat, an XLA pair_reduce in the JAX package) the XLA order.
// The TPU kernel's band blocking, source windows and skip flags exist for
// Mosaic and are not needed here.
//
// For every live query slot (y, x, p) both sum term(dx, dy, r_sq, r, ...) over
// the source slots of the 3x3 cells around (y, x). A pair counts when the
// query and the source are live and 1e-10 < r_sq <= h^2; a dead query writes
// zeros. No epilogue. The term functors are in csrc/pair_terms.cuh.
//
// Layout: the carry is read in place, with no transpose into planes:
// positions (ny, nx, P, 2) f32 read as float2, masks (ny, nx, P) bool, and
// each value as a pointer and an element stride, so that a scalar (ny, nx, P)
// has stride 1 and the two components of an interleaved vector (ny, nx, P, 2)
// are (base, 2) and (base + 1, 2); output (ny, nx, P, n_out), vector-last
// like the carry. The source space may have Ps != P slots (the boundary).
//
// Design (one block per TY x TX cell tile, both powers of two; TY, TX and the
// block's threads come from ops/pallas_pair.py tile_shape, which picks them
// from a recorded sweep, tools/tile_sweep.py --kernel k5 and --kernel k3; the
// dynamic shared memory from its smem_bytes). K1's design
// (csrc/pair_reduce.cu) on this layout:
//  1. Live queries on every lane. The tile's query slots are numbered
//     i = ((ly * TX + lx) << lg PP) | p, PP the power of two >= P, so that a
//     warp reads consecutive slots of consecutive cells (a row of the tile is
//     one contiguous run in memory) and i decodes by shifts (slots p >= P are
//     skipped). Warp ballots count the live ones, every mask load of a thread
//     issued together, and in the same pass each dead slot writes its n_out
//     zeros, coalesced; per-warp offsets from one barrier place the ascending
//     list of live slots in shared memory. A tile without a live query (most
//     of a dam-break grid is air) stops there and stages nothing. A tile with
//     more query slots than the list holds (a large P) takes them in rounds.
//  2. Cell tiles in shared memory. The haloed (TY+2) x (TX+2) x Ps source
//     tile is staged flat in memory order (staging index (hy, hx, sp) with
//     power-of-two strides, decoded by shifts), with every load of a chunk
//     issued before the first is used: positions as float2, each source value
//     component as a plane. Cells off the grid stage as dead, so ragged tiles
//     need no padded copy. Each thread's first live query's position and
//     values are loaded in the same round of loads, so a busy tile waits on
//     device memory twice (query masks; sources and queries). One barrier.
//  3. Per-cell live words. The same pass forms each cell's live source slots
//     as 32-bit words from the staging warps' ballots (bit sp of word sp / 32
//     is slot sp; ceil(Ps / 32) words a cell). Each live query thread walks
//     its 9 cells' words, lowest bit first: the candidates are exactly the
//     live ones, in (dyv, dxv, ascending sp) order, so dead candidates cost
//     nothing and no sum changes.
// Each query sums in one thread in its order, so each kernel gives the bits of
// its first design (one thread per query slot) on the same inputs. K3's twin
// adds slot by slot in the same order, so K3 and its twin
// are bit-equal on the card; K5's twin sums over Ps with torch.sum, so K5 and
// its twin agree to f32 summation order.
//
// Masking skips invalid candidates (a branch), never multiplies them by 0:
// dead sources may hold rho = 0, and both viscosity coefficients divide by it.
//
// What bounds it on the H100: device-memory bytes are far away (each input is
// read once per tile plus a one-cell halo, each output written once, and per
// live pair it does some 10-30 f32 operations, far below the FP32 rate).
// Latency and issue bound it, as K1: the scan of every query slot (a mask
// load and a ballot per 32 slots, the dead slots' zeros) scales with the
// number of tiles, the candidate loops with the longest list in a warp. The
// first designs ran one thread per query slot: at 100k 91.5% of them idled
// through the candidate loop, every thread walked all 9 x Ps candidates past
// the dead ones, and K3 did 64-bit index arithmetic and a mask load per
// candidate.
//
// Halo form (template parameter HALO, args HaloTileArgs; K5's sum order
// only), for spatial sharding over cell rows (parallel/shard_dense.py): the
// staged tile's source rows -1 and ny, dead cells on one device, are read
// from two halo rows that the caller exchanged with the neighbouring shards
// (h_pos (2, nx, Ps) float2, h_mask (2, nx, Ps), and each source value
// component's rows (2, nx, Ps) with the stride of its grid pointer; row -1 at
// index 0). At the ends of the mesh they arrive dead. The JAX package's
// sharded padded route runs this pass in XLA (dense_grid.pair_reduce with
// halo2d_multi); its Pallas kernel pads a ring of zeros there instead
// (pallas_pair.py halo2d), which would lose every neighbour across the seam.
// Nothing else changes (the halo rows stage into the ring the tile already
// has, so the shared memory is the same), so a shard's rows get the sums of
// the one-device kernel on the whole grid, bit for bit. One staging loop
// serves both forms: a staged row -1 or ny of the halo form takes the halo
// rows' pointers, the one-device form compiles that choice away.
//
// bf16 math mode (template parameter M = Bf16Math, K5 only; launchers
// tile_pair_reduce_<form>_bf16 and their halo forms), the JAX package's XLA
// dense_grid.pair_reduce with pair_dtype "bfloat16", which K5 stands in for
// on the padded route: positions are read in f32 and rebased onto their own
// cell's centre ((i + 0.5) h + origin in f32, i the global cell row under
// sharding: args RebaseArgs), then the pair rounded to bf16 by one
// instruction; query and source values are rounded to bf16 where they are
// loaded, two by one instruction. The tile is staged in bf16: positions as
// __nv_bfloat162 (4 B a slot, 8 in f32), values 2 B each (StagedVals; the
// components of a vector share one 4-byte word). Per pair the geometry is
// packed: (dx, dy) is one HSUB2 of the staged pair and the query's, plus the
// view's centre offsets ((dxv - 1), (dyv - 1)) bf16(h) one HADD2, both
// squares one HMUL2, r^2 their bf16 sum; h^2, 1e-10 and the constants compare
// and compute in bf16 (the caller passes them rounded, ops/pallas_pair.py
// bf16_consts; the launcher converts them to PairConstsBf16). Every
// operation of the term is a bf16 operation (csrc/pair_terms.cuh Bf16Math),
// each (x, y) pair of it one packed instruction, and per pair the kernel
// computes its twin's bits (every bf16 operation is the f32 operation
// rounded to nearest even, as torch's bf16 operations). The per-view sums and
// their sum stay f32, in K5's order; the twin's differ by f32 summation
// order, as in f32 mode. A halo row's positions are rebased on the
// neighbour's cell centres (its global row), as the JAX sharded route
// exchanges rows that the neighbour rebased. Native bf16 instructions,
// because an f32 operation rounded to bf16 costs two conversions beside it
// (1.4-1.8x the f32 forms' time on the H100, with f32 staging).
//
// Gate (TileArgs gate, gate_i; the DFSPH pressure loops' device-side exit
// test, csrc/pressure_glue.cu): a launch of loop iteration gate_i reads the
// loop's state and, when gate_i is past its last iteration, returns before it
// loads or writes anything, its output left as allocated (only the loop's
// gated glue kernels read it). Every other caller passes a null gate: its
// work and outputs are the same as without one.
//
// Build: yasph2d_tpu_torch/ops/cuda_build.py (sm_90a, -fmad=false, no fast
// math): each term is rounded as in the plain PyTorch twins
// (yasph2d_tpu_torch/ops/pallas_pair.py pallas_pair_reduce_ref,
// yasph2d_tpu_torch/ops/sm_pair_reduce.py sm_pair_reduce_ref).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pair_terms.cuh"

#define TILE_MAX_VALS 8
#define K5_MAX_THREADS 256
#define K5_MIN_BLOCKS 4     // blocks per SM the registers must allow (<= 64 each)
#define K5_STAGE_CHUNK 4    // staged slots per thread whose loads are issued together
#define K5_MASK_CHUNKS 8    // query-mask chunks whose loads are issued together
#define K5_MAX_LIST 65536   // a list entry is a 16-bit offset into the round

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
  int ty, tx;           // cell tile, powers of two
  int lg_ty, lg_tx;     // their log2
  int lg_pp;            // log2 of PP, the power of two >= P
  int lg_psp;           // log2 of PSP, the power of two >= Ps
  int lg_hxp;           // log2 of a halo row's staging stride, >= (TX + 2) PSP
  int W;                // live words per source cell, ceil(Ps / 32)
  int q_round;          // query slots per round (list entries)
  float scalar;         // dt, as f32
  PairConsts c;
  const int* gate;      // a pressure loop's state (its last iteration to run), or null
  int gate_i;           // the launch's iteration: with a gate it runs iff gate_i <= *gate
};

// the halo form's arguments: source rows -1 (index 0) and ny (index 1)
struct HaloTileArgs : TileArgs {
  const float2* h_pos;  // (2, nx, Ps)
  const bool* h_mask;   // (2, nx, Ps)
  TileVals hv;          // source values' rows over (2, nx, Ps), the strides of sv
};

// the bf16 mode's arguments: what a cell's centre is built from
struct Rebase {
  float ox, oy;  // the grid's origin, f32
  float cell;    // the cell size h, f32
  int row0;      // the grid's first global cell row (a shard's; 0 on one device)
};
template <class Base>
struct RebaseArgs : Base {
  Rebase rb;
  PairConstsBf16 cb;       // the terms' constants (Base::c keeps the f32 cut-off)
  __nv_bfloat16 scalar_b;  // the scalar
};

template <bool HALO, class M = F32Math>
using TileKernelArgs = std::conditional_t<
    M::BF16, RebaseArgs<std::conditional_t<HALO, HaloTileArgs, TileArgs>>,
    std::conditional_t<HALO, HaloTileArgs, TileArgs>>;

// the terms' constants and scalar in the mode's types
template <class M, class A>
__device__ __forceinline__ const typename M::Consts& term_consts(const A& a) {
  if constexpr (M::BF16) return a.cb;
  else return a.c;
}
template <class M, class A>
__device__ __forceinline__ typename M::T term_scalar(const A& a) {
  if constexpr (M::BF16) return a.scalar_b;
  else return a.scalar;
}

// bf16 mode: position p of cell column gx, local row gy (-1 and ny are the
// halo rows) relative to that cell's centre, the pair rounded to bf16 by one
// instruction
__device__ __forceinline__ __nv_bfloat162 rebased(const Rebase& rb, float2 p, int gx, int gy) {
  const float cx = ((float)gx + 0.5f) * rb.cell + rb.ox;
  const float cy = ((float)(rb.row0 + gy) + 0.5f) * rb.cell + rb.oy;
  return __floats2bfloat162_rn(p.x - cx, p.y - cy);
}
// a position read from memory as the mode computes with it: f32 as it is,
// bf16 rebased
template <class M, class A>
__device__ __forceinline__ typename M::T2 mode_pos(const A& a, float2 p, int gx, int gy) {
  if constexpr (M::BF16) return rebased(a.rb, p, gx, gy);
  else return p;
}
// N values read from memory (f32) as the mode's values; bf16 rounds two with
// one instruction
template <class M, int N>
__device__ __forceinline__ void mode_vals(const float* v, typename M::T* out) {
  if constexpr (M::BF16) {
#pragma unroll
    for (int k = 0; k + 1 < N; k += 2) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[k], v[k + 1]);
      out[k] = __low2bfloat16(p);
      out[k + 1] = __high2bfloat16(p);
    }
    if constexpr (N % 2 == 1) out[N - 1] = __float2bfloat16_rn(v[N - 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = v[k];
  }
}

// ---------------------------------------------------------------- shared memory

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of one block's shared-memory regions; ops/pallas_pair.py
// smem_bytes computes the same total. f32: positions float2 (8 B), each
// source value a float plane (4 B a slot); bf16: positions __nv_bfloat162
// (4 B), values 2 B each (StagedVals)
struct TileSmem {
  size_t pos, val, bits, qlist, warps, total;
  __host__ __device__ TileSmem(int ty, int tx, int Ps, int nsv, int W, int q_round, bool bf16) {
    const size_t n_src = (size_t)(ty + 2) * (tx + 2) * Ps;
    pos = 0;                                                         // [hc][Ps]
    val = pos + align16(n_src * (bf16 ? 4 : 8));                     // [nsv][hc][Ps]
    bits = val + align16(n_src * nsv * (bf16 ? 2 : 4));              // uint32 [hc][W]
    qlist = bits + align16((size_t)(ty + 2) * (tx + 2) * W * sizeof(unsigned));
    warps = qlist + align16((size_t)q_round * sizeof(uint16_t));  // int [32]
    total = warps + 32 * sizeof(int);
  }
};

// The staged source values of n_src slots: f32, one float plane per value;
// bf16, values (2j, 2j + 1) as one __nv_bfloat162 plane (one shared-memory
// load gives both), then for an odd NSV a bf16 plane of the last
template <class M, int NSV>
struct StagedVals {
  __device__ static void put(unsigned char* base, int n_src, int s, const float* v) {
    if constexpr (M::BF16) {
      __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(base);
#pragma unroll
      for (int j = 0; j < NSV / 2; ++j)
        pairs[j * n_src + s] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      if constexpr (NSV % 2 == 1)
        reinterpret_cast<__nv_bfloat16*>(pairs + (NSV / 2) * n_src)[s] =
            __float2bfloat16_rn(v[NSV - 1]);
    } else {
      float* t = reinterpret_cast<float*>(base);
#pragma unroll
      for (int k = 0; k < NSV; ++k) t[k * n_src + s] = v[k];
    }
  }
  __device__ static void get(const unsigned char* base, int n_src, int s, typename M::T* sv) {
    if constexpr (M::BF16) {
      const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(base);
#pragma unroll
      for (int j = 0; j < NSV / 2; ++j) {
        const __nv_bfloat162 p = pairs[j * n_src + s];
        sv[2 * j] = __low2bfloat16(p);
        sv[2 * j + 1] = __high2bfloat16(p);
      }
      if constexpr (NSV % 2 == 1)
        sv[NSV - 1] = reinterpret_cast<const __nv_bfloat16*>(pairs + (NSV / 2) * n_src)[s];
    } else {
      const float* t = reinterpret_cast<const float*>(base);
#pragma unroll
      for (int k = 0; k < NSV; ++k) sv[k] = t[k * n_src + s];
    }
  }
};

// ---------------------------------------------------------------- kernel

// PER_VIEW: K5's sum order (per-view sums, then the view sums), else K3's
// (every candidate straight into the accumulators). HALO: source rows -1 and
// ny from the halo rows. M: the math mode (F32Math, or K5's Bf16Math)
template <class Term, bool PER_VIEW, bool HALO, class M = F32Math>
__global__ void __launch_bounds__(K5_MAX_THREADS, K5_MIN_BLOCKS)
    tile_pair_reduce_kernel(const TileKernelArgs<HALO, M> a) {
  using T = typename M::T;
  using T2 = typename M::T2;
  using Vals = StagedVals<M, Term::NSV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem L(a.ty, a.tx, a.Ps, Term::NSV, a.W, a.q_round, M::BF16);
  T2* t_pos = reinterpret_cast<T2*>(smem + L.pos);
  unsigned char* t_val = smem + L.val;
  unsigned* t_bits = reinterpret_cast<unsigned*>(smem + L.bits);
  uint16_t* t_q = reinterpret_cast<uint16_t*>(smem + L.qlist);
  int* t_warp = reinterpret_cast<int*>(smem + L.warps);

  const int y0 = blockIdx.y * a.ty;
  const int x0 = blockIdx.x * a.tx;
  const int hx = a.tx + 2;
  const int n_src = (a.ty + 2) * hx * a.Ps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pp_mask = (1 << a.lg_pp) - 1;
  const int n_tq = (a.ty * a.tx) << a.lg_pp;
  bool staged = false;
  // a gated launch past its loop's last iteration writes nothing
  if (a.gate != nullptr && a.gate_i > *a.gate) return;

  for (int q0 = 0; q0 < n_tq; q0 += a.q_round) {
    // 1. live query slots of this round; each warp takes a contiguous range
    // of whole 32-slot chunks
    const int n_r = min(a.q_round, n_tq - q0);
    const int span = (n_r + n_warps * 32 - 1) / (n_warps * 32) * 32;
    const int lo = warp * span;
    auto slot_index = [&](int j) -> long {  // global slot of round slot j, -1 if none
      const int i = q0 + j;
      const int p = i & pp_mask;
      const int cell = i >> a.lg_pp;
      const int y = y0 + (cell >> a.lg_tx);
      const int x = x0 + (cell & (a.tx - 1));
      return (j < n_r && p < a.P && y < a.ny && x < a.nx) ? ((long)y * a.nx + x) * a.P + p
                                                            : -1;
    };
    // the warp's slots in groups of K5_MASK_CHUNKS chunks, every mask load of
    // a group issued before the first ballot
    auto live_group = [&](int g, bool* live, long* idx) {
#pragma unroll
      for (int r = 0; r < K5_MASK_CHUNKS; ++r) {
        idx[r] = g + r * 32 < span ? slot_index(lo + g + r * 32 + lane) : -1;
        live[r] = idx[r] >= 0 &&
                  __ldg(reinterpret_cast<const unsigned char*>(a.q_mask) + idx[r]) != 0;
      }
    };
    // first pass: count the live slots and write the dead ones' zeros; the
    // live bits of the first group stay in a register for the second pass
    int count = 0;
    unsigned first = 0u;
    for (int g = 0; g < span; g += K5_MASK_CHUNKS * 32) {
      bool live[K5_MASK_CHUNKS];
      long idx[K5_MASK_CHUNKS];
      live_group(g, live, idx);
#pragma unroll
      for (int r = 0; r < K5_MASK_CHUNKS; ++r) {
        count += __popc(__ballot_sync(0xffffffffu, live[r]));
        if (live[r]) {
          if (g == 0) first |= 1u << r;
        } else if (idx[r] >= 0) {
          for (int k = 0; k < Term::NACC; ++k) a.out[idx[r] * Term::NACC + k] = 0.0f;
        }
      }
    }
    if (lane == 0) t_warp[warp] = count;
    // an air round (most tiles of a dam-break grid) ends at this barrier
    if (!__syncthreads_or(count)) continue;
    // exclusive offset of this warp and the round's total, from the warp counts
    const int mine = lane < n_warps ? t_warp[lane] : 0;
    int incl = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    const int n_live = __shfl_sync(0xffffffffu, incl, 31);
    // second pass: the ascending list of live slots
    int next = __shfl_sync(0xffffffffu, incl - mine, warp);
    for (int g = 0; g < span; g += K5_MASK_CHUNKS * 32) {
      bool live[K5_MASK_CHUNKS];
      long idx[K5_MASK_CHUNKS];
      if (g == 0) {
#pragma unroll
        for (int r = 0; r < K5_MASK_CHUNKS; ++r) live[r] = (first >> r) & 1u;
      } else {
        live_group(g, live, idx);  // from L1
      }
#pragma unroll
      for (int r = 0; r < K5_MASK_CHUNKS; ++r) {
        const unsigned ballot = __ballot_sync(0xffffffffu, live[r]);
        if (live[r])
          t_q[next + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)(lo + g + r * 32 + lane);
        next += __popc(ballot);
      }
    }

    __syncthreads();   // the list is complete
    // the live query of list entry j: its tile cell and global slot
    auto query = [&](int j, int& ly, int& lx) -> long {
      const int i = q0 + t_q[j];
      const int cell = i >> a.lg_pp;
      ly = cell >> a.lg_tx;
      lx = cell & (a.tx - 1);
      return ((long)(y0 + ly) * a.nx + (x0 + lx)) * a.P + (i & pp_mask);
    };
    // a live query's position and values in the mode's types
    auto load_query = [&](long idx, int ly, int lx, T2& q, T* qv) {
      q = mode_pos<M>(a, __ldg(a.q_pos + idx), x0 + lx, y0 + ly);
      float v[Term::NQV > 0 ? Term::NQV : 1];
#pragma unroll
      for (int k = 0; k < Term::NQV; ++k) v[k] = __ldg(a.qv.p[k] + idx * a.qv.stride[k]);
      mode_vals<M, Term::NQV>(v, qv);
    };
    // this thread's first live query: its loads go out with the staging's
    int ly0 = 0, lx0 = 0;
    long idx0 = -1;
    T2 qp0 = M::splat(M::k(0.0f));
    T qv0[Term::NQV > 0 ? Term::NQV : 1];
    if (tid < n_live) {
      idx0 = query(tid, ly0, lx0);
      load_query(idx0, ly0, lx0, qp0, qv0);
    }
    if (!staged) {
      // 2. stage the haloed source tile and 3. its live words: staging index
      // t = (hy << lg_hxp) | (hx << lg_psp) | sp, a warp's 32 indices
      // consecutive, so a cell's PSP indices lie in one warp's chunk (or a
      // chunk in one cell's) and the warp's ballot holds its live bits
      constexpr int CHUNK = Term::NSV > 2 ? K5_STAGE_CHUNK / 2 : K5_STAGE_CHUNK;
      const int psp = 1 << a.lg_psp;
      const int n_stage = (a.ty + 2) << a.lg_hxp;
      const int stride = n_warps * 32;
      for (int t0 = warp * 32; t0 < n_stage; t0 += CHUNK * stride) {
        int cell[CHUNK], sp[CHUNK];
        bool ok[CHUNK], m[CHUNK];
        T2 pos[CHUNK];
        float v[CHUNK][Term::NSV > 0 ? Term::NSV : 1];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const int t = t0 + u * stride + lane;
          const int hy = t >> a.lg_hxp;
          const int j = t & ((1 << a.lg_hxp) - 1);
          const int hxi = j >> a.lg_psp;
          sp[u] = j & (psp - 1);
          cell[u] = hy < a.ty + 2 && hxi < hx ? hy * hx + hxi : -1;
          const int gy = y0 + hy - 1;
          const int gx = x0 + hxi - 1;
          // rows -1 and ny: dead on one device, in the halo form the
          // neighbouring shards' edge rows
          bool halo_row = false;
          bool row_ok = gy >= 0 && gy < a.ny;
          if constexpr (HALO) {
            halo_row = gy == -1 || gy == a.ny;
            row_ok = row_ok || halo_row;
          }
          ok[u] = cell[u] >= 0 && sp[u] < a.Ps && row_ok && gx >= 0 && gx < a.nx;
          m[u] = false;
          if (ok[u]) {
            const bool* mk = a.s_mask;
            const float2* pp = a.s_pos;
            int row = gy;
            if constexpr (HALO) {
              if (halo_row) {
                mk = a.h_mask;
                pp = a.h_pos;
                row = gy < 0 ? 0 : 1;
              }
            }
            const long g = ((long)row * a.nx + gx) * a.Ps + sp[u];
            m[u] = __ldg(reinterpret_cast<const unsigned char*>(mk) + g) != 0;
            pos[u] = mode_pos<M>(a, __ldg(pp + g), gx, gy);
#pragma unroll
            for (int k = 0; k < Term::NSV; ++k) {
              const float* vp = a.sv.p[k];
              if constexpr (HALO) {
                if (halo_row) vp = a.hv.p[k];
              }
              v[u][k] = __ldg(vp + g * a.sv.stride[k]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          if (ok[u]) {
            const int s = cell[u] * a.Ps + sp[u];
            t_pos[s] = pos[u];
            Vals::put(t_val, n_src, s, v[u]);
          }
          const unsigned ballot = __ballot_sync(0xffffffffu, m[u]);
          // one lane per word writes it; cells off the grid are dead
          if (cell[u] >= 0 && sp[u] < a.Ps) {
            if (psp >= 32) {
              if ((sp[u] & 31) == 0) t_bits[cell[u] * a.W + (sp[u] >> 5)] = ballot;
            } else if (sp[u] == 0) {
              t_bits[cell[u]] = (ballot >> (lane - sp[u])) & ((1u << psp) - 1u);
            }
          }
        }
      }
      staged = true;
    }
    __syncthreads();

    const typename M::Consts& tc = term_consts<M>(a);
    const T scalar = term_scalar<M>(a);
    const float min_sq = M::f(M::k(MIN_DISTANCE_SQ));
    // bf16 mode: the views' centre offsets (dxv - 1) bf16(h)
    T cell_b = M::k(0.0f);
    if constexpr (M::BF16) cell_b = __float2bfloat16_rn(a.rb.cell);
    const T delta[3] = {M::neg(cell_b), M::k(0.0f), cell_b};
    // the live queries, one per thread, in slot order
    for (int jj = tid; jj < n_live; jj += blockDim.x) {
      int ly = ly0, lx = lx0;
      long idx = idx0;
      T2 q = qp0;
      T qv[Term::NQV > 0 ? Term::NQV : 1];
#pragma unroll
      for (int k = 0; k < Term::NQV; ++k) qv[k] = qv0[k];
      if (jj != tid) {
        idx = query(jj, ly, lx);
        load_query(idx, ly, lx, q, qv);
      }
      float acc[Term::NACC];
      for (int k = 0; k < Term::NACC; ++k) acc[k] = 0.0f;
      for (int dyv = 0; dyv < 3; ++dyv) {
        for (int dxv = 0; dxv < 3; ++dxv) {
          float view[Term::NACC];
          float* sum = PER_VIEW ? view : acc;
          if (PER_VIEW)
            for (int k = 0; k < Term::NACC; ++k) view[k] = 0.0f;
          T2 off = M::splat(M::k(0.0f));
          if constexpr (M::BF16) off = M::pair(delta[dxv], delta[dyv]);
          const int c = (ly + dyv) * hx + (lx + dxv);
          for (int w = 0; w < a.W; ++w) {
            for (unsigned bits = t_bits[c * a.W + w]; bits != 0u; bits &= bits - 1u) {
              const int s = c * a.Ps + w * 32 + __ffs(bits) - 1;
              // (dx, dy) packed; in bf16 plus the view's centre offsets
              T2 d = M::sub2(t_pos[s], q);
              if constexpr (M::BF16) d = M::add2(d, off);
              const T r_sq = M::sum(M::mul2(d, d));
              const float r_sq_f = M::f(r_sq);
              if (!(r_sq_f <= a.c.radius_sq && r_sq_f > min_sq)) continue;
              T sv[Term::NSV > 0 ? Term::NSV : 1];
              Vals::get(t_val, n_src, s, sv);
              Term::term(sum, d, r_sq, M::sqrt(r_sq), qv, sv, tc, scalar);
            }
          }
          if (PER_VIEW)
            for (int k = 0; k < Term::NACC; ++k) acc[k] += view[k];
        }
      }
      for (int k = 0; k < Term::NACC; ++k) a.out[idx * Term::NACC + k] = acc[k];
    }
    if (q0 + a.q_round < n_tq) __syncthreads();  // the next round reuses the list
  }
}

static inline int log2_exact(int v) { return __builtin_ctz((unsigned)v); }
static inline int log2_ceil(int v) { return v <= 1 ? 0 : 32 - __builtin_clz((unsigned)(v - 1)); }

// gate, gate_i: a pressure loop's state and the launch's iteration (null:
// no gate). HALO: h_pos, h_mask and h_vals (Term::NSV pointers, the strides
// of the source values') are the halo rows. M = Bf16Math: `rb` is the rebase
template <class Term, bool PER_VIEW, bool HALO = false, class M = F32Math>
static int launch(const void* q_pos, const void* q_mask, const void* s_pos,
                  const void* s_mask, const void* const* vals, const int* strides,
                  int n_vals, void* out, int P, int Ps, int ny, int nx, int ty, int tx,
                  int threads, int q_round, int smem, float scalar, const void* gate,
                  int gate_i, const PairConsts* consts, void* stream,
                  const void* h_pos = nullptr,
                  const void* h_mask = nullptr, const void* const* h_vals = nullptr,
                  Rebase rb = Rebase{}) {
  const int W = (Ps + 31) / 32;
  if (n_vals != Term::NQV + Term::NSV || P < 1 || Ps < 1 || ty < 1 || tx < 1 ||
      (ty & (ty - 1)) || (tx & (tx - 1)) || threads < 32 || threads > K5_MAX_THREADS ||
      threads % 32 || q_round < 1 || q_round > K5_MAX_LIST ||
      (size_t)smem != TileSmem(ty, tx, Ps, Term::NSV, W, q_round, M::BF16).total)
    return (int)cudaErrorInvalidValue;
  TileKernelArgs<HALO, M> a;
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
  a.ty = ty;
  a.tx = tx;
  a.lg_ty = log2_exact(ty);
  a.lg_tx = log2_exact(tx);
  a.lg_pp = log2_ceil(P);
  a.lg_psp = log2_ceil(Ps);
  a.lg_hxp = log2_ceil((tx + 2) << a.lg_psp);
  a.W = W;
  a.q_round = q_round;
  a.scalar = scalar;
  a.c = *consts;
  a.gate = static_cast<const int*>(gate);
  a.gate_i = gate_i;
  if constexpr (HALO) {
    a.h_pos = static_cast<const float2*>(h_pos);
    a.h_mask = static_cast<const bool*>(h_mask);
    for (int k = 0; k < TILE_MAX_VALS; ++k) {
      a.hv.p[k] = k < Term::NSV ? static_cast<const float*>(h_vals[k]) : nullptr;
      a.hv.stride[k] = k < Term::NSV ? a.sv.stride[k] : 0;
    }
  }
  if constexpr (M::BF16) {
    a.rb = rb;
    a.cb = bf16_consts_of(*consts);
    a.scalar_b = __float2bfloat16_rn(scalar);
  }
  if ((long)ny * nx * P == 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tile_pair_reduce_kernel<Term, PER_VIEW, HALO, M>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty);
  tile_pair_reduce_kernel<Term, PER_VIEW, HALO, M>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K5's call forms, as X(NAME, TERM) with TERM a template of the math mode,
// for the launcher macros of csrc/tile_pair_reduce.cu and
// csrc/tile_pair_reduce_halo.cu: the DFSPH padded step's four (ctx serves
// the fluid and the boundary), the WCSPH padded step's three, then the
// physical viscosity forms of both (the JAX XLA closures' order)
template <class M>
using ViscXsphTerm = ViscTerm<XsphCoef, M>;
template <class M>
using ViscPhysTerm = ViscTerm<PhysCoef, M>;
template <class M>
using WcsphForcesXsphXlaTerm = WcsphForcesXlaTerm<XsphCoef, M>;
template <class M>
using WcsphForcesPhysXlaTerm = WcsphForcesXlaTerm<PhysCoef, M>;
#define K5_PAIR_FORMS(X)                   \
  X(dfsph_ctx, CtxXlaTerm)                 \
  X(dfsph_div, DivXlaTerm)                 \
  X(dfsph_corr, CorrXlaTerm)               \
  X(dfsph_visc, ViscXsphTerm)              \
  X(wcsph_density, WcsphDensityTermT)      \
  X(wcsph_stat, WcsphStatTermT)            \
  X(wcsph_forces, WcsphForcesXsphXlaTerm)  \
  X(dfsph_visc_phys, ViscPhysTerm)         \
  X(wcsph_forces_phys, WcsphForcesPhysXlaTerm)
