// K4: per-step neighbourhood rebuild in the padded slot-major layout (windowed
// re-bucket), with its move codes, new mask and drop count.
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py sm_rebucket
// (body _sm_rebucket_kernel) together with its move codes (dense_grid
// move_codes). Every live slot has a move code 1..9 naming the cell of its
// advected position inside the old 3x3 window (0 = dead slot;
// csrc/move_code.cuh, shared with K2, bit for bit the JAX codes). Each target
// cell (y, x) takes the slots of its 3x3 source cells whose code points at it,
// (2-dyv)*3 + (2-dxv) + 1, in (dyv, dxv, sp) order; the k-th of them fills
// its slot k while k < P (position and every payload component), the slots
// beyond the hits get zeros, and its new mask is k < total. The arrivals
// beyond P are dropped and their count added to one int32 counter.
//
// Exact: payloads are copied, never summed, so the output is bit-equal to the
// plain twin (ops/sm_rebucket.py sm_rebucket_ref) and the JAX kernel. The TPU
// kernel accumulates each hit onto +0.0, which turns a -0.0 payload into
// +0.0; the copy below adds +0.0 for the same reason.
//
// Layout: mask (ny, nx, P) bool, positions (ny, nx, P, 2) f32 read as float2;
// the payload as parts, each (ny, nx, P, C) f32 (C = 1 for an (ny, nx, P)
// part) read through its pointer with element stride C, and written to an
// output of its own shape; new positions and mask as the inputs; dropped ()
// int32.
//
// Design: the whole re-bucket is this one launch (plus a 4-byte memset of the
// drop counter). One block of 256 threads per SR_TY x SR_TX tile of target
// cells.
//  1. Staging. The block reads the mask of its haloed (SR_TY+2) x (SR_TX+2) x
//     P source tile, flat in memory order (a halo row of cells is one
//     contiguous run of slots, so a warp's loads coalesce), every mask load of
//     a thread issued before the first is used, then the positions of the
//     live slots likewise. Each live slot's move code sets bit sp of the word
//     (code, cell) in shared memory: nine words per staged cell (ceil(P/32)
//     words each when P > 32), one per direction a slot can leave in. Cells
//     off the grid stage as dead, so ragged tiles need no padded copy. A tile
//     whose halo holds no live slot skips the search below.
//  2. Output slots in parallel. Thread o of the tile takes target slot
//     (cell, k) in memory order: from the nine words its cell reads (one per
//     view, the direction that points at it) it counts the arrivals, view by
//     view, up to the k-th, and takes that slot's position and payload from
//     device memory; the same popcounts give the cell's total, whose overflow
//     max(total - P, 0) its slot 0 adds to a per-warp sum, added to the drop
//     counter by integer atomicAdd (exact, whatever the order). Consecutive
//     lanes store consecutive slots: a row of SR_TX target cells is one
//     contiguous run of SR_TX x P x C floats of each output, dead slots'
//     zeros included, and two-component parts store as float2.
//  Slot decodes divide by P with a multiply-high by a 32-bit reciprocal,
//  exact for the index range of a tile.
//  P > SR_STAGED_MAX_P (the nine words per cell no longer fit one block's
//  shared memory) takes a slower route in the same launch: one thread per
//  target cell scans its 9 x P source slots in device memory.
//
// Halo form (template parameter HALO, args HaloSrArgs, launcher
// sm_rebucket_halo), for spatial sharding over cell rows
// (parallel/shard_dense.py): the source rows -1 and ny, dead on one device,
// are the neighbouring shards' edge rows of the mask, the positions and every
// payload part (h_mask (2, nx, P), h_pos (2, nx, P) float2, h_in[j]
// (2, nx, P, c_j); row -1 at index 0), which the caller exchanged; at the ends
// of the mesh they arrive dead. Every move code, the halo rows' too, is taken
// against global rows: row gy is cell row row0 + gy (row0 = 0 on one device)
// and MoveGrid's ny is the global row count. So a slot that crosses the seam
// into an edge row arrives from the halo, one that leaves is taken by the
// neighbour, and the drops are this shard's. The JAX package's sharded padded
// route runs this re-bucket in XLA (dense_grid.rebucket(row0=...)), whose halo
// carries the neighbours' codes and payload; K4 computes the halo rows' codes
// itself, as K2's halo form does. One body serves both forms (template
// parameter EDGE of the tile): only the tiles of the first and the last block
// row reach rows -1 and ny, so only they stage a halo row (one extra pass over
// that row's run of slots, its pointers picked once) and choose, per hit,
// between the grid's and the halo rows' arrays; every other tile of a shard
// runs the one-device path. Slots are numbered in 32 bits, a hit's row in the
// grid or in the halo rows with a flag beside it; the launcher refuses a grid
// whose slot index would not fit (a 100k shard holds 515 x 163 x 7 slots, the
// 1M grid 1612 x 1010 x 7, about 11.4 M). The direct route (P >
// SR_STAGED_MAX_P) does the same per target cell: only the cells of the first
// and the last row read a halo row.
//
// What bounds it on the H100: device-memory bytes. It must write every output
// slot (28 MB at 100k with D = 4) and read the mask and the live slots'
// positions and payload once. The first K4 ran one thread per target cell
// with 9 x P serial code-byte loads, stored P x (2 + D) floats a lane apart,
// and took its move codes (~12 launches) and its mask and drop count (~6
// launches) from glue around it, and the DFSPH step concatenated and split its
// payload around that.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "move_code.cuh"

#define SR_TY 8
#define SR_TX 32
#define SR_THREADS 256
#define SR_HX (SR_TX + 2)
#define SR_HC ((SR_TY + 2) * SR_HX)
#define SR_MAX_PARTS 8
#define SR_STAGE_UNROLL 10  // staged slots per thread whose loads are issued together
#define SR_MAX_WORDS 18     // 9 x SR_HC x 18 words = 220,320 bytes of shared memory
#define SR_STAGED_MAX_P (32 * SR_MAX_WORDS)

struct SrPart {
  const float* in;  // (ny, nx, P, c)
  float* out;       // (ny, nx, P, c)
  int c;
};

struct SrArgs {
  const bool* mask;    // (ny, nx, P)
  const float2* pos;   // (ny, nx, P)
  SrPart part[SR_MAX_PARTS];
  int n_parts;
  float2* out_pos;     // (ny, nx, P)
  bool* new_mask;      // (ny, nx, P)
  int* dropped;        // (), zeroed by the launcher
  int P, ny, nx;
  int W;               // 32-bit live words per (code, cell): ceil(P / 32)
  unsigned magic;      // floor((2^32 - 1) / P) + 1: t / P = umulhi(t, magic)
  int row0;            // the grid's first global cell row (a shard's; 0 on one device)
  MoveGrid mg;
};

// the halo form's arguments: rows -1 (index 0) and ny (index 1)
struct HaloSrArgs : SrArgs {
  const bool* h_mask;                // (2, nx, P)
  const float2* h_pos;               // (2, nx, P)
  const float* h_in[SR_MAX_PARTS];   // (2, nx, P, c) each
};

template <bool HALO>
using SrKernelArgs = std::conditional_t<HALO, HaloSrArgs, SrArgs>;

// t / P for 0 <= t < 2^32 / P (a tile's slot indices at P <= SR_STAGED_MAX_P)
__device__ __forceinline__ int div_p(int t, const SrArgs& a) {
  return a.P == 1 ? t : (int)__umulhi((unsigned)t, a.magic);
}

// source slot `src`'s position and payload (+0.0 added) to slot `dst`, or
// zeros for src < 0; under EDGE with `halo` set, src indexes the halo rows
template <bool EDGE, class A>
__device__ __forceinline__ void write_slot(const A& a, int dst, int src, bool halo) {
  const float2 zero = make_float2(0.0f, 0.0f);
  float2 p = zero;
  if (src >= 0) {
    const float2* pp = a.pos;
    if constexpr (EDGE) {
      if (halo) pp = a.h_pos;
    }
    const float2 q = __ldg(pp + src);
    p = make_float2(0.0f + q.x, 0.0f + q.y);
  }
  a.out_pos[dst] = p;
#pragma unroll
  for (int j = 0; j < SR_MAX_PARTS; ++j) {  // unrolled: the parts stay in parameter space
    if (j >= a.n_parts) break;
    const SrPart pt = a.part[j];
    const float* in = pt.in;
    if constexpr (EDGE) {
      if (halo) in = a.h_in[j];
    }
    if (pt.c == 2) {
      float2 v = zero;
      if (src >= 0) v = make_float2(0.0f + __ldg(in + 2 * src), 0.0f + __ldg(in + 2 * src + 1));
      reinterpret_cast<float2*>(pt.out)[dst] = v;
    } else {
      for (int i = 0; i < pt.c; ++i)
        pt.out[dst * pt.c + i] = src >= 0 ? 0.0f + __ldg(in + src * pt.c + i) : 0.0f;
    }
  }
  a.new_mask[dst] = src >= 0;
}

// One tile of the staged route. EDGE: a halo form's tile in the first or the
// last block row, whose source rows -1 and ny are the halo rows
template <bool EDGE, class A>
__device__ __forceinline__ void staged_tile(const A& a) {
  extern __shared__ unsigned bits[];  // [9 codes][SR_HC cells][W words]
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * SR_TY;
  const int x0 = blockIdx.x * SR_TX;
  const int W = a.W;
  for (int i = tid; i < 9 * SR_HC * W; i += SR_THREADS) bits[i] = 0u;
  __syncthreads();

  // 1. move codes of the haloed source tile's live slots, as bits
  const int n_stage = SR_HC * a.P;
  bool seen = false;
  for (int base = tid; base < n_stage; base += SR_STAGE_UNROLL * SR_THREADS) {
    int g[SR_STAGE_UNROLL], cell[SR_STAGE_UNROLL], sp[SR_STAGE_UNROLL];
    bool m[SR_STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < SR_STAGE_UNROLL; ++u) {
      const int t = base + u * SR_THREADS;
      const int c = div_p(t, a);
      const int hy = c / SR_HX;
      const int gy = y0 + hy - 1;
      const int gx = x0 + (c - hy * SR_HX) - 1;
      cell[u] = c;
      sp[u] = t - c * a.P;
      g[u] = -1;
      m[u] = false;
      if (t < n_stage && gy >= 0 && gy < a.ny && gx >= 0 && gx < a.nx) {
        g[u] = (gy * a.nx + gx) * a.P + sp[u];
        m[u] = __ldg(reinterpret_cast<const unsigned char*>(a.mask) + g[u]) != 0;
      }
    }
    float2 q[SR_STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < SR_STAGE_UNROLL; ++u)
      q[u] = m[u] ? __ldg(a.pos + g[u]) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < SR_STAGE_UNROLL; ++u) {
      if (!m[u]) continue;
      const int hy = cell[u] / SR_HX;
      const int code = move_code(q[u].x, q[u].y, a.row0 + y0 + hy - 1,
                                 x0 + (cell[u] - hy * SR_HX) - 1, a.mg);
      atomicOr(&bits[((code - 1) * SR_HC + cell[u]) * W + (sp[u] >> 5)], 1u << (sp[u] & 31));
      seen = true;
    }
  }
  if constexpr (EDGE) {
    // rows -1 and ny where the tile reaches them: the run of the tile's
    // columns in that halo row, its pointers picked once
    for (int r = 0; r < 2; ++r) {
      const int gy = r == 0 ? -1 : a.ny;
      const int hy = gy - y0 + 1;
      if (hy < 0 || hy >= SR_TY + 2) continue;
      const bool* hm = a.h_mask + r * a.nx * a.P;
      const float2* hp = a.h_pos + r * a.nx * a.P;
      const int gx0 = max(x0 - 1, 0);
      const int n_run = (min(x0 + SR_TX + 1, a.nx) - gx0) * a.P;
      for (int t = tid; t < n_run; t += SR_THREADS) {
        const int o = gx0 * a.P + t;  // slot of the halo row
        if (__ldg(reinterpret_cast<const unsigned char*>(hm) + o) == 0) continue;
        const float2 q = __ldg(hp + o);
        const int gx = div_p(o, a);
        const int sp = o - gx * a.P;
        const int code = move_code(q.x, q.y, a.row0 + gy, gx, a.mg);
        atomicOr(&bits[((code - 1) * SR_HC + hy * SR_HX + (gx - x0 + 1)) * W + (sp >> 5)],
                 1u << (sp & 31));
        seen = true;
      }
    }
  }
  const bool any = __syncthreads_or(seen);

  // 2. every target slot of the tile, in memory order
  const int n_out = SR_TY * SR_TX * a.P;
  int over = 0;
  for (int o = tid; o < n_out; o += SR_THREADS) {
    const int cl = div_p(o, a);
    const int k = o - cl * a.P;
    const int ly = cl / SR_TX;
    const int lx = cl - ly * SR_TX;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= a.ny || x >= a.nx) continue;
    int src = -1;
    bool halo = false;
    if (any) {
      int total = 0;
      for (int dyv = 0; dyv < 3; ++dyv) {
        for (int dxv = 0; dxv < 3; ++dxv) {
          // the source cell's slots whose code points at this cell
          const int code = (2 - dyv) * 3 + (2 - dxv);  // minus 1
          const unsigned* wp = bits + (code * SR_HC + (ly + dyv) * SR_HX + (lx + dxv)) * W;
          for (int w = 0; w < W; ++w) {
            unsigned word = wp[w];
            const int n = __popc(word);
            if (src < 0 && k < total + n) {
              for (int r = k - total; r > 0; --r) word &= word - 1u;
              int row = y + dyv - 1;
              if constexpr (EDGE) {
                halo = row < 0 || row >= a.ny;
                if (halo) row = row < 0 ? 0 : 1;
              }
              src = (row * a.nx + (x + dxv - 1)) * a.P + w * 32 + __ffs(word) - 1;
            }
            total += n;
          }
        }
      }
      if (k == 0) over += max(total - a.P, 0);
    }
    write_slot<EDGE>(a, (y * a.nx + x) * a.P + k, src, halo);
  }
  // every lane of the warp takes part (the loop above has no early return)
  over = __reduce_add_sync(0xffffffffu, over);
  if ((tid & 31) == 0 && over > 0) atomicAdd(a.dropped, over);
}

// HALO: the halo form, whose first and last block rows take the edge tiles'
// path; every other tile is the one-device kernel's
template <bool HALO>
__global__ void __launch_bounds__(SR_THREADS) sm_rebucket_staged(const SrKernelArgs<HALO> a) {
  if constexpr (HALO) {
    if (blockIdx.y == 0 || blockIdx.y == gridDim.y - 1) {
      staged_tile<true>(a);
      return;
    }
  }
  staged_tile<false>(a);
}

// P > SR_STAGED_MAX_P: target cell (y, x) scans its 9 x P source slots in
// device memory, codes computed in place; returns its arrivals. EDGE: rows
// -1 and ny from the halo rows
template <bool EDGE, class A>
__device__ __forceinline__ int direct_cell(const A& a, int y, int x, int first) {
  int k = 0;
  for (int dyv = 0; dyv < 3; ++dyv) {
    const int sy = y + dyv - 1;
    int row = sy;
    bool halo = false;
    const bool* mask = a.mask;
    const float2* pos = a.pos;
    if (sy < 0 || sy >= a.ny) {
      if constexpr (!EDGE) continue;
      halo = true;
      row = sy < 0 ? 0 : 1;
      if constexpr (EDGE) {
        mask = a.h_mask;
        pos = a.h_pos;
      }
    }
    for (int dxv = 0; dxv < 3; ++dxv) {
      const int sx = x + dxv - 1;
      if (sx < 0 || sx >= a.nx) continue;
      const int expected = (2 - dyv) * 3 + (2 - dxv) + 1;
      const int base = (row * a.nx + sx) * a.P;
      for (int sp = 0; sp < a.P; ++sp) {
        if (!mask[base + sp]) continue;
        const float2 q = pos[base + sp];
        if (move_code(q.x, q.y, a.row0 + sy, sx, a.mg) != expected) continue;
        if (k < a.P) write_slot<EDGE>(a, first + k, base + sp, halo);
        ++k;
      }
    }
  }
  return k;
}

// P > SR_STAGED_MAX_P: one thread per target cell; in the halo form only the
// cells of the first and the last row take the halo rows' path
template <bool HALO>
__global__ void __launch_bounds__(SR_THREADS) sm_rebucket_direct(const SrKernelArgs<HALO> a) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = cell < a.ny * a.nx;
  int k = 0;
  if (inside) {
    const int y = cell / a.nx;
    const int x = cell - y * a.nx;
    const int first = cell * a.P;
    if (HALO && (y == 0 || y == a.ny - 1))
      k = direct_cell<HALO>(a, y, x, first);
    else
      k = direct_cell<false>(a, y, x, first);
    for (int s = min(k, a.P); s < a.P; ++s) write_slot<false>(a, first + s, -1, false);
  }
  const int over = __reduce_add_sync(0xffffffffu, inside ? max(k - a.P, 0) : 0);
  if ((threadIdx.x & 31) == 0 && over > 0) atomicAdd(a.dropped, over);
}

// HALO: h_mask, h_pos and h_in (n_parts pointers) are the halo rows, row0 the
// shard's first global row and grid_ny the global row count. Refuses a grid
// whose slot indices, times a part's width, would not fit 32 bits
template <bool HALO>
static int sm_rebucket_launch(const void* mask, const void* pos, const void* const* part_in,
                              void* const* part_out, const int* part_c, int n_parts,
                              void* out_pos, void* new_mask, void* dropped, int P, int ny,
                              int nx, int grid_nx, int grid_ny, float inv, float ox, float oy,
                              void* stream, const void* h_mask = nullptr,
                              const void* h_pos = nullptr, const void* const* h_in = nullptr,
                              int row0 = 0) {
  if (n_parts < 0 || n_parts > SR_MAX_PARTS || P < 1 || ny < 0 || nx < 0)
    return (int)cudaErrorInvalidValue;
  SrKernelArgs<HALO> a;
  int widest = 2;
  for (int j = 0; j < SR_MAX_PARTS; ++j) {
    a.part[j] = SrPart{nullptr, nullptr, 0};
    if (j < n_parts) {
      if (part_c[j] < 1) return (int)cudaErrorInvalidValue;
      a.part[j] = SrPart{static_cast<const float*>(part_in[j]), static_cast<float*>(part_out[j]),
                         part_c[j]};
      widest = part_c[j] > widest ? part_c[j] : widest;
    }
  }
  if ((long long)(ny + 2) * nx * P * widest > INT_MAX) return (int)cudaErrorInvalidValue;
  if constexpr (HALO) {
    a.h_mask = static_cast<const bool*>(h_mask);
    a.h_pos = static_cast<const float2*>(h_pos);
    for (int j = 0; j < SR_MAX_PARTS; ++j)
      a.h_in[j] = j < n_parts ? static_cast<const float*>(h_in[j]) : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dropped, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  a.mask = static_cast<const bool*>(mask);
  a.pos = static_cast<const float2*>(pos);
  a.n_parts = n_parts;
  a.out_pos = static_cast<float2*>(out_pos);
  a.new_mask = static_cast<bool*>(new_mask);
  a.dropped = static_cast<int*>(dropped);
  a.P = P;
  a.ny = ny;
  a.nx = nx;
  a.W = (P + 31) / 32;
  a.magic = (unsigned)(0xFFFFFFFFull / (unsigned long long)P + 1ull);
  a.row0 = row0;
  a.mg = MoveGrid{grid_nx, grid_ny, inv, ox, oy};
  const long cells = (long)ny * nx;
  if (cells == 0) return (int)cudaSuccess;
  if (P > SR_STAGED_MAX_P) {
    const int blocks = (int)((cells + SR_THREADS - 1) / SR_THREADS);
    sm_rebucket_direct<HALO><<<blocks, SR_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)9 * SR_HC * a.W * sizeof(unsigned);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sm_rebucket_staged<HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nx + SR_TX - 1) / SR_TX, (ny + SR_TY - 1) / SR_TY);
  sm_rebucket_staged<HALO><<<grid, SR_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int sm_rebucket(const void* mask, const void* pos, const void* const* part_in,
                           void* const* part_out, const int* part_c, int n_parts,
                           void* out_pos, void* new_mask, void* dropped, int P, int ny,
                           int nx, int grid_nx, int grid_ny, float inv, float ox, float oy,
                           void* stream) {
  return sm_rebucket_launch<false>(mask, pos, part_in, part_out, part_c, n_parts, out_pos,
                                   new_mask, dropped, P, ny, nx, grid_nx, grid_ny, inv, ox, oy,
                                   stream);
}

// the halo form: grid_ny is the global row count
extern "C" int sm_rebucket_halo(const void* mask, const void* pos, const void* const* part_in,
                                void* const* part_out, const int* part_c, int n_parts,
                                void* out_pos, void* new_mask, void* dropped, int P, int ny,
                                int nx, int grid_nx, int grid_ny, float inv, float ox,
                                float oy, const void* h_mask, const void* h_pos,
                                const void* const* h_in, int row0, void* stream) {
  return sm_rebucket_launch<true>(mask, pos, part_in, part_out, part_c, n_parts, out_pos,
                                  new_mask, dropped, P, ny, nx, grid_nx, grid_ny, inv, ox, oy,
                                  stream, h_mask, h_pos, h_in, row0);
}
