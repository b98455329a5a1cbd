// The DFSPH pressure loops' glue between K5's (or K3's) two passes of an
// iteration, fused: two launches an iteration in place of the torch
// operations of models/dfsph_dense.py DFSPHSlotSolver's loops (the plain
// twins are in ops/pressure_glue.py). It replaces no TPU kernel: the JAX
// package leaves this glue to XLA, which fuses it.
//
//   slot_pressure_err   after the div pass: delta = div + v . sgs, the loop's
//                       error of it (DENSITY: clamp(rho + (delta m) dt, rho0)
//                       - rho0; else clamp(delta m, 0), 0 where the slot has
//                       fewer than 9 neighbours), k_i = err alpha,
//                       k_sum += k_i, and the sum of err over the live slots
//   slot_pressure_kick  after the corr pass: v -= scale (corr + k sgs)
//
// Exact: each slot runs the twin's float32 operations in the twin's order,
// none fused (-fmad=false), so every slot a kernel writes holds the twin's
// bits. The clamps are torch's on the card: a NaN passes, else fmaxf. The
// residual's sum is taken in another order than torch.sum, but in a fixed
// one: warp shuffles, block partials, and the last block to finish (by an
// integer ticket) sums the partials in block order, so a launch on the same
// inputs gives the same bits.
//
// Layout: slot-major (ny, nx, P[, 2]) contiguous tensors, read as n slots in
// quads of four consecutive slots: a quad's mask is one 32-bit word, its
// scalars one float4 and its two-component values two float4s (the wrapper
// refuses a pointer that is not 16-byte aligned); a last quad past n loads
// slot by slot.
//
// What bounds it on the H100: device-memory bytes. At 1M particles on the
// 1614 x 1013 x 7 grid 9% of the 11.4 M slots are live, and torch's 19 passes
// an iteration read and write every slot. Here a thread loads the mask words
// of its PG_QUADS quads first, then only the quads that hold a live slot
// (every quad without `dead_zero`), all of them in flight together, and
// writes only those: a warp over air issues no value load. An all-dead quad
// is left as it is, which is the twin's bits where K5 wrote its pass outputs
// (+0.0 at dead query slots, so sgs, div and corr are +0.0 there) and a dead
// slot's density is rho0: then its error is +0.0, k_i is +0.0, and v - scale
// (+0 + k_i (+0)) and k_sum + k_i leave v and k_sum as they are. K3 writes
// no such zeros: without `dead_zero` every quad is loaded and written.
//
// In place: k_sum, k_i and v are the loop's own tensors (created in the
// step, never the carry); each slot is read, then written by the same
// thread.
//
// The loop's exit test on the device (the host enqueues iterations ahead of
// it, models/dfsph_dense.py): with a `state` (two ints, zero before the
// loop's first launch: the index of the loop's last iteration to run, then
// the bits of the last run iteration's average), a launch of iteration `it`
// returns at once, writing nothing, unless it <= state[0]. The error
// kernel's last block then does the host's test on the total, in float32 in
// the host's order: mean = total / n_live, ratio = mean / rho0; the loop goes
// on while ratio * dt >= tol and it + 1 <= max_it (at most max_it + 1
// iterations), so it sets state[0] = it + 1; it writes the average the host
// reports (DENSITY: mean; else ratio) to state[1]. Without -fmad and fast
// math these are the host's IEEE operations, so the decision is the host's,
// bit for bit. The kick of the iteration that stops the loop still runs, as
// in the host loop. A gated launch's blocks all read state[0] before any
// takes a ticket, and only the last writes it, so they agree.

#include <cuda_runtime.h>
#include <limits.h>

#define PG_THREADS 256
#define PG_QUADS 2  // quads a thread, PG_THREADS apart: every access coalesces

// quad k of thread threadIdx.x of this block
#define PG_QUAD(k) \
  ((int)blockIdx.x * (PG_THREADS * PG_QUADS) + (k) * PG_THREADS + (int)threadIdx.x)

// the mask bytes of quad q (slot 4q + j in byte j); 0 past the end
__device__ __forceinline__ unsigned quad_mask(const unsigned char* mask, int q, int n) {
  const int s = 4 * q;
  if (s + 4 <= n) return __ldg(reinterpret_cast<const unsigned*>(mask) + q);
  unsigned w = 0u;
  for (int j = 0; j < 4; ++j)
    if (s + j < n) w |= (unsigned)__ldg(mask + s + j) << (8 * j);
  return w;
}

__device__ __forceinline__ bool slot_live(unsigned word, int j) {
  return ((word >> (8 * j)) & 0xffu) != 0u;
}

__device__ __forceinline__ void load4(const float* p, int q, int n, float (&x)[4]) {
  const int s = 4 * q;
  if (s + 4 <= n) {
    const float4 t = *(reinterpret_cast<const float4*>(p) + q);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    for (int j = 0; j < 4; ++j) x[j] = s + j < n ? p[s + j] : 0.0f;
  }
}

__device__ __forceinline__ void load4x2(const float* p, int q, int n, float (&x)[4],
                                        float (&y)[4]) {
  const int s = 4 * q;
  if (s + 4 <= n) {
    const float4 a = *(reinterpret_cast<const float4*>(p) + 2 * q);
    const float4 b = *(reinterpret_cast<const float4*>(p) + 2 * q + 1);
    x[0] = a.x, y[0] = a.y, x[1] = a.z, y[1] = a.w;
    x[2] = b.x, y[2] = b.y, x[3] = b.z, y[3] = b.w;
  } else {
    for (int j = 0; j < 4; ++j) {
      x[j] = s + j < n ? p[2 * (s + j)] : 0.0f;
      y[j] = s + j < n ? p[2 * (s + j) + 1] : 0.0f;
    }
  }
}

__device__ __forceinline__ void store4(float* p, int q, int n, const float (&x)[4]) {
  const int s = 4 * q;
  if (s + 4 <= n) {
    *(reinterpret_cast<float4*>(p) + q) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    for (int j = 0; j < 4; ++j)
      if (s + j < n) p[s + j] = x[j];
  }
}

__device__ __forceinline__ void store4x2(float* p, int q, int n, const float (&x)[4],
                                         const float (&y)[4]) {
  const int s = 4 * q;
  if (s + 4 <= n) {
    *(reinterpret_cast<float4*>(p) + 2 * q) = make_float4(x[0], y[0], x[1], y[1]);
    *(reinterpret_cast<float4*>(p) + 2 * q + 1) = make_float4(x[2], y[2], x[3], y[3]);
  } else {
    for (int j = 0; j < 4; ++j)
      if (s + j < n) p[2 * (s + j)] = x[j], p[2 * (s + j) + 1] = y[j];
  }
}

// torch.clamp(x, min=lo) on the card: a NaN passes, else fmaxf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// the block's sum of each thread's s, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < PG_THREADS / 32 ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// rho_or_count: DENSITY the slots' densities, else their neighbour totals.
// partials: a float a block; ticket: zero before the launch, zero after it;
// state: the loop's (module comment), or null for no gate and no test
template <bool DENSITY>
__global__ void __launch_bounds__(PG_THREADS)
    slot_pressure_err_kernel(const unsigned char* __restrict__ mask,
                             const float* __restrict__ div, const float* __restrict__ v,
                             const float* __restrict__ sgs,
                             const float* __restrict__ rho_or_count,
                             const float* __restrict__ alpha, float* ki, float* k_sum,
                             float* __restrict__ partials, unsigned* __restrict__ ticket,
                             float* __restrict__ total, int n, float m, float dt, float rho0,
                             bool dead_zero, int* state, int it, float n_live, float tol,
                             int max_it) {
  __shared__ float warp_sums[PG_THREADS / 32];
  __shared__ bool last;
  if (state != nullptr && it > state[0]) return;
  const int nq = n / 4 + (n % 4 != 0);
  unsigned word[PG_QUADS];
  bool on[PG_QUADS];
#pragma unroll
  for (int k = 0; k < PG_QUADS; ++k) {
    const int q = PG_QUAD(k);
    word[k] = q < nq ? quad_mask(mask, q, n) : 0u;
    on[k] = q < nq && (!dead_zero || word[k] != 0u);
  }
  float d[PG_QUADS][4], vx[PG_QUADS][4], vy[PG_QUADS][4], sx[PG_QUADS][4], sy[PG_QUADS][4],
      r[PG_QUADS][4], a[PG_QUADS][4], ks[PG_QUADS][4];
#pragma unroll
  for (int k = 0; k < PG_QUADS; ++k) {
    if (!on[k]) continue;
    const int q = PG_QUAD(k);
    load4(div, q, n, d[k]);
    load4x2(v, q, n, vx[k], vy[k]);
    load4x2(sgs, q, n, sx[k], sy[k]);
    load4(rho_or_count, q, n, r[k]);
    load4(alpha, q, n, a[k]);
    load4(k_sum, q, n, ks[k]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < PG_QUADS; ++k) {
    if (!on[k]) continue;
    float kio[4], kso[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float delta = d[k][j] + (vx[k][j] * sx[k][j] + vy[k][j] * sy[k][j]);
      float err;
      if (DENSITY) {
        err = clamp_min(r[k][j] + (delta * m) * dt, rho0) - rho0;
      } else {
        err = clamp_min(delta * m, 0.0f);
        err = r[k][j] < 9.0f ? 0.0f : err;
      }
      kio[j] = err * a[k][j];
      kso[j] = ks[k][j] + kio[j];
      if (slot_live(word[k], j)) sum += err;
    }
    store4(ki, PG_QUAD(k), n, kio);
    store4(k_sum, PG_QUAD(k), n, kso);
  }
  const float s = block_sum(sum, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partial, in block order
  float t = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += PG_THREADS) t += __ldcg(partials + b);
  t = block_sum(t, warp_sums);
  if (threadIdx.x == 0) {
    *total = t;
    *ticket = 0u;
    if (state != nullptr) {
      const float mean = t / n_live;
      const float ratio = mean / rho0;
      if (ratio * dt >= tol && it + 1 <= max_it) state[0] = it + 1;
      state[1] = __float_as_int(DENSITY ? mean : ratio);
    }
  }
}

__global__ void __launch_bounds__(PG_THREADS)
    slot_pressure_kick_kernel(const unsigned char* __restrict__ mask, float* v,
                              const float* __restrict__ corr, const float* __restrict__ k,
                              const float* __restrict__ sgs, int n, float scale,
                              bool dead_zero, const int* state, int it) {
  if (state != nullptr && it > state[0]) return;
  const int nq = n / 4 + (n % 4 != 0);
  bool on[PG_QUADS];
#pragma unroll
  for (int i = 0; i < PG_QUADS; ++i) {
    const int q = PG_QUAD(i);
    on[i] = q < nq && (!dead_zero || quad_mask(mask, q, n) != 0u);
  }
  float vx[PG_QUADS][4], vy[PG_QUADS][4], cx[PG_QUADS][4], cy[PG_QUADS][4], kk[PG_QUADS][4],
      sx[PG_QUADS][4], sy[PG_QUADS][4];
#pragma unroll
  for (int i = 0; i < PG_QUADS; ++i) {
    if (!on[i]) continue;
    const int q = PG_QUAD(i);
    load4x2(v, q, n, vx[i], vy[i]);
    load4x2(corr, q, n, cx[i], cy[i]);
    load4(k, q, n, kk[i]);
    load4x2(sgs, q, n, sx[i], sy[i]);
  }
#pragma unroll
  for (int i = 0; i < PG_QUADS; ++i) {
    if (!on[i]) continue;
    float ox[4], oy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ox[j] = vx[i][j] - scale * (cx[i][j] + kk[i][j] * sx[i][j]);
      oy[j] = vy[i][j] - scale * (cy[i][j] + kk[i][j] * sy[i][j]);
    }
    store4x2(v, PG_QUAD(i), n, ox, oy);
  }
}

// blocks of a launch over n slots, at least one (n = 0 still sums, and
// tests, nothing); false where n is out of range (a two-component tensor's
// 2n floats are indexed with int)
static bool grid_of(int n, dim3* blocks) {
  const int per_block = PG_THREADS * PG_QUADS * 4;
  if (n < 0 || n > INT_MAX / 2 - per_block) return false;
  *blocks = dim3((unsigned)((n + per_block - 1) / per_block + (n == 0)));
  return true;
}

extern "C" int slot_pressure_blocks(int n) {
  dim3 blocks;
  return grid_of(n, &blocks) ? (int)blocks.x : -1;
}

// scratch: slot_pressure_blocks(n) partials, then the ticket (zero before
// the first launch; each launch leaves it zero); total: a 0-d float32;
// state, it, n_live, tol, max_it: the loop's state and the exit test
// (module comment), state null for an ungated launch without a test
extern "C" int slot_pressure_err(const void* mask, const void* div, const void* v,
                                 const void* sgs, const void* rho_or_count, const void* alpha,
                                 void* ki, void* k_sum, void* scratch, void* total, int n,
                                 float m, float dt, float rho0, int density, int dead_zero,
                                 void* state, int it, float n_live, float tol, int max_it,
                                 void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partials = static_cast<float*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + blocks.x);
  auto kernel = density ? slot_pressure_err_kernel<true> : slot_pressure_err_kernel<false>;
  kernel<<<blocks, PG_THREADS, 0, s>>>(
      static_cast<const unsigned char*>(mask), static_cast<const float*>(div),
      static_cast<const float*>(v), static_cast<const float*>(sgs),
      static_cast<const float*>(rho_or_count), static_cast<const float*>(alpha),
      static_cast<float*>(ki), static_cast<float*>(k_sum), partials, ticket,
      static_cast<float*>(total), n, m, dt, rho0, dead_zero != 0, static_cast<int*>(state), it,
      n_live, tol, max_it);
  return (int)cudaGetLastError();
}

// state, it: the loop's state and the launch's iteration (state null: no gate)
extern "C" int slot_pressure_kick(const void* mask, void* v, const void* corr, const void* k,
                                  const void* sgs, int n, float scale, int dead_zero,
                                  const void* state, int it, void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  slot_pressure_kick_kernel<<<blocks, PG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<float*>(v),
      static_cast<const float*>(corr), static_cast<const float*>(k),
      static_cast<const float*>(sgs), n, scale, dead_zero != 0,
      static_cast<const int*>(state), it);
  return (int)cudaGetLastError();
}
