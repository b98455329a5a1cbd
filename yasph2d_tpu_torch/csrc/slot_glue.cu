// The padded WCSPH step's glue between its kernels, fused: four launches a
// step in place of the torch operations of models/wcsph_dense.py
// WCSPHPaddedSolver.step (the plain twins are in ops/slot_glue.py).
//
//   slot_kick_drift    v' = v + (0.5 dt) a, pos' = pos + v' dt (leapfrog part 1)
//   slot_density_tait  dens = clamp(m ((W0 + dyn) + stat0), rho0) and Tait's
//                      pressure of it (models/wcsph.py tait_pressure)
//   slot_accel_cfl     accel = where(mask, (accel_dyn + stat12) + g, 0), and
//                      the max over the live slots of |v + accel dt|^2
//   slot_kick          v + (0.5 dt_new) accel (leapfrog part 2)
//
// Exact: each slot runs the twin's float32 operations in the twin's order,
// none fused (-fmad=false), IEEE division, so every output slot a later
// reader can observe is the twin's bits. The clamps pass a NaN through, as
// torch.clamp does.
//
// Layout: slot-major (ny, nx, P[, C]) contiguous tensors, read as n = ny nx P
// slots; mask bool, two-component tensors float2, the boundary pass's
// (ny, nx, P, 3) output read in place at its element stride 3.
//
// SG_SLOTS slots a thread. What bounds it on the H100: device-memory bytes.
// A thread loads its slots' mask bytes, and a slot's other inputs only where
// they can change an output: a dead slot's inputs are skipped where their producer writes
// +0.0 there (K4's outputs, K5's dead query slots, slot_accel_cfl's accel),
// and the outputs that later readers keep are written in full (dead slots
// from those zeros, through the same operations). slot_kick_drift writes
// live slots only: its outputs feed K4 alone, which reads a live slot's
// position and payload and never a dead one's. At 1M particles on a 1614 x
// 1013 x 8 grid, 8% of the 13.1 M slots are live, so a kernel moves the
// 13 MB mask, the live slots' sectors and its full outputs (105 MB for a
// float2 one) instead of every input in full.
//
// The CFL max: squared speeds are >= +0 or NaN, whose bits order as
// unsigned integers (every NaN above +inf), so a warp reduction, a block
// reduction and one atomicMax on the bits of a 0-d float (zeroed by the
// launcher) give torch's max, a NaN included.

#include <cuda_runtime.h>
#include <limits.h>

#define SG_THREADS 256
#define SG_SLOTS 4  // slots a thread, SG_THREADS apart: every access coalesces

// slot k of thread threadIdx.x of this block
#define SG_SLOT(k) \
  ((int)blockIdx.x * (SG_THREADS * SG_SLOTS) + (k) * SG_THREADS + (int)threadIdx.x)

// Each kernel first loads the masks of its SG_SLOTS slots, then every input
// of the live ones, then computes and stores: a thread keeps its slots'
// loads in flight together, where one slot a thread would wait on a mask
// load and then on the inputs it gates, with nothing else to overlap.

__global__ void __launch_bounds__(SG_THREADS)
    slot_kick_drift_kernel(const unsigned char* __restrict__ mask, const float2* __restrict__ pos,
                           const float2* __restrict__ v, const float2* __restrict__ accel,
                           float2* __restrict__ out_pos, float2* __restrict__ out_v, int n,
                           float half_dt, float dt) {
  bool live[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) live[k] = SG_SLOT(k) < n && mask[SG_SLOT(k)];
  float2 a[SG_SLOTS], u[SG_SLOTS], p[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (!live[k]) continue;
    a[k] = __ldg(accel + SG_SLOT(k));
    u[k] = __ldg(v + SG_SLOT(k));
    p[k] = __ldg(pos + SG_SLOT(k));
  }
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (!live[k]) continue;
    const float2 w = make_float2(u[k].x + half_dt * a[k].x, u[k].y + half_dt * a[k].y);
    out_v[SG_SLOT(k)] = w;
    out_pos[SG_SLOT(k)] = make_float2(p[k].x + w.x * dt, p[k].y + w.y * dt);
  }
}

// dead_zero: dyn and stat hold +0.0 at dead slots (K5's outputs)
__global__ void __launch_bounds__(SG_THREADS)
    slot_density_tait_kernel(const unsigned char* __restrict__ mask, const float* __restrict__ dyn,
                             const float* __restrict__ stat, float* __restrict__ dens,
                             float* __restrict__ pres, int n, float m, float w0, float rho0,
                             float stiffness, bool dead_zero) {
  bool load[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k)
    load[k] = SG_SLOT(k) < n && (!dead_zero || mask[SG_SLOT(k)]);
  float d[SG_SLOTS], s[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    d[k] = 0.0f;
    s[k] = 0.0f;
    if (!load[k]) continue;
    d[k] = __ldg(dyn + SG_SLOT(k));
    s[k] = __ldg(stat + 3 * SG_SLOT(k));
  }
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (SG_SLOT(k) >= n) continue;
    float rho = m * ((w0 + d[k]) + s[k]);
    rho = rho < rho0 ? rho0 : rho;
    float ratio = rho / rho0;
    ratio = ratio < 1.0f ? 1.0f : ratio;
    const float r2 = ratio * ratio;
    const float r3 = ratio * r2;
    const float r4 = r2 * r2;
    dens[SG_SLOT(k)] = rho;
    pres[SG_SLOT(k)] = stiffness * (r3 * r4 - 1.0f);
  }
}

__global__ void __launch_bounds__(SG_THREADS)
    slot_accel_cfl_kernel(const unsigned char* __restrict__ mask,
                          const float2* __restrict__ accel_dyn, const float* __restrict__ stat,
                          const float2* __restrict__ v, float2* __restrict__ accel,
                          unsigned* __restrict__ max_sq, int n, float gx, float gy, float dt) {
  __shared__ unsigned warp_max[SG_THREADS / 32];
  bool live[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) live[k] = SG_SLOT(k) < n && mask[SG_SLOT(k)];
  float2 ad[SG_SLOTS], sv[SG_SLOTS], u[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (!live[k]) continue;
    ad[k] = __ldg(accel_dyn + SG_SLOT(k));
    sv[k] = make_float2(__ldg(stat + 3 * SG_SLOT(k) + 1), __ldg(stat + 3 * SG_SLOT(k) + 2));
    u[k] = __ldg(v + SG_SLOT(k));
  }
  unsigned sq = 0u;  // +0.0: a dead slot's squared speed
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (SG_SLOT(k) >= n) continue;
    float2 a = make_float2(0.0f, 0.0f);
    if (live[k]) {
      a = make_float2((ad[k].x + sv[k].x) + gx, (ad[k].y + sv[k].y) + gy);
      const float wx = u[k].x + a.x * dt;
      const float wy = u[k].y + a.y * dt;
      sq = max(sq, __float_as_uint(wx * wx + wy * wy));
    }
    accel[SG_SLOT(k)] = a;
  }
  sq = __reduce_max_sync(0xffffffffu, sq);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x < 32) {
    sq = threadIdx.x < SG_THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    sq = __reduce_max_sync(0xffffffffu, sq);
    if (threadIdx.x == 0 && sq != 0u) atomicMax(max_sq, sq);
  }
}

// v and accel hold +0.0 at dead slots (K4's and slot_accel_cfl's outputs)
__global__ void __launch_bounds__(SG_THREADS)
    slot_kick_kernel(const unsigned char* __restrict__ mask, const float2* __restrict__ v,
                     const float2* __restrict__ accel, float2* __restrict__ out, int n,
                     float half_dt) {
  bool live[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) live[k] = SG_SLOT(k) < n && mask[SG_SLOT(k)];
  float2 u[SG_SLOTS], a[SG_SLOTS];
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    u[k] = a[k] = make_float2(0.0f, 0.0f);
    if (!live[k]) continue;
    u[k] = __ldg(v + SG_SLOT(k));
    a[k] = __ldg(accel + SG_SLOT(k));
  }
#pragma unroll
  for (int k = 0; k < SG_SLOTS; ++k) {
    if (SG_SLOT(k) >= n) continue;
    out[SG_SLOT(k)] = make_float2(u[k].x + half_dt * a[k].x, u[k].y + half_dt * a[k].y);
  }
}

static bool grid_of(int n, dim3* blocks) {
  const int per_block = SG_THREADS * SG_SLOTS;
  if (n < 0 || n > INT_MAX - per_block) return false;
  *blocks = dim3((unsigned)((n + per_block - 1) / per_block));
  return true;
}

extern "C" int slot_kick_drift(const void* mask, const void* pos, const void* v,
                               const void* accel, void* out_pos, void* out_v, int n,
                               float half_dt, float dt, void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  slot_kick_drift_kernel<<<blocks, SG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const float2*>(pos),
      static_cast<const float2*>(v), static_cast<const float2*>(accel),
      static_cast<float2*>(out_pos), static_cast<float2*>(out_v), n, half_dt, dt);
  return (int)cudaGetLastError();
}

extern "C" int slot_density_tait(const void* mask, const void* dyn, const void* stat,
                                 void* dens, void* pres, int n, float m, float w0, float rho0,
                                 float stiffness, int dead_zero, void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  slot_density_tait_kernel<<<blocks, SG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const float*>(dyn),
      static_cast<const float*>(stat), static_cast<float*>(dens), static_cast<float*>(pres), n,
      m, w0, rho0, stiffness, dead_zero != 0);
  return (int)cudaGetLastError();
}

// max_sq: a 0-d float32, zeroed here, then the live slots' largest |v*|^2
extern "C" int slot_accel_cfl(const void* mask, const void* accel_dyn, const void* stat,
                              const void* v, void* accel, void* max_sq, int n, float gx,
                              float gy, float dt, void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(max_sq, 0, sizeof(unsigned), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  slot_accel_cfl_kernel<<<blocks, SG_THREADS, 0, s>>>(
      static_cast<const unsigned char*>(mask), static_cast<const float2*>(accel_dyn),
      static_cast<const float*>(stat), static_cast<const float2*>(v), static_cast<float2*>(accel),
      static_cast<unsigned*>(max_sq), n, gx, gy, dt);
  return (int)cudaGetLastError();
}

extern "C" int slot_kick(const void* mask, const void* v, const void* accel, void* out, int n,
                         float half_dt, void* stream) {
  dim3 blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  slot_kick_kernel<<<blocks, SG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const float2*>(v),
      static_cast<const float2*>(accel), static_cast<float2*>(out), n, half_dt);
  return (int)cudaGetLastError();
}
