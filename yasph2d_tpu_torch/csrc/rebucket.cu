// K2: per-step neighbourhood rebuild in plane form (windowed re-bucket).
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py pf_rebucket
// (body _pf_rebucket_kernel) together with its move codes (pf_move_codes).
// Every live slot has a move code 1..9 naming the cell of its advected
// position inside the old 3x3 window (0 = dead slot). Each target cell (y, x)
// scans the 3x3 source cells in (dyv, dxv, sp) order, selects the slots whose
// code points at it, (2-dyv)*3 + (2-dxv) + 1, and writes the k-th selected
// slot's payload to its slot k while k < P, zeros in the slots beyond the
// hits, and its new mask plane k < total. The arrivals beyond P are dropped
// and their count added to one int32 counter.
//
// Exact: payloads are copied, never summed, so the output is bit-equal to the
// plain twin (ops/rebucket.py rebucket_ref) and the JAX kernel. The TPU kernel
// accumulates each hit onto +0.0, which turns a -0.0 payload into +0.0; the
// copy below adds +0.0 for the same reason. The move code is pf_move_codes
// bit for bit (csrc/move_code.cuh, shared with K4).
//
// Layout: mask (P, ny, nx) bool, payload planes (P, ny, nx) f32 by pointer
// (x, y, then the values), out (n_pay, P, ny, nx) f32, new mask (P, ny, nx)
// bool, dropped () int32.
//
// Design: the whole re-bucket is this one launch (plus a 4-byte memset of the
// drop counter). One block per RB_TY x RB_TX tile of target cells, one thread
// per target cell. The block computes the move codes of its haloed
// (RB_TY+2) x (RB_TX+2) x P source tile into shared memory (every mask and
// position load of a thread issued before its first code is formed; cells off
// the grid stage as dead, so ragged tiles need no padded copy; the halo's codes
// are computed by the neighbouring blocks too, which is cheap). Each target
// cell then scans its 9 x P staged codes, keeps the plane index of each hit
// in shared memory, and writes its P output slots of every payload plane in
// slot order, so a warp's stores of one (plane, slot) are 32 neighbouring
// cells. Per-warp sums of the overflow max(total - P, 0) go to the drop
// counter by integer atomicAdd: exact, and independent of the order.
//
// What bounds it on the H100: device-memory bytes. It must write every output
// slot of every payload plane (28 MB at 100k with D = 4) and read the mask and
// the live slots' positions and payload once; the scan is shared-memory work.
// The first version ran one thread per target cell with 9 x P serial global
// code-byte loads, after ~20 launches of move-code glue and before ~6 of
// mask and drop glue; in a host-bound step those launches cost more than the
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "move_code.cuh"

#define MAX_PAYLOAD 8
#define RB_TY 8
#define RB_TX 32
#define RB_THREADS (RB_TY * RB_TX)
#define RB_HX (RB_TX + 2)
#define RB_HC ((RB_TY + 2) * RB_HX)
#define RB_STAGE_UNROLL 10  // staged slots per thread whose loads are issued together

struct Payload {
  const float* p[MAX_PAYLOAD];
};

struct RebucketArgs {
  const bool* mask;  // (P, ny, nx)
  Payload src;       // n_pay planes (P, ny, nx): x, y, then the values
  float* out;        // (n_pay, P, ny, nx)
  bool* new_mask;    // (P, ny, nx)
  int* dropped;      // (), zeroed by the launcher
  int P, ny, nx;
  MoveGrid mg;       // the move codes' grid
};

__host__ __device__ inline size_t rebucket_smem_bytes(int P) {
  return (size_t)P * RB_THREADS * sizeof(int) + (size_t)P * RB_HC;
}

template <int N_PAY>
__global__ void __launch_bounds__(RB_THREADS) rebucket_kernel(const RebucketArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hits = reinterpret_cast<int*>(smem);                 // (P, RB_THREADS)
  uint8_t* codes = smem + (size_t)a.P * RB_THREADS * sizeof(int);  // (P, RB_HC)

  const int plane = a.ny * a.nx;
  const int y0 = blockIdx.y * RB_TY;
  const int x0 = blockIdx.x * RB_TX;
  const int tid = threadIdx.x;

  // move codes of the haloed source tile, entry t = sp * RB_HC + cell with x
  // fastest, so a warp's mask and position loads coalesce
  const int n_stage = a.P * RB_HC;
  for (int base = tid; base < n_stage; base += RB_STAGE_UNROLL * RB_THREADS) {
    bool m[RB_STAGE_UNROLL];
    float px[RB_STAGE_UNROLL], py[RB_STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < RB_STAGE_UNROLL; ++u) {
      const int t = base + u * RB_THREADS;
      const int sp = t / RB_HC;
      const int c = t - sp * RB_HC;
      const int hy = c / RB_HX;
      const int gy = y0 + hy - 1;
      const int gx = x0 + (c - hy * RB_HX) - 1;
      m[u] = false;
      px[u] = py[u] = 0.0f;
      if (t < n_stage && gy >= 0 && gy < a.ny && gx >= 0 && gx < a.nx) {
        const int g = sp * plane + gy * a.nx + gx;
        m[u] = __ldg(reinterpret_cast<const unsigned char*>(a.mask) + g) != 0;
        px[u] = __ldg(a.src.p[0] + g);
        py[u] = __ldg(a.src.p[1] + g);
      }
    }
#pragma unroll
    for (int u = 0; u < RB_STAGE_UNROLL; ++u) {
      const int t = base + u * RB_THREADS;
      const int c = t % RB_HC;
      const int hy = c / RB_HX;
      if (t < n_stage)
        codes[t] = m[u] ? move_code(px[u], py[u], y0 + hy - 1, x0 + (c - hy * RB_HX) - 1, a.mg)
                        : 0;
    }
  }
  __syncthreads();

  const int ly = tid / RB_TX;
  const int lx = tid - ly * RB_TX;
  const int y = y0 + ly;
  const int x = x0 + lx;
  const bool inside = y < a.ny && x < a.nx;
  int k = 0;
  if (inside) {
    // halo cells off the grid hold code 0, which never matches
    for (int dyv = 0; dyv < 3; ++dyv) {
      for (int dxv = 0; dxv < 3; ++dxv) {
        const uint8_t expected = (uint8_t)((2 - dyv) * 3 + (2 - dxv) + 1);
        const int c = (ly + dyv) * RB_HX + (lx + dxv);
        const int scell = (y + dyv - 1) * a.nx + (x + dxv - 1);
        for (int sp = 0; sp < a.P; ++sp) {
          if (codes[sp * RB_HC + c] != expected) continue;
          if (k < a.P) hits[k * RB_THREADS + tid] = sp * plane + scell;
          ++k;
        }
      }
    }
    const int cell = y * a.nx + x;
    const int n = a.P * plane;  // stride between payload planes of out
    const int n_hit = min(k, a.P);
    for (int s = 0; s < a.P; ++s) {
      const int src = s < n_hit ? hits[s * RB_THREADS + tid] : -1;
      float v[N_PAY];  // a slot's payload loads all in flight
#pragma unroll
      for (int j = 0; j < N_PAY; ++j) v[j] = src >= 0 ? 0.0f + __ldg(a.src.p[j] + src) : 0.0f;
#pragma unroll
      for (int j = 0; j < N_PAY; ++j) a.out[j * n + s * plane + cell] = v[j];
      a.new_mask[s * plane + cell] = s < k;
    }
  }
  // every lane of the warp takes part (no early return above)
  const int over = __reduce_add_sync(0xffffffffu, inside ? max(k - a.P, 0) : 0);
  if ((tid & 31) == 0 && over > 0) atomicAdd(a.dropped, over);
}

template <int N_PAY>
static int launch(const RebucketArgs& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rebucket_kernel<N_PAY>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.nx + RB_TX - 1) / RB_TX, (a.ny + RB_TY - 1) / RB_TY);
  rebucket_kernel<N_PAY><<<grid, RB_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int rebucket(const void* mask, const void* const* payload, int n_pay,
                        void* out, void* new_mask, void* dropped, int P, int ny, int nx,
                        int grid_nx, int grid_ny, float inv, float ox, float oy,
                        void* stream) {
  if (n_pay < 2 || n_pay > MAX_PAYLOAD || P < 1 || P > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dropped, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  RebucketArgs a;
  a.mask = static_cast<const bool*>(mask);
  for (int j = 0; j < MAX_PAYLOAD; ++j)
    a.src.p[j] = j < n_pay ? static_cast<const float*>(payload[j]) : nullptr;
  a.out = static_cast<float*>(out);
  a.new_mask = static_cast<bool*>(new_mask);
  a.dropped = static_cast<int*>(dropped);
  a.P = P;
  a.ny = ny;
  a.nx = nx;
  a.mg = MoveGrid{grid_nx, grid_ny, inv, ox, oy};
  if ((long)ny * nx == 0) return (int)cudaSuccess;
  const size_t smem = rebucket_smem_bytes(P);
  switch (n_pay) {
    case 2: return launch<2>(a, smem, s);
    case 3: return launch<3>(a, smem, s);
    case 4: return launch<4>(a, smem, s);
    case 5: return launch<5>(a, smem, s);
    case 6: return launch<6>(a, smem, s);
    case 7: return launch<7>(a, smem, s);
    default: return launch<8>(a, smem, s);
  }
}
