// K4: per-step neighbourhood rebuild in the padded slot-major layout (windowed
// re-bucket).
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py sm_rebucket
// (body _sm_rebucket_kernel). Every live slot has a move code 1..9 naming the
// cell of its advected position inside the old 3x3 window (0 = dead slot;
// computed by ops/dense_grid.py move_codes). Each target cell (y, x) scans the
// 3x3 source cells in (dyv, dxv, sp) order, selects the slots whose code
// points at it, (2-dyv)*3 + (2-dxv) + 1, and writes the k-th selected slot's
// position and values to its slot k while k < P. It writes zeros in the slots
// beyond the hits and the incoming total (which may exceed P: the overflow is
// dropped and counted by the caller).
//
// Exact: payloads are copied, never summed, so the output is bit-equal to the
// plain twin (ops/sm_rebucket.py sm_rebucket_ref) and the JAX kernel. The TPU
// kernel accumulates each hit onto +0.0, which turns a -0.0 payload into +0.0;
// the copy below adds +0.0 for the same reason (as K2 does).
//
// Layout, read and written in place: code (ny, nx, P) uint8, positions
// (ny, nx, P, 2) f32, values (ny, nx, P, D) f32, total (ny, nx) int32. One
// thread per target cell. What bounds it on the H100: memory latency of the
// 9 x P code-byte reads per cell (a cell's slots are contiguous, so a thread
// reads each neighbour cell's codes as one run of P bytes), and the stores: a
// thread writes its cell's P x (2 + D) floats, so the lanes of a warp store
// P x (2 + D) floats apart where K2's plane stores are consecutive (55 us
// against K2's 26-31 us at the 100k WCSPH state, NVIDIA H100 80GB HBM3,
// 700 W). No shared-memory staging yet.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
sm_rebucket_kernel(const uint8_t* __restrict__ code, const float* __restrict__ pos,
                   const float* __restrict__ vals, int D, float* __restrict__ out_pos,
                   float* __restrict__ out_vals, int* __restrict__ total, int P,
                   int ny, int nx) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= ny * nx) return;
  const int y = cell / nx;
  const int x = cell - y * nx;
  const long first = (long)cell * P;  // the cell's slot 0

  int k = 0;
  for (int dyv = 0; dyv < 3; ++dyv) {
    const int sy = y + dyv - 1;
    if (sy < 0 || sy >= ny) continue;
    for (int dxv = 0; dxv < 3; ++dxv) {
      const int sx = x + dxv - 1;
      if (sx < 0 || sx >= nx) continue;
      const uint8_t expected = (uint8_t)((2 - dyv) * 3 + (2 - dxv) + 1);
      const long base = ((long)sy * nx + sx) * P;
      for (int sp = 0; sp < P; ++sp) {
        const long sidx = base + sp;
        if (code[sidx] != expected) continue;
        if (k < P) {
          const long o = first + k;
          out_pos[2 * o] = 0.0f + pos[2 * sidx];
          out_pos[2 * o + 1] = 0.0f + pos[2 * sidx + 1];
          for (int j = 0; j < D; ++j) out_vals[o * D + j] = 0.0f + vals[sidx * D + j];
        }
        ++k;
      }
    }
  }
  total[cell] = k;
  for (int s = k < P ? k : P; s < P; ++s) {
    const long o = first + s;
    out_pos[2 * o] = 0.0f;
    out_pos[2 * o + 1] = 0.0f;
    for (int j = 0; j < D; ++j) out_vals[o * D + j] = 0.0f;
  }
}

extern "C" int sm_rebucket(const void* code, const void* pos, const void* vals, int D,
                           void* out_pos, void* out_vals, void* total, int P, int ny,
                           int nx, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int cells = ny * nx;
  if (cells > 0) {
    const int threads = 256;
    const int blocks = (cells + threads - 1) / threads;
    sm_rebucket_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(code), static_cast<const float*>(pos),
        static_cast<const float*>(vals), D, static_cast<float*>(out_pos),
        static_cast<float*>(out_vals), static_cast<int*>(total), P, ny, nx);
  }
  return (int)cudaGetLastError();
}
