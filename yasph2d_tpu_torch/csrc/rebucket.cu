// K2: per-step neighbourhood rebuild in plane form (windowed re-bucket).
//
// Replaces the TPU kernel yasph2d_tpu/ops/pallas_slotmajor.py pf_rebucket
// (body _pf_rebucket_kernel). Every live slot has a move code 1..9 naming the
// cell of its advected position inside the old 3x3 window (0 = dead slot;
// computed by ops/planes.py pf_move_codes). Each target cell (y, x) scans the
// 3x3 source cells in (dyv, dxv, sp) order, selects the slots whose code
// points at it, (2-dyv)*3 + (2-dxv) + 1, and writes the k-th selected slot's
// payload to its slot k while k < P. It writes zeros in the slots beyond the
// hits and the incoming total (which may exceed P: the overflow is dropped and
// counted by the caller).
//
// Exact: payloads are copied, never summed, so the output is bit-equal to the
// plain twin (ops/rebucket.py rebucket_ref) and the JAX kernel. The TPU kernel
// accumulates each hit onto +0.0, which turns a -0.0 payload into +0.0; the
// copy below adds +0.0 for the same reason.
//
// Layout: code (P, ny, nx) uint8, payload planes (P, ny, nx) f32, out
// (n_pay, P, ny, nx) f32, total (ny, nx) int32. One thread per target cell, x
// fastest. What bounds it on the H100: memory latency of the 9 x P code-byte
// reads per cell; movers are rare, so the payload traffic is about one read
// and one write per live slot. No shared-memory staging yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PAYLOAD 8

struct Payload {
  const float* p[MAX_PAYLOAD];
};

__global__ void __launch_bounds__(256)
rebucket_kernel(const uint8_t* __restrict__ code, const Payload src, int n_pay,
                float* __restrict__ out, int* __restrict__ total, int P, int ny, int nx) {
  const int plane = ny * nx;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  const int y = cell / nx;
  const int x = cell - y * nx;
  const int n = P * plane;  // stride between payload planes of out

  int k = 0;
  for (int dyv = 0; dyv < 3; ++dyv) {
    const int sy = y + dyv - 1;
    if (sy < 0 || sy >= ny) continue;
    for (int dxv = 0; dxv < 3; ++dxv) {
      const int sx = x + dxv - 1;
      if (sx < 0 || sx >= nx) continue;
      const uint8_t expected = (uint8_t)((2 - dyv) * 3 + (2 - dxv) + 1);
      const int scell = sy * nx + sx;
      for (int sp = 0; sp < P; ++sp) {
        const int sidx = sp * plane + scell;
        if (code[sidx] != expected) continue;
        if (k < P) {
          for (int j = 0; j < n_pay; ++j) out[j * n + k * plane + cell] = 0.0f + src.p[j][sidx];
        }
        ++k;
      }
    }
  }
  total[cell] = k;
  for (int s = k < P ? k : P; s < P; ++s) {
    for (int j = 0; j < n_pay; ++j) out[j * n + s * plane + cell] = 0.0f;
  }
}

extern "C" int rebucket(const void* code, const void* const* payload, int n_pay,
                        void* out, void* total, int P, int ny, int nx, void* stream) {
  if (n_pay < 1 || n_pay > MAX_PAYLOAD) return (int)cudaErrorInvalidValue;
  Payload src;
  for (int j = 0; j < MAX_PAYLOAD; ++j) src.p[j] = j < n_pay ? static_cast<const float*>(payload[j]) : nullptr;
  const int plane = ny * nx;
  if (plane > 0) {
    const int threads = 256;
    const int blocks = (plane + threads - 1) / threads;
    rebucket_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(code), src, n_pay, static_cast<float*>(out),
        static_cast<int*>(total), P, ny, nx);
  }
  return (int)cudaGetLastError();
}
