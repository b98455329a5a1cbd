// K7: the slot-major ctx-pass probe, one thread per cell.
//
// Replaces the TPU kernel tools/probe_pallas_slotmajor.py ctx_pass_slotmajor
// (:113, body ctx_pass_kernel :65). For every query slot of a cell it sums,
// over the 3x3 cells around it x Ps source slots in (dyv, dxv, sp) order, the
// probe's own Wendland quintic C2 statement (:42-62): W, m grad W (x, y),
// |m grad W|^2 and the neighbour count, for the pairs with query live, source
// live, r_sq <= h^2 and r_sq > 1e-10. Dead queries write zeros.
//
// Layout: the port's, not the probe's TPU blocking. Query planes (3, P, ny, nx)
// and source planes (3, Ps, ny, nx) f32, plane 2 the mask as 0/1; output
// (5, P, ny, nx). Cells off the grid are absent (the probe's zero halo ring
// adds +0.0, which leaves every sum as it is).
//
// Design: the TPU probe keeps its live set small and reuses the loaded source
// window across the query slots. Here one thread owns a cell: the source
// candidates are the outer loop and the P query slots (P <= 8, a template
// parameter) the inner loop, with P x 5 accumulators in registers, so each
// candidate is loaded once per cell where K1 (csrc/pair_reduce.cu, one thread
// per query slot) loads it once per query slot. Each output still receives its
// terms in (dyv, dxv, sp) order, so the sums are the twin's.
//
// What bounds it on the H100: the candidate loads' latency with ~100k threads
// at the probe shape (64 x 1612 cells), then the FP32 pipes (~40 operations
// per valid pair, with a sqrt).
//
// Operation order: the probe's (q = r * f32(1/h); (1-q)^4 = (x x)(x x) and
// (1-q)^3 = x (x x) as lax.integer_pow multiplies; w = (norm_w x^4)(q + 0.25);
// g = ((m norm_g x^3) dx, ...)), built with -fmad=false like the twin in
// yasph2d_tpu_torch/tools/probe_pallas_slotmajor.py ctx_pass_ref.

#include <cuda_runtime.h>

#include "pair_terms.cuh"

struct ProbeConsts {
  float radius_sq;  // f32(h * h)
  float inv_h;      // f32(1 / h)
  float norm_w;     // f32(28 / (pi h^2))
  float norm_g;     // f32(140 / (pi h^4))
  float mass;       // f32(m)
};

template <int P>
__global__ void __launch_bounds__(256)
    probe_ctx_kernel(const float* __restrict__ q, const float* __restrict__ s,
                     float* __restrict__ out, int Ps, int ny, int nx, const ProbeConsts c) {
  const int plane = ny * nx;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  const int y = cell / nx;
  const int x = cell - y * nx;

  float qx[P], qy[P];
  bool qm[P];
  float acc[P][5];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    qx[p] = q[p * plane + cell];
    qy[p] = q[(P + p) * plane + cell];
    qm[p] = q[(2 * P + p) * plane + cell] > 0.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[p][k] = 0.0f;
  }
  const int s_comp = Ps * plane;  // stride of the source planes x, y, mask

  for (int dyv = 0; dyv < 3; ++dyv) {
    const int sy = y + dyv - 1;
    if (sy < 0 || sy >= ny) continue;
    for (int dxv = 0; dxv < 3; ++dxv) {
      const int sx = x + dxv - 1;
      if (sx < 0 || sx >= nx) continue;
      const int scell = sy * nx + sx;
      for (int sp = 0; sp < Ps; ++sp) {
        const int sidx = sp * plane + scell;
        if (!(s[2 * s_comp + sidx] > 0.0f)) continue;
        const float cx = s[sidx];
        const float cy = s[s_comp + sidx];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!qm[p]) continue;
          const float dx = cx - qx[p];
          const float dy = cy - qy[p];
          const float r_sq = dx * dx + dy * dy;
          if (!(r_sq <= c.radius_sq && r_sq > MIN_DISTANCE_SQ)) continue;
          const float qq = sqrtf(r_sq) * c.inv_h;
          const float omq = jmax(1.0f - qq, 0.0f);
          const float omq2 = omq * omq;
          const float w = (c.norm_w * (omq2 * omq2)) * (qq + 0.25f);
          const float mc = c.mass * (c.norm_g * (omq * omq2));
          const float gx = mc * dx;
          const float gy = mc * dy;
          acc[p][0] += w;
          acc[p][1] += gx;
          acc[p][2] += gy;
          acc[p][3] += gx * gx + gy * gy;
          acc[p][4] += 1.0f;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < 5; ++k) out[(k * P + p) * plane + cell] = acc[p][k];
  }
}

template <int P>
static void launch_p(const float* q, const float* s, float* out, int Ps, int ny, int nx,
                     const ProbeConsts& c, cudaStream_t stream) {
  const int n = ny * nx;
  probe_ctx_kernel<P><<<(n + 255) / 256, 256, 0, stream>>>(q, s, out, Ps, ny, nx, c);
}

// q (3, P, ny, nx), s (3, Ps, ny, nx), out (5, P, ny, nx); P in 1..8
extern "C" int probe_ctx(const void* q, const void* s, void* out, int P, int Ps, int ny,
                         int nx, const ProbeConsts* consts, void* stream) {
  if (ny * nx == 0) return (int)cudaGetLastError();
  const float* qp = static_cast<const float*>(q);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: launch_p<1>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 2: launch_p<2>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 3: launch_p<3>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 4: launch_p<4>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 5: launch_p<5>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 6: launch_p<6>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 7: launch_p<7>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    case 8: launch_p<8>(qp, sp, op, Ps, ny, nx, *consts, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
