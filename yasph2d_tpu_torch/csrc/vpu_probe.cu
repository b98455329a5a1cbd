// K6: speed probes of the FP32 pipes, the roofline's measured denominators.
//
// Replaces the TPU kernels tools/vpu_probe.py fma_probe (:39) and mix_probe
// (:76). Each thread owns one element a = x[i] and runs CHAINS independent
// accumulator chains (one chain is latency-bound and underreports the
// instruction rate), seeded acc_c = a * f32(1 + 0.001 c), for
// trips = k_ops / (CHAINS * INNER) loop trips of INNER unrolled steps per
// chain, then writes the chains' sum (acc_0 + acc_1 + ..., in order):
//   fma_probe: acc = acc * a + 1e-7, one FFMA per step, counted as 2 operations
//              (the data-sheet 67 TFLOP/s counts an FMA as two);
//   mix_probe: acc = acc + (a > 0.5 ? a : 0), compare + select + add, counted
//              as 3 operations (three instructions, none of them an FMA).
//
// What bounds it on the H100: the FP32 instruction rate (operations); it
// reads and writes 8 bytes per element against 8-12k operations.
//
// Hopper traps, both of which would make the probe report a rate that the
// card does not have:
// - the library is built with -fmad=false, so `acc * a + 1e-7` would compile
//   to FMUL + FADD and halve the measured rate: the step is __fmaf_rn;
// - `a > 0.5 ? a : 0` is loop-invariant, and ptxas hoists it out of the loop
//   even from volatile inline PTX (seen in the SASS: one FSETP and one FSEL per
//   kernel), leaving one FADD per step that the probe would count as three.
//   So each chain carries its select: s_c = (s_c > 0.5 ? s_c : 0), seeded
//   s_c = a, then acc_c += s_c. Every step's s_c equals a > 0.5 ? a : 0 (a
//   select of a > 0.5 returns a again, a select of 0 returns 0), so the kernel
//   computes the TPU probe's values, but the compare and the select are now
//   loop-carried and execute on every step (setp / selp in inline PTX).
// tools/vpu_probe.py --sass prints the SASS opcode counts of both kernels.
//
// The plain PyTorch twins are in yasph2d_tpu_torch/tools/vpu_probe.py; the
// FMA twin rounds the exact float64 product plus 1e-7 once to f32, as the
// FMA does (up to a rare double rounding), and the mix twin is bit-equal.

#include <cuda_runtime.h>

#define PROBE_INNER 8

template <int CHAINS>
__global__ void __launch_bounds__(256)
    fma_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int trips) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  float acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = a * (float)(1.0 + 0.001 * c);
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int k = 0; k < PROBE_INNER; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) acc[c] = __fmaf_rn(acc[c], a, 1.0e-7f);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
  out[i] = s;
}

// a > 0.5 ? a : 0.0 as one setp and one selp
__device__ __forceinline__ float select_half(float a) {
  float r;
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "setp.gt.f32 p, %1, 0f3F000000;\n\t"
      "selp.f32 %0, %1, 0f00000000, p;\n\t"
      "}"
      : "=f"(r)
      : "f"(a));
  return r;
}

template <int CHAINS>
__global__ void __launch_bounds__(256)
    mix_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int trips) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  float acc[CHAINS], sel[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    acc[c] = a * (float)(1.0 + 0.001 * c);
    sel[c] = a;
  }
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int k = 0; k < PROBE_INNER; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        sel[c] = select_half(sel[c]);  // == (a > 0.5 ? a : 0) on every step
        acc[c] = acc[c] + sel[c];
      }
    }
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
  out[i] = s;
}

static int launch_grid(int n, dim3* blocks) {
  *blocks = dim3((unsigned)((n + 255) / 256));
  return n > 0;
}

// chains 4 or 8 (the probe's configurations); inner must be PROBE_INNER
extern "C" int vpu_fma_probe(const void* x, void* out, int n, int chains, int inner,
                             int trips, void* stream) {
  if (inner != PROBE_INNER) return (int)cudaErrorInvalidValue;
  dim3 blocks;
  if (!launch_grid(n, &blocks)) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (chains == 4) {
    fma_probe_kernel<4><<<blocks, 256, 0, s>>>(xp, op, n, trips);
  } else if (chains == 8) {
    fma_probe_kernel<8><<<blocks, 256, 0, s>>>(xp, op, n, trips);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vpu_mix_probe(const void* x, void* out, int n, int chains, int inner,
                             int trips, void* stream) {
  if (inner != PROBE_INNER) return (int)cudaErrorInvalidValue;
  dim3 blocks;
  if (!launch_grid(n, &blocks)) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (chains == 8) {
    mix_probe_kernel<8><<<blocks, 256, 0, s>>>(xp, op, n, trips);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
