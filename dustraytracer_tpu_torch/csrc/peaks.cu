// The FP32 rate outside the tensor cores, on Hopper (sm_90a): a chain of
// explicit fused multiply-adds that never leaves registers.
//
// Replaces the XLA loop `vpu_chain` of dustraytracer_tpu/utils/roofline.py
// (measure_peaks, :413-421): x = x * 1.0000001 + 1e-7 over a (4096, 512)
// f32 array, once per element per iteration, timed at two iteration
// counts. That loop is the JAX package's measure of the TPU's vector-unit
// FP32 rate; this kernel is the port's measure of the card's FP32 rate
// outside the tensor cores, the 67 TFLOP/s that
// utils/roofline.py::bound_seconds divides by. It computes the same chain,
// x_c = fmaf(x_c, A, B), `iters` times for each of kChains values per
// thread, and writes one value a thread: the sum of its chains, so that no
// chain is dead code.
//
// What bounds it: operations. A thread reads 4 bytes and writes 4 against
// 2 * kChains * iters FLOPs (2 per fmaf). An eager `x * a + b` chain in
// PyTorch would measure launches and L2 bandwidth instead: two kernels per
// step, each streaming the whole array.
//
// The design keeps every FP32 lane busy: kChains = 8 independent chains a
// thread hide the FMA's latency within one warp, 256-thread blocks at up to
// 2048 threads per SM (the caller sizes the grid to fill every SM), and the
// iteration loop unrolled kUnroll times so that loop control takes a small
// share of the issue slots. ops/cuda_build.py builds with -fmad=false, which
// fuses no separate multiply and add but does not split an explicit fmaf:
// each step is one FFMA, rounded once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 8;
constexpr float kA = 1.0000001f;
constexpr float kB = 1e-7f;
// chain c of a thread starts at x0 + c * 2^-10 (exact for x0 in [1, 1.5))
constexpr float kStep = 0.0009765625f;

__global__ void __launch_bounds__(kBlock)
fma_peak_kernel(const float* __restrict__ x0, float* __restrict__ y, int n,
                int iters) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= n) return;
  const float base = x0[t];
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = base + (float)c * kStep;
  int i = 0;
  for (; i + kUnroll <= iters; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) x[c] = fmaf(x[c], kA, kB);
    }
  }
  for (; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = fmaf(x[c], kA, kB);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += x[c];
  y[t] = s;
}

}  // namespace

// Launch on `stream`: y[t] = sum over c of chain c of x0[t] after `iters`
// steps, for t < n. Returns cudaGetLastError() (0 = launched).
extern "C" int drt_fma_peak(const float* x0, float* y, int n, int iters,
                            void* stream) {
  if (n <= 0) return 0;
  if (iters < 0) return (int)cudaErrorInvalidValue;
  fma_peak_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(x0, y, n, iters);
  return (int)cudaGetLastError();
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
