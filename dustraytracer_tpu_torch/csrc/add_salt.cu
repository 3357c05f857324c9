// o = x + SALT, elementwise, for the build-cache reload check
// (tools/repro_cache_hang.py).
//
// Replaces the Pallas TPU kernel of the JAX package's
// tools/repro_cache_hang.py child script (`kernel`, o_ref = x_ref + SALT
// on an (8, 128) f32 block). There the question was whether an
// executable reloaded from the persistent compilation cache hangs; here
// the cache is the port's own (ops/cuda_build.py: a content-hashed .so
// under a file lock), and this kernel is what the check builds, reloads
// and runs. The tool writes a copy of this source with SALT defined per
// run, so an old cache entry cannot stand in for a new build.
//
// What bounds it: 1,024 floats in and out, so launch latency; it is a
// probe of the build cache, not a workload.

#include <cuda_runtime.h>

#ifndef SALT
#define SALT 0.0f
#endif

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
add_salt_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + SALT;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int drt_add_salt(const float* x, float* o, int n, void* stream) {
  if (n <= 0) return 0;
  add_salt_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

extern "C" float drt_add_salt_value() { return SALT; }

// Resident blocks per SM of the kernel (the CUDA occupancy calculator's
// figure); returns the CUDA error code (0 = answered).
extern "C" int drt_add_salt_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, add_salt_kernel, kBlock, 0);
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
