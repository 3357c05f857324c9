// K4: the backward of the row fetch out = table[idx] (dim 0), on Hopper
// (sm_90a): d_table[r, :] = sum of grad[i, :] over the lanes i with
// idx[i] == r, added in an order fixed by (idx, lane) and the shapes
// alone, with no floating-point atomics, so two launches on equal inputs
// give equal bits.
//
// Replaces the transposes of the JAX package's gather-free fetches:
// dustraytracer_tpu/render/integrator.py::_onehot_rows (:50), whose VJP
// is onehot(idx)^T @ grad, a reduction by row id on the MXU, and the
// float texel fetch's custom VJP in dustraytracer_tpu/render/texture.py
// (:21-107), the same transpose factored by texel row and column. On the
// card the one-hot product would cost 2 * N * n_rows * C operations; the
// port's forward is a gather instead, and its library backward
// (index_select -> index_add_) adds with atomics in an order that
// changes from run to run.
//
// What bounds it: bytes. Each lane's cotangent row is read once (N * C
// floats), its id once, each table row written once; the adds are one
// per value read. ops/rows.py plans the order on the card with library
// calls: a stable sort of idx (perm), each row's run of sorted lanes
// [starts[r], starts[r+1]) by searchsorted, and the runs cut into chunks
// of `chunk` sorted lanes, chunk_off[r] = chunks before row r.
//
// Design. Runs are long here (262,144 lanes into a 2-row material table;
// every miss lane on triangle 0), so a row's sum is split in two fixed
// levels:
//   1. rows_grad_chunks: one warp per chunk, lane c on column c (and
//      c + 32, ...). The warp walks the chunk's sorted lanes in order
//      and each lane adds its column sequentially; one lane's row is
//      read by the whole warp, C contiguous floats. The chunk's sum goes
//      to partial[chunk, :].
//   2. rows_grad_rows: one warp per table row. Lane l adds the row's
//      chunks l, l + 32, ... in order, then a fixed __shfl_down_sync tree
//      adds the 32 lanes; lane 0 writes the row. A row with no lanes has
//      no chunks and is written as zero.
// The grid of pass 1 is an upper bound on the chunk count (the wrapper
// does not read the count back, which would make the host wait); warps
// past the count leave at once. Each warp finds its row by a binary
// search over chunk_off. Both passes keep every branch warp-uniform
// around the shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;

// The row r with chunk_off[r] <= j < chunk_off[r + 1] (rows with no
// chunks are skipped: chunk_off is non-decreasing).
__device__ __forceinline__ int row_of_chunk(
    const int64_t* __restrict__ chunk_off, int n_rows, int64_t j) {
  int lo = 0, hi = n_rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_off[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock)
rows_grad_chunks(const float* __restrict__ grad,
                 const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ starts,
                 const int64_t* __restrict__ chunk_off,
                 float* __restrict__ partial, int n_rows, int cols,
                 int chunk, int64_t max_chunks) {
  const int64_t j = (int64_t)blockIdx.x * kWarpsPerBlock
                    + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= max_chunks || j >= chunk_off[n_rows]) return;  // warp-uniform
  const int r = row_of_chunk(chunk_off, n_rows, j);
  const int64_t lo = starts[r] + (j - chunk_off[r]) * chunk;
  const int64_t end = starts[r + 1];
  const int64_t hi = lo + chunk < end ? lo + chunk : end;
  for (int c = lane; c < cols; c += kWarp) {
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t p = lo; p < hi; ++p) acc += grad[perm[p] * cols + c];
    partial[j * cols + c] = acc;
  }
}

__global__ void __launch_bounds__(kBlock)
rows_grad_rows(const float* __restrict__ partial,
               const int64_t* __restrict__ chunk_off,
               float* __restrict__ out, int n_rows, int cols) {
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock
                    + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= n_rows) return;  // warp-uniform
  const int64_t a = chunk_off[r], b = chunk_off[r + 1];
  for (int c = 0; c < cols; ++c) {
    float acc = 0.0f;
    for (int64_t j = a + lane; j < b; j += kWarp) acc += partial[j * cols + c];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[r * cols + c] = acc;
  }
}

}  // namespace

// Launch both passes on `stream`: out (n_rows, cols) from grad (n, cols)
// and the plan (perm (n,), starts and chunk_off (n_rows + 1,), all
// int64); partial holds max_chunks * cols floats. Returns
// cudaGetLastError() (0 = launched).
extern "C" int drt_rows_grad(const float* grad, const int64_t* perm,
                             const int64_t* starts, const int64_t* chunk_off,
                             float* partial, float* out, int n_rows,
                             int cols, int chunk, long long max_chunks,
                             void* stream) {
  if (n_rows <= 0 || cols <= 0) return 0;
  if (chunk <= 0 || max_chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (max_chunks > 0) {
    const long long blocks = (max_chunks + kWarpsPerBlock - 1)
                             / kWarpsPerBlock;
    rows_grad_chunks<<<(unsigned)blocks, kBlock, 0, s>>>(
        grad, perm, starts, chunk_off, partial, n_rows, cols, chunk,
        (int64_t)max_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rows_grad_rows<<<blocks, kBlock, 0, s>>>(partial, chunk_off, out, n_rows,
                                           cols);
  return (int)cudaGetLastError();
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
