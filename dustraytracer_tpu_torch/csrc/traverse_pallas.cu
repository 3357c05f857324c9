// Cluster-BVH closest-hit / any-hit traversal of the BASE threading for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dustraytracer_tpu/ops/traverse_pallas.py
// `_kernel` (launched by `_traverse_impl` through `traverse_cluster_pallas`).
// It computes what `_kernel` computes, per ray: a walk of the base
// pre-order threading of the cluster BVH (node_min / node_max /
// node_skip / node_cluster, no octant orders): enter an interior node ->
// i + 1, otherwise -> skip, skip == -1 -> done. A node is entered when
// the NaN-suppressing slab test hits and t_enter < hit_t. At an entered
// leaf it runs a K-wide Möller–Trumbore over the cluster's triangles; the
// leaf's best is the smallest t, ties to the lowest triangle id, and is
// committed only if best_t < hit_t (and the id is a real one). Any-hit
// mode ends a ray at its first commit. A ray takes at most
// 2 * n_nodes + 4 steps, the TPU kernel's bound. Outputs hit_idx (-1 =
// miss) and t (t_max on a miss); the TPU kernel tracks no visits, and
// neither does this one (the wrapper returns zeros).
//
// On the TPU a node row and a cluster's triangles are fetched by one-hot
// matmuls ((8, M) @ onehot(M, T), (3K, C) @ onehot(C, T)), because Mosaic
// has no per-lane indexing. Here a thread walks one ray and fetches by
// index: a node is two float4 read with __ldg (min.xyz | skip,
// max.xyz | cluster), a triangle three float4 (v0.xyz | id, e1.xyz | 0,
// e2.xyz | 0), the same packed triangle table the sweep kernel reads
// (csrc/traverse_sweep.cu).
//
// What bounds it on this card: the tables are tens of KB to a few MB and
// stay in L2 (50 MB), so it is latency and warp divergence, not memory
// bandwidth. Each thread's walk is a chain of dependent loads; the base
// threading has no near-child-first order, so rays visit more nodes than
// in the sweep kernel's octant threadings.
//
// Built with -fmad=false so that each operation rounds as in the PyTorch
// twin (ops/traverse_pallas.py traverse_cluster_pallas_reference), in the
// twin's operation order; on the card the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kNoId = 1 << 30;
constexpr float kEps = 1e-6f;
constexpr int kBlock = 128;

// torch.maximum / torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kBlock)
traverse_pallas_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_max, int n,
                       const float4* __restrict__ nodes, int max_steps,
                       const float4* __restrict__ tris, int k, int anyhit,
                       int* __restrict__ hit_out, float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = __ldg(origin + 3 * r + 0);
  const float oy = __ldg(origin + 3 * r + 1);
  const float oz = __ldg(origin + 3 * r + 2);
  const float dx = __ldg(direction + 3 * r + 0);
  const float dy = __ldg(direction + 3 * r + 1);
  const float dz = __ldg(direction + 3 * r + 2);
  const float inv_x = 1.0f / dx;
  const float inv_y = 1.0f / dy;
  const float inv_z = 1.0f / dz;

  float hit_t = __ldg(t_max + r);
  int hit_idx = -1;
  int i = 0;
  for (int step = 0; i >= 0 && step < max_steps; ++step) {
    const float4 lo = __ldg(nodes + 2 * i);
    const float4 hi = __ldg(nodes + 2 * i + 1);
    const int skip = __float_as_int(lo.w);
    const int cluster = __float_as_int(hi.w);

    const float tx0 = (lo.x - ox) * inv_x;
    const float tx1 = (hi.x - ox) * inv_x;
    const float ty0 = (lo.y - oy) * inv_y;
    const float ty1 = (hi.y - oy) * inv_y;
    const float tz0 = (lo.z - oz) * inv_z;
    const float tz1 = (hi.z - oz) * inv_z;
    const float t_lo = max_nan(max_nan(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
    const float t_hi = min_nan(min_nan(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fmaxf(tz0, tz1));
    const float t_enter = max_nan(t_lo, 0.0f);
    const bool enter = (t_enter <= t_hi) && (t_hi >= 0.0f) &&
                       (t_enter < hit_t);

    int next = skip;
    if (enter && cluster < 0) {
      next = i + 1;
    } else if (enter) {
      const float cur_t = hit_t;
      float best_t = kBig;
      int best_id = kNoId;
      const float4* ct = tris + (size_t)cluster * k * 3;
      for (int j = 0; j < k; ++j) {
        const float4 a = __ldg(ct + 3 * j + 0);
        const float4 b = __ldg(ct + 3 * j + 1);
        const float4 c = __ldg(ct + 3 * j + 2);
        const int tri_id = __float_as_int(a.w);
        const float px = dy * c.z - dz * c.y;
        const float py = dz * c.x - dx * c.z;
        const float pz = dx * c.y - dy * c.x;
        const float det = b.x * px + b.y * py + b.z * pz;
        const bool par = fabsf(det) < kEps;
        const float inv_det = 1.0f / (par ? 1.0f : det);
        const float tvx = ox - a.x;
        const float tvy = oy - a.y;
        const float tvz = oz - a.z;
        const float u = inv_det * (tvx * px + tvy * py + tvz * pz);
        const float qx = tvy * b.z - tvz * b.y;
        const float qy = tvz * b.x - tvx * b.z;
        const float qz = tvx * b.y - tvy * b.x;
        const float v = inv_det * (dx * qx + dy * qy + dz * qz);
        const float tt = inv_det * (c.x * qx + c.y * qy + c.z * qz);
        // K2's valid has no id test: padding slots are degenerate
        // (det = 0), and the commit below rejects a negative id
        const bool valid = !par && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                           u + v <= 1.0f && tt > kEps && tt < cur_t;
        if (valid && (tt < best_t || (tt == best_t && tri_id < best_id))) {
          best_t = tt;
          best_id = tri_id;
        }
      }
      if (best_t < cur_t && best_id >= 0 && best_id < kNoId) {
        hit_t = best_t;
        hit_idx = best_id;
        if (anyhit) next = -1;
      }
    }
    i = next;
  }
  hit_out[r] = hit_idx;
  t_out[r] = hit_t;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int drt_traverse_pallas(const float* origin, const float* direction,
                                   const float* t_max, int n,
                                   const void* nodes, int max_steps,
                                   const void* tris, int k, int anyhit,
                                   int* hit_idx, float* t, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  traverse_pallas_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n, (const float4*)nodes, max_steps,
      (const float4*)tris, k, anyhit, hit_idx, t);
  return (int)cudaGetLastError();
}

// Resident blocks per SM (the occupancy calculator's figure for kBlock
// threads and no shared memory) into *out; returns a cudaError_t.
extern "C" int drt_traverse_pallas_occupancy(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, traverse_pallas_kernel, kBlock, 0);
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
