// Cluster-BVH closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dustraytracer_tpu/ops/traverse_sweep.py
// `_kernel` (launched by `_traverse_impl` through `traverse_cluster_sweep`).
// It computes what `_kernel` computes, per ray: a walk of a threaded
// pre-order cluster BVH (enter an interior node -> i + 1, otherwise ->
// skip, skip == -1 -> done), a NaN-suppressing slab test against the
// current hit t, and at each entered leaf a Möller–Trumbore test of the
// cluster's K triangles; the leaf's best is the smallest t (ties to the
// lowest triangle id) and is committed only if it improves t. Any-hit
// mode stops a ray at its first committed hit. Outputs hit_idx (-1 =
// miss), t and visits (nodes the ray stood on).
//
// It does not copy the TPU kernel's schedule (uniform scalar cursor over a
// ray tile, UNROLL windows, SMEM paging, one-hot leaf matvec, planar
// tables). Here one thread walks one ray with its own node pointer, and
// each ray walks the near-child-first threading of its OWN direction
// octant (bit2 = x<0, bit1 = y<0, bit0 = z<0); the TPU kernel takes the
// octant of a tile's first ray. Any threading gives the same hit_idx and
// t; visits follow the octant, so they are compared with the PyTorch twin
// (same per-ray rule), not with the TPU kernel.
//
// What bounds it: a leaf is 32 Möller–Trumbore tests of about 50 FP32
// operations each, and the node and triangle tables (tens of KB to a few
// MB) stay resident in L1/L2, so the kernel is bound by latency and warp
// divergence, not by memory bandwidth. The design answers that with
// 16-byte loads through the read-only path (__ldg): a node is two float4
// (min.xyz | skip, max.xyz | cluster), octant-major (8, M); a triangle is
// three float4 (v0.xyz | id, e1.xyz | 0, e2.xyz | 0), cluster-major.
//
// Built with -fmad=false so that each operation rounds as in the PyTorch
// twin (ops/traverse_sweep.py traverse_cluster_sweep_reference), whose
// eager ops round one by one; the operation order is the twin's, e.g.
// det = e1x*px + e1y*py + e1z*pz, left to right.
//
// Emit mode (the TPU kernel's `attrs`, traverse_sweep.py:347-379): the
// in-kernel shading fetch. The TPU body selects the winner's u, v, uv,
// face normal and material with a masked K-reduce at every executed
// leaf; here a thread keeps the winning slot's (cluster, slot, u, v) as
// the Möller–Trumbore test that committed it computed them, and after
// the walk reads that slot's row of the attribute table once (three
// float4: [uv0.xy uv1.xy] [uv2.xy fn.xy] [fn.z mat 0 0]) and writes
// uv = (1-u-v)*uv0 + u*uv1 + v*uv2, face_nrm and mat; misses get zeros.
// It is a template instance of the same kernel, so hit_idx, t and
// visits do not depend on the mode.

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

struct EmitOut {
  const float4* attrs;  // (C, K, 3) float4 rows, see the header
  float* u;
  float* v;
  float* uv;        // (N, 2)
  float* face_nrm;  // (N, 3)
  int* mat;
};

template <bool kEmit>
__global__ void __launch_bounds__(kBlock)
traverse_sweep_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_max, int n,
                      const float4* __restrict__ nodes, int m,
                      const float4* __restrict__ tris, int k, int anyhit,
                      int* __restrict__ hit_out, float* __restrict__ t_out,
                      int* __restrict__ visits_out, EmitOut emit) {
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
  const int oct = (dx < 0.0f) * 4 + (dy < 0.0f) * 2 + (dz < 0.0f);
  const float4* tab = nodes + (size_t)oct * m * 2;

  float hit_t = __ldg(t_max + r);
  int hit_idx = -1;
  int visits = 0;
  int win_c = 0, win_j = 0;  // emit mode: the committed hit's slot
  float win_u = 0.0f, win_v = 0.0f;
  int i = 0;
  // pre-order pointers only move forward, so a walk ends within m steps;
  // the bound only guards against a malformed table
  for (int step = 0; i >= 0 && step < m + 4; ++step) {
    const float4 lo = __ldg(tab + 2 * i);
    const float4 hi = __ldg(tab + 2 * i + 1);
    const int skip = __float_as_int(lo.w);
    const int cluster = __float_as_int(hi.w);
    ++visits;

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
      int best_j = 0;
      float best_u = 0.0f, best_v = 0.0f;
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
        const bool valid = !par && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                           u + v <= 1.0f && tt > kEps && tri_id >= 0 &&
                           tt < cur_t;
        if (valid && (tt < best_t || (tt == best_t && tri_id < best_id))) {
          best_t = tt;
          best_id = tri_id;
          if (kEmit) {
            best_j = j;
            best_u = u;
            best_v = v;
          }
        }
      }
      if (best_id < kNoId && best_t < cur_t) {
        hit_t = best_t;
        hit_idx = best_id;
        if (kEmit) {
          win_c = cluster;
          win_j = best_j;
          win_u = best_u;
          win_v = best_v;
        }
        if (anyhit) next = -1;
      }
    }
    i = next;
  }
  hit_out[r] = hit_idx;
  t_out[r] = hit_t;
  visits_out[r] = visits;
  if (kEmit) {
    float uvx = 0.0f, uvy = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
    int mat = 0;
    if (hit_idx >= 0) {
      const float4* row = emit.attrs + ((size_t)win_c * k + win_j) * 3;
      const float4 a = __ldg(row + 0);  // uv0.xy uv1.xy
      const float4 b = __ldg(row + 1);  // uv2.xy fn.xy
      const float4 c = __ldg(row + 2);  // fn.z mat
      const float w = 1.0f - win_u - win_v;
      uvx = w * a.x + win_u * a.z + win_v * b.x;
      uvy = w * a.y + win_u * a.w + win_v * b.y;
      fx = b.z;
      fy = b.w;
      fz = c.x;
      mat = __float_as_int(c.y);
    }
    emit.u[r] = win_u;
    emit.v[r] = win_v;
    emit.uv[2 * r + 0] = uvx;
    emit.uv[2 * r + 1] = uvy;
    emit.face_nrm[3 * r + 0] = fx;
    emit.face_nrm[3 * r + 1] = fy;
    emit.face_nrm[3 * r + 2] = fz;
    emit.mat[r] = mat;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). A
// non-null `attrs` selects emit mode, which then writes u, v, uv,
// face_nrm and mat; with a null `attrs` those pointers are not read.
extern "C" int drt_traverse_sweep(const float* origin, const float* direction,
                                  const float* t_max, int n,
                                  const void* nodes, int m, const void* tris,
                                  int k, int anyhit, int* hit_idx, float* t,
                                  int* visits, const void* attrs, float* u,
                                  float* v, float* uv, float* face_nrm,
                                  int* mat, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  const EmitOut emit{(const float4*)attrs, u, v, uv, face_nrm, mat};
  if (attrs != nullptr) {
    traverse_sweep_kernel<true><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        origin, direction, t_max, n, (const float4*)nodes, m,
        (const float4*)tris, k, anyhit, hit_idx, t, visits, emit);
  } else {
    traverse_sweep_kernel<false><<<blocks, kBlock, 0,
                                   (cudaStream_t)stream>>>(
        origin, direction, t_max, n, (const float4*)nodes, m,
        (const float4*)tris, k, anyhit, hit_idx, t, visits, emit);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
