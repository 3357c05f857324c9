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
//
// Count mode (the TPU kernel's per-tile executed-work counters
// exec_windows / exec_leafs, traverse_sweep.py:141-142, :392-397): the
// lockstep unit on this card is a warp of 32 consecutive rays, not a TPU
// tile. A third template instance runs the same walk in a warp-uniform
// loop (while (__any_sync(live))) so that a warp's iterations can be
// counted: exec_windows[w] = loop iterations warp w executed (= max
// visits over its lanes), exec_leafs[w] = iterations in which
// __ballot_sync found at least one lane running the K-wide leaf test,
// and leaf_tests[r] = leaves ray r tested. Lanes past n of the last
// warp stay in the loop, inactive, so the warp votes stay full. The
// plain and emit instances keep their per-thread loop and early return.

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

struct CountOut {
  int* exec_windows;  // (ceil(n / 32),)
  int* exec_leafs;    // (ceil(n / 32),)
  int* leaf_tests;    // (n,)
};

// One ray's walk state and its step: stand on node i, slab-test it,
// descend or skip, and at an entered leaf test its K triangles. Returns
// whether this step ran the leaf test.
template <bool kEmit>
struct Walk {
  float ox, oy, oz, dx, dy, dz, inv_x, inv_y, inv_z;
  const float4* tab;
  const float4* tris;
  int k, anyhit;
  float hit_t;
  int hit_idx = -1;
  int visits = 0;
  int win_c = 0, win_j = 0;  // emit mode: the committed hit's slot
  float win_u = 0.0f, win_v = 0.0f;
  int i = 0;

  __device__ __forceinline__ bool step() {
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
    return enter && cluster >= 0;
  }
};

template <bool kEmit, bool kCount>
__global__ void __launch_bounds__(kBlock)
traverse_sweep_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_max, int n,
                      const float4* __restrict__ nodes, int m,
                      const float4* __restrict__ tris, int k, int anyhit,
                      int* __restrict__ hit_out, float* __restrict__ t_out,
                      int* __restrict__ visits_out, EmitOut emit,
                      CountOut count) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kCount && r >= n) return;
  // count mode: a lane past n reads ray 0 and never walks
  const int q = (kCount && r >= n) ? 0 : r;
  Walk<kEmit> w;
  w.ox = __ldg(origin + 3 * q + 0);
  w.oy = __ldg(origin + 3 * q + 1);
  w.oz = __ldg(origin + 3 * q + 2);
  w.dx = __ldg(direction + 3 * q + 0);
  w.dy = __ldg(direction + 3 * q + 1);
  w.dz = __ldg(direction + 3 * q + 2);
  w.inv_x = 1.0f / w.dx;
  w.inv_y = 1.0f / w.dy;
  w.inv_z = 1.0f / w.dz;
  const int oct = (w.dx < 0.0f) * 4 + (w.dy < 0.0f) * 2 + (w.dz < 0.0f);
  w.tab = nodes + (size_t)oct * m * 2;
  w.tris = tris;
  w.k = k;
  w.anyhit = anyhit;
  w.hit_t = __ldg(t_max + q);
  // pre-order pointers only move forward, so a walk ends within m steps;
  // the bound only guards against a malformed table
  if (!kCount) {
    for (int step = 0; w.i >= 0 && step < m + 4; ++step) w.step();
  } else {
    if (r >= n) w.i = -1;
    int windows = 0, leafs = 0, tests = 0;
    for (int step = 0;; ++step) {
      const bool live = w.i >= 0 && step < m + 4;
      if (!__any_sync(0xffffffffu, live)) break;
      const bool leaf = live && w.step();
      ++windows;
      if (__ballot_sync(0xffffffffu, leaf) != 0u) ++leafs;
      tests += leaf;
    }
    if (r >= n) return;
    count.leaf_tests[r] = tests;
    if ((threadIdx.x & 31) == 0) {
      count.exec_windows[r >> 5] = windows;
      count.exec_leafs[r >> 5] = leafs;
    }
  }
  const int hit_idx = w.hit_idx;
  const float hit_t = w.hit_t;
  const int win_c = w.win_c, win_j = w.win_j;
  const float win_u = w.win_u, win_v = w.win_v;
  hit_out[r] = hit_idx;
  t_out[r] = hit_t;
  visits_out[r] = w.visits;
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
// face_nrm and mat; a non-null `exec_windows` selects count mode, which
// writes exec_windows, exec_leafs and leaf_tests. The two modes are
// exclusive; the pointers of a mode that is off are not read.
extern "C" int drt_traverse_sweep(const float* origin, const float* direction,
                                  const float* t_max, int n,
                                  const void* nodes, int m, const void* tris,
                                  int k, int anyhit, int* hit_idx, float* t,
                                  int* visits, const void* attrs, float* u,
                                  float* v, float* uv, float* face_nrm,
                                  int* mat, int* exec_windows,
                                  int* exec_leafs, int* leaf_tests,
                                  void* stream) {
  if (n <= 0) return 0;
  if (attrs != nullptr && exec_windows != nullptr)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBlock - 1) / kBlock;
  const EmitOut emit{(const float4*)attrs, u, v, uv, face_nrm, mat};
  const CountOut count{exec_windows, exec_leafs, leaf_tests};
  cudaStream_t s = (cudaStream_t)stream;
  const float4* nd = (const float4*)nodes;
  const float4* tr = (const float4*)tris;
  if (attrs != nullptr) {
    traverse_sweep_kernel<true, false><<<blocks, kBlock, 0, s>>>(
        origin, direction, t_max, n, nd, m, tr, k, anyhit, hit_idx, t,
        visits, emit, count);
  } else if (exec_windows != nullptr) {
    traverse_sweep_kernel<false, true><<<blocks, kBlock, 0, s>>>(
        origin, direction, t_max, n, nd, m, tr, k, anyhit, hit_idx, t,
        visits, emit, count);
  } else {
    traverse_sweep_kernel<false, false><<<blocks, kBlock, 0, s>>>(
        origin, direction, t_max, n, nd, m, tr, k, anyhit, hit_idx, t,
        visits, emit, count);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
