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
// tables). Each ray walks the near-child-first threading of its OWN
// direction octant (bit2 = x<0, bit1 = y<0, bit0 = z<0); the TPU kernel
// takes the octant of a tile's first ray. Any threading gives the same
// hit_idx and t but for exact-t ties across clusters; visits follow the
// octant, so they are compared with the PyTorch twin (same per-ray
// rule), not with the TPU kernel.
//
// What bounds it on this card: the work is FP32 operations (26 per slab
// test, 57 per triangle test, utils/roofline.py) on node and triangle
// tables that stay in L1/L2, so bandwidth is not the limit; issue slots
// and dependent-load latency are. A walk step is one slab test on a
// node that depends on the previous step; a leaf is K triangle tests. If
// each thread tested its own leaf's K triangles, the warp's other lanes
// would sit masked through 32 serial tests (17-32% of those lane slots
// were useful on the card) and the 32 lanes' reads would go to 32
// clusters. The design:
//
// - One warp-uniform loop (while (__any_sync(live))): iteration s is one
//   step of every live lane, slab test then descend or skip, as step s
//   of the twin's lockstep loop. Lanes past n and lanes whose walk ended
//   stay in the loop, inactive, so every vote and shuffle has 32 lanes.
// - The warp-cooperative leaf test: __ballot_sync collects the lanes
//   whose step entered a leaf, and the warp serves them one at a time,
//   lowest lane first. The served lane's ray, t and cluster go to every
//   lane by __shfl_sync; lane j tests slot j (j + 32, ... for K > 32),
//   three float4 of one coalesced 1.5 KB cluster row; lanes j >= K idle.
//   The warp's best is the minimum of (t, id): __reduce_min_sync over
//   the t bits (all candidate t are positive, so their bit patterns order
//   as the floats do), then over the ids of the lanes holding that t.
//   Slots that fail `valid` carry (3.4e38, 2^30). The test compares with
//   the served ray's t before the leaf, so the outcome does not depend on
//   the order of the slots: it is the twin's.
// - The next served lane's cluster row is loaded before the current one
//   is tested and reduced, so its latency overlaps that work.
// - A persistent schedule: as many blocks as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); each warp takes
//   the next batch of 32 consecutive rays from a counter the caller
//   zeroes, until none is left, so the long rays of the wave's tail do
//   not wait for a new round of blocks.
//
// A node is two float4 (min.xyz | skip, max.xyz | cluster), octant-major
// (8, M); a triangle is three float4 (v0.xyz | id, e1.xyz | 0,
// e2.xyz | 0), cluster-major; both read through the read-only path.
//
// Built with -fmad=false so that each operation rounds as in the PyTorch
// twin (ops/traverse_sweep.py traverse_cluster_sweep_reference), whose
// eager ops round one by one; the operation order is the twin's, e.g.
// det = e1x*px + e1y*py + e1z*pz, left to right.
//
// Emit mode (the TPU kernel's `attrs`, traverse_sweep.py:347-379): the
// in-kernel shading fetch. A commit also takes the winning slot and its
// u, v from the lane that tested it; after the walk each ray reads that
// slot's row of the attribute table once (three float4: [uv0.xy uv1.xy]
// [uv2.xy fn.xy] [fn.z mat 0 0]) and writes uv = (1-u-v)*uv0 + u*uv1 +
// v*uv2, face_nrm and mat; misses get zeros.
//
// Count mode (the TPU kernel's per-tile executed-work counters
// exec_windows / exec_leafs, traverse_sweep.py:141-142, :392-397): the
// lockstep unit on this card is a warp of 32 consecutive rays, not a TPU
// tile. exec_windows[w] = loop iterations warp w executed (= max visits
// over its lanes), exec_leafs[w] = iterations in which at least one lane
// entered a leaf, leaf_tests[r] = leaves ray r tested.
//
// The three modes are template instances of one kernel, so hit_idx, t
// and visits do not depend on the mode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kNoId = 1 << 30;
constexpr float kEps = 1e-6f;
constexpr int kBlock = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

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

struct Params {
  const float* origin;     // (n, 3)
  const float* direction;  // (n, 3)
  const float* t_max;      // (n,)
  int n;
  const float4* nodes;  // (8, m, 2) float4
  int m;
  const float4* tris;  // (C, k, 3) float4
  int k;
  int anyhit;
  int* hit_out;
  float* t_out;
  int* visits_out;
  EmitOut emit;
  CountOut count;
  int* next_batch;  // zeroed by the caller
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Slot j of cluster c: three float4. A slot past k reads nothing and
// gets id -1, which `valid` rejects.
__device__ __forceinline__ void load_slot(const float4* tris, int c, int k,
                                          int j, float4& a, float4& b,
                                          float4& e) {
  if (j < k) {
    const float4* row = tris + ((size_t)c * k + j) * 3;
    a = __ldg(row + 0);
    b = __ldg(row + 1);
    e = __ldg(row + 2);
  } else {
    a = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    b = e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Möller–Trumbore of ray s against the triangle (v0 | id, e1, e2) in the
// twin's operation order; whether the slot may win against cur_t.
__device__ __forceinline__ bool tri_test(const float4 a, const float4 b,
                                         const float4 c, const Ray& s,
                                         float cur_t, float& tt, float& u,
                                         float& v) {
  const int tri_id = __float_as_int(a.w);
  const float px = s.dy * c.z - s.dz * c.y;
  const float py = s.dz * c.x - s.dx * c.z;
  const float pz = s.dx * c.y - s.dy * c.x;
  const float det = b.x * px + b.y * py + b.z * pz;
  const bool par = fabsf(det) < kEps;
  const float inv_det = 1.0f / (par ? 1.0f : det);
  const float tvx = s.ox - a.x;
  const float tvy = s.oy - a.y;
  const float tvz = s.oz - a.z;
  u = inv_det * (tvx * px + tvy * py + tvz * pz);
  const float qx = tvy * b.z - tvz * b.y;
  const float qy = tvz * b.x - tvx * b.z;
  const float qz = tvx * b.y - tvy * b.x;
  v = inv_det * (s.dx * qx + s.dy * qy + s.dz * qz);
  tt = inv_det * (c.x * qx + c.y * qy + c.z * qz);
  return !par && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         tt > kEps && tri_id >= 0 && tt < cur_t;
}

// The rays batch * 32 + lane of one warp, walked to the end.
template <bool kEmit, bool kCount>
__device__ __forceinline__ void trace_batch(const Params& p, int batch,
                                            int lane) {
  const int r = batch * kWarp + lane;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float inv_x = 0.0f, inv_y = 0.0f, inv_z = 0.0f, hit_t = 0.0f;
  const float4* tab = p.nodes;
  int i = -1;  // the node a lane stands on; -1: no walk (done or past n)
  if (r < p.n) {
    ray.ox = __ldg(p.origin + 3 * r + 0);
    ray.oy = __ldg(p.origin + 3 * r + 1);
    ray.oz = __ldg(p.origin + 3 * r + 2);
    ray.dx = __ldg(p.direction + 3 * r + 0);
    ray.dy = __ldg(p.direction + 3 * r + 1);
    ray.dz = __ldg(p.direction + 3 * r + 2);
    inv_x = 1.0f / ray.dx;
    inv_y = 1.0f / ray.dy;
    inv_z = 1.0f / ray.dz;
    const int oct =
        (ray.dx < 0.0f) * 4 + (ray.dy < 0.0f) * 2 + (ray.dz < 0.0f);
    tab = p.nodes + (size_t)oct * p.m * 2;
    hit_t = __ldg(p.t_max + r);
    i = 0;
  }
  int hit_idx = -1, visits = 0;
  int win_c = 0, win_j = 0;  // emit mode: the committed hit's slot
  float win_u = 0.0f, win_v = 0.0f;
  int windows = 0, leafs = 0, tests = 0;

  // pre-order pointers only move forward, so a walk ends within m steps;
  // the bound only guards against a malformed table
  for (int step = 0;; ++step) {
    const bool live = i >= 0 && step < p.m + 4;
    if (!__any_sync(kFull, live)) break;
    int next = i, cluster = -1;
    bool leaf = false;
    if (live) {
      const float4 lo = __ldg(tab + 2 * i);
      const float4 hi = __ldg(tab + 2 * i + 1);
      const int skip = __float_as_int(lo.w);
      cluster = __float_as_int(hi.w);
      ++visits;
      const float tx0 = (lo.x - ray.ox) * inv_x;
      const float tx1 = (hi.x - ray.ox) * inv_x;
      const float ty0 = (lo.y - ray.oy) * inv_y;
      const float ty1 = (hi.y - ray.oy) * inv_y;
      const float tz0 = (lo.z - ray.oz) * inv_z;
      const float tz1 = (hi.z - ray.oz) * inv_z;
      const float t_lo = max_nan(max_nan(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fminf(tz0, tz1));
      const float t_hi = min_nan(min_nan(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fmaxf(tz0, tz1));
      const float t_enter = max_nan(t_lo, 0.0f);
      const bool enter =
          (t_enter <= t_hi) && (t_hi >= 0.0f) && (t_enter < hit_t);
      next = (enter && cluster < 0) ? i + 1 : skip;
      leaf = enter && cluster >= 0;
    }
    unsigned pend = __ballot_sync(kFull, leaf);
    if (kCount) {
      ++windows;
      leafs += pend != 0u;
      tests += leaf;
    }
    if (pend != 0u) {
      // serve the leaf lanes one at a time, lowest first; the row of the
      // next one is in flight while the current one is tested
      int s = __ffs(pend) - 1;
      int c = __shfl_sync(kFull, cluster, s);
      float4 a, b, e;
      load_slot(p.tris, c, p.k, lane, a, b, e);
      for (;;) {
        const Ray sr{__shfl_sync(kFull, ray.ox, s),
                     __shfl_sync(kFull, ray.oy, s),
                     __shfl_sync(kFull, ray.oz, s),
                     __shfl_sync(kFull, ray.dx, s),
                     __shfl_sync(kFull, ray.dy, s),
                     __shfl_sync(kFull, ray.dz, s)};
        const float cur_t = __shfl_sync(kFull, hit_t, s);
        pend &= pend - 1u;
        const int s_next = pend != 0u ? __ffs(pend) - 1 : s;
        const int c_next = __shfl_sync(kFull, cluster, s_next);
        float4 na, nb, ne;
        load_slot(p.tris, c_next, p.k, pend != 0u ? lane : p.k, na, nb, ne);

        float best_t = kBig, tt, u, v;
        int best_id = kNoId, best_j = 0;
        float best_u = 0.0f, best_v = 0.0f;
        if (tri_test(a, b, e, sr, cur_t, tt, u, v)) {
          best_t = tt;
          best_id = __float_as_int(a.w);
          best_j = lane;
          best_u = u;
          best_v = v;
        }
        for (int j = lane + kWarp; j < p.k; j += kWarp) {  // K > 32
          float4 xa, xb, xe;
          load_slot(p.tris, c, p.k, j, xa, xb, xe);
          const int id = __float_as_int(xa.w);
          if (tri_test(xa, xb, xe, sr, cur_t, tt, u, v) &&
              (tt < best_t || (tt == best_t && id < best_id))) {
            best_t = tt;
            best_id = id;
            best_j = j;
            best_u = u;
            best_v = v;
          }
        }
        // the warp's minimum (t, id); every candidate t is > 0
        const unsigned t_bits = __float_as_uint(best_t);
        const unsigned min_t = __reduce_min_sync(kFull, t_bits);
        const unsigned min_id = __reduce_min_sync(
            kFull, t_bits == min_t ? (unsigned)best_id : (unsigned)kNoId);
        const float win_t = __uint_as_float(min_t);
        if (min_id < (unsigned)kNoId && win_t < cur_t) {  // warp-uniform
          if (kEmit) {  // ids are unique: one lane holds the winner
            const int w = __ffs(__ballot_sync(
                              kFull, t_bits == min_t &&
                                         (unsigned)best_id == min_id)) -
                          1;
            const int wj = __shfl_sync(kFull, best_j, w);
            const float wu = __shfl_sync(kFull, best_u, w);
            const float wv = __shfl_sync(kFull, best_v, w);
            if (lane == s) {
              win_c = c;
              win_j = wj;
              win_u = wu;
              win_v = wv;
            }
          }
          if (lane == s) {
            hit_t = win_t;
            hit_idx = (int)min_id;
            if (p.anyhit) next = -1;
          }
        }
        if (pend == 0u) break;
        s = s_next;
        c = c_next;
        a = na;
        b = nb;
        e = ne;
      }
    }
    i = next;
  }

  if (kCount && lane == 0) {
    p.count.exec_windows[batch] = windows;
    p.count.exec_leafs[batch] = leafs;
  }
  if (r >= p.n) return;
  if (kCount) p.count.leaf_tests[r] = tests;
  p.hit_out[r] = hit_idx;
  p.t_out[r] = hit_t;
  p.visits_out[r] = visits;
  if (kEmit) {
    float uvx = 0.0f, uvy = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
    int mat = 0;
    if (hit_idx >= 0) {
      const float4* row = p.emit.attrs + ((size_t)win_c * p.k + win_j) * 3;
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
    p.emit.u[r] = win_u;
    p.emit.v[r] = win_v;
    p.emit.uv[2 * r + 0] = uvx;
    p.emit.uv[2 * r + 1] = uvy;
    p.emit.face_nrm[3 * r + 0] = fx;
    p.emit.face_nrm[3 * r + 1] = fy;
    p.emit.face_nrm[3 * r + 2] = fz;
    p.emit.mat[r] = mat;
  }
}

// Persistent: each warp takes batches of 32 consecutive rays until none
// is left.
template <bool kEmit, bool kCount>
__global__ void __launch_bounds__(kBlock) traverse_sweep_kernel(Params p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int n_batches = (p.n + kWarp - 1) / kWarp;
  for (;;) {
    int batch = 0;
    if (lane == 0) batch = atomicAdd(p.next_batch, 1);
    batch = __shfl_sync(kFull, batch, 0);
    if (batch >= n_batches) return;
    trace_batch<kEmit, kCount>(p, batch, lane);
  }
}

// Resident blocks per SM of one instance (the occupancy calculator's
// figure for kBlock threads and no shared memory), asked once.
template <bool kEmit, bool kCount>
int blocks_per_sm(int* out) {
  static int cached = 0;
  if (cached == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, traverse_sweep_kernel<kEmit, kCount>, kBlock, 0);
    if (err != cudaSuccess) {
      cached = 0;
      return (int)err;
    }
  }
  *out = cached;
  return 0;
}

// As many blocks as are resident on the card at once, or fewer when the
// rays need fewer.
template <bool kEmit, bool kCount>
int launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int occ = blocks_per_sm<kEmit, kCount>(&per_sm);
  if (occ != 0) return occ;
  const int n_batches = (p.n + kWarp - 1) / kWarp;
  const int needed = (n_batches + kBlock / kWarp - 1) / (kBlock / kWarp);
  const int blocks = sms * per_sm < needed ? sms * per_sm : needed;
  traverse_sweep_kernel<kEmit, kCount><<<blocks, kBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). A
// non-null `attrs` selects emit mode, which then writes u, v, uv,
// face_nrm and mat; a non-null `exec_windows` selects count mode, which
// writes exec_windows, exec_leafs and leaf_tests. The two modes are
// exclusive; the pointers of a mode that is off are not read.
// `next_batch` is one int32 on the card, zero at the launch (the
// persistent schedule's batch counter).
extern "C" int drt_traverse_sweep(const float* origin, const float* direction,
                                  const float* t_max, int n,
                                  const void* nodes, int m, const void* tris,
                                  int k, int anyhit, int* hit_idx, float* t,
                                  int* visits, const void* attrs, float* u,
                                  float* v, float* uv, float* face_nrm,
                                  int* mat, int* exec_windows,
                                  int* exec_leafs, int* leaf_tests,
                                  int* next_batch, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || next_batch == nullptr) return (int)cudaErrorInvalidValue;
  if (attrs != nullptr && exec_windows != nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p{origin, direction, t_max, n, (const float4*)nodes, m,
                 (const float4*)tris, k, anyhit, hit_idx, t, visits,
                 EmitOut{(const float4*)attrs, u, v, uv, face_nrm, mat},
                 CountOut{exec_windows, exec_leafs, leaf_tests}, next_batch};
  cudaStream_t s = (cudaStream_t)stream;
  if (attrs != nullptr) return launch<true, false>(p, s);
  if (exec_windows != nullptr) return launch<false, true>(p, s);
  return launch<false, false>(p, s);
}

// Resident blocks per SM of the instance `mode` (0 plain, 1 emit_attrs,
// 2 counters) into *out; returns a cudaError_t (0 = success).
extern "C" int drt_traverse_sweep_occupancy(int mode, int* out) {
  if (mode == 1) return blocks_per_sm<true, false>(out);
  if (mode == 2) return blocks_per_sm<false, true>(out);
  return blocks_per_sm<false, false>(out);
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
