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
// leaf's best is the smallest t, ties to the lowest triangle id (a signed
// int), and is committed only if best_t < hit_t and the id lies in
// [0, 2^30). Any-hit mode ends a ray at its first commit. A ray takes at
// most 2 * n_nodes + 4 steps, the TPU kernel's bound. Outputs hit_idx
// (-1 = miss) and t (t_max on a miss); the TPU kernel tracks no visits,
// and neither does this one (the wrapper returns zeros). The walk order
// decides which cluster wins an exact t tie across clusters and which
// hit ends an any-hit ray, so it is the twin's: no child reordering, no
// octant threadings.
//
// On the TPU a node row and a cluster's triangles are fetched by one-hot
// matmuls ((8, M) @ onehot(M, T), (3K, C) @ onehot(C, T)), because Mosaic
// has no per-lane indexing, and the node table stays in VMEM for the
// whole kernel. Here a node is two float4 (min.xyz | skip,
// max.xyz | cluster) and a triangle three float4 (v0.xyz | id,
// e1.xyz | 0, e2.xyz | 0), the packed triangle table the sweep kernel
// reads (csrc/traverse_sweep.cu).
//
// What bounds it on this card: FP32 operations (26 per slab test, 57 per
// triangle test, utils/roofline.py) on tables of tens of KB to a few MB
// that stay in L1/L2, so not bandwidth; issue slots, divergence and the
// latency of dependent loads are. The base threading has no
// near-child-first order, so a ray visits more nodes than in the sweep
// kernel's octant threadings. The design, point by point:
//
// 1. One warp-uniform loop (while (__any_sync(live))): iteration s is
//    step s of every live lane's own walk (slab test, then i + 1 or
//    skip), as step s of the twin's lockstep loop, with the per-lane
//    bound of 2 * n_nodes + 4 steps. Lanes past n and lanes whose walk
//    ended stay in the loop, inactive, so every vote and shuffle has 32
//    lanes; no lane diverges into a serial leaf loop of its own.
// 2. The warp-cooperative leaf test: __ballot_sync collects the lanes
//    whose step entered a leaf, and the warp serves them one at a time,
//    lowest lane first. The served ray and its t before the leaf go to
//    every lane by __shfl_sync; lane j tests slot j (then j + 32, ... for
//    K > 32), so the 32 lanes read one coalesced cluster row instead of
//    one thread running K tests while its warp waits. The leaf's best is
//    the minimum of (t, id): __reduce_min_sync over the t bits (a valid
//    t is > 1e-6, so the bits order as the floats do), then a signed
//    __reduce_min_sync over the ids of the lanes holding that t, so a
//    valid slot with a negative id wins its tie and blocks the commit as
//    in the twin. Slots that fail the test carry (3.4e38, 2^30). The
//    next served lane's cluster row is loaded before the current one is
//    tested and reduced, so its latency overlaps that work.
// 3. A persistent schedule: as many blocks as are resident on the card
//    at once (the occupancy calculator x SMs); each warp takes the next
//    batch of 32 consecutive rays from a counter the caller zeroes, so
//    the long walks of a wave's tail do not wait for a new round of
//    blocks.
// 4. The node table in shared memory: a table of at most kSharedMaxNodes
//    nodes (1,024 x 32 B = 32 KB) is staged once per block, and every
//    walk step then reads shared memory, as the TPU kernel reads VMEM,
//    instead of a dependent read through the L1/L2 path. A larger table
//    runs the second instance of the kernel, which reads the nodes with
//    __ldg; traverse_cluster_pallas_global forces that instance on any
//    table. The limit is where the table stops paying on an H100
//    (PERF.md): a 1,009-node table ran 7-12% faster than __ldg on a
//    primary wave at 6 blocks per SM, a 2,017-node (64 KB) one 2-4%
//    slower at 3.
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
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// the largest node table staged in shared memory: 1,024 x 32 B = 32 KB,
// under the 48 KB a block may take without opting in
constexpr int kSharedMaxNodes = 1024;
constexpr int kNodeBytes = 32;

// torch.maximum / torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Params {
  const float* origin;     // (n, 3)
  const float* direction;  // (n, 3)
  const float* t_max;      // (n,)
  int n;
  const float4* nodes;  // (m, 2) float4
  int m;
  int max_steps;
  const float4* tris;  // (C, k, 3) float4
  int k;
  int anyhit;
  int* hit_out;
  float* t_out;
  int* next_batch;  // zeroed by the caller
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Slot j of cluster c: three float4. A slot past k reads nothing and is
// all zeros, which no ray hits (det = 0, or NaN through u).
__device__ __forceinline__ void load_slot(const float4* tris, int c, int k,
                                          int j, float4& a, float4& b,
                                          float4& e) {
  if (j < k) {
    const float4* row = tris + ((size_t)c * k + j) * 3;
    a = __ldg(row + 0);
    b = __ldg(row + 1);
    e = __ldg(row + 2);
  } else {
    a = b = e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Möller–Trumbore of ray s against the triangle (v0 | id, e1, e2) in the
// twin's operation order; whether the slot may win against cur_t. K2's
// test has no id term: padding slots are degenerate, and the commit
// rejects an id outside [0, 2^30).
__device__ __forceinline__ bool tri_test(const float4 a, const float4 b,
                                         const float4 c, const Ray& s,
                                         float cur_t, float& tt) {
  const float px = s.dy * c.z - s.dz * c.y;
  const float py = s.dz * c.x - s.dx * c.z;
  const float pz = s.dx * c.y - s.dy * c.x;
  const float det = b.x * px + b.y * py + b.z * pz;
  const bool par = fabsf(det) < kEps;
  const float inv_det = 1.0f / (par ? 1.0f : det);
  const float tvx = s.ox - a.x;
  const float tvy = s.oy - a.y;
  const float tvz = s.oz - a.z;
  const float u = inv_det * (tvx * px + tvy * py + tvz * pz);
  const float qx = tvy * b.z - tvz * b.y;
  const float qy = tvz * b.x - tvx * b.z;
  const float qz = tvx * b.y - tvy * b.x;
  const float v = inv_det * (s.dx * qx + s.dy * qy + s.dz * qz);
  tt = inv_det * (c.x * qx + c.y * qy + c.z * qz);
  return !par && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         tt > kEps && tt < cur_t;
}

// Node i's two float4: from the block's shared copy, or through the
// read-only path.
template <bool kShared>
__device__ __forceinline__ void load_node(const float4* nodes, int i,
                                          float4& lo, float4& hi) {
  if (kShared) {
    lo = nodes[2 * i];
    hi = nodes[2 * i + 1];
  } else {
    lo = __ldg(nodes + 2 * i);
    hi = __ldg(nodes + 2 * i + 1);
  }
}

// The rays batch * 32 + lane of one warp, walked to the end.
template <bool kShared>
__device__ __forceinline__ void trace_batch(const Params& p,
                                            const float4* nodes, int batch,
                                            int lane) {
  const int r = batch * kWarp + lane;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float inv_x = 0.0f, inv_y = 0.0f, inv_z = 0.0f, hit_t = 0.0f;
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
    hit_t = __ldg(p.t_max + r);
    i = 0;
  }
  int hit_idx = -1;

  for (int step = 0;; ++step) {
    const bool live = i >= 0 && step < p.max_steps;
    if (!__any_sync(kFull, live)) break;
    int next = i, cluster = -1;
    bool leaf = false;
    if (live) {
      float4 lo, hi;
      load_node<kShared>(nodes, i, lo, hi);
      const int skip = __float_as_int(lo.w);
      cluster = __float_as_int(hi.w);
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

        float best_t = kBig, tt;
        int best_id = kNoId;
        if (tri_test(a, b, e, sr, cur_t, tt)) {
          best_t = tt;
          best_id = __float_as_int(a.w);
        }
        for (int j = lane + kWarp; j < p.k; j += kWarp) {  // K > 32
          float4 xa, xb, xe;
          load_slot(p.tris, c, p.k, j, xa, xb, xe);
          const int id = __float_as_int(xa.w);
          if (tri_test(xa, xb, xe, sr, cur_t, tt) &&
              (tt < best_t || (tt == best_t && id < best_id))) {
            best_t = tt;
            best_id = id;
          }
        }
        // the leaf's minimum (t, id): unsigned over the t bits (every
        // candidate t is > 0), signed over the ids holding that t
        const unsigned t_bits = __float_as_uint(best_t);
        const unsigned min_t = __reduce_min_sync(kFull, t_bits);
        const int min_id =
            __reduce_min_sync(kFull, t_bits == min_t ? best_id : kNoId);
        const float win_t = __uint_as_float(min_t);
        if (lane == s && win_t < cur_t && min_id >= 0 && min_id < kNoId) {
          hit_t = win_t;
          hit_idx = min_id;
          if (p.anyhit) next = -1;
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
  if (r >= p.n) return;
  p.hit_out[r] = hit_idx;
  p.t_out[r] = hit_t;
}

// Persistent: each warp takes batches of 32 consecutive rays until none
// is left. The shared instance first stages the node table, once per
// block.
template <bool kShared>
__global__ void __launch_bounds__(kBlock) traverse_pallas_kernel(Params p) {
  extern __shared__ float4 shared_nodes[];
  const float4* nodes = p.nodes;
  if (kShared) {
    for (int j = threadIdx.x; j < 2 * p.m; j += kBlock)
      shared_nodes[j] = __ldg(p.nodes + j);
    __syncthreads();
    nodes = shared_nodes;
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int n_batches = (p.n + kWarp - 1) / kWarp;
  for (;;) {
    int batch = 0;
    if (lane == 0) batch = atomicAdd(p.next_batch, 1);
    batch = __shfl_sync(kFull, batch, 0);
    if (batch >= n_batches) return;
    trace_batch<kShared>(p, nodes, batch, lane);
  }
}

// Resident blocks per SM of one instance with `smem` bytes of dynamic
// shared memory on the current device (the occupancy calculator's
// figure), asked once per device and size.
template <bool kShared>
int blocks_per_sm(int smem, int* out) {
  static int cached_dev = -1, cached_smem = -1, cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev || smem != cached_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, traverse_pallas_kernel<kShared>, kBlock, smem);
    if (err != cudaSuccess) {
      cached_dev = -1;
      return (int)err;
    }
    cached_dev = dev;
    cached_smem = smem;
  }
  *out = cached;
  return 0;
}

// The launch of n rays on a table of m nodes: out[0] = 1 for the shared
// instance (m <= kSharedMaxNodes and not force_global), 0 for the __ldg
// one; out[1] resident blocks per SM; out[2] the grid (as many blocks as
// are resident at once, or fewer when the rays need fewer); out[3] the
// dynamic shared memory per block in bytes. Returns a cudaError_t.
int plan(int n, int m, int force_global, int* out) {
  const int shared = !force_global && m <= kSharedMaxNodes;
  const int smem = shared ? m * kNodeBytes : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int occ = shared ? blocks_per_sm<true>(smem, &per_sm)
                         : blocks_per_sm<false>(0, &per_sm);
  if (occ != 0) return occ;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_batches = (n + kWarp - 1) / kWarp;
  const int needed = (n_batches + kBlock / kWarp - 1) / (kBlock / kWarp);
  out[0] = shared;
  out[1] = per_sm;
  out[2] = sms * per_sm < needed ? sms * per_sm : needed;
  out[3] = smem;
  return 0;
}

int launch(const Params& p, int force_global, cudaStream_t stream) {
  if (p.n <= 0) return 0;
  if (p.k < 1 || p.m < 1 || p.next_batch == nullptr)
    return (int)cudaErrorInvalidValue;
  int cfg[4];
  const int err = plan(p.n, p.m, force_global, cfg);
  if (err != 0) return err;
  if (cfg[0])
    traverse_pallas_kernel<true><<<cfg[2], kBlock, cfg[3], stream>>>(p);
  else
    traverse_pallas_kernel<false><<<cfg[2], kBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `nodes`
// holds m base-threading nodes; a table of at most kSharedMaxNodes runs
// the shared-memory instance, a larger one the __ldg instance.
// `next_batch` is one int32 on the card, zero at the launch (the
// persistent schedule's batch counter).
extern "C" int drt_traverse_pallas(const float* origin, const float* direction,
                                   const float* t_max, int n,
                                   const void* nodes, int m, int max_steps,
                                   const void* tris, int k, int anyhit,
                                   int* hit_idx, float* t, int* next_batch,
                                   void* stream) {
  const Params p{origin, direction, t_max, n, (const float4*)nodes, m,
                 max_steps, (const float4*)tris, k, anyhit, hit_idx, t,
                 next_batch};
  return launch(p, 0, (cudaStream_t)stream);
}

// The same launch with the __ldg instance whatever the table's size.
extern "C" int drt_traverse_pallas_global(
    const float* origin, const float* direction, const float* t_max, int n,
    const void* nodes, int m, int max_steps, const void* tris, int k,
    int anyhit, int* hit_idx, float* t, int* next_batch, void* stream) {
  const Params p{origin, direction, t_max, n, (const float4*)nodes, m,
                 max_steps, (const float4*)tris, k, anyhit, hit_idx, t,
                 next_batch};
  return launch(p, 1, (cudaStream_t)stream);
}

// Resident blocks per SM of the __ldg instance (kBlock threads, no shared
// memory) into *out; returns a cudaError_t.
extern "C" int drt_traverse_pallas_occupancy(int* out) {
  return blocks_per_sm<false>(0, out);
}

// What a launch of n rays on m nodes runs (see plan) into out[0..3];
// returns a cudaError_t.
extern "C" int drt_traverse_pallas_launch_config(int n, int m,
                                                 int force_global, int* out) {
  return plan(n, m, force_global, out);
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
