// K4: the backward of the row fetch out = table[idx] (dim 0), on Hopper
// (sm_90a): d_table[r, :] = sum of grad[i, :] over the lanes i with
// idx[i] == r, added in an order fixed by (idx, lane) and the shapes
// (N, n_rows, C) alone, with no floating-point atomics, so two launches on
// equal inputs give equal bits.
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
// floats, row stride `ld`), its id once, each table row written once; the
// adds are one per value read. What costs time above that bound is the
// order: the lanes of one row must be found and added in a fixed order.
//
// Two instances, chosen by the shapes alone (ops/rows.py::rows_grad):
//
// Plan-free, n_rows * C <= kSmallSlots (the 2 x 11 material table):
//   rows_grad_tiles: the N lanes are cut into per_block lanes a block
//      (per_block depends on N only), staged kSmallTile lanes at a time in
//      shared memory by coalesced loads (16 bytes a thread where the rows
//      are contiguous and aligned). Thread t owns one (row, column) slot s
//      = t % slots of lane group g = t / slots: it adds, tile after tile,
//      the lanes of its group's fixed sub-range whose id is its row, in
//      lane order. The groups are then added in group order; the block's
//      sum goes to partial[block, slot].
//   rows_grad_tile_sum: one warp a slot adds the blocks' partials, lane l
//      taking blocks l, l + 32, ... in order, then a fixed shuffle tree.
//   Two launches; the bytes are read once. No sort, no plan.
//
// Planned, every other shape (triangles 16,130 x 19, texels 65,536 x 4):
//   The plan is a stable sort of the lanes by id over only the bits the
//   ids use (ceil(log2 n_rows), one LSD radix pass per 8 bits), with
//   32-bit keys and lane numbers:
//   rows_grad_hist: per block of kSortTile lanes, the digit histogram
//      (integer shared atomics, exact).
//   rows_grad_scan: per digit, one warp: the prefix over the blocks and
//      the digit's total (the scatter scans the 256 totals itself).
//   rows_grad_scatter: each block loads its lanes at once and ranks them
//      stably: rounds of 256 lanes in lane order; in a warp
//      __match_any_sync groups equal digits and a __popc of the lower
//      lanes ranks them; the warps of a round are put in order through
//      shared memory, and a running count per digit carries the rounds.
//      The block then sorts its lanes in shared memory and writes each
//      digit's run out with neighbouring threads on neighbouring outputs.
//   rows_grad_starts: each row's first sorted position, by a binary search
//      of the sorted keys (one thread a row), so perm and starts equal
//      torch.sort(stable) and searchsorted's integers (ops/rows.py::plan).
//   The sum over a row's run of sorted lanes [starts[r], starts[r+1]) is
//   cut into chunks of kChunk lanes, which take the slots from
//   starts[r] / kChunk + r on: no scan numbers them (see below).
//   rows_grad_heads: at each chunk's first sorted lane, chunk_row[slot] =
//      r (so no warp searches for its row); rows of more than one chunk
//      are listed for pass 2; rows with no lanes are written as zero.
//   rows_grad_chunks (pass 1): lanes map to (lane group, column): a group
//      is the next power of two >= C lanes (4 for texels: 8 groups a
//      warp; 32 for C = 19 or 28: one group, columns past 32 in turns),
//      and each group sums its own chunk slot's lanes in order, lane c on
//      column c. So a warp serves 8 texel chunks at once (most texel rows
//      hold ~4 lanes), and with C = 19 or 28 one chunk with 19 or 28 of
//      its 32 lanes, as before. A row of one chunk is written to out here
//      (most triangle and texel rows); other chunks go to partial[slot].
//   rows_grad_rows (pass 2), only the listed rows: one block of 1,024
//      threads a row, lanes on (chunk slot, column): group g adds the
//      row's chunks g, g + G, ... in order, a fixed shuffle tree joins the
//      groups of a warp, then the warps in order.
//   10 launches for two radix passes; nothing is read back to the host:
//   grids are sized from N, n_rows and C (max_chunks, max_multi), and
//   warps past the device's counts leave at once.
// Every branch around a shuffle is warp-uniform; every __syncthreads is
// reached by the whole block. Kernels run on the caller's stream and
// allocate nothing: the wrapper passes the workspaces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;
constexpr int kChunk = 128;            // sorted lanes per chunk (pass 1)
constexpr int kRadix = 256;            // digits per sort pass; its block
constexpr int kRadixWarps = kRadix / kWarp;
constexpr int kSortRounds = 8;
constexpr int kSortTile = kRadix * kSortRounds;  // lanes per sort block
constexpr int kRowsBlock = 1024;       // pass 2
constexpr int kRowsWarps = kRowsBlock / kWarp;
constexpr int kScanRegs = 8;          // blocks a scan lane holds at once
constexpr int kSmallSlots = 64;        // n_rows * C of the plan-free one
constexpr int kSmallTile = 128;        // lanes staged at a time
constexpr int kSmallBlock = 128;
constexpr int kSmallMaxBlocks = 1024;
constexpr int kRowsGrid = 132;         // pass 2's blocks at most

// Lanes of a column group: the next power of two >= cols, at most 32.
__host__ __device__ __forceinline__ int group_width(int cols) {
  int w = 1;
  while (w < cols && w < kWarp) w <<= 1;
  return w;
}

// ---- the plan: a stable LSD radix sort by id, then each row's start ----

template <typename Key>
__global__ void __launch_bounds__(kRadix)
rows_grad_hist(const Key* __restrict__ keys, int n, int shift,
               int* __restrict__ hist) {
  __shared__ int h[kRadix];
  const int t = threadIdx.x;
  h[t] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortTile;
#pragma unroll
  for (int k = 0; k < kSortRounds; ++k) {
    const int i = base + k * kRadix + t;
    if (i < n) atomicAdd(&h[((int)keys[i] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  hist[blockIdx.x * kRadix + t] = h[t];  // block-major
}

// The exclusive scan of one value a thread over a block of kRadix threads
// (warp shuffles, then the warps' totals in order); warp_sum is scratch.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum) {
  const int t = threadIdx.x, w = t / kWarp, lane = t % kWarp;
  int x = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == kWarp - 1) warp_sum[w] = x;
  __syncthreads();
  int below = x - v;
  for (int u = 0; u < w; ++u) below += warp_sum[u];
  __syncthreads();  // warp_sum may be reused
  return below;
}

template <typename Key, bool kFirst>
__global__ void __launch_bounds__(kRadix)
rows_grad_scatter(const Key* __restrict__ keys_in,
                  const int* __restrict__ vals_in, int n, int shift,
                  const int* __restrict__ prefix,
                  const int* __restrict__ totals,
                  int* __restrict__ keys_out, int* __restrict__ vals_out) {
  // a round's counts per (warp, digit), then their bases; two buffers, so
  // a round zeroes the next one's while it scans its own
  __shared__ int cnt[2][kRadixWarps][kRadix];
  __shared__ int first[kRadix];   // the block's first output of each digit
  __shared__ int local[kRadix];   // where each digit starts in the block
  __shared__ int warp_sum[kRadixWarps];
  __shared__ int sk[kSortTile], sv[kSortTile];  // the block's lanes, sorted
  const int t = threadIdx.x, w = t / kWarp, lane = t % kWarp;
  const unsigned lower = (1u << lane) - 1u;
  const int base = blockIdx.x * kSortTile;
  int key[kSortRounds], val[kSortRounds], rank[kSortRounds];
#pragma unroll
  for (int k = 0; k < kSortRounds; ++k) {  // every round's loads at once
    const int i = base + k * kRadix + t;
    key[k] = i < n ? (int)keys_in[i] : -1;
    val[k] = i < n ? (kFirst ? i : vals_in[i]) : 0;
  }
#pragma unroll
  for (int v = 0; v < kRadixWarps; ++v) cnt[0][v][t] = 0;
  // digit t's first output: the totals of the lower digits, then this
  // block's prefix over the earlier blocks
  first[t] = block_exclusive_scan(totals[t], warp_sum)
             + prefix[blockIdx.x * kRadix + t];
  int run = 0;  // thread t: the block's lanes of digit t so far
#pragma unroll
  for (int k = 0; k < kSortRounds; ++k) {
    int(*c)[kRadix] = cnt[k & 1];
    const bool valid = key[k] >= 0;
    const int d = valid ? (key[k] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    const int r = __popc(peers & lower);
    if (valid && r == 0) c[w][d] = __popc(peers);
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kRadixWarps; ++v) {  // digit t, the warps in order
      const int m = c[v][t];
      c[v][t] = run;
      run += m;
      cnt[(k + 1) & 1][v][t] = 0;
    }
    __syncthreads();
    rank[k] = valid ? c[w][d] + r : 0;  // the lane's rank in its digit
  }
  // place the lanes in shared memory by (digit, rank), then write each
  // digit's run out in order: neighbouring threads, neighbouring outputs
  local[t] = block_exclusive_scan(run, warp_sum);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortRounds; ++k) {
    if (key[k] >= 0) {
      const int at = local[(key[k] >> shift) & (kRadix - 1)] + rank[k];
      sk[at] = key[k];
      sv[at] = val[k];
    }
  }
  __syncthreads();
  const int count = n - base < kSortTile ? n - base : kSortTile;
  for (int i = t; i < count; i += kRadix) {
    const int d = (sk[i] >> shift) & (kRadix - 1);
    const int pos = first[d] + i - local[d];
    keys_out[pos] = sk[i];
    vals_out[pos] = sv[i];
  }
}

// Per digit d (one warp each), the exclusive prefix over the blocks of
// hist[b * kRadix + d], in place, and the digit's total: lane l takes a
// fixed range of blocks, a warp scan joins the lanes.
__global__ void __launch_bounds__(kBlock)
rows_grad_scan(int* __restrict__ hist, int nb, int* __restrict__ totals) {
  const int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int per = (nb + kWarp - 1) / kWarp;
  const int b0 = lane * per, b1 = min(b0 + per, nb);
  int v[kScanRegs], sum = 0;
  if (per <= kScanRegs) {  // the lane's counts in registers, loaded at once
#pragma unroll
    for (int m = 0; m < kScanRegs; ++m) {
      v[m] = b0 + m < b1 ? hist[(b0 + m) * kRadix + d] : 0;
      sum += v[m];
    }
  } else {
    for (int b = b0; b < b1; ++b) sum += hist[b * kRadix + d];
  }
  int x = sum;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  int excl = x - sum;
  if (per <= kScanRegs) {
#pragma unroll
    for (int m = 0; m < kScanRegs; ++m) {
      if (b0 + m < b1) hist[(b0 + m) * kRadix + d] = excl;
      excl += v[m];
    }
  } else {
    for (int b = b0; b < b1; ++b) {
      const int c = hist[b * kRadix + d];
      hist[b * kRadix + d] = excl;
      excl += c;
    }
  }
  if (lane == kWarp - 1) totals[d] = x;
}

// starts[r] = the first sorted position with key >= r, for r <= n_rows,
// by a binary search of the sorted keys: one thread a row, so a long run
// of rows with no lanes (the far side of a mesh) costs no thread more
// than the others. Zeroes *n_multi where given (the heads' counter).
__global__ void __launch_bounds__(kBlock)
rows_grad_starts(const int* __restrict__ keys, int n, int n_rows,
                 int* __restrict__ starts, int* __restrict__ n_multi) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r == 0 && n_multi) *n_multi = 0;
  if (r > n_rows) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < r) lo = mid + 1; else hi = mid;
  }
  starts[r] = lo;
}

// ---- the planned sum ----
//
// Row r's chunks take the slots [starts[r] / kChunk + r, ... + ceil(run /
// kChunk)): slots of different rows never overlap, and every slot is
// below n / kChunk + n_rows, so no scan numbers them. A slot no row owns
// is never written; a warp that reads it finds that chunk_row names a row
// that does not own it (or none) and leaves.

// At each chunk head (a sorted position p with (p - starts[r]) % kChunk ==
// 0): chunk_row[slot] = r; a row's first head lists the row for pass 2 if
// it has more than one chunk (the list's order does not matter: each row
// is summed by one block in a fixed order). Thread i < n_rows also writes
// row i of out as zero if it has no lanes.
__global__ void __launch_bounds__(kBlock)
rows_grad_heads(const int* __restrict__ keys, const int* __restrict__ starts,
                int n, int n_rows, int cols, int* __restrict__ chunk_row,
                int* __restrict__ multi, int* __restrict__ n_multi,
                float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n_rows && starts[i] == starts[i + 1])
    for (int c = 0; c < cols; ++c) out[(int64_t)i * cols + c] = 0.0f;
  if (i >= n) return;
  const int r = keys[i];
  const int s = starts[r];
  if ((i - s) % kChunk != 0) return;
  const int k = (i - s) / kChunk;
  chunk_row[s / kChunk + r + k] = r;
  if (k == 0 && starts[r + 1] - s > kChunk) multi[atomicAdd(n_multi, 1)] = r;
}

// Pass 1: lanes on (lane group, column); each group of a warp sums its own
// chunk slot's sorted lanes in order, lane c of the group on columns c,
// c + width, ... A row of one chunk is written to out, other chunks to
// partial[slot]. The loop is bound by the cotangent rows it gathers at
// random (sorted lanes come from anywhere in grad); its loads do not
// depend on the sum, so they are issued ahead of the adds.
__global__ void __launch_bounds__(kBlock)
rows_grad_chunks(const float* __restrict__ grad, int64_t ld,
                 const int* __restrict__ perm,
                 const int* __restrict__ starts,
                 const int* __restrict__ chunk_row,
                 float* __restrict__ partial, float* __restrict__ out,
                 int n_rows, int cols, int max_chunks) {
  const int width = group_width(cols);
  const int lane = threadIdx.x % kWarp, g = lane / width;
  const int j = (blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp)
                * (kWarp / width) + g;
  if (j >= max_chunks) return;
  const int r = chunk_row[j];
  if ((unsigned)r >= (unsigned)n_rows) return;
  const int s = starts[r], e = starts[r + 1];
  const int k = j - (s / kChunk + r);
  const int n_chunks = (e - s + kChunk - 1) / kChunk;
  if (k < 0 || k >= n_chunks) return;  // a slot row r does not own
  const int lo = s + k * kChunk, hi = min(lo + kChunk, e);
  float* dst = n_chunks == 1 ? out + (int64_t)r * cols
                             : partial + (int64_t)j * cols;
  for (int c = lane % width; c < cols; c += width) {
    float acc = 0.0f;
#pragma unroll 4
    for (int p = lo; p < hi; ++p) acc += grad[(int64_t)perm[p] * ld + c];
    dst[c] = acc;
  }
}

// Pass 2, only the listed rows: one block a row, lanes on (chunk slot,
// column): group g adds the row's chunks g, g + G, ... in order, a fixed
// shuffle tree joins the groups of a warp, then the warps in order.
__global__ void __launch_bounds__(kRowsBlock)
rows_grad_rows(const float* __restrict__ partial,
               const int* __restrict__ starts,
               const int* __restrict__ multi,
               const int* __restrict__ n_multi, float* __restrict__ out,
               int cols) {
  __shared__ float red[kRowsWarps][kWarp];
  const int t = threadIdx.x, w = t / kWarp, lane = t % kWarp;
  const int width = group_width(cols);
  const int groups = kRowsBlock / width, g = t / width;
  const int count = *n_multi;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {  // block-uniform
    const int r = multi[i];
    const int s = starts[r];
    const int a = s / kChunk + r;
    const int b = a + (starts[r + 1] - s + kChunk - 1) / kChunk;
    for (int c0 = 0; c0 < cols; c0 += kWarp) {
      const int c = c0 + t % width;
      float acc = 0.0f;
      if (c < cols) {
#pragma unroll 4
        for (int j = a + g; j < b; j += groups)
          acc += partial[(int64_t)j * cols + c];
      }
      for (int off = kWarp / 2; off >= width; off >>= 1)
        acc += __shfl_down_sync(kFull, acc, off);
      if (lane < width) red[w][lane] = acc;
      __syncthreads();
      if (t < width && c < cols) {
        float sum = red[0][t];
#pragma unroll 8
        for (int v = 1; v < kRowsWarps; ++v) sum += red[v][t];
        out[(int64_t)r * cols + c] = sum;
      }
      __syncthreads();
    }
  }
}

// ---- the plan-free instance ----

__global__ void __launch_bounds__(kSmallBlock)
rows_grad_tiles(const float* __restrict__ grad, int64_t ld,
                const int64_t* __restrict__ idx, float* __restrict__ partial,
                int n, int n_rows, int cols, int per_block, int vec) {
  __shared__ __align__(16) float tile[kSmallTile * kSmallSlots];
  __shared__ int ids[kSmallTile];
  __shared__ float red[kSmallBlock];
  const int t = threadIdx.x;
  const int slots = n_rows * cols;
  const int groups = kSmallBlock / slots;
  const int s = t % slots, g = t / slots;
  const int r = s / cols, c = s % cols;
  const int a = g * kSmallTile / groups, b = (g + 1) * kSmallTile / groups;
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t stop = start + per_block < n ? start + per_block : n;
  float acc = 0.0f;
  for (int64_t base = start; base < stop; base += kSmallTile) {
    const int m = stop - base < kSmallTile ? (int)(stop - base) : kSmallTile;
    const int vals = m * cols;
    if (vec) {  // rows contiguous (ld == cols), 16-byte aligned
      const float* src = grad + base * cols;
      const int quads = vals / 4;
      for (int e = t; e < quads; e += kSmallBlock)
        reinterpret_cast<float4*>(tile)[e] =
            reinterpret_cast<const float4*>(src)[e];
      for (int e = quads * 4 + t; e < vals; e += kSmallBlock) tile[e] = src[e];
    } else {
      for (int e = t; e < vals; e += kSmallBlock) {
        const int l = e / cols;
        tile[e] = grad[(base + l) * ld + (e - l * cols)];
      }
    }
    for (int l = t; l < m; l += kSmallBlock) ids[l] = (int)idx[base + l];
    __syncthreads();
    if (g < groups) {
      const int hi = min(b, m);
      for (int l = a; l < hi; ++l)
        if (ids[l] == r) acc += tile[l * cols + c];
    }
    __syncthreads();
  }
  red[t] = acc;
  __syncthreads();
  if (t < slots) {
    float sum = red[t];
    for (int v = 1; v < groups; ++v) sum += red[v * slots + t];
    partial[(int64_t)blockIdx.x * slots + t] = sum;
  }
}

__global__ void __launch_bounds__(kBlock)
rows_grad_tile_sum(const float* __restrict__ partial, float* __restrict__ out,
                   int blocks, int slots) {
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (s >= slots) return;  // warp-uniform
  float acc = 0.0f;
  for (int b = lane; b < blocks; b += kWarp) acc += partial[(int64_t)b * slots + s];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) out[s] = acc;
}

// Radix passes of 8 bits over the bits ids below n_rows use (at least 1).
int sort_passes(int n_rows) {
  int bits = 1;
  while (bits < 31 && (1 << bits) < n_rows) ++bits;
  return (bits + 7) / 8;
}

// The plan's launches; the sorted keys end in *keys_final. Zeroes
// *n_multi where given.
int launch_plan(const int64_t* idx, int n, int n_rows, int* ws, int* perm,
                int* starts, int* n_multi, cudaStream_t st,
                int** keys_final) {
  const int nb = (n + kSortTile - 1) / kSortTile;
  int* keys[2] = {ws, ws + n};
  int* vals[2] = {ws + 2 * (int64_t)n, ws + 3 * (int64_t)n};
  int* hist = ws + 4 * (int64_t)n;
  int* totals = hist + kRadix * nb;
  const int passes = sort_passes(n_rows);
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    const bool last = p == passes - 1;
    int* keys_out = keys[p & 1];
    int* vals_out = last ? perm : vals[p & 1];
    if (p == 0) {
      rows_grad_hist<int64_t><<<nb, kRadix, 0, st>>>(idx, n, shift, hist);
    } else {
      rows_grad_hist<int><<<nb, kRadix, 0, st>>>(keys[(p - 1) & 1], n,
                                                  shift, hist);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rows_grad_scan<<<kRadix / kWarpsPerBlock, kBlock, 0, st>>>(hist, nb,
                                                              totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (p == 0) {
      rows_grad_scatter<int64_t, true><<<nb, kRadix, 0, st>>>(
          idx, nullptr, n, shift, hist, totals, keys_out, vals_out);
    } else {
      rows_grad_scatter<int, false><<<nb, kRadix, 0, st>>>(
          keys[(p - 1) & 1], vals[(p - 1) & 1], n, shift, hist, totals,
          keys_out, vals_out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  *keys_final = keys[(passes - 1) & 1];
  rows_grad_starts<<<n_rows / kBlock + 1, kBlock, 0, st>>>(
      *keys_final, n, n_rows, starts, n_multi);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout constants, for the wrapper to check against its own:
// chunk, sort tile, small slots, small tile, small block, small blocks.
extern "C" void drt_rows_grad_constants(int* out) {
  out[0] = kChunk;
  out[1] = kSortTile;
  out[2] = kSmallSlots;
  out[3] = kSmallTile;
  out[4] = kSmallBlock;
  out[5] = kSmallMaxBlocks;
}

// The plan alone, of ids idx (n,) int64 in [0, n_rows): perm (n,) and
// starts (n_rows + 1,) int32, equal to a stable sort's. ws holds 4 n + 256
// (ceil(n / kSortTile) + 1) ints. Returns cudaGetLastError() (0 = launched).
extern "C" int drt_rows_grad_plan(const int64_t* idx, int n, int n_rows,
                                  int* ws, int* perm, int* starts,
                                  void* stream) {
  if (n <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  int* keys;
  return launch_plan(idx, n, n_rows, ws, perm, starts, nullptr,
                     (cudaStream_t)stream, &keys);
}

// The planned instance: out (n_rows, cols) from grad (n, cols) with row
// stride ld and ids idx. ws holds 4 n + 256 (ceil(n / kSortTile) + 1)
// (the plan's) + n (perm) + n_rows + 1 (starts) + max_chunks + max_multi + 1
// ints, partial max_chunks * cols floats.
extern "C" int drt_rows_grad_planned(const float* grad, long long ld,
                                     const int64_t* idx, int* ws,
                                     float* partial, float* out, int n,
                                     int n_rows, int cols, int max_chunks,
                                     int max_multi, void* stream) {
  if (n <= 0 || n_rows <= 0 || cols <= 0 || max_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (n + kSortTile - 1) / kSortTile;
  int* perm = ws + 4 * (int64_t)n + kRadix * (nb + 1);
  int* starts = perm + n;
  int* chunk_row = starts + n_rows + 1;
  int* multi = chunk_row + max_chunks;
  int* n_multi = multi + max_multi;
  int* keys;
  int err = launch_plan(idx, n, n_rows, ws, perm, starts, n_multi, st,
                        &keys);
  if (err != 0) return err;
  const int threads = n > n_rows ? n : n_rows;
  rows_grad_heads<<<(threads + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      keys, starts, n, n_rows, cols, chunk_row, multi, n_multi, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_block = kWarpsPerBlock * (kWarp / group_width(cols));
  rows_grad_chunks<<<(max_chunks + per_block - 1) / per_block, kBlock, 0,
                     st>>>(grad, (int64_t)ld, perm, starts, chunk_row,
                           partial, out, n_rows, cols, max_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (max_multi > 0) {
    rows_grad_rows<<<max_multi < kRowsGrid ? max_multi : kRowsGrid,
                     kRowsBlock, 0, st>>>(partial, starts, multi, n_multi,
                                          out, cols);
  }
  return (int)cudaGetLastError();
}

// The plan-free sum for n_rows * cols <= kSmallSlots: partial holds
// blocks * n_rows * cols floats, blocks = ceil(n / per_block).
extern "C" int drt_rows_grad_small(const float* grad, long long ld,
                                   const int64_t* idx, float* partial,
                                   float* out, int n, int n_rows, int cols,
                                   int per_block, void* stream) {
  const int slots = n_rows * cols;
  if (n <= 0 || n_rows <= 0 || cols <= 0 || slots > kSmallSlots
      || per_block <= 0 || per_block % kSmallTile != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)(((int64_t)n + per_block - 1) / per_block);
  const int vec = ld == cols && ((uintptr_t)grad & 15) == 0;
  rows_grad_tiles<<<blocks, kSmallBlock, 0, st>>>(grad, (int64_t)ld, idx,
                                                  partial, n, n_rows, cols,
                                                  per_block, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_grad_tile_sum<<<(slots + kWarpsPerBlock - 1) / kWarpsPerBlock, kBlock,
                       0, st>>>(partial, out, blocks, slots);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of each kernel, in the order hist<int64>,
// hist<int32>, scan, scatter<int64>, scatter<int32>, starts, heads,
// chunks, rows, tiles, tile_sum (the CUDA occupancy calculator's figure).
extern "C" int drt_rows_grad_occupancy(int* out) {
  struct { const void* fn; int block; } k[] = {
      {(const void*)rows_grad_hist<int64_t>, kRadix},
      {(const void*)rows_grad_hist<int>, kRadix},
      {(const void*)rows_grad_scan, kBlock},
      {(const void*)rows_grad_scatter<int64_t, true>, kRadix},
      {(const void*)rows_grad_scatter<int, false>, kRadix},
      {(const void*)rows_grad_starts, kBlock},
      {(const void*)rows_grad_heads, kBlock},
      {(const void*)rows_grad_chunks, kBlock},
      {(const void*)rows_grad_rows, kRowsBlock},
      {(const void*)rows_grad_tiles, kSmallBlock},
      {(const void*)rows_grad_tile_sum, kBlock}};
  for (int i = 0; i < (int)(sizeof(k) / sizeof(k[0])); ++i) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[i], k[i].fn, k[i].block, 0);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* drt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
