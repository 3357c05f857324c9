"""Binned-SAH BVH builder -> flat SoA node arrays (port of accel/bvh.py).

The numpy builder, the pre-order threading with skip links and the
static refit plan, unchanged, so the port's tables equal the JAX
package's array for array (tests/test_torch_scene.py), and the torch
refit of the node boxes from live vertices (`refit_bvh_boxes`). The
native C++ builder is not ported yet: `build_bvh(use_native=True)`
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TRAVERSAL_COST = 1.0  # reference: BVHNode.cuh:26-27
INTERSECT_COST = 2.0


@dataclass
class BvhArrays:
    """Flat SoA BVH. Leaf iff node_count > 0; internal nodes use
    left/right child indices. Arrays padded to a multiple of 8.

    After `thread_bvh` post-processing (applied by `build_bvh`), nodes are
    in DFS pre-order with a `node_skip` escape link: the next pre-order
    node after node i's subtree (-1 = traversal done). A ray then walks
    the tree with a single node pointer — enter the AABB -> next node is
    i+1 (first child), miss/leaf -> node_skip[i] — which is the stackless
    layout the TPU traversal (`ops/traverse.py`) and its Pallas kernel
    need: one gather per step, no per-lane stack, no scatters.
    """

    node_min: np.ndarray   # (M, 3) f32
    node_max: np.ndarray   # (M, 3) f32
    node_left: np.ndarray  # (M,) i32
    node_right: np.ndarray  # (M,) i32
    node_first: np.ndarray  # (M,) i32
    node_count: np.ndarray  # (M,) i32
    node_skip: np.ndarray  # (M,) i32  pre-order escape link (-1 = end)
    perm: np.ndarray       # (N,) i64 — reorder of input triangles
    n_nodes: int
    depth: int


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def build_bvh(tri_pos: np.ndarray, leaf_target: int = 8, bins: int = 16,
              use_native: bool = False) -> BvhArrays:
    """Build a binned-SAH BVH over (N, 3, 3) triangle corner positions,
    threaded into DFS pre-order with skip links (see BvhArrays)."""
    if use_native:
        raise NotImplementedError(
            "the native BVH builder is not yet ported, see ROADMAP.md")
    return thread_bvh(_build_bvh_numpy(tri_pos, leaf_target, bins))


def thread_bvh(bvh: BvhArrays) -> BvhArrays:
    """Reorder nodes to DFS pre-order and attach skip (escape) links.

    In pre-order, a node's subtree occupies the contiguous id range
    [i, i + size_i), so its first child is i + 1 and its escape link is
    i + size_i (-1 past the last node). The traversal then needs no
    stack — the reason this layout exists (TPU has no cheap per-lane
    stacks; see ops/traverse.py).
    """
    m = bvh.n_nodes
    left = bvh.node_left[:m]
    right = bvh.node_right[:m]
    is_leaf = bvh.node_count[:m] > 0

    # subtree sizes: builders allocate parents before children, so a
    # reverse sweep sees children first
    size = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if not is_leaf[i]:
            size[i] += size[left[i]] + size[right[i]]

    # iterative pre-order DFS from root 0
    new_of_old = np.empty(m, np.int64)
    old_of_new = np.empty(m, np.int64)
    stack = [0]
    nxt = 0
    while stack:
        o = stack.pop()
        new_of_old[o] = nxt
        old_of_new[nxt] = o
        nxt += 1
        if not is_leaf[o]:
            stack.append(right[o])
            stack.append(left[o])

    skip = new_of_old[old_of_new] * 0  # placeholder alloc
    ids = np.arange(m, dtype=np.int64)
    skip = ids + size[old_of_new]
    skip[skip >= m] = -1

    def remap_child(arr):
        out = np.where(arr[:m] >= 0, new_of_old[np.maximum(arr[:m], 0)], -1)
        return out.astype(np.int32)

    pad = ((m + 7) // 8) * 8

    def _p(a, dtype, fill):
        a = np.asarray(a, dtype)
        return np.concatenate(
            [a, np.full((pad - m,) + a.shape[1:], fill, dtype)])

    return BvhArrays(
        node_min=_p(bvh.node_min[:m][old_of_new], np.float32, np.inf),
        node_max=_p(bvh.node_max[:m][old_of_new], np.float32, -np.inf),
        node_left=_p(remap_child(bvh.node_left)[old_of_new], np.int32, -1),
        node_right=_p(remap_child(bvh.node_right)[old_of_new], np.int32, -1),
        node_first=_p(bvh.node_first[:m][old_of_new], np.int32, 0),
        node_count=_p(bvh.node_count[:m][old_of_new], np.int32, 0),
        node_skip=_p(skip, np.int32, -1),
        perm=bvh.perm,
        n_nodes=m,
        depth=bvh.depth,
    )


def _build_bvh_numpy(tri_pos: np.ndarray, leaf_target: int,
                     bins: int) -> BvhArrays:
    n = tri_pos.shape[0]
    tri_min = tri_pos.min(axis=1).astype(np.float64)
    tri_max = tri_pos.max(axis=1).astype(np.float64)
    centroid = 0.5 * (tri_min + tri_max)

    order = np.arange(n, dtype=np.int64)

    node_min, node_max = [], []
    node_left, node_right = [], []
    node_first, node_count = [], []

    def alloc() -> int:
        node_min.append(np.zeros(3))
        node_max.append(np.zeros(3))
        node_left.append(-1)
        node_right.append(-1)
        node_first.append(-1)
        node_count.append(0)
        return len(node_min) - 1

    root = alloc()
    # Explicit work stack, same shape as the reference's buildIterative
    # (`BVHBuilder.cu:11-92`) but allocation-free partitioning.
    stack = [(root, 0, n, 1)]
    max_depth = 1

    while stack:
        node, start, end, depth = stack.pop()
        max_depth = max(max_depth, depth)
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        count = end - start

        if count <= leaf_target:
            node_first[node] = start
            node_count[node] = count
            continue

        cen = centroid[idx]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        extent = cmax - cmin

        best_axis, best_bin, best_cost = -1, -1, np.inf
        parent_sa = max(_surface_area(bmin, bmax), 1e-30)
        leaf_cost = INTERSECT_COST * count

        for axis in range(3):
            if extent[axis] < 1e-12:
                continue
            scale = bins / extent[axis]
            b = np.minimum(((cen[:, axis] - cmin[axis]) * scale).astype(np.int64),
                           bins - 1)
            counts = np.bincount(b, minlength=bins)
            bin_lo = np.full((bins, 3), np.inf)
            bin_hi = np.full((bins, 3), -np.inf)
            np.minimum.at(bin_lo, b, tri_min[idx])
            np.maximum.at(bin_hi, b, tri_max[idx])

            # prefix/suffix sweep
            left_n = np.cumsum(counts)[:-1]
            right_n = count - left_n
            left_lo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            left_hi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            right_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            right_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]

            sa_l = np.where(left_n > 0, _surface_area(left_lo, left_hi), 0.0)
            sa_r = np.where(right_n > 0, _surface_area(right_lo, right_hi), 0.0)
            cost = TRAVERSAL_COST + (sa_l * left_n + sa_r * right_n) \
                / parent_sa * INTERSECT_COST
            cost = np.where((left_n == 0) | (right_n == 0), np.inf, cost)
            j = int(np.argmin(cost))
            if cost[j] < best_cost:
                best_axis, best_bin, best_cost = axis, j, float(cost[j])

        if best_axis >= 0 and (best_cost < leaf_cost or count > leaf_target):
            scale = bins / extent[best_axis]
            b = np.minimum(((cen[:, best_axis] - cmin[best_axis]) * scale)
                           .astype(np.int64), bins - 1)
            go_left = b <= best_bin
        else:
            # Degenerate (all centroids identical): median split so the
            # leaf-size bound still holds.
            go_left = np.zeros(count, dtype=bool)
            go_left[: count // 2] = True

        n_left = int(go_left.sum())
        if n_left == 0 or n_left == count:
            go_left = np.zeros(count, dtype=bool)
            go_left[: count // 2] = True
            n_left = count // 2

        # Stable partition — contiguous leaf ranges (BVHBuilder.cu:175-214).
        order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])

        lchild = alloc()
        rchild = alloc()
        node_left[node] = lchild
        node_right[node] = rchild
        mid = start + n_left
        stack.append((rchild, mid, end, depth + 1))
        stack.append((lchild, start, mid, depth + 1))

    m = len(node_min)
    pad = ((m + 7) // 8) * 8

    def _p(lst, dtype, fill):
        a = np.asarray(lst, dtype)
        return np.concatenate([a, np.full((pad - m,) + a.shape[1:], fill, dtype)])

    return BvhArrays(
        node_min=_p(node_min, np.float32, np.inf),
        node_max=_p(node_max, np.float32, -np.inf),
        node_left=_p(node_left, np.int32, -1),
        node_right=_p(node_right, np.int32, -1),
        node_first=_p(node_first, np.int32, 0),
        node_count=_p(node_count, np.int32, 0),
        node_skip=np.full(pad, -1, np.int32),  # filled by thread_bvh
        perm=order,
        n_nodes=m,
        depth=max_depth,
    )


# Static per-node range plan for a later live-vertex refit: in
# pre-order every node covers a contiguous range [lo, hi) of the
# SAH-permuted soup, so a box is two overlapping power-of-two windows
# of a sparse min/max table.
def refit_plan(node_first: np.ndarray, node_count: np.ndarray,
               node_skip: np.ndarray, n_nodes: int):
    """Static per-node range-query indices for a box refit.

    Returns (levels, a, b): `levels` = number of sparse-table levels,
    `a`/`b` = (n_nodes,) i64 flat indices into the (levels, N)-stacked
    table such that box_i = reduce(flat[a_i], flat[b_i])."""
    m = n_nodes
    first = np.asarray(node_first[:m], np.int64)
    count = np.asarray(node_count[:m], np.int64)
    skip = np.asarray(node_skip[:m], np.int64)
    leaf = count > 0
    lo = np.zeros(m, np.int64)
    hi = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        if leaf[i]:
            lo[i] = first[i]
            hi[i] = first[i] + count[i]
        else:
            left = i + 1
            right = skip[left]
            lo[i] = lo[left]
            hi[i] = hi[right] if 0 <= right < m else hi[left]
    n = int(hi.max()) if m else 1
    length = np.maximum(hi - lo, 1)
    k = np.floor(np.log2(length)).astype(np.int64)
    levels = int(k.max()) + 1 if m else 1
    a = k * n + lo
    b = k * n + hi - (1 << k)
    return levels, a.astype(np.int32), b.astype(np.int32), n


def sparse_table(x: torch.Tensor, levels: int, reduce_fn) -> torch.Tensor:
    """(levels * N, 3) stacked power-of-two window reductions of the
    (N, 3) rows `x`: level l holds reduce(x[i : i + 2**l]), rows past
    N - 2**l clamped (a refit plan never queries them)."""
    lev = [x]
    for lvl in range(1, levels):
        h = 1 << (lvl - 1)
        prev = lev[-1]
        shifted = torch.cat([prev[h:], prev[-1:].expand(h, -1)], dim=0)
        lev.append(reduce_fn(prev, shifted))
    return torch.cat(lev, dim=0)


@torch.no_grad()
def refit_bvh_boxes(tri_pos, node_min, node_max, *, levels: int,
                    range_a, range_b, n_tris: int, n_nodes: int):
    """Recompute the threaded node boxes from live (N', 3, 3) vertices
    with a refit plan's range queries. Returns new (node_min, node_max);
    padding rows past `n_nodes` are kept from the inputs. Boxes carry no
    gradient (traversal is a discrete selector)."""
    tp = tri_pos.detach()[:n_tris]
    flat_min = sparse_table(tp.amin(dim=1), levels, torch.minimum)
    flat_max = sparse_table(tp.amax(dim=1), levels, torch.maximum)
    a = range_a[:n_nodes].to(torch.int64)
    b = range_b[:n_nodes].to(torch.int64)
    new_min = torch.minimum(flat_min[a], flat_min[b])
    new_max = torch.maximum(flat_max[a], flat_max[b])
    return (torch.cat([new_min, node_min[n_nodes:]], dim=0),
            torch.cat([new_max, node_max[n_nodes:]], dim=0))
