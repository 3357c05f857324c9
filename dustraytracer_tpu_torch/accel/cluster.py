"""Cluster BVH: dense cluster-major triangle tables + a threaded top-level
BVH over the clusters (port of accel/cluster.py).

The SAH-permuted triangle soup is cut into C clusters of K consecutive
triangles; a small BVH with one cluster per leaf is built over the
cluster boxes and threaded into pre-order with skip links, once in the
base order and once per ray-direction octant (near child first). The
host build is numpy and equals the JAX package's array for array; the
tables then live as torch tensors on one device.

`device_tables` caches what a traversal kernel packs from these tables
(ops/traverse_sweep.py), per device, so the packing runs once per scene
and not once per call. `refit_cluster_bvh` re-bakes the tables from live
vertices into a new object with an empty cache.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

CLUSTER_K = 64


@dataclass
class ClusterBvh:
    """Dense cluster tables + threaded top-level BVH (all padded)."""

    node_min: torch.Tensor      # (M, 3) f32
    node_max: torch.Tensor      # (M, 3) f32
    node_skip: torch.Tensor     # (M,) i32
    node_cluster: torch.Tensor  # (M,) i32 cluster id for leaves, -1 internal
    v0: torch.Tensor            # (C, K, 3) f32
    e1: torch.Tensor            # (C, K, 3) f32  v1 - v0
    e2: torch.Tensor            # (C, K, 3) f32  v2 - v0
    tri_idx: torch.Tensor       # (C, K) i32 triangle id, -1 for padding
    n_nodes: int = 0
    n_clusters: int = 0
    k: int = CLUSTER_K
    cl_perm: torch.Tensor | None = None   # (C,) i32
    refit_a: torch.Tensor | None = None   # (n_nodes,) i32
    refit_b: torch.Tensor | None = None   # (n_nodes,) i32
    refit_levels: int = 0
    uv: torch.Tensor | None = None        # (C, K, 3, 2) f32
    face_nrm: torch.Tensor | None = None  # (C, K, 3) f32
    mat: torch.Tensor | None = None       # (C, K) i32
    oct_min: torch.Tensor | None = None      # (8, M, 3) f32
    oct_max: torch.Tensor | None = None      # (8, M, 3) f32
    oct_skip: torch.Tensor | None = None     # (8, M) i32 (-1 = done)
    oct_cluster: torch.Tensor | None = None  # (8, M) i32
    oct_perm0: torch.Tensor | None = None    # (8, M) i32 -> base node id
    device_tables: dict = field(default_factory=dict, repr=False,
                                compare=False)

    def to(self, device) -> "ClusterBvh":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, device_tables={}, **moved)

    @property
    def device(self) -> torch.device:
        return self.v0.device


def _octant_orders(bvh, m: int, node_cluster: np.ndarray):
    """8 near-child-first pre-order threadings of the built tree.

    For each internal node, the split axis is taken as the axis along
    which the children's box centers differ most; 'near first' for a
    ray-direction octant means the child whose center is smaller along
    that axis goes first when the direction component is positive,
    flipped when negative (the same rule the reference applies per ray,
    `BVHTraversal.cuh:30-41` — here baked per octant). Octant bit
    layout matches ray_sort_key: bit2 = x<0, bit1 = y<0, bit0 = z<0.

    Returns (omin, omax, oskip, ocluster, operm) stacked (8, m, ...);
    operm[o, i] = base node id of ordering o's node i."""
    left = bvh.node_left[:m].astype(np.int64)
    right = bvh.node_right[:m].astype(np.int64)
    leaf = bvh.node_count[:m] > 0
    center = 0.5 * (np.nan_to_num(bvh.node_min[:m], posinf=1e30,
                                  neginf=-1e30)
                    + np.nan_to_num(bvh.node_max[:m], posinf=1e30,
                                    neginf=-1e30))

    size = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if not leaf[i]:
            size[i] += size[left[i]] + size[right[i]]

    axis = np.zeros(m, np.int64)
    left_smaller = np.ones(m, bool)
    ints = np.nonzero(~leaf)[0]
    if ints.size:
        diff = center[right[ints]] - center[left[ints]]
        axis[ints] = np.abs(diff).argmax(axis=1)
        left_smaller[ints] = np.take_along_axis(
            diff, axis[ints][:, None], axis=1)[:, 0] >= 0.0

    omin = np.empty((8, m, 3), np.float32)
    omax = np.empty((8, m, 3), np.float32)
    oskip = np.empty((8, m), np.int32)
    ocluster = np.empty((8, m), np.int32)
    operm = np.empty((8, m), np.int32)
    nmin = np.nan_to_num(bvh.node_min[:m], posinf=1e30, neginf=-1e30) \
        .astype(np.float32)
    nmax = np.nan_to_num(bvh.node_max[:m], posinf=1e30, neginf=-1e30) \
        .astype(np.float32)
    for oct_id in range(8):
        neg = np.array([(oct_id >> 2) & 1, (oct_id >> 1) & 1, oct_id & 1],
                       bool)
        old_of_new = np.empty(m, np.int64)
        stack = [0]
        nxt = 0
        while stack:
            o = stack.pop()
            old_of_new[nxt] = o
            nxt += 1
            if not leaf[o]:
                first_left = left_smaller[o] != neg[axis[o]]
                a, b = ((left[o], right[o]) if first_left
                        else (right[o], left[o]))
                stack.append(b)
                stack.append(a)
        skip = np.arange(m, dtype=np.int64) + size[old_of_new]
        skip[skip >= m] = -1
        omin[oct_id] = nmin[old_of_new]
        omax[oct_id] = nmax[old_of_new]
        oskip[oct_id] = skip.astype(np.int32)
        ocluster[oct_id] = node_cluster[old_of_new]
        operm[oct_id] = old_of_new.astype(np.int32)
    return omin, omax, oskip, ocluster, operm


def build_cluster_bvh(tri_pos: np.ndarray, k: int = CLUSTER_K,
                      bins: int = 16, uv: np.ndarray | None = None,
                      face_nrm: np.ndarray | None = None,
                      mat: np.ndarray | None = None) -> ClusterBvh:
    """Build cluster tables over an (already SAH-permuted) (N, 3, 3)
    triangle array; padding triangles are degenerate and never hit.
    `uv`/`face_nrm`/`mat` (same permutation) are optional attribute
    tables. Returns CPU tensors."""
    from dustraytracer_tpu_torch.accel.bvh import (_build_bvh_numpy,
                                                   refit_plan, thread_bvh)

    n = tri_pos.shape[0]
    c = max(1, -(-n // k))
    pad_n = c * k
    tp = np.zeros((pad_n, 3, 3), np.float32)
    tp[:n] = tri_pos

    def _attr(a, shape, dtype, fill=0):
        if a is None:
            return None
        out = np.full((pad_n,) + shape, fill, dtype)
        out[:n] = a[:pad_n][:n]
        return out.reshape((c, k) + shape)

    uv_t = _attr(uv, (3, 2), np.float32)
    fn_t = _attr(face_nrm, (3,), np.float32)
    mat_t = _attr(mat, (), np.int32)

    v0 = tp[:, 0].reshape(c, k, 3)
    e1 = (tp[:, 1] - tp[:, 0]).reshape(c, k, 3)
    e2 = (tp[:, 2] - tp[:, 0]).reshape(c, k, 3)
    tri_idx = np.arange(pad_n, dtype=np.int32).reshape(c, k)
    tri_idx[tri_idx >= n] = -1

    # one-leaf-per-cluster BVH: each cluster enters the SAH builder as a
    # degenerate "triangle" spanning its box
    cl_min = tp.reshape(c, k * 3, 3).min(axis=1)
    cl_max = tp.reshape(c, k * 3, 3).max(axis=1)
    fake = np.stack([cl_min, cl_max, 0.5 * (cl_min + cl_max)], axis=1)
    bvh = thread_bvh(_build_bvh_numpy(fake, leaf_target=1, bins=bins))

    m = bvh.n_nodes
    node_cluster = np.full(bvh.node_min.shape[0], -1, np.int32)
    leaf = bvh.node_count[:m] > 0
    node_cluster[:m][leaf] = bvh.perm[bvh.node_first[:m][leaf]].astype(np.int32)

    refit_levels, refit_a, refit_b, plan_n = refit_plan(
        bvh.node_first, bvh.node_count, bvh.node_skip, m)
    if plan_n != c:
        raise ValueError(f"refit plan covers {plan_n} clusters, not {c}")
    cl_perm = bvh.perm.astype(np.int32)

    # finite padding boxes (inverted, so never entered)
    node_min_f = np.nan_to_num(bvh.node_min, posinf=1e30, neginf=-1e30)
    node_max_f = np.nan_to_num(bvh.node_max, posinf=1e30, neginf=-1e30)

    omin, omax, oskip, ocluster, operm = _octant_orders(bvh, m,
                                                        node_cluster)

    def pad128(a, fill=0.0):
        r = (-a.shape[0]) % 128
        if r == 0:
            return a
        return np.concatenate(
            [a, np.full((r,) + a.shape[1:], fill, a.dtype)], axis=0)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    return ClusterBvh(
        node_min=t(pad128(node_min_f, 1e30)),
        node_max=t(pad128(node_max_f, -1e30)),
        node_skip=t(pad128(bvh.node_skip, -1)),
        node_cluster=t(pad128(node_cluster, -1)),
        v0=t(pad128(v0)),
        e1=t(pad128(e1)),
        e2=t(pad128(e2)),
        tri_idx=t(pad128(tri_idx, -1)),
        n_nodes=m,
        n_clusters=c,
        k=k,
        cl_perm=t(cl_perm),
        refit_a=t(refit_a),
        refit_b=t(refit_b),
        refit_levels=refit_levels,
        uv=None if uv_t is None else t(pad128(uv_t)),
        face_nrm=None if fn_t is None else t(pad128(fn_t)),
        mat=None if mat_t is None else t(pad128(mat_t)),
        oct_min=t(_pad8(omin, 1e30)),
        oct_max=t(_pad8(omax, -1e30)),
        oct_skip=t(_pad8(oskip, -1)),
        oct_cluster=t(_pad8(ocluster, -1)),
        oct_perm0=t(_pad8(operm, 0)),
    )


def _pad8(a: np.ndarray, fill) -> np.ndarray:
    """pad128 along axis 1 (the per-octant node axis)."""
    r = (-a.shape[1]) % 128
    if r == 0:
        return a
    pad = np.full((a.shape[0], r) + a.shape[2:], fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


@torch.no_grad()
def refit_cluster_bvh(cb: ClusterBvh, tri_pos: torch.Tensor) -> ClusterBvh:
    """Re-bake the cluster tables from live triangle positions, topology
    fixed: v0/e1/e2, the cluster-BVH node boxes, all 8 octant tables and
    the oriented face normals. `tri_pos` is the SAH-permuted (N, 3, 3)
    array the tables were built from; padding triangles are zeros, as in
    build_cluster_bvh, so a refit with the built vertices reproduces the
    built tables. No gradient flows into the tables.

    Returns a NEW ClusterBvh with an empty `device_tables` cache: the
    kernel must never walk tables packed from the old geometry."""
    if cb.refit_a is None:
        raise ValueError("ClusterBvh was built without a refit plan")
    from dustraytracer_tpu_torch.accel.bvh import sparse_table

    c, k, m = cb.n_clusters, cb.k, cb.n_nodes
    pad_n = c * k
    take = min(tri_pos.shape[0], pad_n)
    tp = tri_pos.detach()[:take].to(torch.float32)
    if take < pad_n:
        tp = torch.cat([tp, tp.new_zeros((pad_n - take, 3, 3))], dim=0)
    v0 = tp[:, 0].reshape(c, k, 3)
    e1 = (tp[:, 1] - tp[:, 0]).reshape(c, k, 3)
    e2 = (tp[:, 2] - tp[:, 0]).reshape(c, k, 3)

    corners = tp.reshape(c, k * 3, 3)
    perm = cb.cl_perm.to(torch.int64)  # tree order of the clusters
    fmin = sparse_table(corners.amin(dim=1)[perm], cb.refit_levels,
                        torch.minimum)
    fmax = sparse_table(corners.amax(dim=1)[perm], cb.refit_levels,
                        torch.maximum)
    a = cb.refit_a.to(torch.int64)
    b = cb.refit_b.to(torch.int64)
    nm = torch.minimum(fmin[a], fmin[b])
    nx = torch.maximum(fmax[a], fmax[b])

    def splice(old, new):
        return torch.cat([new, old[new.shape[0]:]], dim=0)

    extra = {}
    if cb.oct_min is not None:
        # the 8 threadings are permutations of the same node set
        operm = cb.oct_perm0[:, :m].reshape(-1).to(torch.int64)
        extra["oct_min"] = torch.cat(
            [nm[operm].reshape(8, m, 3), cb.oct_min[:, m:]], dim=1)
        extra["oct_max"] = torch.cat(
            [nx[operm].reshape(8, m, 3), cb.oct_max[:, m:]], dim=1)
    if cb.face_nrm is not None:
        # the ingest orientation survives as a sign against the old normal
        raw = torch.linalg.cross(e1, e2, dim=-1)
        n2 = (raw * raw).sum(dim=-1, keepdim=True)
        good = n2 > 1e-24
        raw = torch.where(good, raw / torch.sqrt(torch.where(good, n2, 1.0)),
                          0.0)
        old = cb.face_nrm[:c]
        sign = torch.where((raw * old).sum(dim=-1, keepdim=True) < 0, -1.0,
                           1.0)
        extra["face_nrm"] = splice(cb.face_nrm, raw * sign)

    return dataclasses.replace(
        cb, node_min=splice(cb.node_min, nm), node_max=splice(cb.node_max, nx),
        v0=splice(cb.v0, v0), e1=splice(cb.e1, e1), e2=splice(cb.e2, e2),
        device_tables={}, **extra)
