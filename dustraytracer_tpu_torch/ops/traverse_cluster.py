"""Lockstep walk of the cluster BVH's base threading (port of
ops/traverse_cluster.py).

Every ray holds a node pointer into the base pre-order threading
(node_min / node_max / node_skip / node_cluster); each step fetches the
live rays' node rows, slab-tests them, descends or skips, and runs a
K-wide Möller–Trumbore at entered leaves. The JAX package fetches rows
with one-hot matmuls for the TPU; here they are plain gathers. Its tie
rule is argmin over the leaf's K slots: the first slot with the
smallest t wins (the kernels and brute take the lowest id instead).
"""

from __future__ import annotations

import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh
from dustraytracer_tpu_torch.ops.intersect import TRIANGLE_EPSILON
from dustraytracer_tpu_torch.ops.traverse_sweep import (BIG, _check_rays,
                                                        _t_init, cluster_mt)


@torch.no_grad()
def traverse_cluster(cb: ClusterBvh, origin, direction, *,
                     anyhit: bool = False, t_max=None) -> dict:
    """Closest-hit (or any-hit) traversal over the cluster BVH: detached
    {"hit_idx" i32 (-1 = miss), "t" f32 (t_max on a miss), "visits" i32
    (nodes each ray stood on)}. With anyhit, a ray stops at its first
    committed hit, so `hit_idx >= 0` means occluded (not necessarily the
    closest hit). t_max: a scalar or (N,) initial t per ray."""
    _check_rays(cb, origin, direction)
    n = origin.shape[0]
    dev = origin.device
    hit_t = _t_init(t_max, n, dev).clone()
    hit_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    skip_t = cb.node_skip.to(torch.int64)
    clus_t = cb.node_cluster.to(torch.int64)
    inv_dir = 1.0 / direction
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    lanes = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    # pre-order pointers only move forward: at most n_nodes steps
    for _ in range(cb.n_nodes + 4):
        if not lanes.numel():
            break
        visits[lanes] += 1
        o = origin[lanes]
        t0 = (cb.node_min[node] - o) * inv_dir[lanes]
        t1 = (cb.node_max[node] - o) * inv_dir[lanes]
        t_enter = torch.clamp_min(torch.fmin(t0, t1).amax(dim=-1), 0.0)
        t_exit = torch.fmax(t0, t1).amin(dim=-1)
        cur_t = hit_t[lanes]
        cluster = clus_t[node]
        is_leaf = cluster >= 0
        enter = (t_enter <= t_exit) & (t_exit >= 0.0) & (t_enter < cur_t)

        # a lane that is not at an entered leaf fetches a zero row there:
        # no valid slot, best t = BIG, best id = 0
        best_t = big.expand(lanes.shape[0]).clone()
        best_idx = torch.zeros_like(lanes)
        at_leaf = torch.nonzero(enter & is_leaf).squeeze(1)
        if at_leaf.numel():
            cl = cluster[at_leaf]
            ll = lanes[at_leaf]
            par, u, v, tt = cluster_mt(cb, cl, origin[ll], direction[ll])
            valid = (~par) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
                & (u + v <= 1.0) & (tt > TRIANGLE_EPSILON) \
                & (tt < cur_t[at_leaf][:, None])
            t_masked = torch.where(valid, tt, BIG)
            slot = t_masked.argmin(dim=1, keepdim=True)
            best_t[at_leaf] = t_masked.gather(1, slot)[:, 0]
            best_idx[at_leaf] = cb.tri_idx[cl].gather(1, slot)[:, 0] \
                .to(torch.int64)
        improve = (best_t < cur_t) & (best_idx >= 0)
        won = lanes[improve]
        hit_t[won] = best_t[improve]
        hit_idx[won] = best_idx[improve].to(torch.int32)

        nxt = torch.where(enter & ~is_leaf, node + 1, skip_t[node])
        live = nxt >= 0
        if anyhit:
            live &= ~improve
        lanes, node = lanes[live], nxt[live]
    return {"hit_idx": hit_idx, "t": hit_t, "visits": visits}
