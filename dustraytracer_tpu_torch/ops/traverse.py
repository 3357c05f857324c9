"""Stackless walk of the scene BVH with per-leaf triangle gathers, and
the alpha-cutout test (port of ops/traverse.py).

The scene's BVH is threaded in pre-order with skip links: a ray enters
an interior node -> next = node + 1, misses a box or leaves a leaf ->
next = skip, and ends at -1. Every live ray advances one node per step;
at an entered leaf it tests the leaf's MAX_LEAF-wide window of
triangles, gathered from the scene tables, and keeps the first slot
with the smallest t. With alpha_test, a candidate hit counts only where
the albedo texture's alpha at the hit's uv is 1 (the reference's
AnyHit cutout). This is the walk for scenes without cluster tables,
`traversal="gather"`, and the only walk that applies the cutout inside
the traversal.

All functions return detached tensors under no_grad: traversal is a
discrete selector.
"""

from __future__ import annotations

import torch

from dustraytracer_tpu_torch.ops.intersect import (moller_trumbore,
                                                   ray_aabb_entry)
from dustraytracer_tpu_torch.scene.scene import MAX_LEAF

BIG = 3.4e38


def _sample_alpha(scene, tex_idx, uv):
    """Point-sampled, repeat-wrapped alpha of texture `tex_idx` (...,)
    (may be -1) at `uv` (..., 2) -> (...,) f32. A texel is opaque (1.0)
    where tex_idx < 0 or the texture has no alpha; u8 stacks read byte 3
    / 255 (the JAX package unpacks it from a u32 word, the same value)."""
    safe = torch.clamp_min(tex_idx, 0).to(torch.int64)
    hw = scene.tex_hw[safe].to(torch.int64)
    h, w = hw[..., 0], hw[..., 1]
    fu = uv[..., 0] - torch.floor(uv[..., 0])
    fv = uv[..., 1] - torch.floor(uv[..., 1])
    x = torch.clamp((fu * w.to(torch.float32)).to(torch.int64),
                    torch.zeros_like(w), w - 1)
    y = torch.clamp((fv * h.to(torch.float32)).to(torch.int64),
                    torch.zeros_like(h), h - 1)
    a = scene.tex_stack[safe, y, x, 3].to(torch.float32)
    if scene.tex_stack.dtype == torch.uint8:
        a = a / 255.0
    opaque = (tex_idx < 0) | ~scene.tex_has_alpha[safe]
    return torch.where(opaque, 1.0, a)


def _leaf_intersect(scene, node, origin, direction, hit_t, alpha_test):
    """Test the MAX_LEAF-wide triangle window of each ray's leaf `node`
    (L,) -> (best_t, best_idx, any_valid), each (L,): the first slot with
    the smallest t among the valid ones."""
    first = scene.node_first[node].to(torch.int64)
    count = scene.node_count[node].to(torch.int64)
    slots = torch.arange(MAX_LEAF, device=node.device)
    # the padded table holds MAX_LEAF slots past the last real triangle;
    # the clamp only mirrors JAX's clamped gather
    prim = torch.clamp_max(first[:, None] + slots[None, :],
                           scene.tri_pos.shape[0] - 1)  # (L, MAX_LEAF)
    in_leaf = slots[None, :] < count[:, None]
    tri = scene.tri_pos[prim]  # (L, MAX_LEAF, 3, 3)
    valid, t, u, v = moller_trumbore(origin[:, None, :], direction[:, None, :],
                                     tri[..., 0, :], tri[..., 1, :],
                                     tri[..., 2, :])
    valid = valid & in_leaf & (t < hit_t[:, None])
    if alpha_test:
        w_b = 1.0 - u - v
        tuv = scene.tri_uv[prim]  # (L, MAX_LEAF, 3, 2)
        uv_i = (w_b[..., None] * tuv[..., 0, :] + u[..., None] * tuv[..., 1, :]
                + v[..., None] * tuv[..., 2, :])
        tex = scene.mat_albedo_tex[scene.tri_mat[prim].to(torch.int64)]
        valid = valid & (_sample_alpha(scene, tex, uv_i) >= 1.0)
    t_masked = torch.where(valid, t, BIG)
    j = t_masked.argmin(dim=1, keepdim=True)
    return (t_masked.gather(1, j)[:, 0], prim.gather(1, j)[:, 0],
            valid.any(dim=1))


def _walk(scene, origin, direction, limit, alpha_test: bool, closest: bool):
    """The threaded walk; closest: (hit_idx, t, visits), else occluded."""
    n = origin.shape[0]
    dev = origin.device
    inv_dir = 1.0 / direction
    skip_t = scene.node_skip.to(torch.int64)
    hit_t = limit.clone()
    hit_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    # pre-order pointers only move forward: at most n_nodes steps
    for _ in range(max(scene.n_nodes, 1) + 4):
        if not lanes.numel():
            break
        visits[lanes] += 1
        cur_t = hit_t[lanes]
        box_hit, box_t = ray_aabb_entry(origin[lanes], inv_dir[lanes],
                                        scene.node_min[node],
                                        scene.node_max[node])
        enter = box_hit & (box_t < cur_t)
        is_leaf = scene.node_count[node] > 0
        at_leaf = torch.nonzero(enter & is_leaf).squeeze(1)
        stop = torch.zeros_like(enter)
        if at_leaf.numel():
            ll = lanes[at_leaf]
            best_t, best_idx, any_valid = _leaf_intersect(
                scene, node[at_leaf], origin[ll], direction[ll],
                cur_t[at_leaf], alpha_test)
            if closest:
                take = any_valid & (best_t < cur_t[at_leaf])
                hit_t[ll[take]] = best_t[take]
                hit_idx[ll[take]] = best_idx[take].to(torch.int32)
            else:
                occluded[ll[any_valid]] = True
                stop[at_leaf[any_valid]] = True
        nxt = torch.where(enter & ~is_leaf, node + 1, skip_t[node])
        live = (nxt >= 0) & ~stop
        lanes, node = lanes[live], nxt[live]
    if closest:
        return {"hit_idx": hit_idx, "t": hit_t, "visits": visits}
    return occluded


@torch.no_grad()
def traverse_closest(scene, origin, direction, *,
                     alpha_test: bool = False) -> dict:
    """Closest-hit walk for N rays (origin, direction: (N, 3) f32) ->
    detached {"hit_idx" i32 (-1 = miss), "t" f32 (3.4e38 on a miss),
    "visits" i32 (nodes each ray stood on)}."""
    limit = torch.full((origin.shape[0],), BIG, dtype=torch.float32,
                       device=origin.device)
    return _walk(scene, origin, direction, limit, alpha_test, closest=True)


@torch.no_grad()
def traverse_anyhit(scene, origin, direction, *, alpha_test: bool = False,
                    t_max=None) -> torch.Tensor:
    """Occlusion query: (N,) bool, True where some accepted hit lies
    before t_max (a scalar or (N,), default 3.4e38); a ray stops at its
    first one."""
    n = origin.shape[0]
    limit = torch.broadcast_to(torch.as_tensor(
        BIG if t_max is None else t_max, dtype=torch.float32,
        device=origin.device), (n,))
    return _walk(scene, origin, direction, limit, alpha_test, closest=False)
