"""Brute-force traversal: every ray against every triangle, no BVH (port
of ops/traverse_brute.py).

For a scene at or below settings.brute_max_tris triangles, `auto`
skips the tree: all pairs of rays and the real clusters' triangles, as
per-component (1, T) rows, in plain PyTorch (the JAX package leaves it
to XLA too). Rays go in tiles sized so that a tile's (tile, T)
intermediates stay near ELEMS floats each, which bounds memory on a
large scene forced to brute; results do not depend on the tile.
"""

from __future__ import annotations

import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh
from dustraytracer_tpu_torch.ops.intersect import TRIANGLE_EPSILON
from dustraytracer_tpu_torch.ops.traverse_sweep import (BIG, _check_rays,
                                                        _t_init)

_NO_ID = 2 ** 30
ELEMS = 1 << 22  # floats per (tile, T) intermediate: 16 MiB


def _flatten_tris(cb: ClusterBvh):
    """(C, K, 3) cluster tables -> per-component (1, T) rows of the real
    clusters (padding slots keep tri_idx == -1)."""
    c = cb.n_clusters
    t = c * cb.k

    def comp(a):
        flat = a[:c].reshape(t, 3)
        return flat[:, 0][None, :], flat[:, 1][None, :], flat[:, 2][None, :]

    return (comp(cb.v0), comp(cb.e1), comp(cb.e2),
            cb.tri_idx[:c].reshape(t)[None, :])


@torch.no_grad()
def traverse_brute(cb: ClusterBvh, origin, direction, *,
                   anyhit: bool = False, t_max=None) -> dict:
    """All-pairs closest hit: detached {"hit_idx" i32 (-1 = miss), "t"
    f32 (t_max on a miss), "visits" i32 ones (the scene is one implicit
    leaf)}. The smallest t wins, ties to the lowest triangle id.
    `anyhit` is accepted and ignored: any-hit is "a closest hit exists"."""
    del anyhit
    _check_rays(cb, origin, direction)
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z), ids = \
        _flatten_tris(cb)
    n = origin.shape[0]
    dev = origin.device
    limit = _t_init(t_max, n, dev)
    hit_t = torch.empty((n,), dtype=torch.float32, device=dev)
    hit_idx = torch.empty((n,), dtype=torch.int32, device=dev)
    tile = max(1, ELEMS // max(ids.shape[1], 1))
    for s in range(0, n, tile):
        ot, dt = origin[s:s + tile], direction[s:s + tile]
        lt = limit[s:s + tile]
        ox, oy, oz = ot[:, 0:1], ot[:, 1:2], ot[:, 2:3]  # (R, 1)
        dx, dy, dz = dt[:, 0:1], dt[:, 1:2], dt[:, 2:3]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        par = det.abs() < TRIANGLE_EPSILON
        inv_det = 1.0 / torch.where(par, torch.ones_like(det), det)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        u = inv_det * (tvx * px + tvy * py + tvz * pz)
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = inv_det * (dx * qx + dy * qy + dz * qz)
        tt = inv_det * (e2x * qx + e2y * qy + e2z * qz)
        valid = (~par) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
            & (u + v <= 1.0) & (tt > TRIANGLE_EPSILON) & (ids >= 0) \
            & (tt < lt[:, None])
        t_masked = torch.where(valid, tt, BIG)
        best_t = t_masked.amin(dim=1)
        is_best = valid & (t_masked <= best_t[:, None])
        best_id = torch.where(is_best, ids, _NO_ID).amin(dim=1)
        hit = best_id < _NO_ID
        hit_idx[s:s + tile] = torch.where(hit, best_id, -1)
        hit_t[s:s + tile] = torch.where(hit, best_t, lt)
    return {"hit_idx": hit_idx, "t": hit_t,
            "visits": torch.ones((n,), dtype=torch.int32, device=dev)}
