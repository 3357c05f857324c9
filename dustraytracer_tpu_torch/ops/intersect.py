"""Geometric intersection primitives over any batch shape (port of
ops/intersect.py): the NaN-suppressing slab test and Möller–Trumbore."""

from __future__ import annotations

import torch

TRIANGLE_EPSILON = 1e-6


def ray_aabb_entry(origin, inv_dir, box_min, box_max):
    """Slab test -> (hit, t_enter), t_enter clamped to 0 inside the box.

    torch.fmin/fmax drop a NaN operand (0 * inf on an axis-parallel ray
    whose origin lies on a slab plane), like CUDA's fminf/fmaxf."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    tmin = torch.fmin(t0, t1)
    tmax = torch.fmax(t0, t1)
    t_enter = tmin.amax(dim=-1)
    t_exit = tmax.amin(dim=-1)
    t_enter_c = torch.clamp_min(t_enter, 0.0)
    hit = (t_enter_c <= t_exit) & (t_exit >= 0.0)
    return hit, t_enter_c


def moller_trumbore(origin, direction, v0, v1, v2, eps=TRIANGLE_EPSILON):
    """Möller–Trumbore ray/triangle test -> (valid, t, u, v); barycentric
    w = 1-u-v belongs to v0. Both faces are accepted."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(direction, e2, dim=-1)
    det = (e1 * pvec).sum(dim=-1)
    parallel = det.abs() < eps
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = origin - v0
    u = inv_det * (tvec * pvec).sum(dim=-1)
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = inv_det * (direction * qvec).sum(dim=-1)
    t = inv_det * (e2 * qvec).sum(dim=-1)
    valid = (~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
        & (u + v <= 1.0) & (t > eps)
    return valid, t, u, v
