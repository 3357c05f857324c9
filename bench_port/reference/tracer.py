"""Closest-hit and any-hit ray casting over a triangle soup.

The soup is cut into chunks of CHUNK spatially close triangles by
recursive median splits of their centroids; each chunk has a padded
box. A ray tests a chunk's triangles (Moller-Trumbore, both faces,
t > EPS) only when it enters the chunk's box before its best hit so far.
The answer is the smallest t over all triangles, ties to the lowest
soup index: what a test of every pair would give."""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6
CHUNK = 64
PAIRS = 1 << 23  # (rays x CHUNK) lanes per Moller-Trumbore block


def _chunks(centroids: np.ndarray) -> list:
    """Triangle ids in chunks of at most CHUNK, by median splits along
    the widest axis of the centroids (float64, so any dtype cuts the
    same chunks)."""
    out = []
    stack = [np.arange(centroids.shape[0])]
    while stack:
        ids = stack.pop()
        if ids.size <= CHUNK:
            out.append(ids)
            continue
        c = centroids[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        half = -(-ids.size // 2 // CHUNK) * CHUNK
        stack += [ids[half:], ids[:half]]
    return out


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore(o, d, v0, e1, e2):
    """(valid, t, u, v) of rays o + t d against triangles v0 + u e1 + v e2;
    any broadcastable shapes (..., 3)."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    parallel = det.abs() < EPS
    inv = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    ok = ~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return ok, t, u, v


class Tracer:
    def __init__(self, v0, v1, v2):
        """v0, v1, v2: (T, 3) corners, in the dtype rays will have."""
        dev, dt = v0.device, v0.dtype
        cen = ((v0 + v1 + v2) / 3).double().cpu().numpy()
        chunks = _chunks(cen)
        n = len(chunks)
        ids = np.full((n, CHUNK), -1, np.int64)
        for i, c in enumerate(chunks):
            ids[i, :c.size] = np.sort(c)
        self.ids = torch.from_numpy(ids).to(dev)
        safe = self.ids.clamp_min(0)
        real = (self.ids >= 0)[..., None]
        e1, e2 = v1 - v0, v2 - v0
        # padding slots: a zero triangle, which no ray hits (det = 0)
        self.v0 = torch.where(real, v0[safe], 0.0)
        self.e1 = torch.where(real, e1[safe], 0.0)
        self.e2 = torch.where(real, e2[safe], 0.0)
        corners = torch.stack([v0[safe], v1[safe], v2[safe]], 2)  # C,K,3,3
        big = torch.finfo(dt).max
        lo = torch.where(real[..., None], corners, big).amin((1, 2))
        hi = torch.where(real[..., None], corners, -big).amax((1, 2))
        pad = 1e-3 * (hi - lo).amax(-1, keepdim=True) + 1e-4
        self.lo, self.hi = lo - pad, hi + pad
        self.tri_v0, self.tri_e1, self.tri_e2 = v0, e1, e2

    def _enter(self, o, inv, c):
        """(box entered at t >= 0, entry t) of chunk c's box."""
        t0 = (self.lo[c] - o) * inv
        t1 = (self.hi[c] - o) * inv
        near = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
        far = torch.maximum(t0, t1).amin(-1)
        return near <= far, near

    @torch.no_grad()
    def closest(self, o, d):
        """(hit, tri, t, u, v): closest hit per ray; tri = -1 on a miss."""
        n = o.shape[0]
        dev = o.device
        tiny = torch.finfo(d.dtype).tiny
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        best_t = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
        best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        bu = torch.zeros((n,), dtype=o.dtype, device=dev)
        bv = torch.zeros_like(bu)
        rows = max(1, PAIRS // CHUNK)
        for c in range(self.ids.shape[0]):
            entered, near = self._enter(o, inv, c)
            cand = (entered & (near <= best_t)).nonzero().squeeze(1)
            for s in range(0, cand.numel(), rows):
                r = cand[s:s + rows]
                ok, t, u, v = moller_trumbore(
                    o[r, None], d[r, None], self.v0[c], self.e1[c],
                    self.e2[c])
                t = torch.where(ok, t, float("inf"))
                tmin = t.amin(1)
                # ties to the lowest id: ids ascend within a chunk
                j = torch.where(t == tmin[:, None], self.ids[c], 1 << 62) \
                    .argmin(1)
                tid = self.ids[c][j]
                cur_t, cur = best_t[r], best[r]
                better = torch.isfinite(tmin) & (
                    (tmin < cur_t) | ((tmin == cur_t) & (tid < cur)))
                k = better.nonzero().squeeze(1)
                rb, jb = r[k], j[k]
                best_t[rb] = tmin[k]
                best[rb] = tid[k]
                bu[rb] = u[k, jb]
                bv[rb] = v[k, jb]
        return best >= 0, best, best_t, bu, bv

    @torch.no_grad()
    def occluded(self, o, d):
        """Whether each ray hits any triangle at t > EPS."""
        n = o.shape[0]
        tiny = torch.finfo(d.dtype).tiny
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
        rows = max(1, PAIRS // CHUNK)
        for c in range(self.ids.shape[0]):
            entered, _ = self._enter(o, inv, c)
            cand = (entered & ~occ).nonzero().squeeze(1)
            for s in range(0, cand.numel(), rows):
                r = cand[s:s + rows]
                ok, _, _, _ = moller_trumbore(
                    o[r, None], d[r, None], self.v0[c], self.e1[c],
                    self.e2[c])
                occ[r[ok.any(1)]] = True
        return occ
