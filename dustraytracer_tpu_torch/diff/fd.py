"""Finite-difference gradient oracle for differentiable rendering (port
of diff/fd.py).

Traversal returns detached discrete hit ids and every continuous
quantity is recomputed from them, so for a fixed RNG frame a sample is
a piecewise-smooth function of the scene parameters, and central
differences must match autograd away from visibility discontinuities. A
vertex moving across a pixel's ray flips the hit id, a jump autograd
does not see: check interior-only configurations here, and silhouettes
with soft edges.
"""

from __future__ import annotations

import numpy as np
import torch


def fd_grad(f, x, eps: float = 1e-3) -> np.ndarray:
    """Central differences of scalar f with respect to each element of x,
    in float64 from float32 evaluations of f: 2 * x.size calls, so only
    for small parameter arrays."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat = x.reshape(-1)
    gflat = g.reshape(-1)

    def at(v):
        return float(f(torch.tensor(v.reshape(x.shape), dtype=torch.float32)))

    with torch.no_grad():
        for i in range(flat.size):
            xp = flat.copy()
            xm = flat.copy()
            xp[i] += eps
            xm[i] -= eps
            gflat[i] = (at(xp) - at(xm)) / (2.0 * eps)
    return g


def check_grads_vs_fd(f, x, eps: float = 1e-3, rtol: float = 5e-2,
                      atol: float = 1e-4):
    """Assert that torch.autograd.grad of f at x matches central
    differences: |ad - fd| <= atol + rtol * max(|ad|, |fd|) elementwise.
    Returns (ad, fd) as float64 arrays."""
    xt = torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=True)
    (ad,) = torch.autograd.grad(f(xt), xt)
    ad = ad.detach().cpu().numpy().astype(np.float64)
    fd = fd_grad(f, x, eps)
    scale = np.maximum(np.abs(fd), np.abs(ad))
    err = np.abs(ad - fd)
    ok = err <= atol + rtol * scale
    if not ok.all():
        bad = np.argwhere(~ok)
        raise AssertionError(
            f"AD/FD mismatch at {bad[:5].tolist()}: ad={ad[~ok][:5]} "
            f"fd={fd[~ok][:5]} (rtol={rtol}, eps={eps})")
    return ad, fd
