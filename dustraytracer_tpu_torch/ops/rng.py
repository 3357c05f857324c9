"""Counter-based PCG RNG + rejection-free samplers (port of ops/rng.py).

Same streams as the JAX package, word for word: a pixel's stream head is
`seed_pixels(pixel_id, frame)` and every draw is one PCG round. State is
an (N,) int64 tensor holding uint32 values: PyTorch on the CPU has no
uint32 add or shift, so the arithmetic runs in int64 and is masked back
to 32 bits after every multiply-add. All products stay below 2**62.

`torch` has no `cbrt`; `random_in_ball` uses x**(1/3) on x >= 1e-12,
which differs from a correctly rounded cbrt by at most a few ulp
(tests/test_torch_ops.py holds it to JAX within 1e-6).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on uint32 words carried in int64."""
    x = x.to(torch.int64) & _MASK
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def seed_pixels(pixel_idx: torch.Tensor, frame_idx: int) -> torch.Tensor:
    """Decorrelated per-pixel stream heads: pcg(p ^ (pcg(f) + golden))."""
    f = torch.tensor(int(frame_idx) & _MASK, dtype=torch.int64,
                     device=pixel_idx.device)
    salt = (pcg_hash(f) + 0x9E3779B9) & _MASK
    return pcg_hash(pixel_idx.to(torch.int64) ^ salt)


def random_float(state: torch.Tensor):
    """Advance the stream; return (new_state, uniform [0,1) float32)."""
    state = pcg_hash(state)
    return state, state.to(torch.float32) / 4294967296.0


def random_unit_vec3(state: torch.Tensor):
    """Uniform direction on the unit sphere (Archimedes projection)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = (2.0 * math.pi) * u2
    return state, torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                              dim=-1)


def random_in_ball(state: torch.Tensor):
    """Uniform point in the unit ball: sphere sample * cbrt(u)."""
    state, sphere = random_unit_vec3(state)
    state, u = random_float(state)
    radius = torch.pow(torch.clamp_min(u, 1e-12), 1.0 / 3.0)
    return state, sphere * radius[..., None]


def random_in_disk(state: torch.Tensor):
    """Uniform point in the unit disk (thin-lens defocus sampling)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return state, torch.stack([r * torch.cos(phi), r * torch.sin(phi)],
                              dim=-1)
