"""Counter-based PCG streams: a pixel's stream head is
pcg(pixel ^ (pcg(frame) + 0x9E3779B9)) and every draw is one PCG round.
uint32 words are carried in int64 and masked after every multiply-add."""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF


def pcg(x: torch.Tensor) -> torch.Tensor:
    state = (x * 747796405 + 2891336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def stream_heads(pixels: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Per-lane heads for int64 pixel ids and frame indices."""
    salt = (pcg(frames & MASK) + 0x9E3779B9) & MASK
    return pcg(pixels ^ salt)


class Stream:
    """One PCG stream per lane; each draw returns uniforms in [0, 1) of
    `dtype`."""

    def __init__(self, heads: torch.Tensor, dtype):
        self.state = heads
        self.dtype = dtype

    def uniform(self) -> torch.Tensor:
        self.state = pcg(self.state)
        return self.state.to(self.dtype) / 4294967296.0

    def unit_vector(self) -> torch.Tensor:
        """Uniform on the sphere (Archimedes): z = 1 - 2 u1, phi = 2 pi u2."""
        z = 1.0 - 2.0 * self.uniform()
        phi = (2.0 * math.pi) * self.uniform()
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)

    def in_ball(self) -> torch.Tensor:
        """Uniform in the unit ball: a sphere sample times u^(1/3)."""
        s = self.unit_vector()
        u = self.uniform()
        return s * torch.pow(torch.clamp_min(u, 1e-12), 1.0 / 3.0)[:, None]
