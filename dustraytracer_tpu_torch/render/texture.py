"""Albedo texture sampling (port of render/texture.py): point or bilinear,
repeat-wrapped UVs, gamma-2 decode of the (T, H, W, 4) u8 stack, as
plain gathers."""

from __future__ import annotations

import torch


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def sample_texture(scene, tex_idx: torch.Tensor, uv: torch.Tensor,
                   bilinear: bool = False) -> torch.Tensor:
    """Linearized albedo RGB (N, 3) of texture `tex_idx` (N,) at `uv`
    (N, 2). Negative ids read texture 0; callers mask them."""
    safe = torch.clamp_min(tex_idx, 0).to(torch.int64)
    hw = scene.tex_hw[safe].to(torch.int64)
    fu = _wrap(uv[..., 0]) * hw[..., 1].to(torch.float32)
    fv = _wrap(uv[..., 1]) * hw[..., 0].to(torch.float32)

    def fetch(xi, yi):
        xi = torch.clamp(xi, torch.zeros_like(xi), hw[..., 1] - 1)
        yi = torch.clamp(yi, torch.zeros_like(yi), hw[..., 0] - 1)
        rgb = scene.tex_stack[safe, yi, xi, :3].to(torch.float32) / 255.0
        return rgb * rgb

    if not bilinear:
        return fetch(fu.to(torch.int64), fv.to(torch.int64))

    x0 = torch.floor(fu - 0.5)
    y0 = torch.floor(fv - 0.5)
    tx = (fu - 0.5 - x0)[..., None]
    ty = (fv - 0.5 - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    c00 = fetch(x0i, y0i)
    c10 = fetch(x0i + 1, y0i)
    c01 = fetch(x0i, y0i + 1)
    c11 = fetch(x0i + 1, y0i + 1)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty
