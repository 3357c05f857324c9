"""Albedo texture sampling (port of render/texture.py): point or bilinear,
repeat-wrapped UVs, from the (T, H, W, 4) texture stack.

A u8 stack is decoded as (u8 / 255)^2, the reference's approximate
sRGB -> linear; a float stack (`decode_textures`) holds linear values,
read as they are, and is differentiable: the learnable-texture path of
inverse rendering. Texels are fetched from the flat (T*H*W, 4) view by
index_select, whose backward is an atomic index_add_ (the backward of
`stack[t, y, x]` is serial on repeated texels)."""

from __future__ import annotations

import torch


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def sample_texture(scene, tex_idx: torch.Tensor, uv: torch.Tensor,
                   bilinear: bool = False) -> torch.Tensor:
    """Linear albedo RGB (N, 3) of texture `tex_idx` (N,) at `uv`
    (N, 2). Negative ids read texture 0; callers mask them."""
    stack = scene.tex_stack
    _, hs, ws, _ = stack.shape
    flat = stack.reshape(-1, 4)
    safe = torch.clamp_min(tex_idx, 0).to(torch.int64)
    hw = scene.tex_hw[safe].to(torch.int64)
    fu = _wrap(uv[..., 0]) * hw[..., 1].to(torch.float32)
    fv = _wrap(uv[..., 1]) * hw[..., 0].to(torch.float32)

    def fetch(xi, yi):
        xi = torch.clamp(xi, torch.zeros_like(xi), hw[..., 1] - 1)
        yi = torch.clamp(yi, torch.zeros_like(yi), hw[..., 0] - 1)
        rgb = flat.index_select(0, (safe * hs + yi) * ws + xi)[:, :3]
        if stack.dtype != torch.uint8:
            return rgb
        rgb = rgb.to(torch.float32) / 255.0
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


def decode_textures(scene):
    """The scene with its u8 texture stack as a linear float32 stack:
    RGB (u8 / 255)^2, alpha u8 / 255. Renders the same image as the u8
    stack, and every texel becomes a differentiable parameter. A float
    stack is returned as it is."""
    u8 = scene.tex_stack
    if u8.dtype != torch.uint8:
        return scene
    f = u8.to(torch.float32) / 255.0
    rgb = f[..., :3] * f[..., :3]
    return scene.replace(tex_stack=torch.cat([rgb, f[..., 3:4]], dim=-1))
