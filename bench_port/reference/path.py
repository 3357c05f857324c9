"""The path integrator, its film and its inverse-rendering step, in plain
PyTorch.

A sample of pixel p in frame f: the PCG stream head of (p, f); a camera
ray through the jittered pixel (two draws, then two more for a lens
disk that a zero defocus angle leaves unused); then `bounces` segments,
each drawing a sun jitter (two) and a ball sample (three): trace the
closest hit; a miss adds throughput * sky(d)^2 * sky intensity and ends
the path; a hit multiplies the throughput by the albedo (a point-sampled
(u8 / 255)^2 texel where the material has a texture), adds
sun colour * intensity * throughput unless a shadow ray from the hit
(offset 1e-3 along the viewer-facing face normal) toward
100 (sin az (1 - sin el), sin el, cos az (1 - sin el)) + 1.5 jitter hits
anything, and bounces to normal + ball. Then the Uncharted2 filmic
tonemap (exposure, white 11.2) and sqrt gamma, where on. The traversal
is a discrete choice: only the shading carries gradients."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.pcg import Stream, stream_heads
from bench_port.reference.tracer import Tracer

LIGHT_KEYS = ("sun_azimuth", "sun_elevation", "sun_color", "sun_intensity",
              "sky_color", "sky_intensity")
NORMAL_OFFSET = 1e-3
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
BLOCK = 1 << 18  # pixels a block in the full-image render


class RefScene:
    """The soup on a device in one dtype: corners, face orientation, uvs,
    material ids, per-material texture ids, the u8 images."""

    def __init__(self, soup: dict, device, dtype):
        def f(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device, dtype)

        pos = np.asarray(soup["positions"], np.float32)
        self.v0, self.v1, self.v2 = f(pos[:, 0]), f(pos[:, 1]), f(pos[:, 2])
        self.tracer = Tracer(self.v0, self.v1, self.v2)
        raw = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        mean_n = np.asarray(soup["normals"], np.float32).mean(1)
        # +1 where the winding agrees with the mean vertex normal
        self.orient = f(np.where((raw * mean_n).sum(-1) < 0, -1.0, 1.0))
        self.uv = f(soup["uvs"])
        self.mat = torch.as_tensor(np.asarray(soup["material"], np.int64),
                                   device=device)
        self.mat_tex = [int(m.get("texture", -1)) for m in soup["materials"]]
        self.images = [torch.as_tensor(np.asarray(im)).to(device)
                       for im in soup["images"]]
        self.dtype, self.device = dtype, device


def camera_rays(cam: dict, width: int, height: int, pixels, stream: Stream):
    """(origin, direction) per lane; cam holds position, look_at,
    vfov_deg, focus_dist as numbers."""
    dt, dev = stream.dtype, pixels.device

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev).to(dt)

    pos = vec(cam["position"])
    fwd = vec(np.asarray(cam["look_at"], np.float32)
              - np.asarray(cam["position"], np.float32))
    fwd = fwd / torch.linalg.vector_norm(fwd)
    up_w = vec([0.0, 0.0, 1.0] if abs(float(fwd[1])) > 0.999
               else [0.0, 1.0, 0.0])
    right = torch.linalg.cross(fwd, up_w)
    right = right / torch.clamp_min(torch.linalg.vector_norm(right), 1e-8)
    up = torch.linalg.cross(right, fwd)
    ju, jv = stream.uniform(), stream.uniform()
    stream.uniform(), stream.uniform()  # the lens disk: defocus angle 0
    px = (pixels % width).to(dt)
    py = (pixels // width).to(dt)
    u = ((px + ju) / width) * 2.0 - 1.0
    v = ((py + jv) / height) * 2.0 - 1.0
    focus = vec(cam["focus_dist"])
    half_h = torch.tan(torch.deg2rad(vec(cam["vfov_deg"])) * 0.5) * focus
    half_w = half_h * (width / height)
    d = fwd * focus + u[:, None] * (half_w * right) \
        + v[:, None] * (half_h * up)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return pos.expand_as(d).clone(), d


def _sky(d, lights):
    g = 0.5 * (1.0 + (d / torch.linalg.vector_norm(d, dim=-1,
                                                   keepdim=True))[:, 1])
    col = (1.0 - g)[:, None] + g[:, None] * lights["sky_color"]
    return col * col


def _albedo(scene: RefScene, albedo, tri, t_uv):
    """Albedo per hit lane: the material's, or its texture's texel."""
    mat = scene.mat[tri]
    out = torch.zeros((tri.shape[0], 3), dtype=albedo.dtype,
                      device=tri.device)
    for k, tex in enumerate(scene.mat_tex):
        sel = (mat == k)[:, None]
        if tex < 0:
            out = out + sel * albedo[k]
            continue
        img = scene.images[tex]
        h, w = img.shape[0], img.shape[1]
        fu = (t_uv[:, 0] - torch.floor(t_uv[:, 0])) * w
        fv = (t_uv[:, 1] - torch.floor(t_uv[:, 1])) * h
        x = fu.to(torch.int64).clamp(0, w - 1)
        y = fv.to(torch.int64).clamp(0, h - 1)
        rgb = img[y, x, :3].to(albedo.dtype) / 255.0
        out = out + sel * (rgb * rgb)
    return out


def _sun_position(lights):
    az, el = lights["sun_azimuth"], lights["sun_elevation"]
    h = 1.0 - torch.sin(el)
    return 100.0 * torch.stack([torch.sin(az) * h, torch.sin(el),
                                torch.cos(az) * h])


def _tonemap(c, exposure: float):
    a, b, cc, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def part(x):
        return (x * (a * x + cc * b) + d * e) / (x * (a * x + b) + d * f) \
            - e / f

    white = part(torch.tensor(11.2, dtype=c.dtype, device=c.device))
    return part(c * exposure) * (1.0 / white)


def render(scene: RefScene, cam: dict, albedo, lights: dict, pixels, frames,
           *, width: int, height: int, bounces: int, tonemap: bool,
           gamma: bool, exposure: float = 2.0):
    """One sample of each lane's (pixel, frame) -> (N, 3) colour."""
    stream = Stream(stream_heads(pixels, frames), scene.dtype)
    o, d = camera_rays(cam, width, height, pixels, stream)
    n = pixels.shape[0]
    dt, dev = scene.dtype, pixels.device
    tp = torch.ones((n, 3), dtype=dt, device=dev)
    light = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    sun = _sun_position(lights)
    sun_col = lights["sun_color"] * lights["sun_intensity"]
    for _ in range(bounces):
        jitter = stream.unit_vector()
        ball = stream.in_ball()
        lanes = alive.nonzero().squeeze(1)
        hit, tri, t, u, v = scene.tracer.closest(o[lanes].detach(),
                                                 d[lanes].detach())
        miss = lanes[~hit]
        light = light.index_add(0, miss, tp[miss] * _sky(d[miss], lights)
                                * lights["sky_intensity"])
        h = lanes[hit]
        tri, t, u, v = tri[hit], t[hit], u[hit], v[hit]
        oh, dh = o[h], d[h]
        e1, e2 = scene.tracer.tri_e1[tri], scene.tracer.tri_e2[tri]
        raw = torch.linalg.cross(e1, e2)
        raw = raw / torch.clamp_min(
            torch.linalg.vector_norm(raw, dim=-1, keepdim=True), 1e-20)
        face = raw * scene.orient[tri][:, None]
        dn = dh / torch.linalg.vector_norm(dh, dim=-1, keepdim=True)
        front = (face * dn).sum(-1) <= 0
        nrm = torch.where(front[:, None], face, -face)
        w = 1.0 - u - v
        uv = scene.uv[tri]
        t_uv = w[:, None] * uv[:, 0] + u[:, None] * uv[:, 1] \
            + v[:, None] * uv[:, 2]
        tp_h = tp[h] * _albedo(scene, albedo, tri, t_uv)
        new_o = oh + dh * t[:, None] + nrm * NORMAL_OFFSET
        occ = scene.tracer.occluded(new_o.detach(),
                                    (sun[None, :] + jitter[h] * 1.5).detach())
        lit = h[~occ]
        light = light.index_add(0, lit, sun_col * tp_h[~occ])
        tp = tp.index_copy(0, h, tp_h)
        o = o.index_copy(0, h, new_o.to(o.dtype))
        d = d.index_copy(0, h, nrm + ball[h])
        alive = torch.zeros_like(alive).index_fill(0, h, True)
    if tonemap:
        light = _tonemap(light, exposure)
    if gamma:
        light = torch.sqrt(torch.clamp_min(light, 0.0))
    return light


def film_pixels(scene, cam, albedo, lights, pixels, spp: int, **kw):
    """The film after `spp` samples (frames 0 .. spp - 1) at `pixels`:
    the running sum of the samples over spp."""
    n = pixels.shape[0]
    frames = torch.arange(spp, device=pixels.device).repeat_interleave(n)
    col = render(scene, cam, albedo, lights, pixels.repeat(spp), frames, **kw)
    acc = torch.zeros_like(col[:n])
    for j in range(spp):
        acc = acc + col[j * n:(j + 1) * n]
    return acc / float(spp)


def image(scene, cam, albedo, lights, frame: int, *, width, height, **kw):
    """A full sample image as (W H, 3), rendered in blocks of pixels."""
    out = []
    for s in range(0, width * height, BLOCK):
        px = torch.arange(s, min(s + BLOCK, width * height),
                          device=scene.device)
        out.append(render(scene, cam, albedo, lights, px,
                          torch.full_like(px, frame), width=width,
                          height=height, **kw))
    return torch.cat(out)


def train(scene: RefScene, cam: dict, init: dict, true: dict, *, steps: int,
          frames, lr: float, width: int, height: int, bounces: int,
          target_frame: int, bounds: dict, half_batch: bool = False):
    """`steps` Adam steps of the mean squared error of one sample against
    a target rendered at the true parameters. `init` and `true` map leaf
    names ("mat_albedo", "lights.<key>") to arrays. Returns
    {"losses", "grad0" (the first step's gradients), "params" (after the
    steps)}. With half_batch the loss is the mean over the first half of
    the pixels only (a planted fault)."""
    dt, dev = scene.dtype, scene.device
    kw = dict(width=width, height=height, bounces=bounces, tonemap=False,
              gamma=False)
    target = _target(scene, cam, true, target_frame, kw)
    params = {k: _leaf(scene, v, True) for k, v in init.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    s2 = {k: torch.zeros_like(p) for k, p in params.items()}
    n = width * height // 2 if half_batch else width * height
    losses, grad0 = [], None
    for step in range(steps):
        alb, lights = _split(params)
        total = torch.zeros((), dtype=dt, device=dev)
        for s in range(0, n, BLOCK):
            px = torch.arange(s, min(s + BLOCK, n), device=dev)
            col = render(scene, cam, alb, lights, px,
                         torch.full_like(px, int(frames[step])), **kw)
            part = ((col - target[px]) ** 2).sum() / (n * 3)
            part.backward()
            total = total + part.detach()
        losses.append(float(total))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if grad0 is None:
            grad0 = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
            for k, p in params.items():
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                s2[k] = b2 * s2[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** (step + 1))
                vh = s2[k] / (1 - b2 ** (step + 1))
                p -= lr * mh / (torch.sqrt(vh) + eps)
                if k in bounds:
                    p.clamp_(*bounds[k])
                p.grad = None
    return {"losses": losses, "grad0": grad0,
            "params": {k: p.detach() for k, p in params.items()}}


def losses_at(scene: RefScene, cam: dict, points, true: dict, *, width: int,
              height: int, bounces: int, target_frame: int) -> list:
    """The loss of one sample at each point (leaves, frame), the leaves
    named as in `train`, against the same target; no gradient."""
    kw = dict(width=width, height=height, bounces=bounces, tonemap=False,
              gamma=False)
    target = _target(scene, cam, true, target_frame, kw)
    out = []
    with torch.no_grad():
        for leaves, frame in points:
            alb, lights = _split({k: _leaf(scene, v, False)
                                  for k, v in leaves.items()})
            col = image(scene, cam, alb, lights, int(frame), **kw)
            out.append(float(((col - target) ** 2).sum() / target.numel()))
    return out


def _leaf(scene: RefScene, a, grad: bool):
    x = torch.tensor(np.asarray(a, np.float32), device=scene.device)
    return x.to(scene.dtype).requires_grad_(grad)


def _split(p: dict):
    return p["mat_albedo"], {k: p[f"lights.{k}"] for k in LIGHT_KEYS}


def _target(scene: RefScene, cam: dict, true: dict, frame: int, kw: dict):
    with torch.no_grad():
        alb, lights = _split({k: _leaf(scene, v, False)
                              for k, v in true.items()})
        return image(scene, cam, alb, lights, frame, **kw)
