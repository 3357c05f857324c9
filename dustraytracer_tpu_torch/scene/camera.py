"""Thin-lens camera and batched primary rays (port of scene/camera.py).
The rays are differentiable in every camera field."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dustraytracer_tpu_torch.ops.rng import random_float, random_in_disk

WORLD_UP = (0.0, 1.0, 0.0)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@dataclass
class Camera:
    position: torch.Tensor       # (3,)
    forward: torch.Tensor        # (3,) need not be normalized
    vfov_deg: torch.Tensor       # ()
    focus_dist: torch.Tensor     # ()
    defocus_angle: torch.Tensor  # () degrees; <= 0 disables DoF
    exposure: torch.Tensor       # () tonemap exposure bias

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def basis(self):
        """Orthonormal (forward, right, up) with world-up Y, falling back
        to world-up Z when looking straight up or down."""
        fwd = self.forward / _norm(self.forward)
        # world-up Y and Z as rows of an identity made on the device: no
        # copy from the host
        axes = torch.eye(3, dtype=torch.float32, device=fwd.device)
        up_w = torch.where(fwd[1].abs() > 0.999, axes[2], axes[1])
        right = torch.linalg.cross(fwd, up_w, dim=-1)
        right = right / torch.clamp_min(_norm(right), 1e-8)
        up = torch.linalg.cross(right, fwd, dim=-1)
        return fwd, right, up


def make_camera(position=(0.0, 1.0, 3.0), look_at=None, forward=None,
                vfov_deg=60.0, focus_dist=10.0, defocus_angle=0.0,
                exposure=2.0, device="cpu") -> Camera:
    position = np.asarray(position, np.float32)
    if forward is None:
        target = np.asarray(look_at if look_at is not None else (0, 1, 0),
                            np.float32)
        forward = target - position
        if np.linalg.norm(forward) < 1e-8:
            forward = np.array([0, 0, -1], np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(position=f32(position), forward=f32(forward),
                  vfov_deg=f32(vfov_deg), focus_dist=f32(focus_dist),
                  defocus_angle=f32(defocus_angle), exposure=f32(exposure))


def generate_rays(camera: Camera, width: int, height: int,
                  rng_state: torch.Tensor, jitter: bool = True,
                  pixel_ids: torch.Tensor | None = None):
    """Primary rays for a batch of flat pixel ids (y * width + x; pixel
    (0, 0) is bottom-left). Returns (rng_state, origins, directions),
    each (N, 3) float32 on the state's device."""
    fwd, right, up = camera.basis()
    if pixel_ids is None:
        pixel_ids = torch.arange(width * height, dtype=torch.int64,
                                 device=rng_state.device)
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)

    if jitter:
        rng_state, ju = random_float(rng_state)
        rng_state, jv = random_float(rng_state)
    else:
        ju = jv = 0.5

    u = ((px + ju) / width) * 2.0 - 1.0
    v = ((py + jv) / height) * 2.0 - 1.0

    theta = torch.deg2rad(camera.vfov_deg) * 0.5
    half_h = torch.tan(theta) * camera.focus_dist
    half_w = half_h * (width / height)

    plane_point = (fwd * camera.focus_dist
                   + u[:, None] * (half_w * right)
                   + v[:, None] * (half_h * up))

    defocus_radius = camera.focus_dist * torch.tan(
        torch.deg2rad(torch.clamp_min(camera.defocus_angle, 0.0)) * 0.5)
    rng_state, disk = random_in_disk(rng_state)
    lens_offset = defocus_radius * (disk[:, 0:1] * right + disk[:, 1:2] * up)
    lens_offset = torch.where(camera.defocus_angle > 0.0, lens_offset, 0.0)

    origins = camera.position + lens_offset
    directions = plane_point - lens_offset
    directions = directions / _norm(directions)
    return rng_state, origins, directions


# --- host-side fly-cam controls (EditorLayer.cpp:324-417, Camera.cu:44-80) ---

def move_camera(camera: Camera, local_delta) -> Camera:
    """Translate in camera space (WASD/QE fly movement)."""
    fwd, right, up = camera.basis()
    d = torch.as_tensor(np.asarray(local_delta, np.float32),
                        device=camera.position.device)
    world = d[0] * right + d[1] * up + d[2] * fwd
    return camera.replace(position=camera.position + world)


def rotate_camera(camera: Camera, yaw_rad: float, pitch_rad: float) -> Camera:
    """Yaw about world up, pitch about camera right (Rodrigues rotations,
    `Camera.cu:44-80` semantics)."""
    fwd, right, _ = camera.basis()
    dev = fwd.device

    def rodrigues(v, axis, angle):
        axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis), 1e-8)
        angle = torch.tensor(angle, dtype=torch.float32, device=dev)
        c, s = torch.cos(angle), torch.sin(angle)
        return (v * c + torch.linalg.cross(axis, v) * s
                + axis * torch.sum(axis * v) * (1.0 - c))

    up = torch.tensor(WORLD_UP, dtype=torch.float32, device=dev)
    f = rodrigues(fwd, up, yaw_rad)
    f = rodrigues(f, right, pitch_rad)
    return camera.replace(forward=f)
