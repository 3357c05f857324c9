"""Render settings (port of scene/settings.py).

`RenderSettings` is the same frozen dataclass with the same field names
and defaults, so one settings object reads the same in both packages,
and the port renders every option of it. `LightParams` holds the
lighting scalars as float32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

import torch


class RenderMode(enum.Enum):
    NORMAL = 0
    DEBUG = 1


class DebugMode(enum.Enum):
    ALBEDO = 0
    NORMAL = 1
    BARYCENTRIC = 2
    UVS = 3
    BVH = 4
    WORLD_BVH = 5


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration; see the JAX package for each knob."""

    render_mode: RenderMode = RenderMode.NORMAL
    debug_mode: DebugMode = DebugMode.ALBEDO
    max_samples: int = 500
    bounces: int = 3
    enable_tonemap: bool = True
    enable_gamma: bool = True
    enable_sunlight: bool = True
    sun_azimuth: float = 0.7
    sun_elevation: float = 1.0
    sun_color: tuple = (1.0, 1.0, 1.0)
    sun_intensity: float = 30.0
    sky_color: tuple = (0.2, 0.4, 1.0)
    sky_intensity: float = 20.0
    shading: str = "reference"
    traversal: str = "auto"
    brute_max_tris: int = 512
    shade_fetch: str = "auto"
    alpha_test: bool = False
    alpha_rounds: int = 8
    ray_sort: str = "auto"
    russian_roulette: bool = False
    rr_start_bounce: int = 2
    soft_edges: float = 0.0
    tex_filter: str = "point"
    smooth_shading: bool = False
    cosine_weighted: bool = False
    nee_cosine: bool = False

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


@dataclass
class LightParams:
    """Lighting parameters as float32 tensors: sun direction angles,
    colour and intensity, sky colour and intensity. Any leaf may be a
    `requires_grad` tensor: the render differentiates through all six."""

    sun_azimuth: torch.Tensor
    sun_elevation: torch.Tensor
    sun_color: torch.Tensor
    sun_intensity: torch.Tensor
    sky_color: torch.Tensor
    sky_intensity: torch.Tensor

    @classmethod
    def from_settings(cls, s: RenderSettings, device="cpu") -> "LightParams":
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(f32(s.sun_azimuth), f32(s.sun_elevation),
                   f32(s.sun_color), f32(s.sun_intensity),
                   f32(s.sky_color), f32(s.sky_intensity))

    def to(self, device) -> "LightParams":
        return LightParams(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})

    def replace(self, **kw) -> "LightParams":
        return dataclasses.replace(self, **kw)

    def sun_position(self) -> torch.Tensor:
        """100 * (sin(az) * h, sin(el), cos(az) * h), h = 1 - sin(el):
        the reference's sun model, horizontal attenuation quirk kept."""
        az, el = self.sun_azimuth, self.sun_elevation
        horiz = 1.0 - torch.sin(el)
        return 100.0 * torch.stack(
            [torch.sin(az) * horiz, torch.sin(el), torch.cos(az) * horiz])
