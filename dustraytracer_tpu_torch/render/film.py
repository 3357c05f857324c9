"""Progressive accumulation film (port of render/film.py): a running sum
of post-processed samples and a sample count, averaged on read. On a
card, film_accumulate replays the sample as CUDA graphs where it can
(render/graphed.py) and renders it eagerly otherwise; the two add the
same bits."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings
from dustraytracer_tpu_torch.utils import profiling

_LIGHTS = {}  # device -> (the settings' light fields, LightParams there)


@dataclass
class Film:
    accum: torch.Tensor  # (H, W, 3) f32 running sum of samples
    frame: int           # number of accumulated samples


def film_init(width: int, height: int, device="cpu") -> Film:
    return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device), frame=0)


def film_add(film: Film, sample: torch.Tensor) -> Film:
    with profiling.span("drt.film_add"):
        return Film(accum=film.accum + sample, frame=film.frame + 1)


def film_image(film: Film) -> torch.Tensor:
    """Running mean of the accumulated samples."""
    with profiling.span("drt.film_image"):
        return film.accum / float(max(film.frame, 1))


@torch.inference_mode()
def film_accumulate(scene, camera, lights, film: Film, count: int, *,
                    width: int, height: int,
                    settings: RenderSettings) -> Film:
    """Accumulate `count` samples; sample j uses frame film.frame + j.
    Forward only: runs under inference_mode, so no autograd graph. On a
    card each sample replays the graphs of graphed.runner where
    graphed.eager_reason finds nothing against it; film_add consumes the
    graphs' output before the next replay."""
    start = film.frame
    run = graphed.runner(scene, camera, lights, width=width, height=height,
                         settings=settings) if count else None
    for j in range(count):
        if run is not None:
            sample = run.sample(camera, lights, start + j)
        else:
            sample = render_sample(scene, camera, lights, start + j,
                                   width=width, height=height,
                                   settings=settings)
        film = film_add(film, sample)
    return film


def _settings_lights(settings: RenderSettings, dev) -> LightParams:
    """LightParams.from_settings(settings) on `dev`, built once per light
    fields and device (a copy from the host is a host wait)."""
    key = (settings.sun_azimuth, settings.sun_elevation, settings.sun_color,
           settings.sun_intensity, settings.sky_color,
           settings.sky_intensity)
    hit = _LIGHTS.get(dev)
    if hit is None or hit[0] != key:
        hit = _LIGHTS[dev] = (key,
                              LightParams.from_settings(settings).to(dev))
    return hit[1]


def render_progressive(scene, camera, settings: RenderSettings, *,
                       width: int, height: int, spp: int,
                       lights: LightParams | None = None,
                       film: Film | None = None) -> Film:
    """Accumulate `spp` more samples on the scene's device, stopping at
    `settings.max_samples` in total (the reference's sample cap). One
    `drt.frame` span a call."""
    with profiling.span("drt.frame"):
        dev = scene.device
        camera = camera.to(dev)
        lights = (lights.to(dev) if lights is not None
                  else _settings_lights(settings, dev))
        film = film or film_init(width, height, device=dev)
        todo = min(film.frame + spp, settings.max_samples) - film.frame
        return film_accumulate(scene, camera, lights, film, max(todo, 0),
                               width=width, height=height, settings=settings)
