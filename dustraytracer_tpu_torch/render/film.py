"""Progressive accumulation film (port of render/film.py): a running sum
of post-processed samples and a sample count, averaged on read."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings


@dataclass
class Film:
    accum: torch.Tensor  # (H, W, 3) f32 running sum of samples
    frame: int           # number of accumulated samples


def film_init(width: int, height: int, device="cpu") -> Film:
    return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device), frame=0)


def film_add(film: Film, sample: torch.Tensor) -> Film:
    return Film(accum=film.accum + sample, frame=film.frame + 1)


def film_image(film: Film) -> torch.Tensor:
    """Running mean of the accumulated samples."""
    return film.accum / float(max(film.frame, 1))


@torch.inference_mode()
def film_accumulate(scene, camera, lights, film: Film, count: int, *,
                    width: int, height: int,
                    settings: RenderSettings) -> Film:
    """Accumulate `count` samples; sample j uses frame film.frame + j.
    Forward only: runs under inference_mode, so no autograd graph."""
    start = film.frame
    for j in range(count):
        sample = render_sample(scene, camera, lights, start + j,
                               width=width, height=height, settings=settings)
        film = film_add(film, sample)
    return film


def render_progressive(scene, camera, settings: RenderSettings, *,
                       width: int, height: int, spp: int,
                       lights: LightParams | None = None,
                       film: Film | None = None) -> Film:
    """Accumulate `spp` more samples on the scene's device, stopping at
    `settings.max_samples` in total (the reference's sample cap)."""
    dev = scene.device
    camera = camera.to(dev)
    lights = (lights or LightParams.from_settings(settings)).to(dev)
    film = film or film_init(width, height, device=dev)
    todo = min(film.frame + spp, settings.max_samples) - film.frame
    return film_accumulate(scene, camera, lights, film, max(todo, 0),
                           width=width, height=height, settings=settings)
