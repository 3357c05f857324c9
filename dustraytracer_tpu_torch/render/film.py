"""Progressive accumulation film (port of render/film.py): a running sum
of post-processed samples and a sample count, averaged on read. On a
card, film_accumulate replays the sample as CUDA graphs where it can
(render/graphed.py) and renders it eagerly otherwise; the two add the
same bits.

With a mesh of N > 1 devices (parallel/mesh.py) film_init makes a
`TileFilm`: tile i holds the global pixel ids
`tile_pixel_ids(mesh, W H)[i]`, contiguous bands of rows, and mesh[i]
renders and accumulates it; a mesh of one device makes the plain Film
there. From then on the film's layout decides where a sample renders.
A frame issues device 0, then 1, 2, ...: each loads its inputs, replays
its tile's graphs (parallel/shard.py's tile_sample) and adds the sample to its
tile, and the host waits for no device in between. film_image gathers
the tiles' means onto mesh[0] by device-to-device copies, with no host
wait. The pixels equal the single-device film's bit for bit: the RNG is
keyed on the global pixel id."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from dustraytracer_tpu_torch.parallel.mesh import replicas, tile_bounds
# a module, not its names: parallel/shard.py imports render/ in turn
from dustraytracer_tpu_torch.parallel import shard
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings
from dustraytracer_tpu_torch.utils import profiling

_LIGHTS = {}  # device -> (the settings' light fields, LightParams there)


@dataclass
class Film:
    accum: torch.Tensor  # (H, W, 3) f32 running sum of samples
    frame: int           # number of accumulated samples


@dataclass
class TileFilm:
    """A film split over a mesh: tiles[i] is the (H W / N, 3) f32 running
    sum of tile i's pixels on mesh[i]."""
    tiles: list
    frame: int
    width: int
    height: int


def _devices(film: Film | TileFilm) -> list:
    """The devices a film renders on: its tiles', or the one of a Film."""
    if isinstance(film, TileFilm):
        return [t.device for t in film.tiles]
    return [film.accum.device]


def film_init(width: int, height: int, device="cpu", *,
              mesh=None) -> Film | TileFilm:
    """An empty film on `device`, or with a mesh of N > 1 devices an
    empty TileFilm (a mesh of one device is a Film there). Pixels that
    do not divide the mesh raise ValueError."""
    if mesh is not None and len(mesh) > 1:
        return TileFilm(
            tiles=[torch.zeros((b - a, 3), dtype=torch.float32, device=dev)
                   for (a, b), dev in zip(tile_bounds(width * height,
                                                      len(mesh)), mesh)],
            frame=0, width=width, height=height)
    if mesh is not None:
        device = mesh[0]
    return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device), frame=0)


def film_split(film: Film, mesh) -> Film | TileFilm:
    """A whole film laid out on the mesh as film_init lays out an empty
    one: its tiles, or with a mesh of one device the Film there (a
    checkpoint resumed over the mesh)."""
    if len(mesh) == 1:
        return Film(accum=film.accum.to(mesh[0]), frame=film.frame)
    h, w = film.accum.shape[:2]
    flat = film.accum.reshape(-1, 3)
    return TileFilm(tiles=[flat[a:b].to(dev) for (a, b), dev in
                           zip(tile_bounds(w * h, len(mesh)), mesh)],
                    frame=film.frame, width=w, height=h)


def film_add(film: Film, sample: torch.Tensor) -> Film:
    with profiling.span("drt.film_add"):
        return Film(accum=film.accum + sample, frame=film.frame + 1)


def _gather(film: TileFilm, divisor: float) -> torch.Tensor:
    """The tiles divided by `divisor`, each on its own device, then
    copied in order into one (H, W, 3) tensor on the first tile's
    device: device-to-device copies, no host wait."""
    with profiling.span("drt.tiles.gather"):
        first = film.tiles[0]
        out = torch.empty((film.width * film.height, 3), dtype=first.dtype,
                          device=first.device)
        at = 0
        for t in film.tiles:
            part = out[at:at + t.shape[0]]
            if t.device == out.device:
                torch.div(t, divisor, out=part)
            else:
                part.copy_(t / divisor)
            at += t.shape[0]
        if profiling.enabled():
            profiling.count("drt.tiles.gather_bytes",
                            (out.numel() - first.numel())
                            * out.element_size())
        return out.view(film.height, film.width, 3)


def film_image(film: Film | TileFilm) -> torch.Tensor:
    """Running mean of the accumulated samples, (H, W, 3); a TileFilm's
    on the device of its first tile."""
    with profiling.span("drt.film_image"):
        divisor = float(max(film.frame, 1))
        if isinstance(film, TileFilm):
            return _gather(film, divisor)
        return film.accum / divisor


def film_whole(film: Film | TileFilm) -> Film:
    """The film as one (H, W, 3) running sum (a TileFilm's gathered on
    its first tile's device), to save as a checkpoint."""
    if isinstance(film, TileFilm):
        return Film(accum=_gather(film, 1.0), frame=film.frame)
    return film


@functools.lru_cache(maxsize=None)
def _tile_spans(i: int) -> SimpleNamespace:
    """The names of tile i's span and device timer."""
    return SimpleNamespace(issue=f"drt.tile.c{i}",
                           device_ms=f"drt.tile.c{i}.device_ms")


@torch.inference_mode()
def film_accumulate(scene, camera, lights, film: Film | TileFilm,
                    count: int, *, width: int, height: int,
                    settings: RenderSettings) -> Film | TileFilm:
    """Accumulate `count` samples on the film's devices; sample j uses
    frame film.frame + j. Forward only: runs under inference_mode, so no
    autograd graph. On a card each sample replays the graphs of
    graphed.runner where graphed.eager_reason finds nothing against it;
    film_add consumes the graphs' output before the next replay. Scene,
    camera and lights are each one value or a list of one per device of
    the film (`replicate_scene`'s)."""
    devs = _devices(film)
    scenes, cams, lits = (replicas(x, devs) for x in (scene, camera, lights))
    if isinstance(film, TileFilm):
        return _accumulate_tiles(scenes, cams, lits, film, count, width=width,
                                 height=height, settings=settings)
    scene, camera, lights = scenes[0], cams[0], lits[0]
    start = film.frame
    run = graphed.runner(scene, camera, lights, width=width, height=height,
                         settings=settings) if count else None
    for j in range(count):
        if run is not None:
            sample = run.sample(camera, lights, start + j).view(height,
                                                                width, 3)
        else:
            sample = render_sample(scene, camera, lights, start + j,
                                   width=width, height=height,
                                   settings=settings)
        film = film_add(film, sample)
    return film


def _accumulate_tiles(scenes, cams, lits, film: TileFilm, count: int, *,
                      width: int, height: int,
                      settings: RenderSettings) -> TileFilm:
    """film_accumulate over the tiles: for each sample, the tiles'
    devices 0, 1, ... in turn load their inputs, replay their tile's
    graphs (or render it eagerly) and add it to their tile, with no host
    wait."""
    devs = _devices(film)
    bounds = tile_bounds(width * height, len(devs))
    tiles = list(film.tiles)
    with profiling.span("drt.tiles"):
        if profiling.enabled():
            profiling.count("drt.tiles.cards", len(devs))
        for j in range(count):
            for i, dev in enumerate(devs):
                names = _tile_spans(i)
                with profiling.span(names.issue), graphed.on_card(dev):
                    sample = shard.tile_sample(
                        scenes[i], cams[i], lits[i], film.frame + j,
                        bounds[i], width=width, height=height,
                        settings=settings, timer=names.device_ms)
                    with profiling.span("drt.film_add"), \
                            profiling.device_timer(names.device_ms, dev):
                        tiles[i] = tiles[i] + sample
    return TileFilm(tiles=tiles, frame=film.frame + count, width=width,
                    height=height)


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
                       film: Film | TileFilm | None = None,
                       mesh=None) -> Film | TileFilm:
    """Accumulate `spp` more samples, stopping at `settings.max_samples`
    in total (the reference's sample cap). One `drt.frame` span a call.
    Without a film, film_init's: on the scene's device, or over `mesh`
    (a TileFilm where it has N > 1 devices, tile i on mesh[i]); a given
    film renders where it lies. `scene` may be `replicate_scene`'s list,
    and `camera` and `lights` one value or a list of one per device (a
    list spares the per-call copies to each device). Pixels that do not
    divide the mesh raise ValueError."""
    with profiling.span("drt.frame"):
        if film is None:
            film = film_init(width, height, mesh=mesh or [
                (scene[0] if isinstance(scene, list) else scene).device])
        devs = _devices(film)
        cams = replicas(camera, devs)
        lits = (replicas(lights, devs) if lights is not None
                else [_settings_lights(settings, d) for d in devs])
        todo = min(film.frame + spp, settings.max_samples) - film.frame
        return film_accumulate(scene, cams, lits, film, max(todo, 0),
                               width=width, height=height, settings=settings)
