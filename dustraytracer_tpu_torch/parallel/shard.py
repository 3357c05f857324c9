"""Tile-sharded rendering and the inverse-rendering train step over a
mesh, and the parameter overlay (port of parallel/shard.py).

The flat pixel ids are split along the mesh (`mesh.tile_sharding`); the
scene, camera and lights are replicated, one copy per device. Tile i
renders its global pixel ids on mesh[i] (the RNG is keyed on the global
id, so a tile's pixels equal the single-device render's), and the tiles
are concatenated in order on mesh[0]. In the train step the parameter
leaves live on mesh[0] and each tile renders from their `.to(mesh[i])`
copies: autograd carries every tile's gradient back to the one leaf and
sums it there, which is the JAX package's gradient all-reduce, so no
collective is added.
"""

from __future__ import annotations

import dataclasses

import torch

from dustraytracer_tpu_torch.parallel.mesh import (replicas,
                                                   tile_bounds,
                                                   tile_pixel_ids,
                                                   tile_sharding)
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.integrator import render_pixels
from dustraytracer_tpu_torch.scene.camera import Camera
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings
from dustraytracer_tpu_torch.utils import profiling


def apply_params(scene, camera, lights, params: dict):
    """Overlay optimizable parameters onto scene/camera/lights.

    Recognized keys: any Scene field (`mat_albedo`, `mat_emissive`,
    `mat_metallic`, `mat_roughness`, `mat_transmission`, `mat_ior`,
    `tri_pos`, a float `tex_stack`), `camera` (a whole Camera), `lights`
    (a whole LightParams). Scene fields go through Scene.replace, so a
    new `tri_pos` re-bakes the cluster tables and refits the BVH
    boxes."""
    scene_keys = {k: v for k, v in params.items()
                  if k not in ("camera", "lights")}
    if scene_keys:
        scene = scene.replace(**scene_keys)
    camera = params.get("camera", camera)
    lights = params.get("lights", lights)
    return scene, camera, lights


def map_params(fn, params: dict) -> dict:
    """`fn` applied to every tensor of a params dict, inside Camera and
    LightParams values too."""
    out = {}
    for k, v in params.items():
        if dataclasses.is_dataclass(v):
            out[k] = dataclasses.replace(
                v, **{f.name: fn(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
        else:
            out[k] = fn(v)
    return out


def tile_sample(scene, camera: Camera, lights: LightParams, frame: int,
                tile, *, width: int, height: int, settings: RenderSettings,
                timer: str | None = None) -> torch.Tensor:
    """Sample `frame` of the global pixel ids tile[0] ... tile[1] - 1 on
    the scene's device, (n, 3): the replay of its runner, whose static
    output the tile's next sample overwrites, or render_pixels where
    eager_reason finds something against it. Call it with that device
    current (graphed.on_card). `timer`: the name of a
    profiling.device_timer around each replayed stage, or around the
    whole eager sample."""
    run = graphed.runner(scene, camera, lights, width=width, height=height,
                         settings=settings, tile=tile)
    if run is not None:
        return run.sample(camera, lights, frame, timer=timer)
    with profiling.device_timer(timer, scene.device):
        ids = torch.arange(*tile, dtype=torch.int64, device=scene.device)
        return render_pixels(scene, camera, lights, frame, ids, width=width,
                             height=height, settings=settings)


def render_tiles(scene, camera, lights, frame_idx: int, *, mesh,
                 width: int, height: int, settings: RenderSettings,
                 tile0: int = 0, n_tiles: int | None = None) -> torch.Tensor:
    """One sample of `tile_pixel_ids`' tiles, tile tile0 + i rendered on
    mesh[i] by tile_sample (its card's graph runner where
    graphed.eager_reason finds nothing against it, else eagerly); their
    flat colours concatenated in order on mesh[0]. `scene` is a Scene or
    `replicate_scene`'s list."""
    scenes = replicas(scene, mesh)
    cams = replicas(camera, mesh)
    lits = replicas(lights, mesh)
    n_tiles = len(mesh) if n_tiles is None else n_tiles
    bounds = tile_bounds(width * height, n_tiles, tile0, len(mesh))
    parts = []
    for i, dev in enumerate(mesh):
        with graphed.on_card(dev):
            color = tile_sample(scenes[i], cams[i], lits[i], frame_idx,
                                bounds[i], width=width, height=height,
                                settings=settings)
            # a replay's output is overwritten by the runner's next
            # sample: the concatenation below copies it
            parts.append(color.to(mesh[0]))
    return torch.cat(parts)


def sharded_render_sample(scene, camera, lights, frame_idx: int, *, mesh,
                          width: int, height: int,
                          settings: RenderSettings) -> torch.Tensor:
    """One progressive sample with the pixels split over the mesh ->
    (H, W, 3) on mesh[0]. `scene` is a Scene or `replicate_scene`'s list.
    Pixels that do not divide the mesh raise ValueError."""
    return render_tiles(scene, camera, lights, frame_idx, mesh=mesh,
                        width=width, height=height,
                        settings=settings).reshape(height, width, 3)


def sharded_loss(params: dict, scene, camera, lights, target, frame_idx,
                 *, mesh, width: int, height: int,
                 settings: RenderSettings, norm: float | None = None):
    """sum over tiles of sum((color - target)**2) / norm on mesh[0], with
    the params overlaid on every replica (norm: the global pixel count by
    default). Differentiable in the params' leaves."""
    n = width * height
    norm = n if norm is None else norm
    scenes = replicas(scene, mesh)
    tgts = tile_sharding(mesh)(target.reshape(n, 3))
    total = None
    for i, ids in enumerate(tile_pixel_ids(mesh, n)):
        dev = mesh[i]
        # tensors, and whole Camera / LightParams values, by `.to`: the
        # identity on their own device, a differentiable copy elsewhere,
        # so every tile's gradient reaches the one leaf
        tile_params = {k: v.to(dev) for k, v in params.items()}
        sc, cam, li = apply_params(scenes[i], camera.to(dev),
                                   lights.to(dev), tile_params)
        color = render_pixels(sc, cam, li, frame_idx, ids, width=width,
                              height=height, settings=settings)
        part = (((color - tgts[i]) ** 2).sum() / norm).to(mesh[0])
        total = part if total is None else total + part
    return total


def sharded_train_step(params: dict, scene, camera, lights, target,
                       frame_idx: int, lr: float, *, mesh, width: int,
                       height: int, settings: RenderSettings):
    """One SGD step of inverse rendering, tile-sharded.

    Args:
      params: optimizable overlay (see `apply_params`) on mesh[0].
      target: (H, W, 3) target image, host-order rows.
      lr: learning rate.

    Returns (new_params, loss): new_params = p - lr * g with g the sum of
    every tile's gradient (a leaf the image does not reach keeps its
    value, as with JAX's zero gradient), loss the mean over the whole
    image of the squared error summed over channels. Both equal the
    single-device computation up to the order of the sums."""
    leaves = map_params(lambda t: t.detach().requires_grad_(True), params)
    loss = sharded_loss(leaves, scene, camera, lights, target, frame_idx,
                        mesh=mesh, width=width, height=height,
                        settings=settings)
    if loss.requires_grad:
        loss.backward()

    @torch.no_grad()
    def update(t):
        return t.detach() if t.grad is None else t - lr * t.grad

    return map_params(update, leaves), loss.detach()
