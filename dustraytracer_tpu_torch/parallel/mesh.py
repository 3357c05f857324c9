"""Device meshes and scene replication for tile-parallel rendering (port
of parallel/mesh.py).

A mesh here is an ordered list of `torch.device`s along one axis,
`TILE_AXIS`: tile i of the flat pixel ids renders on mesh[i], and every
device holds the whole scene. A list may name one device more than once:
the CPU tests stand in for the JAX package's 8 virtual host devices with
`[torch.device("cpu")] * 8`, and two tiles can share one card. In a
multi-process job each process holds the mesh of its own devices, and
tile i of process r is global tile `r * len(mesh) + i`.
"""

from __future__ import annotations

import torch

TILE_AXIS = "tiles"


def _canonical(device) -> torch.device:
    """`device` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices() -> list:
    """This process's cards, cuda:0 ... cuda:k-1; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card "
                           "for the mesh (pass the CPU devices explicitly)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_render_mesh(n_devices: int | None = None, devices=None) -> list:
    """The first `n_devices` of `devices` (default: every local card), as
    the mesh's ordered device list. Asking for more devices than the
    list holds raises ValueError."""
    devices = [_canonical(d) for d in (local_devices() if devices is None
                                       else devices)]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} available: {devices}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def multihost_mesh(devices=None) -> list:
    """This process's part of a multi-process mesh: its local cards, or
    `devices` if given."""
    return make_render_mesh(devices=devices)


def replicate_scene(scene, mesh) -> list:
    """One copy of `scene` per mesh entry, each on its entry's device.
    Entries naming one device share one copy, and the scene itself
    serves its own device, so no device holds two copies and no packed
    kernel table is rebuilt. Works for a Scene, a Camera or LightParams
    (anything with `.to(device)`)."""
    own = _canonical(scene.device) if hasattr(scene, "device") else None
    copies = {}
    out = []
    for dev in mesh:
        dev = _canonical(dev)
        if dev not in copies:
            copies[dev] = scene if dev == own else scene.to(dev)
        out.append(copies[dev])
    return out


def replicas(x, mesh) -> list:
    """`x` (a Scene, Camera or LightParams) as one copy per mesh entry:
    the list `replicate_scene` made, or a single `x` replicated now."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh):
            raise ValueError(f"{len(x)} replicas for a mesh of {len(mesh)} "
                             f"devices")
        return list(x)
    return replicate_scene(x, mesh)


def tile_bounds(n: int, n_tiles: int, tile0: int = 0,
                count: int | None = None) -> list:
    """(start, stop) of the global pixel ids of tiles tile0 ... tile0 +
    count - 1 (default: every tile) of the n pixels split in `n_tiles`
    contiguous tiles. Pixels that do not divide the tiles raise
    ValueError."""
    if n % n_tiles:
        raise ValueError(f"pixels ({n}) must divide mesh size ({n_tiles})")
    step = n // n_tiles
    count = n_tiles - tile0 if count is None else count
    return [((tile0 + i) * step, (tile0 + i + 1) * step)
            for i in range(count)]


def tile_pixel_ids(mesh, n: int, tile0: int = 0,
                   n_tiles: int | None = None) -> list:
    """Global pixel ids of tiles tile0 ... tile0 + len(mesh) - 1 of the n
    pixels split in `n_tiles` (default len(mesh)) contiguous tiles, tile
    tile0 + i made on mesh[i]. Pixels that do not divide the tiles raise
    ValueError."""
    n_tiles = len(mesh) if n_tiles is None else n_tiles
    return [torch.arange(a, b, dtype=torch.int64, device=dev)
            for (a, b), dev in zip(tile_bounds(n, n_tiles, tile0, len(mesh)),
                                   mesh)]


def tile_sharding(mesh):
    """The split of a flat per-pixel array over the mesh: returns
    `split(x)`, the list of tiles `x[i*n/N:(i+1)*n/N]`, tile i moved to
    mesh[i] (n = len(x), N = len(mesh); n must divide N)."""
    def split(x: torch.Tensor) -> list:
        n, n_tiles = x.shape[0], len(mesh)
        if n % n_tiles:
            raise ValueError(f"pixels ({n}) must divide mesh size "
                             f"({n_tiles})")
        step = n // n_tiles
        return [x[i * step:(i + 1) * step].to(dev)
                for i, dev in enumerate(mesh)]

    return split
