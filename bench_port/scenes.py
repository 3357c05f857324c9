"""Scene generators, by the name a configuration's "scene.generator"
gives: the built-in `sphere`, else the `make(seed, **args)` of
`<data>/generators/<name>.py`, so that a deployment with a scene of its
own brings it as a new file. Each returns a triangle soup made from the
seed, as numpy arrays that the program (through `to_document`) and the
plain reference both take:

    positions (T, 3, 3) f32, normals (T, 3, 3) f32, uvs (T, 3, 2) f32,
    material (T,) i32, materials [{"name", "base_color", "texture"}],
    images [(H, W, 4) u8], meshes [(name, first, count)]

`sphere` is a frozen copy of the port's `tools/grad_bench.py::sphere_doc`
(its reference shading variant): a displaced lat-long sphere of
2 n_lon (n_lat - 1) triangles on a checker-textured ground quad, two
materials and one 256x256 u8 image. With seed 0 it is the tool's scene;
the benchmark draws the displacement from the run's seed."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np


def sphere(n_lon: int, n_lat: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, np.pi, n_lat + 1)[:, None]
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)[None, :]
    dirs = np.stack(np.broadcast_arrays(np.sin(lat) * np.cos(lon),
                                        np.cos(lat),
                                        np.sin(lat) * np.sin(lon)), axis=-1)
    freq = rng.normal(0.0, 4.0, (8, 3))
    phase = rng.uniform(0.0, 2.0 * np.pi, 8)
    amp = rng.uniform(0.01, 0.03, 8)
    radius = 1.0 + (amp * np.sin(dirs @ freq.T + phase)).sum(-1)
    verts = np.array([0.0, 1.0, 0.0]) + dirs * radius[..., None]
    uvs = np.stack(np.broadcast_arrays(lon / (2 * np.pi), lat / np.pi),
                   axis=-1)

    tris, nrms, tuv = [], [], []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = (i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)
            for tri in ((a, b, c), (a, c, d)):
                if (tri == (a, c, d) and i == 0) or \
                        (tri == (a, b, c) and i == n_lat - 1):
                    continue  # degenerate at the poles
                tris.append([verts[p] for p in tri])
                nrms.append([dirs[p] for p in tri])
                tuv.append([uvs[p] for p in tri])

    h = 50.0
    g = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32)
    guv = np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32)
    idx = [[0, 2, 1], [0, 3, 2]]

    yy, xx = np.mgrid[0:256, 0:256]
    check = ((yy // 32 + xx // 32) % 2).astype(np.uint8)
    img = np.empty((256, 256, 4), np.uint8)
    img[..., 0] = np.where(check, 150, 20)
    img[..., 1] = np.where(check, 140, 25)
    img[..., 2] = np.where(check, 120, 35)
    img[..., 3] = 255

    n_s = len(tris)
    return {
        "positions": np.concatenate([np.asarray(tris, np.float32),
                                     g[idx]]),
        "normals": np.concatenate([
            np.asarray(nrms, np.float32),
            np.broadcast_to(np.float32([0, 1, 0]), (2, 3, 3))]),
        "uvs": np.concatenate([np.asarray(tuv, np.float32), guv[idx]]),
        "material": np.concatenate([np.zeros(n_s, np.int32),
                                    np.ones(2, np.int32)]),
        "materials": [
            {"name": "sphere", "base_color": [0.5, 0.2, 0.15],
             "texture": -1},
            {"name": "ground", "base_color": [1.0, 1.0, 1.0], "texture": 0}],
        "images": [img],
        "meshes": [("sphere", 0, n_s), ("ground", n_s, 2)],
    }


GENERATORS = {"sphere": sphere}


def from_file(data: Path, folder: str, name: str, attr: str):
    """`attr` of `<data>/<folder>/<name>.py`, loaded by path: a loop, a
    scene generator or a metric reader that a cell brings as a file."""
    path = Path(data) / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {folder} entry {name!r}: {path} is not a file")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def make(spec: dict, seed: int, data: Path) -> dict:
    """The soup of a configuration's "scene" entry; `data` is the
    benchmark's data folder."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    name = spec["generator"]
    gen = GENERATORS.get(name) or from_file(data, "generators", name, "make")
    return gen(seed=seed % 2 ** 32, **args)


def to_document(soup: dict):
    """The soup as the program's glTF document type."""
    from dustraytracer_tpu_torch.scene.gltf import (GltfDocument,
                                                    GltfMaterial,
                                                    GltfPrimitive)

    meshes = []
    for name, first, count in soup["meshes"]:
        sl = slice(first, first + count)
        mat = int(soup["material"][first])
        meshes.append((name, [GltfPrimitive(
            positions=soup["positions"][sl].copy(),
            normals=soup["normals"][sl].copy(),
            uvs=soup["uvs"][sl].copy(), material=mat)]))
    mats = [GltfMaterial(name=m["name"],
                         base_color=np.float32(m["base_color"]),
                         base_color_texture=int(m["texture"]))
            for m in soup["materials"]]
    return GltfDocument(meshes=meshes, materials=mats,
                        images=list(soup["images"]), cameras=[])
