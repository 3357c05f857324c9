"""The bench's gradient step (bench.py:73-80) on a seeded synthetic
scene, and the measurements of it that PERF.md quotes, on one CUDA card.

    python -m dustraytracer_tpu_torch.tools.grad_bench [--out FILE.json]

The scene is a displaced lat-long sphere of LONxLAT segments over a
textured ground (`sphere_doc`; 128x64 is chip_smoke.py's 16,130-triangle
scene; `sphere_doc(pbr=True)` and `glass_panes_doc` are its PBR scenes).
Each section prints one JSON line; --out gets all of them:

  fetch    per sphere size: what shade_fetch="auto" picks there, and the
           512x512, 4-bounce fwd+bwd step with the kernel fetch and with
           the gather fetch, timed with CUDA events in alternating order
           (k g g k k g ...): median, min and max ms of the step, median
           forward and backward ms, rays/s, peak memory above the
           resident scene
  repeat   the 128x64 step twice on the same inputs: are the loss and
           the gradients equal bit for bit?
  profile  torch.profiler over one 128x64 step ("auto" fetch): device
           kernels and their summed time, the top kernels by device time,
           and the top aten/autograd ops by device and by host time
  gathers  the backward of one duplicated-index row gather at the step's
           shapes (262,144 rays; the 2-row material table, the padded
           triangle table), table[idx] against table.index_select(0, idx)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from functools import partial

import numpy as np
import torch

from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                       render_sample)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.gltf import (GltfDocument, GltfMaterial,
                                                GltfPrimitive)
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)

WIDTH = HEIGHT = 512
BOUNCES = 4
POSE = dict(position=(0.0, 1.5, 5.0), look_at=(0.0, 0.5, 0.0), vfov_deg=45.0)
LIGHT_KEYS = ("sun_azimuth", "sun_elevation", "sun_color", "sun_intensity",
              "sky_color", "sky_intensity")
GRAD_PARAMS = ("mat_albedo", "mat_emissive", *LIGHT_KEYS, "position",
               "tri_pos")
FETCHES = ("kernel", "gather")
SMOKE_SPHERE = (128, 64)
SMALL_SPHERE = (16, 8)  # 226 triangles: `auto` traverses it by brute force
# below, inside and above the 12,288-16,384 band of shade_fetch="auto"
SPHERES = ((64, 32), (96, 48), SMOKE_SPHERE, (192, 96), (256, 128))
REPS = 9


def quad_prim(corners, normal, material: int) -> GltfPrimitive:
    """Two triangles (0, 1, 2) and (0, 2, 3) over four corners, with uvs
    (0, 0), (1, 0), (1, 1), (0, 1) and one normal."""
    c = np.asarray(corners, np.float32)
    cuv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
    idx = [[0, 1, 2], [0, 2, 3]]
    return GltfPrimitive(
        positions=c[idx], uvs=cuv[idx],
        normals=np.broadcast_to(np.float32(normal), (2, 3, 3)).copy(),
        material=material)


def sphere_doc(n_lon: int = 128, n_lat: int = 64, seed: int = 0,
               cutout: bool = False, pbr: bool = False):
    """A displaced lat-long sphere (2·n_lon·(n_lat - 1) triangles: 16,128
    at 128x64) on a checker-textured ground quad, two materials, one
    256x256 u8 image; all from `seed`. With `cutout`, a 2-triangle quad
    with a checker alpha texture (texels of alpha 0 and 255, 8x8 cells
    of 64x64) stands between the bench pose's camera and the sphere: a
    third material and a second image. With `pbr` (not with `cutout`)
    the sphere is metallic 0.6, roughness 0.3, a glass pane (transmission
    0.85, ior 1.5, roughness 0.05) stands at the cutout quad's place and
    an emissive panel (3.5, 0.4, 0.4) with a black albedo behind the
    sphere: 16,134 triangles at 128x64."""
    if cutout and pbr:
        raise ValueError("sphere_doc: cutout and pbr put a quad in the "
                         "same place")
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
    sphere = GltfPrimitive(positions=np.asarray(tris, np.float32),
                           normals=np.asarray(nrms, np.float32),
                           uvs=np.asarray(tuv, np.float32), material=0)

    h = 50.0
    g = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32)
    guv = np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32)
    idx = [[0, 2, 1], [0, 3, 2]]
    ground = GltfPrimitive(
        positions=g[idx], uvs=guv[idx],
        normals=np.broadcast_to(np.float32([0, 1, 0]), (2, 3, 3)).copy(),
        material=1)

    yy, xx = np.mgrid[0:256, 0:256]
    check_px = ((yy // 32 + xx // 32) % 2).astype(np.uint8)
    img = np.empty((256, 256, 4), np.uint8)
    img[..., 0] = np.where(check_px, 150, 20)
    img[..., 1] = np.where(check_px, 140, 25)
    img[..., 2] = np.where(check_px, 120, 35)
    img[..., 3] = 255

    mats = [GltfMaterial(name="sphere",
                         base_color=np.float32([0.5, 0.2, 0.15]),
                         metallic=0.6 if pbr else 0.0,
                         roughness=0.3 if pbr else 1.0),
            GltfMaterial(name="ground", base_color=np.float32([1, 1, 1]),
                         base_color_texture=0)]
    meshes = [("sphere", [sphere]), ("ground", [ground])]
    images = [img]
    pane = [[-0.8, 0.3, 2.2], [0.8, 0.3, 2.2], [0.8, 1.9, 2.2],
            [-0.8, 1.9, 2.2]]
    if pbr:
        meshes.append(("pane", [quad_prim(pane, [0, 0, 1], 2)]))
        meshes.append(("panel", [quad_prim(
            [[-2.0, 0.0, -2.5], [2.0, 0.0, -2.5], [2.0, 3.0, -2.5],
             [-2.0, 3.0, -2.5]], [0, 0, 1], 3)]))
        mats.append(GltfMaterial(
            name="glass", base_color=np.float32([0.95, 0.98, 1.0]),
            roughness=0.05, transmission=0.85, ior=1.5))
        mats.append(GltfMaterial(
            name="panel", base_color=np.zeros(3, np.float32),
            emissive=np.float32([3.5, 0.4, 0.4])))
    if cutout:
        meshes.append(("cutout", [quad_prim(pane, [0, 0, 1], 2)]))
        yy, xx = np.mgrid[0:64, 0:64]
        cells = (yy // 8 + xx // 8) % 2
        cut = np.empty((64, 64, 4), np.uint8)
        cut[..., :3] = np.uint8([200, 180, 60])
        cut[..., 3] = np.where(cells, 255, 0)
        images.append(cut)
        mats.append(GltfMaterial(name="cutout",
                                 base_color=np.float32([1, 1, 1]),
                                 base_color_texture=1))
    return GltfDocument(meshes=meshes, materials=mats, images=images,
                        cameras=[])


def _square(center, size: float, axis: int, material: int) -> GltfPrimitive:
    """tests/util_scenes.py's make_quad for axis 1 (an XZ square facing
    +y) and 2 (an XY square facing +z)."""
    h = size / 2.0
    if axis == 2:
        corners = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    else:
        corners = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]])
    return quad_prim(corners + np.asarray(center, np.float32),
                     np.eye(3)[axis], material)


def glass_panes_doc():
    """tests/util_scenes.py's make_glass_panes_scene as a document of the
    port's glTF types (the card's machine has no JAX): a pane of glass
    (transmission 0.85, ior 1.5), tilted 20 degrees about x, before a red
    emissive wall over a grey ground. The scene of the committed golden
    tests/goldens/glass_panes_exact.npz."""
    pane = _square((0, 1.2, -0.8), 2.2, axis=2, material=0)
    pos = pane.positions.copy()
    c, s = np.cos(np.radians(20)), np.sin(np.radians(20))
    y = pos[..., 1] - 1.2
    z = pos[..., 2] + 0.8
    pos[..., 1] = 1.2 + c * y - s * z
    pos[..., 2] = -0.8 + s * y + c * z
    pane = GltfPrimitive(positions=pos, normals=pane.normals, uvs=pane.uvs,
                         material=0)
    return GltfDocument(
        meshes=[("pane", [pane]),
                ("wall", [_square((0, 1.5, -3), 6, axis=2, material=1)]),
                ("ground", [_square((0, 0, 0), 12, axis=1, material=2)])],
        materials=[
            GltfMaterial(name="glass",
                         base_color=np.float32([0.95, 0.98, 1.0]),
                         roughness=0.0, transmission=0.85, ior=1.5),
            GltfMaterial(name="wall", base_color=np.zeros(3, np.float32),
                         emissive=np.float32([3.5, 0.4, 0.4]),
                         roughness=1.0),
            GltfMaterial(name="ground",
                         base_color=np.float32([0.55, 0.55, 0.55]),
                         roughness=1.0)],
        images=[], cameras=[])


def grad_step(scene, camera, lights, settings, width: int, height: int, *,
              wrt=GRAD_PARAMS, events=None):
    """The bench's gradient step (bench.py:73-80): the mean of one sample,
    differentiated with respect to the leaves named in `wrt` (albedo,
    emissive, every LightParams field, the camera position and the
    vertices by default; the others are constants). The vertices go in
    through Scene.replace, so the cluster and BVH refit runs in the step.
    `events`, three CUDA events, are recorded before the forward, between
    forward and backward, and after the backward. Returns (loss,
    {name: gradient}) over `wrt`; a leaf the image does not reach
    (emissive in reference shading) gets a zero gradient."""
    leaves = {"mat_albedo": scene.mat_albedo,
              "mat_emissive": scene.mat_emissive,
              "tri_pos": scene.tri_pos, "position": camera.position,
              **{k: getattr(lights, k) for k in LIGHT_KEYS}}
    leaves = {k: v.detach().clone().requires_grad_(k in wrt)
              for k, v in leaves.items()}
    if events:
        events[0].record()
    sc = scene.replace(mat_albedo=leaves["mat_albedo"],
                       mat_emissive=leaves["mat_emissive"],
                       tri_pos=leaves["tri_pos"])
    img = render_sample(sc, camera.replace(position=leaves["position"]),
                        lights.replace(**{k: leaves[k] for k in LIGHT_KEYS}),
                        0, width=width, height=height, settings=settings)
    loss = img.mean()
    if events:
        events[1].record()
    loss.backward()
    if events:
        events[2].record()
    return loss.detach(), {
        k: leaves[k].grad if leaves[k].grad is not None
        else torch.zeros_like(leaves[k]) for k in wrt}


def median_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(fn, name: str | None = None, reps: int = 5) -> float:
    """Device time per call of fn(): the summed duration of the CUDA
    kernels it launched (those whose name contains `name`, if given)
    under torch.profiler, over `reps` calls after one warm-up. Unlike
    CUDA events around one call, it does not count host time the device
    spends waiting for the launch. With a `name`, each call launches the
    same number of such kernels, so a count that `reps` does not divide
    means the profiler lost events: the window is profiled again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and (name is None or name in e.name)]
        if us and (name is None or len(us) % reps == 0):
            return sum(us) / reps / 1e3
    raise RuntimeError(f"the profiler saw {len(us)} device kernels "
                       f"{name or ''} in {reps} calls of fn()")


def _settings() -> RenderSettings:
    return RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                          enable_gamma=False)


def _setup(n_lon: int, n_lat: int, dev):
    t0 = time.perf_counter()
    scene = build_scene(sphere_doc(n_lon, n_lat)).to(dev)
    build_s = time.perf_counter() - t0
    settings = _settings()
    camera = make_camera(**POSE, device=dev)
    lights = LightParams.from_settings(settings, device=dev)
    return scene, camera, lights, settings, build_s


def _timed(run):
    """(forward ms, backward ms) of one run(events=...) call."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    run(events=ev)
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def fetch_section(n_lon: int, n_lat: int, reps: int, dev) -> dict:
    scene, camera, lights, settings, build_s = _setup(n_lon, n_lat, dev)
    runs = {f: partial(grad_step, scene, camera, lights,
                       settings.replace(shade_fetch=f), WIDTH, HEIGHT)
            for f in FETCHES}
    res = {"section": "fetch", "sphere": f"{n_lon}x{n_lat}",
           "triangles": scene.n_tris,
           "padded_triangles": int(scene.tri_pos.shape[0]),
           "auto": _resolve_fetch(scene, settings),
           "build_seconds": build_s}
    mem = {}
    for f, run in runs.items():
        run()  # warm-up: allocator, packed tables
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        mem[f] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    times = {f: [] for f in FETCHES}
    for i in range(reps):
        for f in (FETCHES if i % 2 == 0 else FETCHES[::-1]):
            times[f].append(_timed(runs[f]))
    rays = WIDTH * HEIGHT * 2 * BOUNCES
    for f, ts in times.items():
        tot = [a + b for a, b in ts]
        med = float(np.median(tot))
        res[f] = {"ms_median": med, "ms_min": min(tot), "ms_max": max(tot),
                  "fwd_ms_median": float(np.median([a for a, _ in ts])),
                  "bwd_ms_median": float(np.median([b for _, b in ts])),
                  "rays_per_second": rays / (med / 1e3),
                  "step_mem_gib": mem[f]}
    return res


def repeat_section(dev) -> dict:
    scene, camera, lights, settings, _ = _setup(*SMOKE_SPHERE, dev)
    settings = settings.replace(shade_fetch="kernel")
    (l1, g1), (l2, g2) = (grad_step(scene, camera, lights, settings, WIDTH,
                                    HEIGHT) for _ in range(2))
    return {"section": "repeat", "sphere": "%dx%d" % SMOKE_SPHERE,
            "shade_fetch": "kernel", "loss_equal": bool(torch.equal(l1, l2)),
            "grads": {k: {"equal": bool(torch.equal(g1[k], g2[k])),
                          "max_abs_diff": float((g1[k] - g2[k]).abs().max()),
                          "max_abs": float(g1[k].abs().max())}
                      for k in GRAD_PARAMS}}


def _self_device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(avg, name, None)
        if val is not None:
            return float(val)
    return 0.0


def profile_section(dev, top: int = 15) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene, camera, lights, settings, _ = _setup(*SMOKE_SPHERE, dev)
    run = partial(grad_step, scene, camera, lights, settings, WIDTH, HEIGHT)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd_ms, bwd_ms = _timed(run)
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += e.time_range.elapsed_us() / 1e3
    ops = [a for a in prof.key_averages() if a.key not in by_kernel]

    def op_row(a):
        return {"op": a.key, "calls": a.count,
                "self_device_ms": _self_device_us(a) / 1e3,
                "self_host_ms": a.self_cpu_time_total / 1e3}

    return {"section": "profile", "sphere": "%dx%d" % SMOKE_SPHERE,
            "shade_fetch": _resolve_fetch(scene, settings),
            "profiled_fwd_ms": fwd_ms, "profiled_bwd_ms": bwd_ms,
            "device_kernels": len(kernels),
            "device_ms": sum(ms for _, ms in by_kernel.values()),
            "top_kernels": [
                {"kernel": k[:120], "calls": c, "device_ms": ms}
                for k, (c, ms) in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1][1])[:top]],
            "top_ops_device": [op_row(a) for a in sorted(
                ops, key=lambda a: -_self_device_us(a))[:top]],
            "top_ops_host": [op_row(a) for a in sorted(
                ops, key=lambda a: -a.self_cpu_time_total)[:top]]}


def gathers_section(n_tris: int, reps: int, dev) -> dict:
    n = WIDTH * HEIGHT
    rng = np.random.default_rng(0)
    mat_idx = (rng.uniform(size=n) < 0.5).astype(np.int64)
    # ~30% miss lanes clamp to triangle 0, the rest spread over the table
    tri_idx = np.where(rng.uniform(size=n) < 0.3, 0,
                       rng.integers(0, n_tris, n))
    cases = {"material_2x11": (2, 11, mat_idx),
             f"triangle_{n_tris}x19": (n_tris, 19, tri_idx)}
    res = {"section": "gathers", "rays": n}
    for name, (rows, cols, idx) in cases.items():
        tab = torch.rand(rows, cols, device=dev, requires_grad=True)
        idx = torch.from_numpy(idx).to(dev)
        up = torch.ones(n, cols, device=dev)
        grads = {}

        def run(how):
            tab.grad = None
            out = tab[idx] if how == "getitem" else tab.index_select(0, idx)
            out.backward(up)

        res[name] = {}
        for how in ("getitem", "index_select"):
            res[name][f"{how}_ms"] = median_ms(partial(run, how), reps)
            grads[how] = tab.grad.clone()
        res[name]["max_abs_grad_diff"] = float(
            (grads["getitem"] - grads["index_select"]).abs().max())
    return res


def build_parser():
    p = argparse.ArgumentParser(prog="dustraytracer_tpu_torch.tools."
                                "grad_bench")
    p.add_argument("--out", help="write every section as one JSON here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool "
                           "measures on a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = [{"section": "card", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}]
    print(json.dumps(out[0]), flush=True)

    def add(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for n_lon, n_lat in SPHERES:
        add(fetch_section(n_lon, n_lat, REPS, dev))
    add(repeat_section(dev))
    add(profile_section(dev))
    smoke = build_scene(sphere_doc(*SMOKE_SPHERE))
    add(gathers_section(int(smoke.tri_pos.shape[0]), REPS, dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
