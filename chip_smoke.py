"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's forward render path (dustraytracer_tpu_torch) on a
synthetic scene the size of a dense bundled scene, generated from a seed:

  0. card      nvidia-smi name and power limit; fails without CUDA
  1. build     nvcc build of csrc/traverse_sweep.cu for sm_90a
  2. scene     a displaced lat-long sphere (128 x 64 segments) over a
               textured ground, built by the port's build_scene
  3. kernel    the traversal kernel against its PyTorch twin on the card:
               512x512 sorted primary rays, a bounce wave with 10% parked
               lanes, and any-hit shadow rays; equal hit ids, visits and
               occlusion, t within rtol 1e-4; median times of both
  4. slice     render_progressive at 512x512, 4 bounces, 8 spp; the kernel
               must launch exactly 2 x bounces x spp times
  5. card/cpu  the same render at 96x96, 1 spp, on the card (kernel) and
               on the CPU (twin), within the render tolerance of the tests
  6. cli       the render CLI in a subprocess on a .glb of the scene

Each phase prints one JSON line; then a {"kernels": [...]} line, the
nvidia-smi line and, last, {"ok": true, "device": {...}}. Any failure
raises and exits non-zero before the last line.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

WIDTH = HEIGHT = 512
BOUNCES = 4
SPP = 8
POSE = dict(position=(0.0, 1.5, 5.0), look_at=(0.0, 0.5, 0.0), vfov_deg=45.0)
T_RTOL = 1e-4
PIX_TOL = 2e-3       # tests/test_reference_parity.py golden bound
PIX_FRAC = 0.999     # share of pixels that must be within PIX_TOL
MIN_PSNR = 50.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def make_doc(seed: int = 0):
    """Displaced sphere (16,128 triangles) on a checker-textured ground
    quad, two materials, one 256x256 u8 image; all from `seed`."""
    from dustraytracer_tpu_torch.scene.gltf import (GltfDocument,
                                                    GltfMaterial,
                                                    GltfPrimitive)

    rng = np.random.default_rng(seed)
    n_lon, n_lat = 128, 64
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
                         base_color=np.float32([0.5, 0.2, 0.15])),
            GltfMaterial(name="ground", base_color=np.float32([1, 1, 1]),
                         base_color_texture=0)]
    return GltfDocument(meshes=[("sphere", [sphere]), ("ground", [ground])],
                        materials=mats, images=[img], cameras=[])


def write_glb(path: Path, doc) -> None:
    """The document's geometry and material factors as a .glb (no images):
    one mesh per primitive, u32 indices."""
    blob, views, accessors, meshes, nodes = b"", [], [], [], []

    def add(arr, target_type, comp, count):
        nonlocal blob
        data = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob += data + b"\0" * ((-len(data)) % 4)
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": count, "type": target_type}
        if target_type == "VEC3":
            flat = np.asarray(arr).reshape(-1, 3)
            acc["min"] = flat.min(0).tolist()
            acc["max"] = flat.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for mi, (name, prims) in enumerate(doc.meshes):
        gprims = []
        for p in prims:
            nv = p.positions.shape[0] * 3
            attrs = {"POSITION": add(p.positions.reshape(-1, 3), "VEC3",
                                     5126, nv),
                     "NORMAL": add(p.normals.reshape(-1, 3), "VEC3",
                                   5126, nv),
                     "TEXCOORD_0": add(p.uvs.reshape(-1, 2), "VEC2",
                                       5126, nv)}
            ind = add(np.arange(nv, dtype=np.uint32), "SCALAR", 5125, nv)
            gprims.append({"attributes": attrs, "indices": ind,
                           "material": p.material})
        meshes.append({"name": name, "primitives": gprims})
        nodes.append({"mesh": mi})
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
        "meshes": meshes,
        "materials": [{"name": m.name, "pbrMetallicRoughness": {
            "baseColorFactor": [*map(float, m.base_color), 1.0],
            "metallicFactor": 0.0}} for m in doc.materials],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)


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


def compare_images(a: torch.Tensor, b: torch.Tensor) -> dict:
    a = a.detach().cpu().numpy()
    b = b.detach().cpu().numpy()
    diff = np.abs(a - b).max(axis=-1)
    mse = float(np.mean((a - b) ** 2))
    return {"max_abs": float(diff.max()),
            "pixels_over_tol": int((diff > PIX_TOL).sum()),
            "frac_within": float((diff <= PIX_TOL).mean()),
            "psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from dustraytracer_tpu_torch.ops import traverse_sweep as ts
    from dustraytracer_tpu_torch.ops.cuda_build import ARCH, load_library
    from dustraytracer_tpu_torch.ops.rng import seed_pixels
    from dustraytracer_tpu_torch.render.film import (film_image,
                                                     render_progressive)
    from dustraytracer_tpu_torch.render.integrator import (render_sample,
                                                           ray_sort_key)
    from dustraytracer_tpu_torch.scene.camera import (generate_rays,
                                                      make_camera)
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, device_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build
    rec = load_library("traverse_sweep")
    ts.load_kernel()
    ptxas = [ln.strip() for ln in rec["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=rec["seconds"], built=rec["built"], arch=ARCH,
         flags=rec["log"].splitlines()[0] if rec["log"] else "",
         ptxas=ptxas)

    # 2. scene
    t0 = time.perf_counter()
    scene_cpu = build_scene(make_doc(0))
    build_s = time.perf_counter() - t0
    scene = scene_cpu.to(dev)
    cb = scene.cluster
    emit("scene", triangles=scene.n_tris, bvh_nodes=scene.n_nodes,
         clusters=cb.n_clusters, cluster_nodes=cb.n_nodes, k=cb.k,
         build_seconds=build_s)

    # 3. kernel vs twin on the card
    settings = RenderSettings(bounces=BOUNCES)
    lights = LightParams.from_settings(settings, device=dev)
    camera = make_camera(**POSE, device=dev)
    ids = torch.arange(WIDTH * HEIGHT, device=dev)
    _, o, d = generate_rays(camera, WIDTH, HEIGHT, seed_pixels(ids, 0),
                            pixel_ids=ids)
    lo, hi = scene.node_min[0], scene.node_max[0]

    def sort(o, d):
        perm = torch.argsort(ray_sort_key(lo, hi, o, d), stable=True)
        return o[perm].contiguous(), d[perm].contiguous()

    o, d = sort(o, d)
    rng = np.random.default_rng(1)
    n = o.shape[0]
    prim = ts.traverse_cluster_sweep(cb, o, d)
    hit = prim["hit_idx"] >= 0
    t_hit = torch.where(hit, prim["t"], 0.0)
    hit_pt = o + d * (t_hit * 0.999)[:, None]
    bd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    bd = bd / torch.linalg.vector_norm(bd, dim=-1, keepdim=True)
    parked = torch.from_numpy(rng.uniform(size=n) < 0.1).to(dev)
    bo, bd = sort(torch.where(parked[:, None], 3.0e37, hit_pt), bd)
    jit = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    jit = jit / torch.linalg.vector_norm(jit, dim=-1, keepdim=True)
    sd = (lights.sun_position()[None, :] + jit * 1.5).contiguous()
    so, sd = sort(torch.where(hit[:, None], hit_pt, 3.0e37), sd)

    waves = {"primary": (o, d, False), "bounce": (bo, bd, False),
             "shadow_anyhit": (so, sd, True)}
    results, max_err = {}, 0.0
    for wave, (wo, wd, ah) in waves.items():
        rk = ts.traverse_cluster_sweep(cb, wo, wd, anyhit=ah)
        rt = ts.traverse_cluster_sweep_reference(cb, wo, wd, anyhit=ah)
        torch.cuda.synchronize()
        hk, ht = rk["hit_idx"], rt["hit_idx"]
        if ah:
            check(torch.equal(hk >= 0, ht >= 0), f"{wave}: occlusion differs")
        else:
            check(torch.equal(hk, ht), f"{wave}: hit_idx differs in "
                  f"{int((hk != ht).sum())} rays")
        check(torch.equal(rk["visits"], rt["visits"]),
              f"{wave}: visits differ")
        both = (hk >= 0) & (ht >= 0)
        err = float((rk["t"][both] - rt["t"][both]).abs().max()) \
            if bool(both.any()) else 0.0
        check(bool(torch.allclose(rk["t"][both], rt["t"][both],
                                  rtol=T_RTOL, atol=0.0)),
              f"{wave}: t beyond rtol {T_RTOL}")
        max_err = max(max_err, err)
        k_ms = median_ms(lambda: ts.traverse_cluster_sweep(cb, wo, wd,
                                                           anyhit=ah))
        p_ms = median_ms(lambda: ts.traverse_cluster_sweep_reference(
            cb, wo, wd, anyhit=ah))
        results[wave] = {"kernel_ms": k_ms, "twin_ms": p_ms,
                         "kernel_mrays_s": n / k_ms / 1e3,
                         "twin_mrays_s": n / p_ms / 1e3}
        emit("kernel_vs_twin", wave=wave, rays=n, anyhit=ah,
             hits=int((hk >= 0).sum()), max_abs_t_err=err,
             mean_visits=float(rk["visits"].float().mean()), **results[wave])

    # 4. the slice, through the user entry point
    render_progressive(scene, camera, settings, width=WIDTH, height=HEIGHT,
                       spp=1)  # warm-up: allocator, packed tables
    torch.cuda.synchronize()
    ts.LAUNCHES = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    film = render_progressive(scene, camera, settings, width=WIDTH,
                              height=HEIGHT, spp=SPP)
    e1.record()
    torch.cuda.synchronize()
    launches = ts.LAUNCHES
    ms = e0.elapsed_time(e1)
    img = film_image(film)
    check(launches == 2 * BOUNCES * SPP,
          f"kernel launched {launches} times, expected {2 * BOUNCES * SPP}")
    check(bool(torch.isfinite(img).all()), "render has non-finite pixels")
    mean = float(img.mean())
    check(0.0 < mean <= 1.0, f"render mean {mean} outside (0, 1]")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"shape {img.shape}")
    emit("slice", size=[WIDTH, HEIGHT], bounces=BOUNCES, spp=SPP,
         launches=launches, mean=mean, ms_per_sample=ms / SPP,
         mrays_per_second=WIDTH * HEIGHT * SPP * 2 * BOUNCES / (ms / 1e3)
         / 1e6)

    # 5. card vs CPU at 96x96, 1 spp
    s1 = RenderSettings(bounces=BOUNCES)
    img_gpu = render_sample(scene, camera, lights, 0, width=96, height=96,
                            settings=s1)
    img_cpu = render_sample(scene_cpu, camera.to("cpu"), lights.to("cpu"), 0,
                            width=96, height=96, settings=s1)
    cmp = compare_images(img_gpu, img_cpu)
    check(cmp["frac_within"] >= PIX_FRAC and cmp["psnr_db"] > MIN_PSNR,
          f"card vs cpu render: {cmp}")
    emit("card_vs_cpu", size=[96, 96], spp=1, **cmp)

    # 6. the CLI
    with tempfile.TemporaryDirectory() as tmp:
        glb = Path(tmp) / "smoke_scene.glb"
        png = Path(tmp) / "smoke.png"
        write_glb(glb, make_doc(0))
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli",
             "render", "--scene", str(glb), "--size", "256x256", "--spp", "4",
             "--bounces", "4", "--camera-pos", "0,1.5,5",
             "--look-at", "0,0.5,0", "--vfov", "45", "--out", str(png)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"CLI rc {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        metrics = json.loads(proc.stdout)
        check(png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "CLI wrote no PNG")
        check(metrics.get("mrays_per_second") is not None,
              "CLI metrics lack mrays_per_second")
    emit("cli", **{k: metrics[k] for k in ("triangles", "size", "spp",
                                           "bounces", "render_seconds",
                                           "mrays_per_second")})

    prim_t = results["primary"]
    print(json.dumps({"kernels": [{
        "name": "traverse_sweep", "route": "cuda",
        "source": "dustraytracer_tpu_torch/csrc/traverse_sweep.cu",
        "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:98",
        "launches": launches, "max_abs_err": max_err,
        "ms": prim_t["kernel_ms"], "plain_ms": prim_t["twin_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
