"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's forward render and gradient paths
(dustraytracer_tpu_torch) on a synthetic scene the size of a dense
bundled scene, generated from a seed:

  0. card      nvidia-smi name and power limit; fails without CUDA
  1. build     nvcc build of csrc/traverse_sweep.cu for sm_90a
  2. scene     a displaced lat-long sphere (128 x 64 segments) over a
               textured ground (tools/grad_bench.py::sphere_doc), built
               by the port's build_scene
  3. kernel    the traversal kernel against its PyTorch twin on the card:
               512x512 sorted primary rays, a bounce wave with 10% parked
               lanes, and any-hit shadow rays; equal hit ids, visits and
               occlusion, t within rtol 1e-4; median times of both
  3e. emit     the kernel's emit_attrs mode (the in-kernel shading fetch)
               on the primary and bounce waves: against the twin, hit ids,
               visits and materials equal and t, u, v, uv, face normal bit
               for bit; against the kernel without emission, hit ids, t
               and visits identical; median times of both modes and twin
  4. slice     render_progressive at 512x512, 4 bounces, 8 spp; the shade
               fetch resolves to "kernel", so each bounce launches the
               kernel once with emission (closest) and once without
               (shadow any-hit): bounces x spp launches of each
  5. card/cpu  the same render at 96x96, 1 spp, on the card (kernel) and
               on the CPU (twin), within the render tolerance of the tests
  6. cli       the render CLI in a subprocess on a .glb of the scene
  7. grad      the bench's gradient step at 512x512, 4 bounces: mean image,
               backward to albedo, emissive, every light field, camera
               position and vertices (Scene.replace refits in the step);
               finite and nonzero gradients, 2 x bounces launches, ms per
               fwd+bwd step, rays/s, peak memory; the same step with the
               gather fetch; the camera position alone (kernel fetch)
               agrees with the full step
  8. grad card/cpu  the same step at 48x48, 2 bounces, on the card
               (kernel) and on the CPU (twin): loss within 1e-5 relative,
               gradients within atol 2e-4 max|g|, rtol 2e-3
  9. optimize  the optimizer CLI's self-test in a subprocess: 30 Adam
               steps on albedo and lights at 128x128, 2 bounces; the loss
               must fall and a checkpoint must be written

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
T_RTOL = 1e-4
PIX_TOL = 2e-3       # tests/test_reference_parity.py golden bound
PIX_FRAC = 0.999     # share of pixels that must be within PIX_TOL
MIN_PSNR = 50.0
EMIT_KEYS = ("u", "v", "uv", "face_nrm", "mat")
CPU_GRAD_SIZE = 48
CPU_GRAD_BOUNCES = 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3     # tests/test_sweep.py:277; atol is 2e-4 * max|g|
OPT_STEPS = 30
OPT_BOUNCES = 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def reset_launches(ts) -> None:
    ts.LAUNCHES = 0
    ts.EMIT_LAUNCHES = 0


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
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           render_sample,
                                                           ray_sort_key)
    from dustraytracer_tpu_torch.scene.camera import (generate_rays,
                                                      make_camera)
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.grad_bench import (GRAD_PARAMS, POSE,
                                                          grad_step,
                                                          median_ms,
                                                          sphere_doc)

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
    scene_cpu = build_scene(sphere_doc())
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

    # 3e. the emit_attrs mode against the twin and the plain kernel
    emit_res, emit_err = {}, 0.0
    for wave in ("primary", "bounce"):
        wo, wd, _ = waves[wave]
        rk = ts.traverse_cluster_sweep(cb, wo, wd, emit_attrs=True)
        rt = ts.traverse_cluster_sweep_reference(cb, wo, wd, emit_attrs=True)
        rp = ts.traverse_cluster_sweep(cb, wo, wd)
        torch.cuda.synchronize()
        for key in ("hit_idx", "visits", "mat"):
            check(torch.equal(rk[key], rt[key]),
                  f"emit {wave}: {key} differs from the twin in "
                  f"{int((rk[key] != rt[key]).sum())} rays")
        errs = {}
        for key in ("t", "u", "v", "uv", "face_nrm"):
            diff = (rk[key] - rt[key]).abs()
            errs[key] = float(diff.max())
            check(torch.equal(rk[key], rt[key]),
                  f"emit {wave}: {key} not bit for bit with the twin "
                  f"(max abs {errs[key]})")
        for key in ("hit_idx", "t", "visits"):
            check(torch.equal(rk[key], rp[key]),
                  f"emit {wave}: {key} changes with emission")
        emit_err = max(emit_err, *errs.values())
        emit_res[wave] = {
            "kernel_emit_ms": median_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd, emit_attrs=True)),
            "kernel_plain_ms": median_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd)),
            "twin_emit_ms": median_ms(
                lambda: ts.traverse_cluster_sweep_reference(
                    cb, wo, wd, emit_attrs=True))}
        emit("kernel_emit_vs_twin", wave=wave, rays=n,
             hits=int((rk["hit_idx"] >= 0).sum()), max_abs_err=errs,
             **emit_res[wave])

    # 4. the slice, through the user entry point
    fetch = _resolve_fetch(scene, settings)
    check(fetch == "kernel", f"shade_fetch 'auto' resolved to {fetch!r}")
    render_progressive(scene, camera, settings, width=WIDTH, height=HEIGHT,
                       spp=1)  # warm-up: allocator, packed tables
    torch.cuda.synchronize()
    reset_launches(ts)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    film = render_progressive(scene, camera, settings, width=WIDTH,
                              height=HEIGHT, spp=SPP)
    e1.record()
    torch.cuda.synchronize()
    launches = {"slice": (ts.LAUNCHES, ts.EMIT_LAUNCHES)}
    ms = e0.elapsed_time(e1)
    img = film_image(film)
    check(launches["slice"] == (BOUNCES * SPP, BOUNCES * SPP),
          f"kernel launched {launches['slice']} times (plain, emit), "
          f"expected {BOUNCES * SPP} each")
    check(bool(torch.isfinite(img).all()), "render has non-finite pixels")
    mean = float(img.mean())
    check(0.0 < mean <= 1.0, f"render mean {mean} outside (0, 1]")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"shape {img.shape}")
    emit("slice", size=[WIDTH, HEIGHT], bounces=BOUNCES, spp=SPP,
         shade_fetch=fetch, launches=sum(launches["slice"]),
         launches_emit=launches["slice"][1], mean=mean,
         ms_per_sample=ms / SPP,
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

    tmp = tempfile.TemporaryDirectory()
    glb = Path(tmp.name) / "smoke_scene.glb"
    write_glb(glb, sphere_doc())
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    # 6. the CLI
    png = Path(tmp.name) / "smoke.png"
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

    # 7. the gradient step at the bench's size
    gset = RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                          enable_gamma=False)
    fetch = _resolve_fetch(scene, gset)
    check(fetch == "kernel", f"grad: shade_fetch 'auto' resolved to "
          f"{fetch!r}, expected 'kernel'")
    grad_step(scene, camera, lights, gset, WIDTH, HEIGHT)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launches(ts)
    loss, grads = grad_step(scene, camera, lights, gset, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches["grad"] = (ts.LAUNCHES, ts.EMIT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["grad"] == (BOUNCES, BOUNCES),
          f"grad step launched {launches['grad']} (plain, emit), expected "
          f"{BOUNCES} each")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"grad: {k} not finite")
    for k in ("mat_albedo", "sun_color", "sun_intensity", "sky_color",
              "sky_intensity", "tri_pos"):
        check(float(grads[k].abs().max()) > 0.0, f"grad: {k} is all zero")
    step_ms = median_ms(lambda: grad_step(scene, camera, lights, gset,
                                          WIDTH, HEIGHT))
    gather_set = gset.replace(shade_fetch="gather")
    torch.cuda.reset_peak_memory_stats()
    loss_g, _ = grad_step(scene, camera, lights, gather_set, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    peak_g = torch.cuda.max_memory_allocated()
    check(abs(float(loss_g) - float(loss)) <= LOSS_RTOL * abs(float(loss)),
          f"grad: gather loss {float(loss_g)} vs kernel {float(loss)}")
    gather_ms = median_ms(lambda: grad_step(scene, camera, lights,
                                            gather_set, WIDTH, HEIGHT))
    # the camera alone, as `optimize --optimize camera` differentiates it:
    # the rays are then the kernel fetch's only differentiable input
    _, g_cam = grad_step(scene, camera, lights, gset, WIDTH, HEIGHT,
                         wrt=("position",))
    g_full = grads["position"]
    check(bool(torch.isfinite(g_cam["position"]).all()) and bool(
        ((g_cam["position"] - g_full).abs()
         <= 2e-4 * float(g_full.abs().max())
         + GRAD_RTOL * g_full.abs()).all()),
          f"grad: camera-only gradient {g_cam['position'].tolist()} vs "
          f"{g_full.tolist()} in the full step")
    rays = WIDTH * HEIGHT * 2 * BOUNCES
    emit("grad", size=[WIDTH, HEIGHT], bounces=BOUNCES, shade_fetch=fetch,
         loss=float(loss), launches=sum(launches["grad"]),
         launches_emit=launches["grad"][1], ms_per_step=step_ms,
         rays_per_second=rays / (step_ms / 1e3),
         peak_mem_gib=peak / 2 ** 30,
         step_mem_gib=(peak - base_mem) / 2 ** 30,
         gather_ms_per_step=gather_ms,
         gather_rays_per_second=rays / (gather_ms / 1e3),
         gather_peak_mem_gib=peak_g / 2 ** 30,
         camera_only_grad=g_cam["position"].tolist(),
         grad_max_abs={k: float(g.abs().max()) for k, g in grads.items()})
    del grads

    # 8. the gradient step on the card (kernel) and on the CPU (twin)
    cset = gset.replace(bounces=CPU_GRAD_BOUNCES, shade_fetch="kernel")
    s = CPU_GRAD_SIZE
    loss_k, g_k = grad_step(scene, camera, lights, cset, s, s)
    loss_c, g_c = grad_step(scene_cpu, camera.to("cpu"), lights.to("cpu"),
                            cset, s, s)
    rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    check(rel <= LOSS_RTOL, f"grad card vs cpu: loss rel diff {rel}")
    excess = {}
    for k in GRAD_PARAMS:
        gk, gc = g_k[k].cpu(), g_c[k]
        bound = 2e-4 * float(gc.abs().max()) + GRAD_RTOL * gc.abs()
        excess[k] = float(((gk - gc).abs() - bound).max())
        check(excess[k] <= 0.0, f"grad card vs cpu: {k} beyond tolerance "
              f"by {excess[k]}")
    emit("grad_card_vs_cpu", size=[s, s], bounces=CPU_GRAD_BOUNCES,
         loss_card=float(loss_k), loss_cpu=float(loss_c), loss_rel_diff=rel,
         max_excess_over_tol=excess)

    # 9. the optimizer CLI
    out = Path(tmp.name) / "opt"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.optimize",
         "--scene", str(glb), "--self-test", "--optimize", "albedo",
         "lights", "--size", "128x128", "--steps", str(OPT_STEPS),
         "--bounces", str(OPT_BOUNCES), "--checkpoint-every", "10",
         "--camera-pos", "0,1.5,5", "--look-at", "0,0.5,0", "--vfov", "45",
         "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"optimize rc {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout)
    first, final = res["history"][0]["loss"], res["final_loss"]
    check(final < first, f"optimize: loss {first} -> {final} did not fall")
    check((out / "ckpt.npz").exists(), "optimize wrote no ckpt.npz")
    launches["optimize"] = tuple(res["traversal_launches"])
    check(launches["optimize"] == (OPT_STEPS * OPT_BOUNCES,
                                   OPT_STEPS * OPT_BOUNCES),
          f"optimize launched {launches['optimize']} (plain, emit), "
          f"expected {OPT_STEPS * OPT_BOUNCES} each")
    emit("optimize", steps=OPT_STEPS, size=[128, 128], bounces=OPT_BOUNCES,
         first_loss=first, final_loss=final,
         seconds_per_step=res["seconds_per_step"],
         param_mae=res["param_mae"], launches=sum(launches["optimize"]),
         wall_seconds=wall)
    tmp.cleanup()

    by_path = {p: {"traverse_sweep": c[0], "traverse_sweep[emit_attrs]": c[1]}
               for p, c in launches.items()}
    src = "dustraytracer_tpu_torch/csrc/traverse_sweep.cu"
    prim_t, prim_e = results["primary"], emit_res["primary"]
    print(json.dumps({"kernels": [
        {"name": "traverse_sweep", "route": "cuda", "source": src,
         "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:98",
         "launches": launches["grad"][0], "max_abs_err": max_err,
         "ms": prim_t["kernel_ms"], "plain_ms": prim_t["twin_ms"],
         "launches_by_path": {p: c["traverse_sweep"]
                              for p, c in by_path.items()}},
        {"name": "traverse_sweep[emit_attrs]", "route": "cuda",
         "source": src,
         "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:347",
         "launches": launches["grad"][1], "max_abs_err": emit_err,
         "ms": prim_e["kernel_emit_ms"], "plain_ms": prim_e["twin_emit_ms"],
         "launches_by_path": {p: c["traverse_sweep[emit_attrs]"]
                              for p, c in by_path.items()}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
