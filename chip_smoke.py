"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's forward render and gradient paths, every traversal
backend and the build cache (dustraytracer_tpu_torch) on a synthetic
scene the size of a dense bundled scene, generated from a seed:

  0. card      nvidia-smi name and power limit; fails without CUDA
  1. build     nvcc builds of csrc/traverse_sweep.cu, traverse_pallas.cu
               and add_salt.cu for sm_90a, started together; ptxas lines,
               and the registers of each instance of the sweep kernel and
               of the base-threading kernel (none may spill)
  2. scene     a displaced lat-long sphere (128 x 64 segments) over a
               textured ground (tools/grad_bench.py::sphere_doc), built
               by the port's build_scene; also its 16 x 8 variant (226
               triangles) and the 128 x 64 one with an alpha cutout quad
  3. kernel    the traversal kernel against its PyTorch twin on the card:
               512x512 sorted primary rays, a bounce wave with 10% parked
               lanes, and any-hit shadow rays; equal hit ids, visits and
               occlusion, t within rtol 1e-4; median times of both
  3e. emit     the kernel's emit_attrs mode (the in-kernel shading fetch)
               on the primary and bounce waves: against the twin, hit ids,
               visits and materials equal and t, u, v, uv, face normal bit
               for bit; against the kernel without emission, hit ids, t
               and visits identical; median times of both modes and twin
  3c. counters the kernel's counting mode on the three waves: hit ids, t
               and visits identical to the plain kernel's, exec_windows,
               exec_leafs and leaf_tests equal to the twin's; median times
               of both modes and the twin, the work the rays need
               (utils/roofline.py), the bound and the roofline share;
               resident blocks per SM of each sweep instance
  3t. ties/K   all three sweep instances, and both node-table instances
               of the base-threading kernel in closest and any-hit mode,
               against their twins, bit for bit, on a seeded
               2,048-triangle soup at K = 8, 16, 32 and 64, with
               duplicated triangles under new ids so that rays see exact
               t ties inside one cluster (the lowest id must win) and
               across two clusters; counts the tied rays (none fails)
  3p. pallas   the base-threading kernel (the TPU one-hot kernel's port) on
               the same waves, in both node-table instances (shared
               memory, which the wrapper picks for this scene, and the
               __ldg one, forced): hit ids equal and t bit for bit with
               its twin, visits zero; hit ids equal to the sweep kernel's
               but for exact t ties (counted); device ms, registers,
               blocks per SM, shared-memory bytes and grid of each
               instance, medians of the twin and the sweep kernel, and
               the bound from the same work count
  3s. tables   K2 on the sphere re-clustered at K = 16: 2,017 nodes, past
               the shared-memory table's limit, so the wrapper picks the
               __ldg instance; primary and shadow waves, bit for bit with
               the twin, and their device ms
  4. slice     render_progressive at 512x512, 4 bounces, 8 spp; the shade
               fetch resolves to "kernel", so each bounce launches the
               kernel once with emission (closest) and once without
               (shadow any-hit): bounces x spp launches of each
  5. card/cpu  the same render at 96x96, 1 spp, on the card (kernel) and
               on the CPU (twin), within the render tolerance of the tests
  5b. backends every settings.traversal at 96x96, 1 spp, on the card and
               on the CPU within the same tolerance: auto (brute on the
               16 x 8 sphere), brute (same scene), cluster, gather and
               sweep (the 128 x 64 sphere); ms per sample at 512x512 b4,
               one timed sample each (the plain-PyTorch walks take
               seconds per sample)
  5a. alpha    the cutout scene with alpha_test: render_progressive at
               512x512 b4 8 spp through the sweep kernel and the re-trace
               (launches, traces, mean rounds per trace, ms per sample);
               card against CPU at 96x96; the cutout changes the image
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
 10. cache_reload  tools/repro_cache_hang.py: four fresh processes build,
               reload, die in nvcc and rebuild the add_salt kernel
               (seconds and results of each)

Phases 11-15 run on the PBR sphere (sphere_doc(pbr=True): the sphere
metallic 0.6, roughness 0.3, a glass pane before it, an emissive panel
behind it; 16,134 triangles, so "auto" still picks the kernel fetch),
after phase 8:

 11. pbr       render_progressive at 512x512, 4 bounces, 8 spp with
               shading="pbr": bounces x spp launches with emission and as
               many any-hit; card against CPU at 96x96; the committed
               golden tests/goldens/glass_panes_exact.npz regenerated on
               the card, within the render tolerance
 12. kernel_continuation  K1 (plain, any-hit, emit) against its twin bit
               for bit on the soft-edge continuation wave (each primary
               hit's ray restarted a hair past it) and on the refracted
               rays of a PBR sample's second wave; hits at t below 1e-3
 13. soft_edges  the gradient step at 512x512 b4 with soft_edges=0.05:
               2 x bounces closest-hit and bounces any-hit launches,
               finite, nonzero vertex gradients, ms per step; card
               against CPU at 48x48 b2 within the gradient tolerance
 14. textures  decode_textures: the float render equals the u8 render bit
               for bit; the gradient step on the texels (ms per step);
               the texel fetch's forward and backward device ms
               (torch.profiler) at 262,144 lookups
 15. debug     every debug view at 96x96, card against CPU, one closest
               launch each
 16. optimize_pbr  the optimizer self-test of phase 9 on the PBR sphere's
               .glb with --optimize emissive metallic roughness
               transmission ior (shading="pbr"); the loss must fall

Each kernel's launch counts are set to 0 just before the path that runs
it and read just after. Each phase prints one JSON line; then a
{"kernels": [...]} line, the nvidia-smi line and, last, {"ok": true,
"device": {...}}. Any failure raises and exits non-zero before the last
line.
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
BACKEND_SIZE = 96
TWIN_REPS = 3        # the plain-PyTorch walks take 0.1-0.5 s per wave
SWEEP_KERNEL = "traverse_sweep_kernel"  # the device kernels' name stems
PALLAS_KERNEL = "traverse_pallas_kernel"
KERNELS = ("traverse_sweep", "traverse_sweep[emit_attrs]",
           "traverse_sweep[counters]", "traverse_pallas", "add_salt")
SWEEP_MODES = {"traverse_sweep": "plain",  # K1's rows -> instances
               "traverse_sweep[emit_attrs]": "emit_attrs",
               "traverse_sweep[counters]": "counters"}
# the instances' template arguments in the mangled kernel names
INSTANCE_OF = {"ILb0ELb0E": "plain", "ILb1ELb0E": "emit_attrs",
               "ILb0ELb1E": "counters"}
PALLAS_INSTANCE_OF = {"ILb1E": "shared", "ILb0E": "global"}
TIE_KS = (8, 16, 32, 64)
# the sphere re-clustered at this K has 2,017 nodes: past K2's
# shared-memory node table limit
TABLE_K = 16
TIE_CALLS = {"plain": {}, "anyhit": {"anyhit": True},  # keyword arguments
             "emit_attrs": {"emit_attrs": True},
             "counters": {"counters": True}}
TIE_TRIS = 2048
TIE_RAYS = 32768
PBR_OPT = ("emissive", "metallic", "roughness", "transmission", "ior")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def write_glb(path: Path, doc) -> None:
    """The document's geometry and material factors (base colour,
    metallic, roughness, emission, transmission, ior) as a .glb, without
    images: one mesh per primitive, u32 indices."""
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

    def material(m):
        out = {"name": m.name, "pbrMetallicRoughness": {
            "baseColorFactor": [*map(float, m.base_color), 1.0],
            "metallicFactor": float(m.metallic),
            "roughnessFactor": float(m.roughness)},
            "emissiveFactor": [*map(float, m.emissive)]}
        if m.transmission or m.ior != 1.5:
            out["extensions"] = {
                "KHR_materials_transmission": {
                    "transmissionFactor": float(m.transmission)},
                "KHR_materials_ior": {"ior": float(m.ior)}}
        return out

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
        "materials": [material(m) for m in doc.materials],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)


def instance_registers(log: str, stem: str, instances: dict) -> dict:
    """Registers and spill bytes of each instance of the kernel `stem`
    (template arguments -> instance name), from the ptxas -v lines of its
    build log."""
    regs, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = next((m for key, m in instances.items()
                          if stem + key in ln), None)
        elif entry and "spill stores" in ln:
            words = ln.replace(",", " ").split()
            regs.setdefault(entry, {})["spill_bytes"] = (
                int(words[words.index("spill") - 2])
                + int(words[words.index("loads") - 3]))
        elif entry and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            regs.setdefault(entry, {})["registers"] = int(
                words[words.index("registers") - 1])
    return regs


def tie_soup(k: int, seed: int = 5):
    """A seeded soup of TIE_TRIS triangles (test_torch_sweep_ties.py's
    shape: centres uniform in [-5, 5]^3, corners N(0, 0.3) around them),
    sorted by a 8^3 grid cell so that clusters of K consecutive triangles
    are compact, and with duplicates under new ids: in every second
    cluster c, slot K-1 repeats slot 3 (a tie inside one cluster) and
    slot K-2 repeats slot 4 of cluster c+1 (a tie across two clusters).
    Returns positions (N, 3, 3) and the pairs (low id, high id) of each
    kind."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (TIE_TRIS, 1, 3))
    pos = (centers + rng.normal(0, 0.3, (TIE_TRIS, 3, 3))).astype(np.float32)
    cell = np.clip(((pos.mean(axis=1) + 5.0) / 1.25).astype(np.int64), 0, 7)
    pos = pos[np.argsort(cell @ np.array([64, 8, 1]), kind="stable")]
    inside, across = [], []
    for c in range(0, TIE_TRIS // k - 1, 2):
        base = c * k
        pos[base + k - 1] = pos[base + 3]
        inside.append((base + 3, base + k - 1))
        pos[base + k - 2] = pos[base + k + 4]
        across.append((base + k - 2, base + k + 4))
    return pos, np.array(inside), np.array(across)


def tie_rays(pos, pairs, seed: int = 6):
    """TIE_RAYS rays from uniform origins in [-12, 12]^3 toward points
    inside triangles: half toward the tied pairs' triangles, half toward
    any triangle."""
    rng = np.random.default_rng(seed)
    half = TIE_RAYS // 2
    tri = np.concatenate([pairs[rng.integers(0, len(pairs), half), 0],
                          rng.integers(0, len(pos), TIE_RAYS - half)])
    a, b = (rng.uniform(0.1, 0.45, TIE_RAYS)[:, None] for _ in range(2))
    v0, v1, v2 = pos[tri, 0], pos[tri, 1], pos[tri, 2]
    target = v0 + a * (v1 - v0) + b * (v2 - v0)
    o = rng.uniform(-12, 12, (TIE_RAYS, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def reset_launches() -> None:
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    ts.LAUNCHES = ts.EMIT_LAUNCHES = ts.COUNT_LAUNCHES = 0
    tp.LAUNCHES = 0


def read_launches() -> dict:
    """Launches since reset_launches(), by kernel (add_salt runs only in
    the cache-reload tool's child processes, which report their own)."""
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    return {"traverse_sweep": ts.LAUNCHES,
            "traverse_sweep[emit_attrs]": ts.EMIT_LAUNCHES,
            "traverse_sweep[counters]": ts.COUNT_LAUNCHES,
            "traverse_pallas": tp.LAUNCHES}


def compare_images(a: torch.Tensor, b: torch.Tensor) -> dict:
    a = a.detach().cpu().numpy()
    b = b.detach().cpu().numpy()
    diff = np.abs(a - b).max(axis=-1)
    mse = float(np.mean((a - b) ** 2))
    return {"max_abs": float(diff.max()),
            "pixels_over_tol": int((diff > PIX_TOL).sum()),
            "frac_within": float((diff <= PIX_TOL).mean()),
            "psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12))}


def grad_card_vs_cpu(scene, camera, lights, settings, scene_cpu) -> dict:
    """The gradient step at CPU_GRAD_SIZE² on the card and on the CPU
    (twin): loss within LOSS_RTOL relative, every gradient within atol
    2e-4 max|g| + rtol GRAD_RTOL of the CPU's; the excess over that bound
    of each (<= 0 passes)."""
    from dustraytracer_tpu_torch.tools.grad_bench import (GRAD_PARAMS,
                                                          grad_step)

    s = CPU_GRAD_SIZE
    loss_k, g_k = grad_step(scene, camera, lights, settings, s, s)
    loss_c, g_c = grad_step(scene_cpu, camera.to("cpu"), lights.to("cpu"),
                            settings, s, s)
    rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    excess = {}
    for k in GRAD_PARAMS:
        gk, gc = g_k[k].cpu(), g_c[k]
        bound = 2e-4 * float(gc.abs().max()) + GRAD_RTOL * gc.abs()
        excess[k] = float(((gk - gc).abs() - bound).max())
    check(rel <= LOSS_RTOL, f"grad card vs cpu: loss rel diff {rel}")
    bad = {k: e for k, e in excess.items() if e > 0.0}
    check(not bad, f"grad card vs cpu: beyond tolerance by {bad}")
    return {"loss_card": float(loss_k), "loss_cpu": float(loss_c),
            "loss_rel_diff": rel, "max_excess_over_tol": excess}


def run_optimizer(glb: Path, out: Path, what, env) -> tuple:
    """The optimizer CLI's self-test on `glb` in a subprocess: OPT_STEPS
    Adam steps on the parameters `what` at 128x128, OPT_BOUNCES bounces;
    the loss must fall, a checkpoint be written, and each step launch K1
    once per bounce with emission and once without. Returns (results,
    launches)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.optimize",
         "--scene", str(glb), "--self-test", "--optimize", *what,
         "--size", "128x128", "--steps", str(OPT_STEPS),
         "--bounces", str(OPT_BOUNCES), "--checkpoint-every", "10",
         "--camera-pos", "0,1.5,5", "--look-at", "0,0.5,0", "--vfov", "45",
         "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"optimize {what} rc {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout)
    first, final = res["history"][0]["loss"], res["final_loss"]
    check(final < first, f"optimize {what}: loss {first} -> {final} did "
          "not fall")
    check((out / "ckpt.npz").exists(), "optimize wrote no ckpt.npz")
    got = tuple(res["traversal_launches"])
    want = OPT_STEPS * OPT_BOUNCES
    check(got == (want, want), f"optimize {what} launched {got} (plain, "
          f"emit), expected {want} each")
    return ({"first_loss": first, "final_loss": final,
             "seconds_per_step": res["seconds_per_step"],
             "param_mae": res["param_mae"], "wall_seconds": wall},
            {"traverse_sweep": got[0], "traverse_sweep[emit_attrs]": got[1]})


class record_sweep_calls:
    """Within the block, every K1 call the integrator makes appends its
    (origin, direction, keyword arguments) to `calls` and runs as
    before."""

    def __enter__(self):
        from dustraytracer_tpu_torch.render import integrator

        self.calls = []
        self.orig = integrator.traverse_cluster_sweep

        def rec(cb, o, d, **kw):
            self.calls.append((o.clone(), d.clone(), kw))
            return self.orig(cb, o, d, **kw)

        integrator.traverse_cluster_sweep = rec
        return self.calls

    def __exit__(self, *exc):
        from dustraytracer_tpu_torch.render import integrator

        integrator.traverse_cluster_sweep = self.orig
        return False


def kernel_against_twin(cb, o, d, wave: str, **kw) -> dict:
    """K1 and its twin on one wave, every output bit for bit."""
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    rk = ts.traverse_cluster_sweep(cb, o, d, **kw)
    rt = ts.traverse_cluster_sweep_reference(cb, o, d, **kw)
    torch.cuda.synchronize()
    check(rk.keys() == rt.keys(), f"{wave} {kw}: keys")
    for key in rk:
        check(torch.equal(rk[key], rt[key]),
              f"{wave} {kw}: {key} differs from the twin in "
              f"{int((rk[key] != rt[key]).sum())} entries")
    return rk


def pbr_phases(camera, lights, launches: dict) -> None:
    """Phases 11-15 on the PBR sphere (tools/grad_bench.py::sphere_doc
    (pbr=True)): the PBR slice, K1 on soft-edge continuation and refracted
    waves, the soft-edge vertex step, float textures and the debug views.
    Adds each path's launches to `launches`."""
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts
    from dustraytracer_tpu_torch.render.film import (film_image,
                                                     render_progressive)
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           render_sample)
    from dustraytracer_tpu_torch.render.texture import (decode_textures,
                                                        sample_texture)
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (DebugMode,
                                                        LightParams,
                                                        RenderMode,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.ab_main_paths import sweep_waves
    from dustraytracer_tpu_torch.tools.grad_bench import (device_ms,
                                                          glass_panes_doc,
                                                          grad_step,
                                                          median_ms,
                                                          sphere_doc)

    dev = torch.device("cuda")
    pbr_cpu = build_scene(sphere_doc(pbr=True))
    pbr = pbr_cpu.to(dev)
    cb = pbr.cluster
    no_kernel = dict.fromkeys(read_launches(), 0)

    def compare_96(st, what):
        """The 96x96 sample on the card and on the CPU, compared."""
        b = BACKEND_SIZE
        with torch.inference_mode():
            a = render_sample(pbr, camera, lights, 0, width=b, height=b,
                              settings=st)
            c = render_sample(pbr_cpu, camera.to("cpu"), lights.to("cpu"),
                              0, width=b, height=b, settings=st)
        res = compare_images(a, c)
        check(res["frac_within"] >= PIX_FRAC and res["psnr_db"] > MIN_PSNR,
              f"{what} card vs cpu: {res}")
        return res

    # 11. the PBR slice
    pset = RenderSettings(bounces=BOUNCES, shading="pbr")
    fetch = _resolve_fetch(pbr, pset)
    check(fetch == "kernel", f"pbr: shade_fetch 'auto' resolved to {fetch}")
    render_progressive(pbr, camera, pset, width=WIDTH, height=HEIGHT,
                       spp=1)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    film = render_progressive(pbr, camera, pset, width=WIDTH, height=HEIGHT,
                              spp=SPP)
    e1.record()
    torch.cuda.synchronize()
    launches["pbr"] = read_launches()
    check(launches["pbr"] == {**no_kernel, "traverse_sweep": BOUNCES * SPP,
                              "traverse_sweep[emit_attrs]": BOUNCES * SPP},
          f"pbr launched {launches['pbr']}")
    img = film_image(film)
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          "pbr render not finite or black")
    cmp = compare_96(RenderSettings(bounces=BOUNCES, shading="pbr"), "pbr")
    # the committed golden of the glass scene, regenerated on the card
    with np.load(ROOT / "tests" / "goldens" / "glass_panes_exact.npz") as z:
        golden = torch.from_numpy(z["image"].astype(np.float32))
        meta = json.loads(str(z["meta"]))
    gscene = build_scene(glass_panes_doc()).to(dev)
    gset = RenderSettings(bounces=meta["bounces"], **meta["overrides"])
    gcam = make_camera(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in meta["camera"].items()}, device=dev)
    glights = LightParams.from_settings(gset, device=dev)
    n = meta["size"]
    with torch.inference_mode():
        gimg = sum(render_sample(gscene, gcam, glights, i, width=n,
                                 height=n, settings=gset)
                   for i in range(meta["spp"])) / meta["spp"]
    gcmp = compare_images(gimg, golden)
    check(gcmp["frac_within"] >= PIX_FRAC and gcmp["psnr_db"] > MIN_PSNR,
          f"glass_panes golden on the card: {gcmp}")
    emit("pbr", size=[WIDTH, HEIGHT], bounces=BOUNCES, spp=SPP,
         triangles=pbr.n_tris, padded_triangles=int(pbr.tri_pos.shape[0]),
         shade_fetch=fetch, launches=launches["pbr"],
         mean=float(img.mean()), ms_per_sample=e0.elapsed_time(e1) / SPP,
         card_vs_cpu_96=cmp, glass_panes_golden=gcmp)

    # 12. K1 against its twin on the rays PBR and soft edges add:
    # continuations a hair past each primary hit, and refracted rays
    wo, wd, _ = sweep_waves(pbr, camera, lights, WIDTH)["primary"]
    prim = ts.traverse_cluster_sweep(cb, wo, wd)
    hit = prim["hit_idx"] >= 0
    adv = torch.where(hit, prim["t"] * (1.0 + 1e-4) + 1e-4, 0.0)
    co = torch.where(hit[:, None], wo + wd * adv[:, None], 3.0e37)
    with torch.inference_mode(), record_sweep_calls() as calls:
        render_sample(pbr, camera, lights, 0, width=WIDTH, height=HEIGHT,
                      settings=pset)
    # the second closest-hit wave starts at the first hits; the rays that
    # left the pane (z = 2.2, facing +z) backwards were refracted
    ro, rd, _ = [c for c in calls if not c[2].get("anyhit")][1]
    refr = ((ro[:, 2] < 2.2) & (ro[:, 2] > 2.19) & (rd[:, 2] < 0.0)
            & (ro[:, 0].abs() <= 0.8) & (ro[:, 1] >= 0.3) & (ro[:, 1] <= 1.9))
    ro, rd = ro[refr].contiguous(), rd[refr].contiguous()
    check(ro.shape[0] > 1000, f"only {ro.shape[0]} refracted rays")
    cont = {}
    for wave, (o, d) in (("continuation", (co, wd)), ("refracted", (ro, rd))):
        rk = kernel_against_twin(cb, o, d, wave)
        kernel_against_twin(cb, o, d, wave, anyhit=True)
        kernel_against_twin(cb, o, d, wave, emit_attrs=True)
        h = rk["hit_idx"] >= 0
        cont[wave] = {
            "rays": int(o.shape[0]), "hits": int(h.sum()),
            "hits_t_below_1e-3": int((h & (rk["t"] < 1e-3)).sum()),
            "min_t": float(rk["t"][h].min()) if bool(h.any()) else None,
            "kernel_ms": device_ms(lambda: ts.traverse_cluster_sweep(
                cb, o, d), SWEEP_KERNEL),
            "kernel_anyhit_ms": device_ms(lambda: ts.traverse_cluster_sweep(
                cb, o, d, anyhit=True), SWEEP_KERNEL)}
    emit("kernel_continuation", **cont)

    # 13. the soft-edge gradient step: two closest hits and one any-hit
    # per bounce, gather fetch
    sset = RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                          enable_gamma=False, shading="pbr", soft_edges=0.05)
    fetch = _resolve_fetch(pbr, sset)
    check(fetch == "gather", f"soft edges: fetch {fetch}")
    grad_step(pbr, camera, lights, sset, WIDTH, HEIGHT)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    loss, grads = grad_step(pbr, camera, lights, sset, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches["soft_edges"] = read_launches()
    check(launches["soft_edges"] == {**no_kernel,
                                     "traverse_sweep": 3 * BOUNCES},
          f"soft edges launched {launches['soft_edges']}, expected "
          f"{2 * BOUNCES} closest and {BOUNCES} any-hit")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"soft edges: {k} not finite")
    check(float(grads["tri_pos"].abs().max()) > 0.0,
          "soft edges: vertex gradient all zero")
    step_ms = median_ms(lambda: grad_step(pbr, camera, lights, sset, WIDTH,
                                          HEIGHT))
    emit("soft_edges", size=[WIDTH, HEIGHT], bounces=BOUNCES,
         soft_edges=0.05, shading="pbr", loss=float(loss),
         launches=launches["soft_edges"], ms_per_step=step_ms,
         tri_pos_grad_max_abs=float(grads["tri_pos"].abs().max()),
         card_vs_cpu=grad_card_vs_cpu(
             pbr, camera, lights, sset.replace(bounces=CPU_GRAD_BOUNCES),
             pbr_cpu))
    del grads

    # 14. float textures: the same image as u8, and a step on the texels
    tset = RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                          enable_gamma=False, shading="pbr")
    fscene = decode_textures(pbr)
    with torch.inference_mode():
        u8 = render_sample(pbr, camera, lights, 0, width=WIDTH,
                           height=HEIGHT, settings=tset)
        f32 = render_sample(fscene, camera, lights, 0, width=WIDTH,
                            height=HEIGHT, settings=tset)
    check(torch.equal(u8, f32), "float texture render differs from u8 by "
          f"{float((u8 - f32).abs().max())}")

    def tex_step():
        leaf = fscene.tex_stack.detach().clone().requires_grad_(True)
        img = render_sample(fscene.replace(tex_stack=leaf), camera, lights,
                            0, width=WIDTH, height=HEIGHT, settings=tset)
        img.mean().backward()
        return leaf.grad

    tex_step()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    g = tex_step()
    torch.cuda.synchronize()
    launches["textures"] = read_launches()
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0,
          "texture gradient not finite or all zero")
    # the texel fetch alone, at the step's shape: WIDTHxHEIGHT lookups of
    # the 256x256 ground texture
    gen = torch.Generator().manual_seed(0)
    uv = torch.rand(WIDTH * HEIGHT, 2, generator=gen).mul(40.0).to(dev)
    tid = torch.zeros(WIDTH * HEIGHT, dtype=torch.int32, device=dev)
    stack = fscene.tex_stack.detach().clone().requires_grad_(True)
    texels = sample_texture(fscene.replace(tex_stack=stack), tid, uv)
    up = torch.ones_like(texels)
    emit("textures", size=[WIDTH, HEIGHT], bounces=BOUNCES,
         float_equals_u8=True, launches=launches["textures"],
         ms_per_step=median_ms(tex_step),
         texel_grad_max_abs=float(g.abs().max()),
         texture_fetch_lookups=WIDTH * HEIGHT,
         texture_fwd_device_ms=device_ms(
             lambda: sample_texture(fscene, tid, uv)),
         texture_bwd_device_ms=device_ms(
             lambda: texels.backward(up, retain_graph=True)))

    # 15. every debug view, card against CPU; one closest trace each
    views, launches["debug"] = {}, dict(no_kernel)
    for dm in DebugMode:
        st = RenderSettings(render_mode=RenderMode.DEBUG, debug_mode=dm)
        reset_launches()
        with torch.inference_mode():
            render_sample(pbr, camera, lights, 0, width=BACKEND_SIZE,
                          height=BACKEND_SIZE, settings=st)
        torch.cuda.synchronize()
        got = read_launches()
        check(got == {**no_kernel, "traverse_sweep[emit_attrs]": 1},
              f"debug {dm.name} launched {got}")
        launches["debug"] = {k: launches["debug"][k] + got[k] for k in got}
        views[dm.name] = compare_96(st, f"debug {dm.name}")
    emit("debug", size=[BACKEND_SIZE] * 2, launches=launches["debug"],
         card_vs_cpu=views)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from concurrent.futures import ThreadPoolExecutor

    from dustraytracer_tpu_torch.accel.cluster import build_cluster_bvh
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts
    from dustraytracer_tpu_torch.ops.cuda_build import ARCH, load_library
    from dustraytracer_tpu_torch.render.film import (film_image,
                                                     render_progressive)
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           render_sample)
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools import repro_cache_hang
    from dustraytracer_tpu_torch.tools.ab_main_paths import sweep_waves
    from dustraytracer_tpu_torch.tools.grad_bench import (POSE,
                                                          SMALL_SPHERE,
                                                          device_ms,
                                                          grad_step,
                                                          median_ms,
                                                          sphere_doc)
    from dustraytracer_tpu_torch.utils.roofline import (bound_seconds,
                                                        nbytes, sweep_work)

    dev = torch.device("cuda")
    # K2's node-table instances: the wrapper's pick on the scenes here,
    # and the __ldg one, forced
    k2_calls = {"shared": tp.traverse_cluster_pallas,
                "global": tp.traverse_cluster_pallas_global}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, device_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build: one nvcc per source, all started together
    srcs = ("traverse_sweep", "traverse_pallas", "add_salt")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as pool:
        recs = dict(zip(srcs, pool.map(load_library, srcs)))
    nvcc_s = time.perf_counter() - t0
    ts.load_kernel()
    tp.load_kernel()
    for src_name, rec in recs.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        emit("build", source=f"csrc/{src_name}.cu", seconds=rec["seconds"],
             built=rec["built"], arch=ARCH,
             flags=rec["log"].splitlines()[0] if rec["log"] else "",
             ptxas=ptxas, all_builds_seconds=nvcc_s)
    sweep_regs = instance_registers(recs["traverse_sweep"]["log"],
                                    SWEEP_KERNEL, INSTANCE_OF)
    pallas_regs = instance_registers(recs["traverse_pallas"]["log"],
                                     PALLAS_KERNEL, PALLAS_INSTANCE_OF)
    for src_name, regs, want in (
            ("traverse_sweep", sweep_regs, SWEEP_MODES.values()),
            ("traverse_pallas", pallas_regs, tp.NODE_TABLES)):
        check(sorted(regs) == sorted(want),
              f"ptxas lines for the {src_name} instances: {regs}")
        for inst, reg in regs.items():
            check(reg.get("spill_bytes") == 0,
                  f"{src_name} {inst} spills: {reg}")
        emit("build", source=f"csrc/{src_name}.cu", instances=regs)

    # 2. scene
    t0 = time.perf_counter()
    scene_cpu = build_scene(sphere_doc())
    build_s = time.perf_counter() - t0
    scene = scene_cpu.to(dev)
    cb = scene.cluster
    emit("scene", triangles=scene.n_tris, bvh_nodes=scene.n_nodes,
         clusters=cb.n_clusters, cluster_nodes=cb.n_nodes, k=cb.k,
         build_seconds=build_s)
    small_cpu = build_scene(sphere_doc(*SMALL_SPHERE))
    cut_cpu = build_scene(sphere_doc(cutout=True))
    small, cut = small_cpu.to(dev), cut_cpu.to(dev)
    emit("scene", name="small", triangles=small.n_tris,
         padded_cluster_triangles=small.cluster.n_clusters * small.cluster.k)
    emit("scene", name="cutout", triangles=cut.n_tris,
         textures_with_alpha=int(cut.tex_has_alpha.sum()))

    # 3. kernel vs twin on the card
    settings = RenderSettings(bounces=BOUNCES)
    lights = LightParams.from_settings(settings, device=dev)
    camera = make_camera(**POSE, device=dev)
    waves = sweep_waves(scene, camera, lights, WIDTH)
    n = WIDTH * HEIGHT
    results, max_err, plain_out = {}, 0.0, {}
    for wave, (wo, wd, ah) in waves.items():
        rk = ts.traverse_cluster_sweep(cb, wo, wd, anyhit=ah)
        plain_out[wave] = rk
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
        k_ms = device_ms(lambda: ts.traverse_cluster_sweep(cb, wo, wd,
                                                           anyhit=ah),
                         SWEEP_KERNEL)
        p_ms = median_ms(lambda: ts.traverse_cluster_sweep_reference(
            cb, wo, wd, anyhit=ah))
        results[wave] = {
            "kernel_ms": k_ms, "twin_ms": p_ms,
            "kernel_call_ms": median_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd, anyhit=ah)),
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
        if wave == "primary":
            emit_bytes = nbytes(*rk.values())
        emit_res[wave] = {
            "kernel_emit_ms": device_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd, emit_attrs=True), SWEEP_KERNEL),
            "kernel_plain_ms": device_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd), SWEEP_KERNEL),
            "twin_emit_ms": median_ms(
                lambda: ts.traverse_cluster_sweep_reference(
                    cb, wo, wd, emit_attrs=True))}
        emit("kernel_emit_vs_twin", wave=wave, rays=n,
             hits=int((rk["hit_idx"] >= 0).sum()), max_abs_err=errs,
             **emit_res[wave])

    # 3c. K1's counting mode: its path is the counting call on each wave
    reset_launches()
    counted = {wave: ts.traverse_cluster_sweep(cb, wo, wd, anyhit=ah,
                                               counters=True)
               for wave, (wo, wd, ah) in waves.items()}
    torch.cuda.synchronize()
    launches = {"kernel_counters": read_launches()}
    check(launches["kernel_counters"]["traverse_sweep[counters]"]
          == len(waves), f"counting mode launched "
          f"{launches['kernel_counters']}")
    nodes_t, tris_t = ts.device_tables(cb)
    sweep_tables = nbytes(nodes_t, tris_t)
    occ = ts.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(all(b > 0 for b in occ.values()), f"occupancy {occ}")
    emit("kernel_counters", resident_blocks_per_sm=occ, sms=sms,
         threads_per_block=128,
         resident_warps_per_sm={k: 4 * b for k, b in occ.items()})
    work, count_res, count_err = {}, {}, 0.0
    for wave, (wo, wd, ah) in waves.items():
        rc, rp = counted[wave], plain_out[wave]
        for key in ("hit_idx", "t", "visits"):
            check(torch.equal(rc[key], rp[key]),
                  f"counters {wave}: {key} differs from the plain kernel")
        rt = ts.traverse_cluster_sweep_reference(cb, wo, wd, anyhit=ah,
                                                 counters=True)
        torch.cuda.synchronize()
        for key in ("exec_windows", "exec_leafs", "leaf_tests", "visits"):
            check(torch.equal(rc[key], rt[key]),
                  f"counters {wave}: {key} differs from the twin in "
                  f"{int((rc[key] != rt[key]).sum())} entries")
        both = (rc["hit_idx"] >= 0) & (rt["hit_idx"] >= 0)
        if bool(both.any()):
            count_err = max(count_err, float(
                (rc["t"][both] - rt["t"][both]).abs().max()))
        work[wave] = sweep_work(rc, cb.k, sweep_tables)
        bound_s, bound_by = bound_seconds(work[wave]["ops"],
                                          work[wave]["bytes"])
        c_ms = device_ms(lambda: ts.traverse_cluster_sweep(
            cb, wo, wd, anyhit=ah, counters=True), SWEEP_KERNEL)
        p_ms = device_ms(lambda: ts.traverse_cluster_sweep(cb, wo, wd,
                                                           anyhit=ah),
                         SWEEP_KERNEL)
        t_ms = median_ms(lambda: ts.traverse_cluster_sweep_reference(
            cb, wo, wd, anyhit=ah, counters=True), TWIN_REPS)
        count_res[wave] = {"kernel_count_ms": c_ms, "kernel_plain_ms": p_ms,
                           "twin_count_ms": t_ms, "bound_ms": bound_s * 1e3,
                           "bound_by": bound_by,
                           "roofline_share": bound_s * 1e3 / c_ms}
        emit("kernel_counters", wave=wave, anyhit=ah, **count_res[wave],
             **work[wave])

    # 3t. K1's three instances and K2's two against their twins at other
    # K and on ties
    tie_ms = {inst: {} for inst in SWEEP_MODES.values()}
    k2_tie_ms = {inst: {} for inst in tp.NODE_TABLES}
    tie_total = 0
    for k in TIE_KS:
        pos, inside, across = tie_soup(k)
        trng = np.random.default_rng(100 + k)
        nt = pos.shape[0]
        fn = trng.normal(size=(nt, 3)).astype(np.float32)
        fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
        tcb = build_cluster_bvh(
            pos, k=k, uv=trng.uniform(0, 1, (nt, 3, 2)).astype(np.float32),
            face_nrm=fn, mat=trng.integers(0, 4, nt).astype(np.int32)
        ).to(dev)
        to, td = (torch.from_numpy(x).to(dev)
                  for x in tie_rays(pos, np.concatenate([inside, across])))
        outs = {}
        for mode, kw in TIE_CALLS.items():
            rk = ts.traverse_cluster_sweep(tcb, to, td, **kw)
            rt = ts.traverse_cluster_sweep_reference(tcb, to, td, **kw)
            torch.cuda.synchronize()
            check(rk.keys() == rt.keys(), f"ties K={k} {mode}: keys")
            for key in rk:
                check(torch.equal(rk[key], rt[key]),
                      f"ties K={k} {mode}: {key} differs from the twin in "
                      f"{int((rk[key] != rt[key]).sum())} entries")
            outs[mode] = rk
            if mode != "anyhit":
                tie_ms[mode][str(k)] = device_ms(
                    lambda: ts.traverse_cluster_sweep(tcb, to, td, **kw),
                    SWEEP_KERNEL)
        hit = outs["plain"]["hit_idx"].cpu().numpy()
        ins = np.isin(hit, inside)
        acr = np.isin(hit, across)
        # a ray whose closest hit is one of a pair inside one cluster
        # must take its lower id
        check(bool(np.isin(hit[ins], inside[:, 0]).all()),
              f"ties K={k}: {int((~np.isin(hit[ins], inside[:, 0])).sum())}"
              " rays tied inside a cluster took the higher id")
        for key in ("hit_idx", "t", "visits"):
            check(torch.equal(outs["emit_attrs"][key], outs["plain"][key])
                  and torch.equal(outs["counters"][key], outs["plain"][key]),
                  f"ties K={k}: {key} changes with the instance")
        tied = {"inside_cluster": int(ins.sum()),
                "across_clusters": int(acr.sum())}
        check(min(tied.values()) > 0, f"ties K={k}: tied rays {tied}")
        tie_total += sum(tied.values())
        # K2 walks the base threading: its own winners of the same ties
        check(tp.launch_config(tcb, TIE_RAYS)["node_table"] == "shared",
              f"ties K={k}: the soup's table does not fit shared memory")
        k2_out = {}
        for mode, kw in (("closest", {}), ("anyhit", {"anyhit": True})):
            rt = tp.traverse_cluster_pallas_reference(tcb, to, td, **kw)
            for inst, call in k2_calls.items():
                rk = call(tcb, to, td, **kw)
                torch.cuda.synchronize()
                for key in rk:
                    check(torch.equal(rk[key], rt[key]),
                          f"ties K={k} pallas {inst} {mode}: {key} differs "
                          f"from the twin in "
                          f"{int((rk[key] != rt[key]).sum())} entries")
                if mode == "closest":
                    k2_tie_ms[inst][str(k)] = device_ms(
                        lambda: call(tcb, to, td), PALLAS_KERNEL)
            k2_out[mode] = rt["hit_idx"].cpu().numpy()
        hit2 = k2_out["closest"]
        ins2 = np.isin(hit2, inside)
        high2 = int((~np.isin(hit2[ins2], inside[:, 0])).sum())
        check(high2 == 0, f"ties K={k}: pallas: {high2} rays tied inside a "
              "cluster took the higher id")
        tied2 = {"inside_cluster": int(ins2.sum()),
                 "across_clusters": int(np.isin(hit2, across).sum())}
        check(min(tied2.values()) > 0, f"ties K={k}: pallas tied {tied2}")
        tie_total += sum(tied2.values())
        emit("kernel_ties_and_k", k=k, triangles=nt, clusters=tcb.n_clusters,
             rays=TIE_RAYS, hits=int((hit >= 0).sum()), tied_rays=tied,
             anyhit_hits=int((outs["anyhit"]["hit_idx"] >= 0).sum()),
             kernel_ms={m: tie_ms[m][str(k)] for m in tie_ms},
             pallas_hits=int((hit2 >= 0).sum()), pallas_tied_rays=tied2,
             pallas_anyhit_hits=int((k2_out["anyhit"] >= 0).sum()),
             pallas_ms={m: k2_tie_ms[m][str(k)] for m in k2_tie_ms})
    check(tie_total > 0, "no tied ray exercised")
    emit("kernel_ties_and_k", tied_rays_total=tie_total)

    # 3p. K2: its path is traverse_cluster_pallas on each wave, which runs
    # the shared-memory instance on this scene; then the __ldg instance,
    # forced, on the same waves
    k2_cfg = {"shared": tp.launch_config(cb, n),
              "global": tp.launch_config(cb, n, "global")}
    check(k2_cfg["shared"]["node_table"] == "shared",
          f"traverse_pallas on {cb.n_nodes} nodes plans {k2_cfg['shared']}")
    reset_launches()
    k2 = {wave: tp.traverse_cluster_pallas(cb, wo, wd, anyhit=ah)
          for wave, (wo, wd, ah) in waves.items()}
    torch.cuda.synchronize()
    launches["kernel_pallas"] = read_launches()
    check(launches["kernel_pallas"]["traverse_pallas"] == len(waves),
          f"traverse_pallas launched {launches['kernel_pallas']}")
    k2_occ = tp.occupancy()
    check(k2_occ > 0 and k2_occ == k2_cfg["global"]["blocks_per_sm"],
          f"traverse_pallas occupancy {k2_occ}, plan {k2_cfg['global']}")
    base_tables = nbytes(tp.device_base_nodes(cb), tris_t)
    k2_res, k2_err = {}, 0.0
    for wave, (wo, wd, ah) in waves.items():
        r1 = plain_out[wave]
        rt = tp.traverse_cluster_pallas_reference(cb, wo, wd, anyhit=ah)
        outs = {"shared": k2[wave],
                "global": tp.traverse_cluster_pallas_global(cb, wo, wd,
                                                           anyhit=ah)}
        torch.cuda.synchronize()
        for inst, r2 in outs.items():
            check(torch.equal(r2["hit_idx"], rt["hit_idx"]),
                  f"pallas {inst} {wave}: hit_idx differs from the twin in "
                  f"{int((r2['hit_idx'] != rt['hit_idx']).sum())} rays")
            check(torch.equal(r2["t"], rt["t"]),
                  f"pallas {inst} {wave}: t not bit for bit with the twin")
            check(not bool(r2["visits"].any()),
                  f"pallas {inst} {wave}: visits not all zero")
            both = (r2["hit_idx"] >= 0) & (rt["hit_idx"] >= 0)
            if bool(both.any()):
                k2_err = max(k2_err, float(
                    (r2["t"][both] - rt["t"][both]).abs().max()))
        r2 = outs["shared"]
        if ah:  # first hits differ with the walk order; occlusion not
            check(torch.equal(r2["hit_idx"] >= 0, r1["hit_idx"] >= 0),
                  f"pallas {wave}: occlusion differs from the sweep kernel")
            ties = 0
        else:
            differ = r2["hit_idx"] != r1["hit_idx"]
            ties = int(differ.sum())
            check(torch.equal(r2["t"][differ], r1["t"][differ]),
                  f"pallas {wave}: hit_idx differs from the sweep kernel "
                  f"in {ties} rays, not all exact t ties")
        b_work = sweep_work(counted[wave], cb.k, base_tables,
                            out_bytes=nbytes(*r2.values()))
        bound_s, bound_by = bound_seconds(b_work["ops"], b_work["bytes"])
        by_inst = {inst: device_ms(lambda: fn(cb, wo, wd, anyhit=ah),
                                   PALLAS_KERNEL)
                   for inst, fn in k2_calls.items()}
        k_ms = by_inst["shared"]
        k2_res[wave] = {
            "kernel_ms": k_ms, "kernel_ms_by_instance": by_inst,
            "twin_ms": median_ms(
                lambda: tp.traverse_cluster_pallas_reference(
                    cb, wo, wd, anyhit=ah), TWIN_REPS),
            "sweep_kernel_ms": device_ms(lambda: ts.traverse_cluster_sweep(
                cb, wo, wd, anyhit=ah), SWEEP_KERNEL),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "roofline_share": bound_s * 1e3 / k_ms}
        emit("kernel_pallas_vs_twin", wave=wave, rays=n, anyhit=ah,
             hits=int((r2["hit_idx"] >= 0).sum()), max_abs_t_err=k2_err,
             exact_t_ties_vs_sweep=ties, **k2_res[wave])
    k2_inst = {inst: {**k2_cfg[inst], **pallas_regs[inst], "ms_by_wave": {
        w: r["kernel_ms_by_instance"][inst] for w, r in k2_res.items()}}
        for inst in tp.NODE_TABLES}
    emit("kernel_pallas_vs_twin", cluster_nodes=cb.n_nodes,
         threads_per_block=128, instances=k2_inst)

    # 3s. K2 past its node-table limit, on the sphere re-clustered at a
    # smaller K: the wrapper's own pick is the __ldg instance
    kcb = build_cluster_bvh(scene.tri_pos.cpu().numpy(), k=TABLE_K).to(dev)
    cfg = tp.launch_config(kcb, n)
    check(cfg["node_table"] == "global",
          f"traverse_pallas on {kcb.n_nodes} nodes plans {cfg}")
    by_wave = {}
    for wave in ("primary", "shadow_anyhit"):
        wo, wd, ah = waves[wave]
        rk = tp.traverse_cluster_pallas(kcb, wo, wd, anyhit=ah)
        rt = tp.traverse_cluster_pallas_reference(kcb, wo, wd, anyhit=ah)
        torch.cuda.synchronize()
        for key in rk:
            check(torch.equal(rk[key], rt[key]),
                  f"pallas K={TABLE_K} {wave}: {key} differs from the twin "
                  f"in {int((rk[key] != rt[key]).sum())} entries")
        by_wave[wave] = {
            "hits": int((rk["hit_idx"] >= 0).sum()),
            "kernel_ms": device_ms(lambda: tp.traverse_cluster_pallas(
                kcb, wo, wd, anyhit=ah), PALLAS_KERNEL)}
    emit("kernel_pallas_tables", k=TABLE_K, cluster_nodes=kcb.n_nodes, **cfg,
         waves=by_wave)

    # 4. the slice, through the user entry point
    fetch = _resolve_fetch(scene, settings)
    check(fetch == "kernel", f"shade_fetch 'auto' resolved to {fetch!r}")
    render_progressive(scene, camera, settings, width=WIDTH, height=HEIGHT,
                       spp=1)  # warm-up: allocator, packed tables
    torch.cuda.synchronize()
    reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    film = render_progressive(scene, camera, settings, width=WIDTH,
                              height=HEIGHT, spp=SPP)
    e1.record()
    torch.cuda.synchronize()
    launches["slice"] = read_launches()
    ms = e0.elapsed_time(e1)
    img = film_image(film)
    check(launches["slice"] == {**dict.fromkeys(launches["slice"], 0),
                                "traverse_sweep": BOUNCES * SPP,
                                "traverse_sweep[emit_attrs]": BOUNCES * SPP},
          f"kernels launched {launches['slice']}, expected "
          f"{BOUNCES * SPP} plain and {BOUNCES * SPP} emit")
    check(bool(torch.isfinite(img).all()), "render has non-finite pixels")
    mean = float(img.mean())
    check(0.0 < mean <= 1.0, f"render mean {mean} outside (0, 1]")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"shape {img.shape}")
    emit("slice", size=[WIDTH, HEIGHT], bounces=BOUNCES, spp=SPP,
         shade_fetch=fetch, launches=launches["slice"], mean=mean,
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

    def timed_sample(sc, st):
        """ms of one 512x512 sample, and the launches it made."""
        reset_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.inference_mode():
            e0.record()
            out = render_sample(sc, camera, lights, 1, width=WIDTH,
                                height=HEIGHT, settings=st)
            e1.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "non-finite sample")
        return e0.elapsed_time(e1), read_launches()

    def card_vs_cpu(sc, sc_cpu, st):
        """The 96x96 sample on the card and on the CPU, compared; and the
        card run's launches."""
        b = BACKEND_SIZE
        reset_launches()
        with torch.inference_mode():
            a = render_sample(sc, camera, lights, 0, width=b, height=b,
                              settings=st)
            torch.cuda.synchronize()
            got = read_launches()
            c = render_sample(sc_cpu, camera.to("cpu"), lights.to("cpu"), 0,
                              width=b, height=b, settings=st)
        res = compare_images(a, c)
        check(res["frac_within"] >= PIX_FRAC and res["psnr_db"] > MIN_PSNR,
              f"card vs cpu render ({st.traversal}, alpha_test="
              f"{st.alpha_test}): {res}")
        return a, res, got

    # 5b. every traversal backend, card against CPU; brute on the small
    # scene only
    no_kernel = dict.fromkeys(read_launches(), 0)
    backends = {}
    for trav, sc, sc_cpu in (("auto", small, small_cpu),
                             ("brute", small, small_cpu),
                             ("cluster", scene, scene_cpu),
                             ("gather", scene, scene_cpu),
                             ("sweep", scene, scene_cpu)):
        st = RenderSettings(bounces=BOUNCES, traversal=trav)
        _, res, got = card_vs_cpu(sc, sc_cpu, st)
        if trav == "sweep":
            check(got == {**no_kernel, "traverse_sweep": BOUNCES,
                          "traverse_sweep[emit_attrs]": BOUNCES},
                  f"backend sweep launched {got}")
        else:  # plain-PyTorch walks
            check(got == no_kernel, f"backend {trav} launched {got}")
        ms, got = timed_sample(sc, st)
        launches[f"backend_{trav}"] = got
        backends[trav] = ms
        emit("backends", traversal=trav, triangles=sc.n_tris,
             size_card_vs_cpu=[BACKEND_SIZE] * 2, **res,
             ms_per_sample_512_b4=ms, launches_512=got)

    # 5a. the alpha cutout through the sweep kernel and the re-trace
    aset = RenderSettings(bounces=BOUNCES, alpha_test=True)
    check(_resolve_fetch(cut, aset) == "gather", "alpha: fetch not gather")
    render_progressive(cut, camera, aset, width=WIDTH, height=HEIGHT,
                       spp=1)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    film = render_progressive(cut, camera, aset, width=WIDTH, height=HEIGHT,
                              spp=SPP)
    e1.record()
    torch.cuda.synchronize()
    launches["alpha"] = read_launches()
    alpha_ms = e0.elapsed_time(e1) / SPP
    traces = 2 * BOUNCES * SPP  # closest and shadow, each re-traced
    used = launches["alpha"]["traverse_sweep"]
    check(traces <= used <= traces * aset.alpha_rounds
          and used == sum(launches["alpha"].values()),
          f"alpha: launches {launches['alpha']} for {traces} traces")
    a_img = film_image(film)
    check(bool(torch.isfinite(a_img).all()), "alpha render not finite")
    img_cut, res, _ = card_vs_cpu(cut, cut_cpu, aset)
    with torch.inference_mode():
        img_opaque = render_sample(cut, camera, lights, 0,
                                   width=BACKEND_SIZE, height=BACKEND_SIZE,
                                   settings=aset.replace(alpha_test=False))
    means = (float(img_cut.mean()), float(img_opaque.mean()))
    check(abs(means[0] - means[1]) > 1e-4,
          f"alpha: the cutout does not change the image, means {means}")
    emit("alpha", size=[WIDTH, HEIGHT], bounces=BOUNCES, spp=SPP,
         launches=launches["alpha"], traces=traces,
         mean_rounds_per_trace=used / traces,
         alpha_rounds=aset.alpha_rounds, ms_per_sample=alpha_ms,
         mean=float(a_img.mean()), mean_96_cutout=means[0],
         mean_96_opaque=means[1], card_vs_cpu_96=res)

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
    reset_launches()
    loss, grads = grad_step(scene, camera, lights, gset, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches["grad"] = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["grad"] == {**dict.fromkeys(launches["grad"], 0),
                               "traverse_sweep": BOUNCES,
                               "traverse_sweep[emit_attrs]": BOUNCES},
          f"grad step launched {launches['grad']}, expected {BOUNCES} "
          "plain and emit")
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
         loss=float(loss), launches=launches["grad"], ms_per_step=step_ms,
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
    emit("grad_card_vs_cpu", size=[CPU_GRAD_SIZE] * 2,
         bounces=CPU_GRAD_BOUNCES,
         **grad_card_vs_cpu(scene, camera, lights, cset, scene_cpu))

    # 11.-15. PBR and glass, K1 on continuation and refracted rays, soft
    # edges, float textures and the debug views, on the PBR sphere
    pbr_phases(camera, lights, launches)

    # 9. the optimizer CLI: albedo and lights; then the PBR parameters
    for key, what, sc in (("optimize", ("albedo", "lights"), glb),
                          ("optimize_pbr", PBR_OPT, None)):
        if sc is None:
            sc = Path(tmp.name) / "smoke_pbr.glb"
            write_glb(sc, sphere_doc(pbr=True))
        res, launches[key] = run_optimizer(sc, Path(tmp.name) / key, what,
                                           env)
        emit(key, steps=OPT_STEPS, size=[128, 128], bounces=OPT_BOUNCES,
             optimize=list(what), **res, launches=launches[key])
    tmp.cleanup()

    # 10. the build cache: four fresh processes build, reload, die in
    # nvcc and rebuild the add_salt kernel; each reports its launches
    reload = repro_cache_hang.run(timeout=240.0)
    kids = {k["child"]: k for k in reload["children"]}
    emit("cache_reload", ok=reload["ok"], salt=reload["salt"],
         failures=reload["failures"],
         children={t: {key: k.get(key) for key in (
             "seconds", "built", "ok", "launches", "killed_during_nvcc",
             "hung", "load_seconds", "ms", "plain_ms")}
             for t, k in kids.items()})
    check(reload["ok"], f"cache reload: {reload['failures']}")
    launches["cache_reload"] = {"add_salt": sum(
        kids[t]["launches"] for t in ("A", "B", "D"))}

    prim = "primary"

    def bound(out_bytes, tables):  # the primary wave's work in one mode
        wk = sweep_work(counted[prim], cb.k, tables, out_bytes=out_bytes)
        b_s, by = bound_seconds(wk["ops"], wk["bytes"])
        return {"bound_ms": b_s * 1e3, "bound_by": by}

    a_kid = kids["A"]
    salt_bytes = 2 * 4 * 8 * 128
    salt_bound, salt_by = bound_seconds(8 * 128, salt_bytes)
    main = {"traverse_sweep": "grad", "traverse_sweep[emit_attrs]": "grad",
            "traverse_sweep[counters]": "kernel_counters",
            "traverse_pallas": "kernel_pallas", "add_salt": "cache_reload"}
    src = "dustraytracer_tpu_torch/csrc/"
    rows = [
        {"name": "traverse_sweep", "source": src + "traverse_sweep.cu",
         "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:98",
         "max_abs_err": max_err, "ms": results[prim]["kernel_ms"],
         "plain_ms": results[prim]["twin_ms"],
         **bound(nbytes(*plain_out[prim].values()), sweep_tables)},
        {"name": "traverse_sweep[emit_attrs]",
         "source": src + "traverse_sweep.cu",
         "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:347",
         "max_abs_err": emit_err, "ms": emit_res[prim]["kernel_emit_ms"],
         "plain_ms": emit_res[prim]["twin_emit_ms"],
         **bound(emit_bytes, sweep_tables
                 + nbytes(ts.device_attr_table(cb)))},
        {"name": "traverse_sweep[counters]",
         "source": src + "traverse_sweep.cu",
         "replaces": "dustraytracer_tpu/ops/traverse_sweep.py:392",
         "max_abs_err": count_err, "ms": count_res[prim]["kernel_count_ms"],
         "plain_ms": count_res[prim]["twin_count_ms"],
         "bound_ms": count_res[prim]["bound_ms"],
         "bound_by": count_res[prim]["bound_by"]},
        {"name": "traverse_pallas", "source": src + "traverse_pallas.cu",
         "replaces": "dustraytracer_tpu/ops/traverse_pallas.py:45",
         "max_abs_err": k2_err, "ms": k2_res[prim]["kernel_ms"],
         "plain_ms": k2_res[prim]["twin_ms"],
         "bound_ms": k2_res[prim]["bound_ms"],
         "bound_by": k2_res[prim]["bound_by"],
         "node_table": k2_cfg["shared"]["node_table"],
         "blocks_per_sm": k2_cfg["shared"]["blocks_per_sm"],
         "registers": pallas_regs["shared"]["registers"],
         "shared_bytes": k2_cfg["shared"]["shared_bytes"],
         "grid": k2_cfg["shared"]["grid"],
         "ms_by_wave": {w: r["kernel_ms"] for w, r in k2_res.items()},
         "instances": k2_inst, "tie_soup_ms_by_k": k2_tie_ms},
        {"name": "add_salt", "source": src + "add_salt.cu",
         "replaces": "tools/repro_cache_hang.py:52",
         "max_abs_err": a_kid["max_abs_err"], "ms": a_kid["ms"],
         "plain_ms": a_kid["plain_ms"], "bound_ms": salt_bound * 1e3,
         "bound_by": salt_by, "library_ms": a_kid["plain_ms"]}]
    by_wave = {
        "plain": {w: r["kernel_ms"] for w, r in results.items()},
        "emit_attrs": {w: r["kernel_emit_ms"] for w, r in emit_res.items()},
        "counters": {w: r["kernel_count_ms"] for w, r in count_res.items()}}
    for row in rows[:3]:
        inst = SWEEP_MODES[row["name"]]
        row.update(ms_by_wave=by_wave[inst], blocks_per_sm=occ[inst],
                   **sweep_regs[inst], tie_soup_ms_by_k=tie_ms[inst])
    for row in rows:
        kernel = row["name"]
        count = launches[main[kernel]].get(kernel, 0)
        check(count > 0, f"{kernel} was not launched on its path "
              f"{main[kernel]!r}")
        row.update(route="cuda", launches=count,
                   library_ms=row.get("library_ms"),
                   launches_by_path={p: c[kernel]
                                     for p, c in launches.items()
                                     if kernel in c})
    check([r["name"] for r in rows] == list(KERNELS), "kernel rows")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
