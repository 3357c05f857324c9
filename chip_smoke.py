"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's forward render and gradient paths, every traversal
backend, the build cache, the tile-sharded render and train step, the
multi-process runtime, profiling, the viewer and the native BVH builder
(dustraytracer_tpu_torch) on a synthetic scene the size of a dense
bundled scene, generated from a seed:

  0. card      nvidia-smi name and power limit; fails without CUDA
  1. build     nvcc builds of csrc/traverse_sweep.cu, traverse_pallas.cu,
               add_salt.cu, peaks.cu and rows_grad.cu for sm_90a, started
               together; ptxas lines, and the registers of each instance
               of the sweep kernel, of the base-threading kernel, of the
               FMA peak kernel and of the row-fetch backward's eleven
               kernels (none may spill)
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
               finite and nonzero gradients, 2 x bounces K1 launches and
               2 x bounces - 1 of K4 (the row fetch's backward: the
               material rows of every bounce, the triangle rows of all
               but the last, whose hit attributes reach no loss), ms per
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

Phases 17-23 run on the bench sphere again, after phase 16:

 17. sharded   sharded_render_sample at 512x512 b4 on the meshes
               [cuda:0] and [cuda:0, cuda:0] (the scene replicated once;
               one warm-up sample captures the tiles' graph runners)
               against render_sample: max |diff| <= 1e-6 (and whether
               bit for bit), K1 launches per tile of a replayed sample,
               ms per sample of each and of the plain path (CUDA events,
               median of 5)
 18. sharded_train  the two-tile train step against the plain step
               (albedo, vertices, every light and camera field) at 48x48
               b2 within phase 8's tolerance; then ms per step, peak and
               step memory of the plain step, one tile and two tiles at
               512x512 b4, and their launches
 19. cli_devices  the render CLI and the optimizer self-test of phase 9
               with --devices 1, in subprocesses
 20. multihost two processes on the one card joined over gloo, each
               rendering its tile on cuda:0 (512x512 b4, 2 spp); rank 0's
               gathered image against the one-process two-tile render
               (atol 1e-5); seconds
 21. profiling trace() writes a Chrome trace of one sample with device
               kernels, and spans.json with the sample's drt.* spans
 22. viewer    the viewer's render thread and HTTP API on the card at
               256x256 b4: samples accumulate, /frame.png, a move and a
               settings change reset it; FrameStats' ms_avg
 23. native_bvh  the native BVH builder compiled here and loaded, its
               build of the sphere equal to the numpy builder's; seconds
               of both

Phase 24 measures the card and K1's speed of light (utils/roofline.py),
on the waves of phase 3:

 24. roofline  "peaks": the four measured ceilings (f32 and bf16 matmul,
               the FP32 rate by the FMA peak kernel csrc/peaks.cu, HBM)
               beside NVIDIA's figures, none above 105%, and the peak
               kernel against its float64 plain version within its
               rounding bound; "calibration": K1's rates per warp
               iteration, leaf iteration and served leaf from the chain
               scenes, with each chain's counters; "attribution", per
               wave: device ms by device_seconds_per_call beside phase
               3's torch.profiler ms (within 15% on the primary wave),
               sol_pct, sol_raw_pct (at most 170) and the window and leaf
               shares; "volume", per wave: the float64 replay of
               half the warps against the kernel's counters (visits equal
               on >= 99% of the rays, the window share within one point
               of the counters' on the same warps and of the whole
               wave's walk_useful_share), beside useful_share

Phases 25-26 run the device tuning tools (dustraytracer_tpu_torch/tools/)
on the bench sphere, in one fresh process:

 25. stages    tools/profile_stages.py at 512x512 b4: one line per stage
               (wall ms, device ms, idle share, the places that make the
               host wait for the card, the slope's device ms of the
               parts), the refit's share of the vertex step; the fwd+bwd
               step may not take less than the forward sample
 26. tuning    a short form of tools/retune_fetch.py, bench_anyhit_sort.py
               and bench_cluster_k.py, 3 alternating rounds: the kernel
               against the gather fetch (b2 sample, b4 step), each wave
               sorted against bare (bit for bit), K = 16, 32 and 64 (K1
               bit for bit with its twin on every wave); what each
               `auto` rule picks now and what these rounds would pick,
               asserting no winner

Phases 27-28 follow phase 8, on the bench sphere; phase 29 follows 26:

 27. rows      K4 (csrc/rows_grad.cu, the row fetch's deterministic
               backward) on the calls of one bench step, recorded, on the
               timed shapes (262,144 lanes into the 2 x 11 material table,
               the 16,130 x 19 triangle table and its 28-column
               smooth-normal variant with ~40% of the lanes on row 0, and
               a 256 x 256 float texel stack) and on edge shapes (one row,
               every lane on one row, the upper half of the rows empty,
               every row empty but the last, fewer lanes than a sort tile
               or a chunk, 600,000 lanes): within atol 2e-4 max|g|
               + rtol 2e-3 of the twin (index_add_ into zeros) and of its
               float64 run, two launches equal bit for bit, the plan
               kernels' perm / starts equal to the plain plan's, a strided
               cotangent equal to the contiguous one, no host sync under
               set_sync_debug_mode("error"), a CUDA-graph replay equal to
               an eager launch; the step must take both instances
               (plan-free and planned); device ms of the wrapper, of its
               kernels alone, of the twin and of the library's
               torch.index_add, kernels per call, the bound from bytes,
               resident blocks per SM of each kernel
 28. repeat    phase 7's step twice with the kernel fetch and twice with
               the gather fetch: loss and every gradient equal bit for bit
 29. bench     tools/bench.py in a fresh process (one JSON line, the bench
               step's rays/s), then tools/bench_scenes.py --configs
               cornell_256,suzanne_512 --sol-reps 1 into a temporary
               report, which tools/update_readme_perf.py renders into a
               temporary copy of README.md (the JAX table unchanged)

Each kernel's launch counts are set to 0 just before the path that runs
it and read just after. Each phase prints one JSON line. Device ms come
from torch.profiler (grad_bench.device_ms); where the profiler lost a
call's kernels in every try, that call was timed by CUDA events instead,
and the "timers" line names it. Then a {"kernels": [...]} line, the nvidia-smi line and, last, {"ok": true,
"device": {...}}. Any failure raises and exits non-zero before the last
line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
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
           "traverse_sweep[counters]", "traverse_pallas", "add_salt",
           "fma_peak", "rows_grad")
SWEEP_MODES = {"traverse_sweep": "plain",  # K1's rows -> instances
               "traverse_sweep[emit_attrs]": "emit_attrs",
               "traverse_sweep[counters]": "counters"}
# the instances' template arguments in the mangled kernel names
INSTANCE_OF = {"ILb0ELb0E": "plain", "ILb1ELb0E": "emit_attrs",
               "ILb0ELb1E": "counters"}
PALLAS_INSTANCE_OF = {"ILb1E": "shared", "ILb0E": "global"}
# K4's kernels (csrc/rows_grad.cu) by the mangled name's tail; the values
# are ops/rows.py::KERNELS
ROWS_INSTANCE_OF = {"histIl": "hist_i64", "histIi": "hist_i32",
                    "scan": "scan", "scatterIl": "scatter_i64",
                    "scatterIi": "scatter_i32", "starts": "starts",
                    "heads": "heads", "chunks": "chunks", "rows": "rows",
                    "tiles": "tiles", "tile_sum": "tile_sum"}
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
SHARD_GRAD_SIZE = 48
MULTIHOST_SPP = 2
VIEWER_SIZE = 256
WAIT_S = 120.0  # bound on every wait for a viewer or worker
VOLUME_WARPS = 4096  # warps of each 8,192-warp wave the replay walks
TUNING_ROUNDS = 3
TUNING_KS = (16, 32, 64)
# K4 launches of one 512x512 b4 step: the material rows of each bounce
# and the triangle rows of all but the last (tests/test_torch_rows.py
# counts the same structure on the CPU); with soft edges one triangle
# fetch more per bounce
STEP_ROWS = 2 * BOUNCES - 1
SOFT_STEP_ROWS = 3 * BOUNCES - 1
ROWS_LANES = 262_144
# K4's timed shapes (rows, columns, lanes, ids; chip_smoke.rows_inputs):
# the material table and the bench sphere's triangle table with ~40% of
# the lanes on row 0 (the clamped miss lanes), a 256 x 256 float texel
# stack, and the smooth-normal fetch's 28 columns
ROWS_CASES = {
    "material_2x11": (2, 11, ROWS_LANES, "miss_heavy"),
    "triangle_16130x19": (16130, 19, ROWS_LANES, "miss_heavy"),
    "texels_65536x4": (65536, 4, ROWS_LANES, "spread"),
    "normals_16130x28": (16130, 28, ROWS_LANES, "miss_heavy")}
# and its edge shapes, checked only: one row (plan-free, and planned with
# 100 columns), every lane on one row, the upper half of the rows empty
# (as the far side of the bench sphere), every row empty but the last,
# fewer lanes than one sort tile and than one chunk, and more sort blocks
# than the digit scan holds in registers (past 524,288 lanes)
ROWS_EDGE_CASES = {
    "one_row_1x4": (1, 4, ROWS_LANES, "spread"),
    "one_row_1x100": (1, 100, 4096, "spread"),
    "one_row_of_300x19": (300, 19, ROWS_LANES, "one_row"),
    "near_half_16130x19": (16130, 19, ROWS_LANES, "near_half"),
    "last_row_only_300x19": (300, 19, ROWS_LANES, "last_row_only"),
    "below_one_tile_300x19": (300, 19, 1000, "spread"),
    "below_one_chunk_70000x4": (70000, 4, 37, "spread"),
    "below_one_tile_2x11": (2, 11, 5, "spread"),
    "past_scan_registers_16130x4": (16130, 4, 600_000, "spread")}


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


# the launch counters (utils/profiling.py) by the kernel they count
LAUNCH_COUNTERS = {"traverse_sweep": "drt.launch.k1",
                   "traverse_sweep[emit_attrs]": "drt.launch.k1_emit",
                   "traverse_sweep[counters]": "drt.launch.k1_counters",
                   "traverse_pallas": "drt.launch.k2",
                   "fma_peak": "drt.launch.fma_peak",
                   "rows_grad": "drt.launch.k4"}


def reset_launches() -> None:
    from dustraytracer_tpu_torch.utils import profiling

    profiling.clear()


def read_launches() -> dict:
    """Launches since reset_launches(), by kernel (add_salt runs only in
    the cache-reload tool's child processes, which report their own)."""
    from dustraytracer_tpu_torch.utils import profiling

    got = profiling.counters("drt.launch.")
    return {k: got.get(name, 0) for k, name in LAUNCH_COUNTERS.items()}


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


def run_optimizer(glb: Path, out: Path, what, env, extra=()) -> tuple:
    """The optimizer CLI's self-test on `glb` in a subprocess: OPT_STEPS
    Adam steps on the parameters `what` at 128x128, OPT_BOUNCES bounces,
    with the options `extra`; the loss must fall, a checkpoint be written,
    and each step launch K1 once per bounce with emission and once
    without. Returns (results, launches)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.optimize",
         "--scene", str(glb), "--self-test", "--optimize", *what,
         "--size", "128x128", "--steps", str(OPT_STEPS),
         "--bounces", str(OPT_BOUNCES), "--checkpoint-every", "10",
         "--camera-pos", "0,1.5,5", "--look-at", "0,0.5,0", "--vfov", "45",
         "--out", str(out), *extra],
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
                                     "traverse_sweep": 3 * BOUNCES,
                                     "rows_grad": SOFT_STEP_ROWS},
          f"soft edges launched {launches['soft_edges']}, expected "
          f"{2 * BOUNCES} closest, {BOUNCES} any-hit and {SOFT_STEP_ROWS} "
          "rows_grad")
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


# one rank of the multihost phase: join the group, render its tiles on
# cuda:0, and save rank 0's gathered image
MULTIHOST_WORKER = """
import json, sys, time
import torch
from dustraytracer_tpu_torch.parallel.multihost import (initialize,
                                                        render_distributed)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import RenderSettings

coordinator, rank, scene, out, size, spp, bounces, pose = sys.argv[1:9]
rank, size = int(rank), int(size)
initialize(coordinator, num_processes=2, process_id=rank,
           initialization_timeout=120)
t0 = time.perf_counter()
img = render_distributed(scene, width=size, height=size, spp=int(spp),
                         settings=RenderSettings(bounces=int(bounces)),
                         camera=make_camera(**json.loads(pose)),
                         devices=[torch.device("cuda", 0)])
seconds = time.perf_counter() - t0
if rank == 0:
    import numpy as np
    np.save(out, img)
    print(json.dumps({"seconds": seconds}))
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grad_excess(got: dict, ref: dict) -> dict:
    """Each gradient's largest excess over phase 8's bound, atol 2e-4
    max|g| + rtol GRAD_RTOL of the reference's (<= 0 passes)."""
    out = {}
    for k, g in ref.items():
        bound = 2e-4 * float(g.abs().max()) + GRAD_RTOL * g.abs()
        out[k] = float(((got[k] - g).abs() - bound).max())
    return out


def port_phases(scene, camera, lights, glb: Path, tmp: Path, env,
                launches: dict) -> None:
    """The phases of the modules that run around the kernels: the
    tile-sharded render and train step, both CLIs with --devices, the
    two-process render, profiling, the viewer and the native BVH
    builder. Adds each path's K1 launches to `launches`."""
    from dustraytracer_tpu_torch.accel import bvh
    from dustraytracer_tpu_torch.accel.native import build as native
    from dustraytracer_tpu_torch.apps.viewer import ViewerState, make_handler
    from dustraytracer_tpu_torch.parallel.mesh import (make_render_mesh,
                                                       replicate_scene)
    from dustraytracer_tpu_torch.parallel.shard import (apply_params,
                                                        map_params,
                                                        sharded_render_sample,
                                                        sharded_train_step)
    from dustraytracer_tpu_torch.render.integrator import render_sample
    from dustraytracer_tpu_torch.scene.scene import load_scene
    from dustraytracer_tpu_torch.scene.settings import RenderSettings
    from dustraytracer_tpu_torch.tools.grad_bench import (POSE, median_ms,
                                                          sphere_doc)
    from dustraytracer_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda", 0)
    no_kernel = dict.fromkeys(read_launches(), 0)
    meshes = {t: make_render_mesh(devices=[dev] * t) for t in (1, 2)}

    def per_tile(tiles, n=BOUNCES):
        return {**no_kernel, "traverse_sweep": n * tiles,
                "traverse_sweep[emit_attrs]": n * tiles}

    # sharded: 1 and 2 tiles against the plain sample, the same pixels
    st = RenderSettings(bounces=BOUNCES)

    def plain():
        with torch.inference_mode():
            return render_sample(scene, camera, lights, 1, width=WIDTH,
                                 height=HEIGHT, settings=st)

    ref = plain()
    res = {"plain_ms_per_sample": median_ms(plain)}
    for tiles, mesh in meshes.items():
        reps = replicate_scene(scene, mesh)
        check(all(r is scene for r in reps), "replicate_scene copied the "
              "scene onto its own card")

        def tiled(reps=reps, mesh=mesh):
            with torch.inference_mode():
                return sharded_render_sample(reps, camera, lights, 1,
                                             mesh=mesh, width=WIDTH,
                                             height=HEIGHT, settings=st)

        tiled()  # warm-up: captures the tiles' graph runners, whose
        torch.cuda.synchronize()  # eager warm-up sample counts launches
        reset_launches()
        out = tiled()
        torch.cuda.synchronize()
        got = read_launches()
        launches[f"sharded_{tiles}"] = got
        check(got == per_tile(tiles), f"sharded {tiles} tiles launched {got}")
        diff = float((out - ref).abs().max())
        check(diff <= 1e-6, f"sharded {tiles} tiles: max |diff| {diff}")
        res[f"tiles_{tiles}"] = {
            "max_abs_diff": diff, "bitwise_equal": bool(torch.equal(out, ref)),
            "ms_per_sample": median_ms(tiled), "launches": got,
            "k1_launches_per_tile": {k: v // tiles for k, v in got.items()}}
    emit("sharded", size=[WIDTH, HEIGHT], bounces=BOUNCES, **res)

    # sharded_train: the two-tile step against the plain step at 48² b2
    # (phase 8's tolerance), then ms and peak memory at 512² b4
    def params_of(sc):
        return {"mat_albedo": sc.mat_albedo, "tri_pos": sc.tri_pos,
                "lights": lights, "camera": camera}

    def plain_step(params, target, w, h, stt, lr):
        leaves = map_params(lambda t: t.detach().requires_grad_(True),
                            params)
        sc, cam, li = apply_params(scene, camera, lights, leaves)
        img = render_sample(sc, cam, li, 0, width=w, height=h, settings=stt)
        loss = ((img - target) ** 2).sum() / (w * h)
        loss.backward()
        return map_params(lambda t: t.detach() if t.grad is None
                          else (t - lr * t.grad).detach(),
                          leaves), loss.detach()

    def flat_grads(params, new):  # lr = 1: g = p - p1
        out = {}
        for k, v in params.items():
            if k in ("lights", "camera"):
                for f in dataclasses.fields(v):
                    out[f"{k}.{f.name}"] = (getattr(v, f.name)
                                            - getattr(new[k], f.name))
            else:
                out[k] = v - new[k]
        return out

    gs = SHARD_GRAD_SIZE
    gset = RenderSettings(bounces=CPU_GRAD_BOUNCES, enable_tonemap=False,
                          enable_gamma=False)
    tgt = torch.zeros((gs, gs, 3), device=dev)
    p_ref, loss_ref = plain_step(params_of(scene), tgt, gs, gs, gset, 1.0)
    p_two, loss_two = sharded_train_step(
        params_of(scene), scene, camera, lights, tgt, 0, 1.0,
        mesh=meshes[2], width=gs, height=gs, settings=gset)
    g_ref = flat_grads(params_of(scene), p_ref)
    g_two = flat_grads(params_of(scene), p_two)
    rel = abs(float(loss_two) - float(loss_ref)) / abs(float(loss_ref))
    excess = grad_excess(g_two, g_ref)
    check(rel <= LOSS_RTOL, f"sharded train: loss rel diff {rel}")
    check(all(e <= 0.0 for e in excess.values()),
          f"sharded train: gradients beyond tolerance by {excess}")
    max_rel = {k: float(((g_two[k] - g).abs()).max()
                        / max(float(g.abs().max()), 1e-30))
               for k, g in g_ref.items()}
    res = {"small": {"size": [gs, gs], "bounces": CPU_GRAD_BOUNCES,
                     "loss_plain": float(loss_ref), "loss_2_tiles":
                     float(loss_two), "loss_rel_diff": rel,
                     "grad_max_diff_over_max_abs": max_rel,
                     "max_excess_over_tol": excess}}
    tset = RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                          enable_gamma=False)
    target = ref.clone() * 0.5  # outside inference mode: a plain tensor
    steps = {"plain": lambda: plain_step(params_of(scene), target, WIDTH,
                                         HEIGHT, tset, 1e-4)}
    for tiles, mesh in meshes.items():
        steps[f"tiles_{tiles}"] = (
            lambda mesh=mesh: sharded_train_step(
                params_of(scene), scene, camera, lights, target, 0, 1e-4,
                mesh=mesh, width=WIDTH, height=HEIGHT, settings=tset))
    for name, fn in steps.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        _, loss = fn()
        torch.cuda.synchronize()
        got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        tiles = int(name.split("_")[1]) if name != "plain" else 1
        if name == "plain":  # K4 per tile: one step's row fetches
            step_rows = got["rows_grad"]
            check(step_rows > 0, f"train step {name} launched {got}")
        check(got == {**per_tile(tiles), "rows_grad": tiles * step_rows},
              f"train step {name} launched {got}")
        check(bool(torch.isfinite(loss)), f"train step {name}: loss {loss}")
        launches[f"sharded_train_{name}"] = got
        res[name] = {"ms_per_step": median_ms(fn), "loss": float(loss),
                     "peak_mem_gib": peak / 2 ** 30,
                     "step_mem_gib": (peak - base) / 2 ** 30,
                     "launches": got}
    emit("sharded_train", size=[WIDTH, HEIGHT], bounces=BOUNCES, **res)

    # cli_devices: both CLIs with --devices 1 in subprocesses
    png = tmp / "devices1.png"
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli",
         "render", "--scene", str(glb), "--size", "256x256", "--spp", "4",
         "--bounces", "4", "--camera-pos", "0,1.5,5",
         "--look-at", "0,0.5,0", "--vfov", "45", "--devices", "1",
         "--out", str(png)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"CLI --devices 1 rc {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    metrics = json.loads(proc.stdout)
    check(metrics["devices"] == 1 and png.read_bytes()[:4] == b"\x89PNG",
          f"CLI --devices 1: {metrics}")
    opt, launches["optimize_devices"] = run_optimizer(
        glb, tmp / "opt_devices", ("albedo", "lights"), env,
        extra=("--devices", "1"))
    emit("cli_devices", render={k: metrics[k] for k in (
        "devices", "size", "spp", "render_seconds", "samples_per_second")},
        optimize=opt, launches=launches["optimize_devices"])

    # multihost: two processes on the one card over gloo
    out = tmp / "multihost.npy"
    coordinator = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, coordinator, str(rank),
         str(glb), str(out), str(WIDTH), str(MULTIHOST_SPP), str(BOUNCES),
         json.dumps(POSE)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"multihost rcs {rcs}:\n" + "\n---\n".join(
        o[1][-3000:] for o in outs))
    got = torch.from_numpy(np.load(out))
    glb_scene = load_scene(str(glb)).to(dev)  # the workers' scene
    with torch.inference_mode():
        want = sum(sharded_render_sample(glb_scene, camera, lights, f,
                                         mesh=meshes[2], width=WIDTH,
                                         height=HEIGHT, settings=st)
                   for f in range(MULTIHOST_SPP)) / MULTIHOST_SPP
    diff = float((got - want.cpu()).abs().max())
    check(diff <= 1e-5, f"multihost vs one process: max |diff| {diff}")
    emit("multihost", processes=2, size=[WIDTH, HEIGHT], bounces=BOUNCES,
         spp=MULTIHOST_SPP, max_abs_diff=diff, wall_seconds=wall,
         rank0_render_seconds=json.loads(outs[0][0])["seconds"])

    # profiling: a trace of one sample holds device kernels and the
    # program's spans. The profiler has lost a whole window's kernels in
    # some processes (grad_bench.device_ms): a trace without one is taken
    # again, twice
    for tries in range(1, 4):
        with trace(str(tmp / "trace")):
            plain()
            torch.cuda.synchronize()
        events = json.loads((tmp / "trace" / "trace.json").read_text())
        kernels = sum(1 for ev in events["traceEvents"]
                      if ev.get("cat") == "kernel")
        if kernels:
            break
    check(kernels > 0, f"trace holds no device kernel in {tries} tries")
    totals = json.loads((tmp / "trace" / "spans.json").read_text())["totals"]
    check({"drt.sample", "drt.raygen", "drt.b0.trace"} <= set(totals),
          f"spans.json lacks the sample's spans: {sorted(totals)}")
    emit("profiling", trace_kernels=kernels, trace_tries=tries,
         span_ms={k: v["total_ms"] for k, v in sorted(totals.items())})

    # viewer: the API roundtrip on the card
    vs = VIEWER_SIZE
    state = ViewerState(scene, camera, RenderSettings(bounces=BOUNCES),
                        width=vs, height=vs, speed=0.05)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state,
                                                             ["night"]))
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    threads = [threading.Thread(target=state.run, daemon=True),
               threading.Thread(target=srv.serve_forever, daemon=True)]
    reset_launches()
    for t in threads:
        t.start()

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    def post(cmd):
        req = urllib.request.Request(url + "/api",
                                     data=json.dumps(cmd).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def wait_samples(n):
        deadline = time.monotonic() + WAIT_S
        while True:
            snap = json.loads(get("/state"))
            if snap["samples"] >= n or time.monotonic() > deadline:
                return snap
            time.sleep(0.05)

    try:
        first = wait_samples(4)
        check(first["samples"] >= 4, f"viewer: {first['samples']} samples")
        frame = get("/frame.png")
        check(frame[:8] == b"\x89PNG\r\n\x1a\n"
              and struct.unpack(">II", frame[16:24]) == (vs, vs),
              "viewer: /frame.png is no PNG of the frame's size")
        post({"move": [0, 0, 1]})
        post({"set": {"bounces": 2}})
        after = wait_samples(2)
        check(after["samples"] >= 2 and after["settings"]["bounces"] == 2,
              f"viewer after a change: {after['samples']} samples")
    finally:
        state.running = False
        srv.shutdown()
        srv.server_close()
        for t in threads:
            t.join(timeout=WAIT_S)
    torch.cuda.synchronize()
    launches["viewer"] = read_launches()
    check(not any(t.is_alive() for t in threads), "viewer threads alive")
    check(launches["viewer"]["traverse_sweep"] > 0,
          f"viewer launched {launches['viewer']}")
    emit("viewer", size=[vs, vs], ms_avg=after["freq"]["ms_avg"],
         freq=after["freq"], sample_ms=after["sample_ms"],
         samples=after["samples"], launches=launches["viewer"])

    # native_bvh: the C++ builder built here and loaded, equal to numpy's
    rec = native.load_library()
    tris = np.concatenate([p.positions for _, prims in sphere_doc().meshes
                           for p in prims])
    t0 = time.perf_counter()
    nat = native.build_bvh_native(tris, 8, 16)
    native_s = time.perf_counter() - t0
    check(nat is not None, "native builder refused the sphere")
    t0 = time.perf_counter()
    ref_b = bvh._build_bvh_numpy(tris, 8, 16)
    numpy_s = time.perf_counter() - t0
    for key in ("perm", "node_left", "node_right", "node_count"):
        check(np.array_equal(getattr(nat, key), getattr(ref_b, key)),
              f"native {key} differs from numpy's")
    m = nat.n_nodes  # rows past it are padding (+-inf)
    box = max(float(np.abs(nat.node_min[:m] - ref_b.node_min[:m]).max()),
              float(np.abs(nat.node_max[:m] - ref_b.node_max[:m]).max()))
    check(np.allclose(nat.node_min, ref_b.node_min, rtol=1e-6)
          and np.allclose(nat.node_max, ref_b.node_max, rtol=1e-6),
          f"native boxes differ from numpy's by {box}")
    emit("native_bvh", library=Path(rec["path"]).name, built=rec["built"],
         compile_seconds=rec["seconds"], triangles=int(tris.shape[0]),
         nodes=nat.n_nodes, native_seconds=native_s, numpy_seconds=numpy_s,
         max_abs_box_diff=box)


def roofline_phase(cb, waves, work, profiler_ms: dict,
                   launches: dict) -> dict:
    """24. The card's measured peaks, K1's calibrated rates, each wave's
    attribution at those rates and its replayed volume (utils/roofline.py).
    `work` and `profiler_ms` are phase 3c's sweep_work and phase 3's
    torch.profiler device ms of each wave. Its path, for the FMA peak
    kernel's count, is measure_peaks. Returns the fma_peak row of the
    kernels line. It takes no torch.profiler trace of its own: late in
    this process the profiler lost sweep kernels' events (3 of 5, three
    profiles in a row)."""
    from dustraytracer_tpu_torch.ops import peaks as pk
    from dustraytracer_tpu_torch.tools.grad_bench import median_ms
    from dustraytracer_tpu_torch.utils import roofline as rl

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    reset_launches()
    peaks = rl.measure_peaks()
    torch.cuda.synchronize()
    launches["roofline"] = read_launches()
    check(launches["roofline"]["fma_peak"] > 0,
          f"measure_peaks launched {launches['roofline']}")
    # the FMA peak kernel against its plain version at the longer chain
    n, iters = pk.fill_threads(dev), rl.FMA_ITERS[1]
    x0 = torch.linspace(1.0, 1.25, n, device=dev)
    got = pk.fma_chain(x0, iters)
    ref = pk.fma_chain_reference(x0, iters)
    torch.cuda.synchronize()
    err = (got.double() - ref).abs()
    excess = float((err / pk.fma_tolerance(ref, iters)).max())
    check(excess <= 1.0, f"fma_peak: error {float(err.max())} is "
          f"{excess:.3f} of its rounding bound")
    fma_ms = 1e3 * rl.device_seconds_per_call(
        lambda _i: pk.fma_chain(x0, iters), n_lo=1, n_hi=5, strict=True)
    bound_s, bound_by = rl.bound_seconds(pk.fma_flops(n, iters), 8 * n)
    row = {"max_abs_err": float(err.max()), "ms": fma_ms,
           "plain_ms": median_ms(lambda: pk.fma_chain_reference(x0, iters),
                                 3),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": None}
    emit("peaks", device=peaks["device"], allow_tf32=peaks["allow_tf32"],
         measured={k: peaks[k] for k in rl.PUBLISHED},
         published=rl.PUBLISHED,
         pct_of_published={k: 100.0 * peaks[k] / v
                           for k, v in rl.PUBLISHED.items()},
         bf16_note="cuBLAS's rate on 2048^3 products, not the card's peak",
         fma_peak={**row, "threads": n, "iters": iters,
                   "err_over_bound": excess,
                   "tflops": pk.fma_flops(n, iters) / fma_ms / 1e9},
         launches=launches["roofline"])

    rates = rl.calibrate_sweep_rates(cb.k, cb.v0.shape[0])
    emit("calibration", **{k: rates[k] for k in (
        "window_ns", "leaf_iter_ns", "leaf_ns", "n_tiles",
        "leaf_iteration_ns")},
         chains={name: [{"m": c["m"], "ms": c["seconds"] * 1e3,
                         "W": c["exec_windows"], "E": c["exec_leafs"],
                         "S": c["leaf_tests"]} for c in runs]
                 for name, runs in rates["chains"].items()})

    for wave, (wo, wd, ah) in waves.items():
        att = rl.sweep_attribution(cb, wo, wd, rates, anyhit=ah)
        prof_ms = profiler_ms[wave]
        check(att["sol_raw_pct"] <= rl.SOL_CEILING_PCT, f"{wave}: {att}")
        ratio = att["measured_s"] * 1e3 / prof_ms
        check(wave != "primary" or abs(ratio - 1.0) <= 0.15,
              f"primary: device_seconds_per_call {att['measured_s']} s "
              f"against the profiler's {prof_ms} ms")
        emit("attribution", wave=wave, anyhit=ah,
             measured_ms=att["measured_s"] * 1e3, profiler_ms=prof_ms,
             measured_over_profiler=ratio,
             model_ms=att["model_s"] * 1e3,
             **{k: att[k] for k in (
                 "sol_pct", "sol_raw_pct", "window_share_pct",
                 "leaf_share_pct", "mrays_per_s", "sol_mrays_per_s",
                 "exec_windows", "exec_leafs", "leaf_tests",
                 "windows_per_tile", "leafs_per_tile",
                 "leaf_tests_per_tile")})
        vol = rl.volume_efficiency(cb, wo, wd, rates, max_tiles=VOLUME_WARPS,
                                   anyhit=ah)
        check(vol["visits_equal_pct"] >= 99.0,
              f"{wave}: replayed visits equal the kernel's on only "
              f"{vol['visits_equal_pct']:.2f}% of the sampled rays")
        gap = vol["vol_eff_window_pct"] - vol["kernel_window_pct"]
        check(abs(gap) <= 1.0, f"{wave}: replay's window share "
              f"{vol['vol_eff_window_pct']:.3f}% against the counters' "
              f"{vol['kernel_window_pct']:.3f}% on the same warps")
        wk = work[wave]
        gap = vol["vol_eff_window_pct"] - 100.0 * wk["walk_useful_share"]
        check(abs(gap) <= 1.0, f"{wave}: replay's window share "
              f"{vol['vol_eff_window_pct']:.3f}% against the whole wave's "
              f"walk_useful_share {wk['walk_useful_share']:.5f}")
        emit("volume", wave=wave, **vol,
             walk_useful_share_pct=100.0 * wk["walk_useful_share"],
             useful_share_pct=100.0 * wk["useful_share"],
             window_pct_minus_wave=gap,
             leaf_pct_minus_wave=vol["vol_eff_leaf_pct"]
             - 100.0 * wk["useful_share"])
    emit("roofline", seconds=time.perf_counter() - t_phase)
    return row


# argv: scene, size, bounces, rounds, comma-separated Ks
TOOLS_CHILD = r"""
import json
import sys
import time
import torch
from dustraytracer_tpu_torch.scene.settings import LightParams
from dustraytracer_tpu_torch.tools import (bench_anyhit_sort,
                                           bench_cluster_k, profile_stages,
                                           retune_fetch, tuning)
name, size, bounces, rounds = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), int(sys.argv[4]))
ks = [int(k) for k in sys.argv[5].split(",")]
dev = torch.device("cuda")
t0 = time.perf_counter()
scene, camera, label, _ = tuning.build(name, dev)
settings = profile_stages.settings_for(bounces, "reference", 0.0)
lights = LightParams.from_settings(settings, device=dev)
out = {"stages": profile_stages.measure(scene, camera, lights, settings,
                                        size, [], label)}
del scene
t1 = time.perf_counter()
rows = []
fetch = retune_fetch.measure([name], rounds, dev, rows)
kinds = bench_anyhit_sort.measure([name], size, rounds, dev, rows)
recs = bench_cluster_k.measure([name], ks, size, rounds, dev, rows,
                               twin=True)
out.update(rows=rows, fetch=retune_fetch.new_band(fetch),
           sort={i: bench_anyhit_sort.pick_sort(
               [k for k in kinds if k["closest_instance"] == i])
               for i in ("plain", "emit")},
           k=bench_cluster_k.pick_k(recs), stages_seconds=t1 - t0,
           tuning_seconds=time.perf_counter() - t1)
print(json.dumps(out))
"""


def tools_phases(scene, env) -> None:
    """25.-26. tools/profile_stages.py at 512x512 b4, then the short form
    of retune_fetch, bench_anyhit_sort and bench_cluster_k, on the bench
    sphere in one fresh process (its torch.profiler then sees every
    kernel).

    25. stages: one line per stage; the fwd+bwd step may not take less
    than the forward sample in wall or in device ms; the refit's share of
    the vertex step.
    26. tuning: TUNING_ROUNDS rounds, the kernel against the gather
    fetch, each wave sorted against bare (bit for bit, or the tool
    raises), K = TUNING_KS with K1 bit for bit against its twin on every
    wave; what each `auto` rule picks now and what these rounds would
    pick. It asserts correctness, never a winner."""
    from dustraytracer_tpu_torch.render.integrator import (AUTO_SORTED,
                                                           KERNEL_FETCH_BAND,
                                                           _resolve_fetch)
    from dustraytracer_tpu_torch.scene.scene import AUTO_CLUSTER_K
    from dustraytracer_tpu_torch.scene.settings import RenderSettings

    proc = subprocess.run(
        [sys.executable, "-c", TOOLS_CHILD, "16.1k", str(WIDTH),
         str(BOUNCES), str(TUNING_ROUNDS), ",".join(map(str, TUNING_KS))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"tools rc {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])

    rows = {r["stage"]: r for r in res["stages"]}
    for name, r in rows.items():
        emit("stages", stage=name, **{k: r.get(k) for k in (
            "wall_ms", "device_ms", "idle_pct", "syncs", "slope_ms")})
    fwd, step = rows["fwd"], rows["step_mat"]
    for key in ("wall_ms", "device_ms"):
        check(step[key] >= fwd[key], f"stages: the step's {key} "
              f"{step[key]} is below the forward sample's {fwd[key]}")
    emit("stages", size=[WIDTH, HEIGHT], bounces=BOUNCES,
         refit_share_of_vertex_step={
             k: rows["refit"][k] / rows["step_tri_pos"][k]
             for k in ("wall_ms", "device_ms")},
         seconds=res["stages_seconds"])

    for r in res["rows"]:
        if "twin_equal" in r:
            check(all(r["twin_equal"].values()),
                  f"tuning: K1 at K={r['k']} differs from its twin "
                  f"{r['twin_equal']}")
            emit("tuning", rule="cluster_k", k=r["k"],
                 cluster_nodes=r["cluster_nodes"],
                 build_seconds=r["build_seconds"], twin_equal=True,
                 **{m: r["step_weighted"][m] for m in ("wall", "device")})
        elif "wave" in r:
            check(r["equal_bit_for_bit"], f"tuning: sort {r}")
            emit("tuning", rule="ray_sort", wave=r["wave"],
                 instance=r["instance"], equal_bit_for_bit=True,
                 **{side: {m: r[side][m] for m in ("wall", "device")}
                    for side in ("sorted", "bare")})
        elif "kernel" in r:
            emit("tuning", rule="shade_fetch", scene=r["scene"],
                 **{f: {w: {m: r[f][w][m] for m in ("wall", "device",
                                                    "mem_mib")}
                        for w in ("sample", "step")}
                    for f in ("kernel", "gather")})
    check(sorted(r["k"] for r in res["rows"] if "twin_equal" in r)
          == sorted(TUNING_KS), "tuning: a K was not measured")
    emit("tuning", picks_now={
        "kernel_fetch_band": KERNEL_FETCH_BAND,
        "bench_sphere_fetch": _resolve_fetch(scene, RenderSettings()),
        "auto_sorted": list(AUTO_SORTED), "auto_cluster_k": AUTO_CLUSTER_K,
        "bench_sphere_k": scene.cluster.k},
        these_rounds_would_pick={
            "kernel_fetch_band": res["fetch"]["band"],
            "auto_sorted": {i: list(v["sorted"])
                            for i, v in res["sort"].items()},
            "auto_cluster_k": res["k"]["k"]},
        rounds=TUNING_ROUNDS, seconds=res["tuning_seconds"])


def rows_inputs(n_rows: int, cols: int, lanes: int, ids: str, seed: int):
    """A seeded K4 call on the card: ids "spread" uniform over the rows,
    "miss_heavy" ~40% on row 0 (the clamped miss lanes), "near_half" the
    same with the upper half of the rows empty, "one_row" all on
    the middle row, "last_row_only" every row empty but the last; a
    normal cotangent (lanes, cols) float32."""
    rng = np.random.default_rng(seed)
    if ids == "spread":
        idx = rng.integers(0, n_rows, lanes)
    elif ids == "miss_heavy":
        idx = np.where(rng.uniform(size=lanes) < 0.4, 0,
                       rng.integers(0, n_rows, lanes))
    elif ids == "near_half":  # the step's triangles: the far half unhit
        idx = np.where(rng.uniform(size=lanes) < 0.4, 0,
                       rng.integers(0, n_rows // 2, lanes))
    elif ids == "one_row":
        idx = np.full(lanes, n_rows // 2)
    else:
        idx = np.full(lanes, n_rows - 1)
    dev = torch.device("cuda")
    grad = torch.from_numpy(rng.normal(size=(lanes, cols))
                            .astype(np.float32)).to(dev)
    return grad, torch.from_numpy(idx.astype(np.int64)).to(dev), n_rows


def check_rows_kernel(grad, idx, n_rows) -> dict:
    """K4's checks on one call: the instance the shapes pick; for the
    planned one, the plan kernels' perm and starts equal to the plain
    plan's as integers; for the plan-free one, whether it equals its
    float32 replay bit for bit; within atol 2e-4 max|g| + rtol 2e-3 of the
    float32 twin and of its float64 run; two launches equal bit for bit;
    a column slice of a wider cotangent equal to the contiguous one; no
    host sync under set_sync_debug_mode("error"); a launch captured in a
    CUDA graph and replayed equal to an eager one. Raises on a failure."""
    from dustraytracer_tpu_torch.ops import rows as rw

    n, cols = grad.shape
    what = f"rows_grad {n} lanes into {n_rows} x {cols}"
    got = rw.rows_grad(grad, idx, n_rows)
    again = rw.rows_grad(grad, idx, n_rows)
    twin = rw.rows_grad_reference(grad, idx, n_rows)
    twin64 = rw.rows_grad_reference(grad.double(), idx, n_rows)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: two launches differ")
    res = {"lanes": n, "rows": n_rows, "cols": cols,
           "instance": "plan_free" if rw.is_small(n_rows, cols)
           else "planned"}
    for name, ref in (("twin", twin), ("twin_float64", twin64)):
        err = (got.double() - ref.double()).abs()
        bound = 2e-4 * float(ref.abs().max()) + GRAD_RTOL * ref.abs().double()
        check(bool((err <= bound).all()), f"{what}: beyond tolerance of "
              f"the {name} by {float((err - bound).max())}")
        res["max_abs_err" if name == "twin" else "max_abs_err_vs_float64"] \
            = float(err.max())
    if res["instance"] == "planned":
        perm, starts = rw.plan_kernel(idx, n_rows)
        want = rw.plan(idx, n_rows)
        check(torch.equal(perm, want[0]) and torch.equal(starts, want[1]),
              f"{what}: the plan kernels' perm / starts differ from the "
              "plain plan's")
        res["plan_equal"] = True
    else:
        replay = rw.rows_grad_small_replay(grad.cpu(), idx.cpu(), n_rows)
        res["replay_bit_equal"] = bool(torch.equal(got.cpu(), replay))
    wide = torch.zeros(n, cols + 3, device=grad.device)
    wide[:, 1:1 + cols] = grad
    check(torch.equal(rw.rows_grad(wide[:, 1:1 + cols], idx, n_rows), got),
          f"{what}: a strided cotangent differs from the contiguous one")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rw.rows_grad(grad, idx, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rw.rows_grad(grad, idx, n_rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rw.rows_grad(grad, idx, n_rows)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, got), f"{what}: the graph's replay differs "
          "from an eager launch")
    res.update(strided_equal=True, no_sync=True, graph_equal=True)
    return res


def _kernels_per_call(fn) -> int:
    """Device kernels of csrc/rows_grad.cu that one call of fn launches
    (torch.profiler; 0 where it lost the events)."""
    from torch.profiler import ProfilerActivity, profile

    from dustraytracer_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in profiling.device_ops(prof)
               if "rows_grad_" in e.name)


def _rows_case(grad, idx, n_rows) -> dict:
    """K4 on one call: check_rows_kernel's checks, then device ms of the
    wrapper (plan included), of its kernels alone, of the twin and of the
    library's torch.index_add, the kernels one call launches, and the
    bound from bytes."""
    from dustraytracer_tpu_torch.ops.rows import (rows_grad,
                                                  rows_grad_reference)
    from dustraytracer_tpu_torch.tools.grad_bench import device_ms
    from dustraytracer_tpu_torch.utils.roofline import bound_seconds, nbytes

    res = check_rows_kernel(grad, idx, n_rows)
    zeros = torch.zeros(n_rows, grad.shape[1], device=grad.device)
    cols = grad.shape[1]
    b_s, b_by = bound_seconds(grad.shape[0] * cols,
                              nbytes(grad, idx) + n_rows * cols * 4)
    run = lambda: rows_grad(grad, idx, n_rows)  # noqa: E731
    res.update(
        ms=device_ms(run), kernels_ms=device_ms(run, "rows_grad_"),
        kernels_per_call=_kernels_per_call(run),
        plain_ms=device_ms(lambda: rows_grad_reference(grad, idx, n_rows)),
        library_ms=device_ms(lambda: torch.index_add(zeros, 0, idx, grad)),
        bound_ms=b_s * 1e3, bound_by=b_by)
    return res


def rows_phase(scene, camera, lights, gset) -> dict:
    """27. K4 on the calls one bench step makes (recorded), on the stated
    shapes (timed) and on the edge shapes (checked). Returns the
    per-launch means over the step's calls."""
    from dustraytracer_tpu_torch.ops import rows as rw
    from dustraytracer_tpu_torch.tools.grad_bench import grad_step

    calls, orig = [], rw.rows_grad

    def record(grad, idx, n_rows):
        calls.append((grad.contiguous().clone(), idx.clone(), n_rows))
        return orig(grad, idx, n_rows)

    rw.rows_grad = record
    try:
        grad_step(scene, camera, lights, gset, WIDTH, HEIGHT)
    finally:
        rw.rows_grad = orig
    torch.cuda.synchronize()
    check(len(calls) == STEP_ROWS, f"rows: the step made {len(calls)} "
          f"row-fetch backward calls, expected {STEP_ROWS}")
    step = [_rows_case(*c) for c in calls]
    check(any(c["instance"] == "plan_free" for c in step)
          and any(c["instance"] == "planned" for c in step),
          "rows: the step's calls did not take both instances")
    shapes = {name: _rows_case(*rows_inputs(*case, seed=11 + i))
              for i, (name, case) in enumerate(ROWS_CASES.items())}
    edges = {name: check_rows_kernel(*rows_inputs(*case, seed=31 + i))
             for i, (name, case) in enumerate(ROWS_EDGE_CASES.items())}
    keys = ("ms", "kernels_ms", "plain_ms", "library_ms", "bound_ms")
    per_launch = {k: float(np.mean([c[k] for c in step])) for k in keys}
    per_launch.update(
        max_abs_err=max(c["max_abs_err"] for c in step + list(
            shapes.values()) + list(edges.values())),
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in step)
        else "operations",
        ms_per_step=sum(c["ms"] for c in step),
        plain_ms_per_step=sum(c["plain_ms"] for c in step),
        library_ms_per_step=sum(c["library_ms"] for c in step),
        bound_ms_per_step=sum(c["bound_ms"] for c in step),
        kernels_per_call={c["instance"]: c["kernels_per_call"] for c in step},
        ms_by_case={k: c["ms"] for k, c in shapes.items()},
        kernels_ms_by_case={k: c["kernels_ms"] for k, c in shapes.items()},
        bound_ms_by_case={k: c["bound_ms"] for k, c in shapes.items()},
        library_ms_by_case={k: c["library_ms"] for k, c in shapes.items()},
        instance_by_case={k: c["instance"] for k, c in {
            **shapes, **edges}.items()},
        blocks_per_sm=rw.occupancy())
    emit("rows", step_calls=step, shapes=shapes, edges=edges,
         per_launch=per_launch)
    return {"per_launch": per_launch}


def repeat_phase(scene, camera, lights, gset) -> None:
    """28. Phase 7's step twice with each fetch: equal bit for bit."""
    from dustraytracer_tpu_torch.tools.grad_bench import repeat_check

    res = {}
    for fetch in ("kernel", "gather"):
        rec = repeat_check(scene, camera, lights,
                           gset.replace(shade_fetch=fetch))
        unequal = [k for k, g in rec["grads"].items() if not g["equal"]]
        check(rec["loss_equal"] and not unequal,
              f"repeat {fetch}: loss equal {rec['loss_equal']}, gradients "
              f"not bit for bit: {unequal}")
        res[fetch] = rec
    emit("repeat", size=[WIDTH, HEIGHT], bounces=BOUNCES, **res)


def bench_phase(env) -> None:
    """29. tools/bench.py and a two-config tools/bench_scenes.py in fresh
    processes, and tools/update_readme_perf.py on a copy of README.md."""
    import shutil

    from dustraytracer_tpu_torch.tools import update_readme_perf

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"{args[0]} rc {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    out, bench_s = run("dustraytracer_tpu_torch.tools.bench")
    lines = out.strip().splitlines()
    check(len(lines) == 1, f"tools.bench printed {len(lines)} lines")
    res = json.loads(lines[0])
    check(res["metric"] == "rays_per_sec_chip_fwd_bwd"
          and res["vs_baseline"] is None and res["value"] > 0
          and 0.0 < res["idle_pct"] < 100.0
          and res["wave_order"] == "pixel"
          and all(res.get(k) is not None for k in (
              "ms_per_sample", "ms_per_sample_dispatched", "compile_s",
              "device_ms_per_sample", "sol_pct", "vol_eff_pct")),
          f"tools.bench line {res}")
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "bench_report_torch.json"
        _, scenes_s = run("dustraytracer_tpu_torch.tools.bench_scenes",
                          "--configs", "cornell_256,suzanne_512",
                          "--sol-reps", "1", "--out", str(report))
        rep = json.loads(report.read_text())
        by = {c["config"]: c for c in rep["configs"]}
        check(sorted(by) == ["cornell_256", "suzanne_512"]
              and all(c["fwdbwd_mrays_per_s"] > 0 for c in by.values())
              and "sol_pct" in by["suzanne_512"]
              and "sol_pct" not in by["cornell_256"],
              f"bench_scenes report {rep}")
        readme = Path(tmp) / "README.md"
        shutil.copy(ROOT / "README.md", readme)
        update_readme_perf.main(["--report", str(report), "--readme",
                                 str(readme)])
        text = readme.read_text()
        jax_table = (ROOT / "README.md").read_text().split(
            "<!-- BENCH_TABLE_END -->")[0]
        check(text.startswith(jax_table)
              and rep["nvidia_smi"] in text and "cornell_256" in text,
              "update_readme_perf: table or JAX part wrong")
    emit("bench", bench=res, bench_seconds=bench_s,
         bench_scenes=rep["configs"], bench_scenes_seconds=scenes_s)


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
                                                          PROFILER_MISSES,
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
    srcs = ("traverse_sweep", "traverse_pallas", "add_salt", "peaks",
            "rows_grad")
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
    peak_regs = instance_registers(recs["peaks"]["log"], "fma_peak_kernel",
                                   {"": "fma_peak"})
    rows_regs = instance_registers(recs["rows_grad"]["log"], "rows_grad_",
                                   ROWS_INSTANCE_OF)
    for src_name, regs, want in (
            ("traverse_sweep", sweep_regs, SWEEP_MODES.values()),
            ("traverse_pallas", pallas_regs, tp.NODE_TABLES),
            ("peaks", peak_regs, ("fma_peak",)),
            ("rows_grad", rows_regs, ROWS_INSTANCE_OF.values())):
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
                               "traverse_sweep[emit_attrs]": BOUNCES,
                               "rows_grad": STEP_ROWS},
          f"grad step launched {launches['grad']}, expected {BOUNCES} "
          f"plain and emit, {STEP_ROWS} rows_grad")
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

    # 27.-28. K4 against its twin on the step's own calls and the issue's
    # shapes; the step twice, bit for bit
    rows_res = rows_phase(scene, camera, lights, gset)
    repeat_phase(scene, camera, lights, gset)

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

    # 17.-23. the tile-sharded render and train step, the CLIs'
    # --devices, two processes, profiling, the viewer, the native builder
    port_phases(scene, camera, lights, glb, Path(tmp.name), env, launches)
    tmp.cleanup()

    # 24. the card's peaks, K1's calibrated speed of light and volume
    fma_row = roofline_phase(
        cb, waves, work, {w: r["kernel_ms"] for w, r in results.items()},
        launches)

    # 25.-26. the stage table and the tuning tools' short form
    tools_phases(scene, env)

    # 29. the benchmark harness: tools/bench.py, two configs of the sweep, the
    # README table
    bench_phase(env)

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
            "traverse_pallas": "kernel_pallas", "add_salt": "cache_reload",
            "fma_peak": "roofline", "rows_grad": "grad"}
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
         "bound_by": salt_by, "library_ms": a_kid["plain_ms"],
         "blocks_per_sm": a_kid["blocks_per_sm"]},
        {"name": "fma_peak", "source": src + "peaks.cu",
         "replaces": "dustraytracer_tpu/utils/roofline.py:413",
         **fma_row, "registers": peak_regs["fma_peak"]["registers"]},
        {"name": "rows_grad", "source": src + "rows_grad.cu",
         "replaces": "dustraytracer_tpu/render/integrator.py:50",
         "also_replaces": "dustraytracer_tpu/render/texture.py:21",
         **rows_res["per_launch"],
         "registers": {k: r["registers"] for k, r in rows_regs.items()}}]
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
    emit("timers", profiler_misses=PROFILER_MISSES)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
