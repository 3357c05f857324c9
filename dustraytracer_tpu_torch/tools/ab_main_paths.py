"""Two checkouts' main paths, measured in turns on one card.

    python -m dustraytracer_tpu_torch.tools.ab_main_paths --other DIR \\
        [--turns 2] [--out FILE.json]

DIR is another checkout of the repository, for example a parent commit
unpacked with `git archive` into a git-ignored directory. Each
measurement runs in a fresh process, `turns` times in the order other,
this, this, other, then this, other, other, this, and so on, so both
trees see the same card and the same host in every position. A process
measures, on chip_smoke.py's 128x64 sphere and pose:

  kernel  the sweep kernel's device time on chip_smoke.py's five waves of
          262,144 sorted rays (`sweep_waves`; torch.profiler, mean of 10
          launches each): plain closest on the primary and the bounce
          wave, plain any-hit on the shadow wave, and emit_attrs on the
          primary and the bounce wave; and the base-threading kernel's
          (`traverse_cluster_pallas`) on the primary, bounce and shadow
          any-hit waves
  slice   render_progressive at 512x512, 4 bounces, 8 spp: ms per sample
          (CUDA events, median of 3 after a 1-spp warm-up)
  grad    the bench's gradient step at 512x512, 4 bounces
          (grad_bench.grad_step; median of 5 after a warm-up)

The measuring script goes to each process as source text that uses only
entry points both trees have (`traverse_cluster_sweep` with `anyhit`
and `emit_attrs`, `traverse_cluster_pallas` with `anyhit`). Prints one
JSON object: every run, and each side's median, min and max of every
metric.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def sweep_waves(scene, camera, lights, size: int) -> dict:
    """chip_smoke.py's three traversal waves on `scene` from `camera`, each
    of size * size rays sorted by ray_sort_key: "primary" (camera rays),
    "bounce" (from the primary hits in normal-random directions, 10% of
    the lanes parked at 3e37) and "shadow_anyhit" (from the primary hits
    toward a jittered sun; misses parked). Returns {name: (origin,
    direction, anyhit)}; numpy seed 1 makes the same waves in every
    tree whose kernel gives the same primary hits."""
    import numpy as np
    import torch

    from dustraytracer_tpu_torch.ops import traverse_sweep as ts
    from dustraytracer_tpu_torch.ops.rng import seed_pixels
    from dustraytracer_tpu_torch.render.integrator import ray_sort_key
    from dustraytracer_tpu_torch.scene.camera import generate_rays

    dev = scene.tri_pos.device
    ids = torch.arange(size * size, device=dev)
    _, o, d = generate_rays(camera, size, size, seed_pixels(ids, 0),
                            pixel_ids=ids)
    lo, hi = scene.node_min[0], scene.node_max[0]

    def sort(o, d):
        perm = torch.argsort(ray_sort_key(lo, hi, o, d), stable=True)
        return o[perm].contiguous(), d[perm].contiguous()

    o, d = sort(o, d)
    rng = np.random.default_rng(1)
    n = o.shape[0]
    prim = ts.traverse_cluster_sweep(scene.cluster, o, d)
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
    return {"primary": (o, d, False), "bounce": (bo, bd, False),
            "shadow_anyhit": (so, sd, True)}


CHILD = inspect.getsource(sweep_waves) + r'''
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dustraytracer_tpu_torch.ops import traverse_pallas as tp
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.render.film import render_progressive
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, grad_step,
                                                      median_ms, sphere_doc)

dev = torch.device("cuda")
scene = build_scene(sphere_doc()).to(dev)
cam = make_camera(**POSE, device=dev)
size, bounces, spp = 512, 4, 8
st = RenderSettings(bounces=bounces)
waves = sweep_waves(scene, cam, LightParams.from_settings(st, device=dev),
                    size)
res = {}
for key, wave, emit in (("plain_primary", "primary", False),
                        ("plain_bounce", "bounce", False),
                        ("plain_anyhit", "shadow_anyhit", False),
                        ("emit_primary", "primary", True),
                        ("emit_bounce", "bounce", True),
                        ("pallas_primary", "primary", None),
                        ("pallas_bounce", "bounce", None),
                        ("pallas_anyhit", "shadow_anyhit", None)):
    o, d, ah = waves[wave]
    if emit is None:  # the base-threading kernel
        stem = "traverse_pallas_kernel"
        run = lambda: tp.traverse_cluster_pallas(scene.cluster, o, d,
                                                 anyhit=ah)
    else:
        stem = "traverse_sweep_kernel"
        run = lambda: ts.traverse_cluster_sweep(scene.cluster, o, d,
                                                anyhit=ah, emit_attrs=emit)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if getattr(e, "device_type", None) == DeviceType.CUDA
          and stem in e.name]
    if len(us) != 10:
        raise RuntimeError(f"{key}: the profiler saw {len(us)} kernels")
    res[key + "_ms"] = sum(us) / 10 / 1e3
render_progressive(scene, cam, st, width=size, height=size, spp=1)
torch.cuda.synchronize()
slices = []
for _ in range(3):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    render_progressive(scene, cam, st, width=size, height=size, spp=spp)
    e1.record()
    torch.cuda.synchronize()
    slices.append(e0.elapsed_time(e1) / spp)
gset = RenderSettings(bounces=bounces, enable_tonemap=False,
                      enable_gamma=False)
lights = LightParams.from_settings(gset, device=dev)
step = median_ms(lambda: grad_step(scene, cam, lights, gset, size, size))
print(json.dumps({**res, "slice_ms_per_sample": sorted(slices)[1],
                  "grad_ms_per_step": step}))
'''

METRICS = ("plain_primary_ms", "plain_bounce_ms", "plain_anyhit_ms",
           "emit_primary_ms", "emit_bounce_ms", "pallas_primary_ms",
           "pallas_bounce_ms", "pallas_anyhit_ms", "slice_ms_per_sample",
           "grad_ms_per_step")


def measure_in(tree: Path, child: str, timeout: float = 600) -> dict:
    """Run the measuring source `child` in a fresh process with `tree` on
    its path; return the JSON object of its last line."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"measurement in {tree} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def in_turns(other: Path, measure, turns: int, metrics) -> dict:
    """measure(tree) in the order other, this, this, other, then this,
    other, other, this, ...; returns {"card", "other", "runs", "stats"}
    with each side's median, min and max of every metric."""
    trees = {"other": Path(other).resolve(), "this": ROOT}
    runs = []
    orders = (("other", "this", "this", "other"),
              ("this", "other", "other", "this"))
    for turn in range(turns):
        for side in orders[turn % 2]:
            rec = {"side": side, **measure(trees[side])}
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    stats = {}
    for side in trees:
        stats[side] = {}
        for m in metrics:
            vals = [r[m] for r in runs if r["side"] == side]
            stats[side][m] = {"median": statistics.median(vals),
                              "min": min(vals), "max": max(vals)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"card": smi, "other": str(trees["other"]), "runs": runs,
            "stats": stats}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.ab_main_paths")
    p.add_argument("--other", required=True, help="the other checkout")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--out", help="also write the JSON here")
    args = p.parse_args(argv)
    res = in_turns(args.other, lambda tree: measure_in(tree, CHILD),
                   args.turns, METRICS)
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
