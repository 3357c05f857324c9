"""Two checkouts' main paths, measured in turns on one card.

    python -m dustraytracer_tpu_torch.tools.ab_main_paths --other DIR \\
        [--turns 2] [--out FILE.json]

DIR is another checkout of the repository, for example a parent commit
unpacked with `git archive` into a git-ignored directory. Each
measurement runs in a fresh process, `turns` times in the order other,
this, this, other, then this, other, other, this, and so on, so both
trees see the same card and the same host in every position. A process
measures, on chip_smoke.py's 128x64 sphere and pose:

  kernel  the plain sweep kernel's device time on the sorted 512x512
          primary wave (torch.profiler, mean of 10 launches)
  slice   render_progressive at 512x512, 4 bounces, 8 spp: ms per sample
          (CUDA events, median of 3 after a 1-spp warm-up)
  grad    the bench's gradient step at 512x512, 4 bounces
          (grad_bench.grad_step; median of 5 after a warm-up)

The measuring script goes to each process as source text that uses only
entry points both trees have. Prints one JSON object: every run, and
the median of each side.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CHILD = r'''
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.ops.rng import seed_pixels
from dustraytracer_tpu_torch.render.film import render_progressive
from dustraytracer_tpu_torch.render.integrator import ray_sort_key
from dustraytracer_tpu_torch.scene.camera import generate_rays, make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import LightParams, RenderSettings
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, grad_step,
                                                      median_ms, sphere_doc)

dev = torch.device("cuda")
scene = build_scene(sphere_doc()).to(dev)
cam = make_camera(**POSE, device=dev)
size, bounces, spp = 512, 4, 8
ids = torch.arange(size * size, device=dev)
_, o, d = generate_rays(cam, size, size, seed_pixels(ids, 0), pixel_ids=ids)
perm = torch.argsort(ray_sort_key(scene.node_min[0], scene.node_max[0], o, d),
                     stable=True)
o, d = o[perm].contiguous(), d[perm].contiguous()
run = lambda: ts.traverse_cluster_sweep(scene.cluster, o, d)
run()
torch.cuda.synchronize()
acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
with profile(activities=acts) as prof:
    for _ in range(10):
        run()
    torch.cuda.synchronize()
us = [e.time_range.elapsed_us() for e in prof.events()
      if getattr(e, "device_type", None) == DeviceType.CUDA
      and "traverse_sweep_kernel" in e.name]
st = RenderSettings(bounces=bounces)
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
print(json.dumps({"kernel_ms": sum(us) / 10 / 1e3,
                  "slice_ms_per_sample": sorted(slices)[1],
                  "grad_ms_per_step": step}))
'''

METRICS = ("kernel_ms", "slice_ms_per_sample", "grad_ms_per_step")


def _measure(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"measurement in {tree} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.ab_main_paths")
    p.add_argument("--other", required=True, help="the other checkout")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--out", help="also write the JSON here")
    args = p.parse_args(argv)
    trees = {"other": Path(args.other).resolve(), "this": ROOT}
    runs = []
    orders = (("other", "this", "this", "other"),
              ("this", "other", "other", "this"))
    for turn in range(args.turns):
        for side in orders[turn % 2]:
            rec = {"side": side, **_measure(trees[side])}
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    medians = {side: {m: statistics.median(r[m] for r in runs
                                           if r["side"] == side)
                      for m in METRICS} for side in trees}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"card": smi, "other": str(trees["other"]), "runs": runs,
           "medians": medians}
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
