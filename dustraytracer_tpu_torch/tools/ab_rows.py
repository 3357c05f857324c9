"""K4 (the row fetch's backward, csrc/rows_grad.cu) in two checkouts,
measured in turns on one card.

    python -m dustraytracer_tpu_torch.tools.ab_rows --other DIR \\
        [--turns 2] [--out FILE.json]

DIR is another checkout of the repository, for example a parent commit
unpacked with `git archive` into a git-ignored directory. Each side runs
in fresh processes, in ab_main_paths.in_turns' order (other, this, this,
other, then this, other, other, this, ...). A measuring process, through
entry points both trees have (`ops/rows.py::rows_grad`,
`tools/profile_stages.py`'s stages, `tools/grad_bench.py`):

  <case>_ms, _kernels_ms  device ms per call of rows_grad at chip_smoke.py's
                          timed shapes (262,144 lanes: material 2 x 11 and
                          triangles 16,130 x 19 with ~40% of the lanes on
                          row 0, texels 65,536 x 4, normals 16,130 x 28),
                          the whole wrapper (plan included) and the
                          kernels named rows_grad_* alone (torch.profiler,
                          20 calls); _kernels_per_call (rows_grad_*) and
                          _device_kernels_per_call (every device kernel,
                          library calls of the plan included); _kernel_us,
                          each rows_grad_* kernel's device us per call;
                          _library_ms, one torch.index_add on the same
                          inputs
  step_rows_*             the calls one 512x512 b4 bench step makes on
                          the 16.1k sphere, recorded and replayed: mean ms
                          per launch, ms and kernels per step
  <stage>_device_ms, _wall_ms  profile_stages' step_mat, shade_hits_bwd,
                          fetch_bwd_albedo and fetch_bwd_texels
                          (torch.profiler; host-clock ms per call)

then, in a process of its own, tools/bench.py's line (rays/s, host and
device ms per step, idle share). Prints one JSON object: every run, and
each side's median, min and max of every metric.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from dustraytracer_tpu_torch.tools.ab_main_paths import in_turns, measure_in

CASES = {"material_2x11": (2, 11, 262_144, "miss_heavy"),
         "triangle_16130x19": (16130, 19, 262_144, "miss_heavy"),
         "texels_65536x4": (65536, 4, 262_144, "spread"),
         "normals_16130x28": (16130, 28, 262_144, "miss_heavy")}
STAGES = ("step_mat", "shade_hits_bwd", "fetch_bwd_albedo",
          "fetch_bwd_texels")
BENCH_KEYS = ("value", "ms_per_sample", "device_ms_per_sample", "idle_pct")

CHILD = r'''
import json
import re
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dustraytracer_tpu_torch.ops import rows as rw
from dustraytracer_tpu_torch.scene.settings import LightParams
from dustraytracer_tpu_torch.tools import profile_stages as ps
from dustraytracer_tpu_torch.tools import tuning
from dustraytracer_tpu_torch.tools.grad_bench import device_ms, grad_step

CASES, STAGES = %r, %r
dev = torch.device("cuda")


def inputs(n_rows, cols, lanes, ids, seed):
    rng = np.random.default_rng(seed)
    if ids == "spread":
        idx = rng.integers(0, n_rows, lanes)
    else:
        idx = np.where(rng.uniform(size=lanes) < 0.4, 0,
                       rng.integers(0, n_rows, lanes))
    grad = torch.from_numpy(rng.normal(size=(lanes, cols))
                            .astype(np.float32)).to(dev)
    return grad, torch.from_numpy(idx.astype(np.int64)).to(dev), n_rows


def kernels(fn, reps=5):
    """(name, us) of each device kernel of one call of fn, over reps."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # a record_function span's annotation on the device's timeline is no
    # kernel
    return [(e.name, e.time_range.elapsed_us() / reps) for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def per_call(fn, stem="rows_grad_"):
    return sum(1 for name, _ in kernels(fn, 1)
               if stem is None or stem in name)


def kernel_us(fn):
    """Device us per call of each rows_grad_* kernel, by its name after
    the stem (the last match: a mangled name holds the file's too)."""
    us = {}
    for name, t in kernels(fn):
        found = re.findall(r"rows_grad_([a-z_]+)", name)
        if found:
            us[found[-1]] = us.get(found[-1], 0.0) + t
    return us


res = {}
for i, (name, case) in enumerate(CASES.items()):
    grad, idx, n_rows = inputs(*case, seed=11 + i)
    run = lambda: rw.rows_grad(grad, idx, n_rows)
    zeros = torch.zeros(n_rows, grad.shape[1], device=dev)
    res[name + "_ms"] = device_ms(run, reps=20)
    res[name + "_kernels_ms"] = device_ms(run, "rows_grad_", reps=20)
    res[name + "_kernels_per_call"] = per_call(run)
    res[name + "_device_kernels_per_call"] = per_call(run, None)
    res[name + "_kernel_us"] = kernel_us(run)
    res[name + "_library_ms"] = device_ms(
        lambda: torch.index_add(zeros, 0, idx, grad), reps=20)
scene, camera, label, _ = tuning.build("16.1k", dev)
settings = ps.settings_for(4, "reference", 0.0)
lights = LightParams.from_settings(settings, device=dev)
calls, orig = [], rw.rows_grad


def record(grad, idx, n_rows):
    calls.append((grad.contiguous().clone(), idx.clone(), n_rows))
    return orig(grad, idx, n_rows)


rw.rows_grad = record
try:
    grad_step(scene, camera, lights, settings, 512, 512)
finally:
    rw.rows_grad = orig
torch.cuda.synchronize()
step = [device_ms(lambda c=c: rw.rows_grad(*c), reps=10) for c in calls]
res["step_calls"] = len(calls)
res["step_rows_ms_per_launch"] = sum(step) / len(step)
res["step_rows_ms"] = sum(step)
res["step_rows_kernels"] = sum(per_call(lambda c=c: rw.rows_grad(*c))
                               for c in calls)
res["step_rows_device_kernels"] = sum(
    per_call(lambda c=c: rw.rows_grad(*c), None) for c in calls)
fns = {**ps.whole_stages(scene, camera, lights, settings, 512),
       **ps.part_stages(scene, camera, lights, settings, 512)}
for name in STAGES:
    whole = name.startswith("step")
    res[name + "_device_ms"] = tuning.profiled_ms(fns[name],
                                                  reps=1 if whole else 4)
    res[name + "_wall_ms"] = tuning.dispatch_ms(fns[name], 2 if whole else 4)
print(json.dumps(res))
''' % (CASES, STAGES)

METRICS = tuple(
    [f"{c}_{k}" for c in CASES for k in (
        "ms", "kernels_ms", "kernels_per_call", "device_kernels_per_call",
        "library_ms")]
    + ["step_rows_ms_per_launch", "step_rows_ms", "step_rows_kernels",
       "step_rows_device_kernels"]
    + [f"{s}_{k}" for s in STAGES for k in ("device_ms", "wall_ms")]
    + [f"bench_{k}" for k in BENCH_KEYS])


def bench_line(tree: Path) -> dict:
    """tools/bench.py's line, run in `tree` in a process of its own."""
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.tools.bench"],
        cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"bench in {tree} failed:\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    return {f"bench_{k}": line[k] for k in BENCH_KEYS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dustraytracer_tpu_torch.tools.ab_rows")
    p.add_argument("--other", required=True, help="the other checkout")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--out", help="also write the JSON here")
    args = p.parse_args(argv)
    res = in_turns(args.other,
                   lambda tree: {**measure_in(tree, CHILD), **bench_line(tree)},
                   args.turns, METRICS)
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
