"""The port's single-number benchmark (counterpart of the repository's
bench.py): rays per second through the fwd+bwd gradient step on one CUDA
card, and K1's calibrated speed of light on the step's camera wave.

    python -m dustraytracer_tpu_torch.tools.bench [--scene PATH.glb]

Prints ONE JSON line:
  {"metric": "rays_per_sec_chip_fwd_bwd", "value": N, "unit": "rays/s",
   "vs_baseline": null, ...}

Workload (bench.py:73-80): 512x512, 4 bounces with sun NEE (W·H·2·B
traced rays a step: the path segments and the shadow rays), tonemap and
gamma off, the mean image differentiated with respect to mat_albedo,
mat_emissive and every LightParams field (grad_bench.grad_step); the
frame index advances each step. Scene: suzanne_plane.glb is not in the
repository, so without --scene the step runs on its seeded stand-in of
the same 970 triangles (bench_scenes.STAND_INS, sphere_doc(22, 23)) at
bench.py's pose; `workload` names it. --scene takes a .glb (or a
tuning.STAND_INS name).

Keys (bench.py:144-198), plus the port's own:
  ms_per_sample             host-clock ms per step of back-to-back steps
                            ending in a synchronize (utils/roofline.py
                            delta_time_dispatch): what a user waits; the
                            value's denominator
  ms_per_sample_dispatched  DISPATCHED steps and one synchronize, per step
  compile_s                 seconds to the first gradient, kernel loads
                            (ops/cuda_build.py) included
  device_ms_per_sample      the summed device kernels of one step
                            (torch.profiler; "device_timer" names CUDA
                            events instead where the profiler lost the
                            kernels); idle_pct = 100 (1 - device / host)
  traversal_mrays_per_s ... vol_eff_leaf_pct   K1 on the step's camera
                            wave in pixel order (the port's integrator
                            sorts no wave: "wave_order"), priced at rates
                            calibrated on this card (calibrate_sweep_rates,
                            sweep_attribution, volume_efficiency)
  nvidia_smi                the card's name and power limit
vs_baseline is null: no baseline has been recorded on this card. Without
CUDA it raises before it measures or prints anything; nothing is caught.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dustraytracer_tpu_torch.tools import tuning

WIDTH = HEIGHT = 512
BOUNCES = 4
DISPATCH_REPS = 4  # delta_time_dispatch's R (bench.py:129)
DISPATCHED = 8     # steps behind one synchronize (bench.py:132-135)
PROFILED = 2       # steps under torch.profiler


def build(spec: str | None, dev):
    """(scene on dev, camera, scene string): `spec` as tuning.document
    takes it, or suzanne_plane's stand-in."""
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.tools.bench_scenes import config_document

    if spec is None:
        doc, pose, label = config_document("suzanne_512",
                                           "suzanne_plane.glb", None)
    else:
        doc, pose, label = tuning.document(spec)
    return build_scene(doc).to(dev), make_camera(**pose, device=dev), label


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dustraytracer_tpu_torch.tools.bench")
    p.add_argument("--scene", help="a .glb (default: the 970-triangle "
                   "stand-in of suzanne_plane.glb)")
    args = p.parse_args(argv)
    tuning.require_cuda("tools.bench")
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.bench_scenes import sol_section
    from dustraytracer_tpu_torch.tools.grad_bench import LIGHT_KEYS, grad_step
    from dustraytracer_tpu_torch.utils.roofline import delta_time_dispatch

    dev = torch.device("cuda")
    scene, camera, label = build(args.scene, dev)
    settings = RenderSettings(bounces=BOUNCES, enable_tonemap=False,
                              enable_gamma=False)
    lights = LightParams.from_settings(settings, device=dev)
    wrt = ("mat_albedo", "mat_emissive", *LIGHT_KEYS)
    frame = [0]

    def dispatch():
        frame[0] += 1
        return grad_step(scene, camera, lights, settings, WIDTH, HEIGHT,
                         wrt=wrt, frame=frame[0])

    t0 = time.perf_counter()
    dispatch()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    dt = delta_time_dispatch(dispatch, torch.cuda.synchronize,
                             reps=DISPATCH_REPS)
    t0 = time.perf_counter()
    for _ in range(DISPATCHED):
        dispatch()
    torch.cuda.synchronize()
    dt_disp = (time.perf_counter() - t0) / DISPATCHED
    dev_ms, dev_timer = tuning.profiled(dispatch, reps=PROFILED)

    rays = WIDTH * HEIGHT * 2 * BOUNCES
    result = {
        "metric": "rays_per_sec_chip_fwd_bwd",
        "value": rays / dt,
        "unit": "rays/s",
        "vs_baseline": None,
        "baseline": "none recorded on this card",
        "workload": f"{label} {WIDTH}x{HEIGHT} b{BOUNCES} fwd+bwd",
        "triangles": scene.n_tris,
        "ms_per_sample": dt * 1e3,
        "ms_per_sample_dispatched": dt_disp * 1e3,
        "compile_s": compile_s,
        "device_ms_per_sample": dev_ms,
        "device_timer": dev_timer,
        "idle_pct": 100.0 * (1.0 - dev_ms / (dt * 1e3)),
    }
    if scene.cluster is not None \
            and scene.n_tris > settings.brute_max_tris:
        sol = sol_section(scene, camera, WIDTH, HEIGHT, reps=1)
        result.update({k: v for k, v in sol.items() if k != "sol_reps"})
    result["nvidia_smi"] = tuning.card_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
