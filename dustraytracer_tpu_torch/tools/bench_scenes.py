"""The port's scene sweep (counterpart of the repository's bench_scenes.py):
the five configurations of the JAX sweep, forward-only and fwd+bwd with
respect to albedo, with the kernel-fetch variant where the JAX sweep runs
it, and K1's calibrated speed of light and volume efficiency on each
cluster-BVH scene; one report JSON.

    python -m dustraytracer_tpu_torch.tools.bench_scenes
        [--out results/bench_report_torch.json] [--configs a,b]
        [--merge] [--skip-sol] [--sol-reps 5] [--skip-readme]
        [--models DIR] [--cpu]

Scenes. The reference models are not in the repository, so each
configuration runs on a seeded stand-in of its triangle count at the
bench pose (STAND_INS: grad_bench.sphere_doc, 2 n_lon (n_lat - 1) + 2
triangles), and its `scene` string says so. With --models DIR, a
configuration whose .glb exists under DIR loads it, with the JAX bench's
camera (tuning.CAMERAS).

Timing, on the card. ms per sample: host-clock seconds per call of
back-to-back calls ending in torch.cuda.synchronize (utils/roofline.py
delta_time_dispatch), what a user waits; where its median is not
positive (a call inside the timing noise) the reps grow, up to
MAX_REP_GROWTH times, and then it raises. *_dispatched: one call and
its synchronize. *_compile_s: the first call, kernel loads included.
device ms (torch.profiler, the summed kernels of one call; *_device_timer
names CUDA events instead where the profiler lost the kernels) and
idle_pct = 100 (1 - device / host) are the port's additions. With --cpu the
twins run on the CPU and every time is the CPU's host clock (no device
key is written); --cpu needs --skip-sol, since K1's attribution times
the card. Nothing is caught: a failure exits non-zero, and without
--cpu a missing card raises.

Speed of light (utils/roofline.py), per cluster-BVH scene past
brute_max_tris: the camera wave traced in pixel order, as the port's
integrator traces it (integrator.AUTO_SORTED is empty); --sol-reps
calibrations, each with sweep_attribution and volume_efficiency (which
replays its sampled warps in sorted order, by its own definition);
medians, with the inter-quartile range under "<key>_iqr".

After writing the default --out, the README's port table is rewritten
(tools/update_readme_perf.py) unless --skip-readme.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dustraytracer_tpu_torch.tools import tuning

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "results" / "bench_report_torch.json"
# (name, reference model, W, H, bounces, spp), bench_scenes.py:28-37
CONFIGS = [
    ("cornell_256", "cornell_box.glb", 256, 256, 2, 4),
    ("suzanne_512", "suzanne_plane.glb", 512, 512, 4, 2),
    ("dense_monkey_1k", "dense_monkey.glb", 1024, 1024, 2, 1),
    ("cs16_dust_512", "source/cs16_dust.glb", 512, 512, 2, 2),
    ("katana_512", "valorant_katana.glb", 512, 512, 2, 2),
]
# config -> (sphere_doc segments, what the stand-in leaves out); counts
# 34, 970, 16,130, 11,202 and 90,722 triangles
STAND_INS = {
    "cornell_256": ((8, 3), ""),
    "suzanne_512": ((22, 23), ""),
    "dense_monkey_1k": (tuning.STAND_INS["16.1k"], ""),
    "cs16_dust_512": (tuning.STAND_INS["11.2k"], "; one texture, not 23"),
    "katana_512": (tuning.STAND_INS["90.7k"], ""),
}
GRAD_WRT = ("mat_albedo",)
MAX_REP_GROWTH = 2  # times the reps are raised 4x on a non-positive median


def stand_in_triangles(n_lon: int, n_lat: int) -> int:
    """sphere_doc's triangle count: the sphere and the 2-triangle ground."""
    return 2 * n_lon * (n_lat - 1) + 2


def config_document(name: str, model: str, models: str | None):
    """(glTF document, camera pose, scene string) of a configuration: the
    .glb under `models` if it exists there, else the stand-in."""
    from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc

    if models and (Path(models) / model).is_file():
        doc, pose, _ = tuning.document(str(Path(models) / model))
        return doc, pose, model
    (n_lon, n_lat), note = STAND_INS[name]
    return (sphere_doc(n_lon, n_lat), POSE,
            f"sphere_doc({n_lon}, {n_lat}): stand-in for {model}, "
            f"{stand_in_triangles(n_lon, n_lat)} triangles{note}")


def time_dispatch(dispatch, reps: int, device) -> tuple:
    """(seconds per call, reps used) by delta_time_dispatch with a
    synchronize on the card (a no-op fence on the CPU). A non-positive
    median raises reps 4x, at most MAX_REP_GROWTH times; then the error
    stands."""
    from dustraytracer_tpu_torch.utils.roofline import delta_time_dispatch

    fence = (torch.cuda.synchronize if device.type == "cuda"
             else (lambda _out: None))
    for _ in range(MAX_REP_GROWTH):
        try:
            return delta_time_dispatch(dispatch, fence, reps=reps), reps
        except RuntimeError as err:
            if "non-positive delta timing" not in str(err):
                raise
            reps *= 4
    return delta_time_dispatch(dispatch, fence, reps=reps), reps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def measure(entry: dict, key: str, dispatch, reps: int, rays: int,
            device) -> None:
    """Fill entry's {key}_compile_s, _ms_per_sample, _mrays_per_s,
    _ms_per_sample_dispatched and, on the card, _device_ms_per_sample and
    _idle_pct for `dispatch` (one sample or step)."""
    t0 = time.perf_counter()
    dispatch()
    _sync(device)
    entry[f"{key}_compile_s"] = time.perf_counter() - t0
    dt, used = time_dispatch(dispatch, reps, device)
    entry[f"{key}_ms_per_sample"] = dt * 1e3
    entry[f"{key}_mrays_per_s"] = rays / dt / 1e6
    entry[f"{key}_reps"] = used
    t0 = time.perf_counter()
    dispatch()
    _sync(device)
    entry[f"{key}_ms_per_sample_dispatched"] = (time.perf_counter() - t0) * 1e3
    if device.type == "cuda":
        dev_ms, timer = tuning.profiled(dispatch, reps=1)
        entry[f"{key}_device_ms_per_sample"] = dev_ms
        entry[f"{key}_device_timer"] = timer
        entry[f"{key}_idle_pct"] = 100.0 * (1.0 - dev_ms / (dt * 1e3))


def camera_wave(scene, camera, w: int, h: int):
    """The sample's camera rays (frame 0) in pixel order."""
    from dustraytracer_tpu_torch.ops.rng import seed_pixels
    from dustraytracer_tpu_torch.scene.camera import generate_rays

    ids = torch.arange(w * h, device=scene.device)
    _, o, d = generate_rays(camera, w, h, seed_pixels(ids, 0),
                            pixel_ids=ids)
    return o.contiguous(), d.contiguous()


def sol_section(scene, camera, w: int, h: int, reps: int) -> dict:
    """K1 on the pixel-order camera wave: `reps` calibrations, each with
    its attribution and volume efficiency; medians (and IQRs when reps >
    1) under bench_scenes.py's keys."""
    from dustraytracer_tpu_torch.utils.roofline import (calibrate_sweep_rates,
                                                        sweep_attribution,
                                                        volume_efficiency)

    cb = scene.cluster
    o, d = camera_wave(scene, camera, w, h)
    attrs, rate_runs, vols = [], [], []
    for _ in range(reps):
        rates = calibrate_sweep_rates(k=cb.k, c_pad=cb.v0.shape[0])
        rate_runs.append(rates)
        attrs.append(sweep_attribution(cb, o, d, rates=rates))
        vols.append(volume_efficiency(cb, o, d, rates=rates))
    out = {"wave_order": "pixel", "sol_reps": reps,
           "exec_windows_per_tile": attrs[0]["windows_per_tile"],
           "exec_leafs_per_tile": attrs[0]["leafs_per_tile"]}

    def put(key, vals):
        q1, q2, q3 = np.percentile(np.asarray(vals, np.float64),
                                   [25, 50, 75])
        out[key] = float(q2)
        if reps > 1:
            out[key + "_iqr"] = float(q3 - q1)

    put("traversal_mrays_per_s", [a["mrays_per_s"] for a in attrs])
    put("sol_pct", [a["sol_pct"] for a in attrs])
    put("sol_raw_pct", [a["sol_raw_pct"] for a in attrs])
    put("kernel_window_ns", [r["window_ns"] for r in rate_runs])
    put("kernel_leaf_ns", [r["leaf_ns"] for r in rate_runs])
    put("leaf_share_pct", [a["leaf_share_pct"] for a in attrs])
    for key in ("vol_eff_pct", "vol_eff_window_pct", "vol_eff_leaf_pct"):
        put(key, [v[key] for v in vols])
    return out


def run_config(cfg, device, models, skip_sol: bool, sol_reps: int) -> dict:
    """One configuration's entry (bench_scenes.py:152-337's keys)."""
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           render_sample)
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.grad_bench import grad_step

    name, model, w, h, bounces, spp = cfg
    doc, pose, label = config_document(name, model, models)
    t0 = time.perf_counter()
    scene = build_scene(doc).to(device)
    build_s = time.perf_counter() - t0
    camera = make_camera(**pose, device=device)
    settings = RenderSettings(bounces=bounces, enable_tonemap=False,
                              enable_gamma=False)
    lights = LightParams.from_settings(settings, device=device)
    cb = scene.cluster
    entry = {"config": name, "scene": label, "size": [w, h],
             "bounces": bounces, "triangles": scene.n_tris,
             "bvh_nodes": cb.n_nodes if cb is not None else scene.n_nodes,
             "build_s": build_s,
             "shade_fetch_auto": _resolve_fetch(scene, settings)}
    rays = w * h * 2 * bounces
    reps = max(spp, 4)
    frame = [0]

    def fwd(st):
        def run():
            frame[0] += 1
            with torch.inference_mode():
                return render_sample(scene, camera, lights, frame[0],
                                     width=w, height=h, settings=st).sum()
        return run

    def step(st):
        def run():
            frame[0] += 1
            return grad_step(scene, camera, lights, st, w, h, wrt=GRAD_WRT,
                             frame=frame[0])
        return run

    measure(entry, "fwd", fwd(settings), reps, rays, device)
    measure(entry, "fwdbwd", step(settings), reps, rays, device)
    big = cb is not None and scene.n_tris > settings.brute_max_tris
    if big and cb.uv is not None:  # the in-kernel shading fetch
        kset = settings.replace(shade_fetch="kernel")
        measure(entry, "fwd_kernelfetch", fwd(kset), reps, rays, device)
        measure(entry, "fwdbwd_kernelfetch", step(kset), reps, rays, device)
    if big and not skip_sol:
        entry.update(sol_section(scene, camera, w, h, max(1, sol_reps)))
    return entry


def build_parser():
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.bench_scenes")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--cpu", action="store_true",
                   help="run the twins on the CPU (needs --skip-sol)")
    p.add_argument("--skip-sol", action="store_true")
    p.add_argument("--sol-reps", type=int, default=5,
                   help="calibration + attribution repeats; the sol and "
                   "volume keys are their medians, with IQR")
    p.add_argument("--configs", default="",
                   help="comma-separated config names to (re)run; the "
                   "others keep their entries from --out (implies --merge)")
    p.add_argument("--merge", action="store_true")
    p.add_argument("--skip-readme", action="store_true",
                   help="do not rewrite README's port table")
    p.add_argument("--models", help="a directory holding the reference "
                   ".glb files (default: seeded stand-ins)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.configs:
        args.merge = True
        known = {c[0] for c in CONFIGS}
        unknown = set(tuning.split_list(args.configs)) - known
        if unknown:
            p.error(f"unknown --configs names: {sorted(unknown)} "
                    f"(known: {sorted(known)})")
    if args.cpu and not args.skip_sol:
        p.error("--cpu needs --skip-sol: K1's attribution times the card")
    if args.cpu:
        device = torch.device("cpu")
        report = {"backend": "cpu", "device": "cpu", "nvidia_smi": None}
    else:
        tuning.require_cuda("bench_scenes")
        device = torch.device("cuda")
        report = {"backend": "cuda",
                  "device": torch.cuda.get_device_name(0),
                  "nvidia_smi": tuning.card_line()}
    report.update({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "timing": "host-clock ms per call of back-to-back calls ending in "
                  "a synchronize (utils/roofline.py delta_time_dispatch); "
                  "device ms by torch.profiler (or the *_device_timer "
                  "named); idle_pct = 100 (1 - device / host)",
        "configs": []})
    only = set(tuning.split_list(args.configs))
    prior = {}
    if args.merge and Path(args.out).exists():
        prior = {c["config"]: c
                 for c in json.loads(Path(args.out).read_text())["configs"]}
    for cfg in CONFIGS:
        if only and cfg[0] not in only:
            if cfg[0] in prior:
                report["configs"].append(prior[cfg[0]])
            continue
        entry = run_config(cfg, device, args.models, args.skip_sol,
                           args.sol_reps)
        report["configs"].append(entry)
        print(json.dumps(entry), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(f"wrote {args.out}", flush=True)
    if not args.skip_readme and \
            Path(args.out).resolve() == DEFAULT_OUT.resolve():
        from dustraytracer_tpu_torch.tools import update_readme_perf

        update_readme_perf.main([])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
