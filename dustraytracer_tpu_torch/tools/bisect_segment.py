"""One path segment, bisected into cumulative prefixes, on one CUDA card
(port of the JAX tool tools/bisect_segment.py).

    python -m dustraytracer_tpu_torch.tools.bisect_segment [--scene 16.1k]
        [--size 512] [--out FILE.json]

Each prefix is the previous one plus one more real piece of the
integrator's _segment at 1 bounce: raygen, trace (the closest tracer
_make_tracers picks, sort included), shade_hits (or the kernel fetch's
emitted attributes), albedo_sky, nee (the any-hit tracer and the sun)
and bounce (the diffuse direction). A prefix sums everything it computed
into one scalar, and runs under inference_mode. Each prefix is timed
whole: wall_ms, host-clock ms per call (delta_time_dispatch), and
device_ms, the summed device kernels per call (torch.profiler); the
deltas between consecutive prefixes are each piece's cost in place,
host dispatch included, which is what a host-bound eager step pays. The
last line times render_sample at 1 bounce for comparison. One JSON line
per prefix.
"""

from __future__ import annotations

import argparse

import torch

from dustraytracer_tpu_torch.tools import tuning

STOPS = ("raygen", "trace", "shade_hits", "albedo_sky", "nee", "bounce")
REPS = 4


def prefix(scene, camera, lights, settings, size: int, stop: str,
           frame: int = 0) -> torch.Tensor:
    """The segment up to and including `stop`, every value it computed
    summed into one float32 scalar (the JAX tool's `upto(stop)`).
    `settings` at 1 bounce; the fetch is resolved as render_pixels
    resolves it."""
    from dustraytracer_tpu_torch.ops.rng import (random_in_ball,
                                                 random_unit_vec3,
                                                 seed_pixels)
    from dustraytracer_tpu_torch.render.integrator import (
        _albedo, _fetch_material, _make_tracers, _resolve_fetch,
        _shade_from_kernel, _sky, shade_hits)
    from dustraytracer_tpu_torch.scene.camera import generate_rays

    if stop not in STOPS:
        raise ValueError(f"stop {stop!r} is none of {STOPS}")
    settings = settings.replace(shade_fetch=_resolve_fetch(scene, settings))
    closest, anyhit = _make_tracers(scene, settings)
    n = size * size
    ids = torch.arange(n, device=scene.device)
    acc = torch.zeros((), dtype=torch.float32, device=scene.device)
    rng = seed_pixels(ids, frame)
    rng, origin, direction = generate_rays(camera, size, size, rng,
                                           pixel_ids=ids)
    acc = acc + origin.sum() + direction.sum()
    if stop == "raygen":
        return acc
    res = closest(origin, direction)
    hit_idx = res["hit_idx"]
    acc = acc + (res["t"] * (res["t"] < 1e30)).sum() + hit_idx.sum()
    if stop == "trace":
        return acc
    if settings.shade_fetch == "kernel":
        sh = _shade_from_kernel(scene, origin, direction, hit_idx, res)
    else:
        sh = shade_hits(scene, origin, direction, hit_idx)
    acc = acc + sum(v.to(torch.float32).sum() for v in sh.values())
    if stop == "shade_hits":
        return acc
    matd = _fetch_material(scene, sh["material"])
    alb = _albedo(scene, matd, sh["uv"])
    hit = (hit_idx >= 0)[:, None]
    throughput = torch.where(hit, alb, 1.0)
    light = torch.where(~hit, _sky(direction, lights)
                        * lights.sky_intensity, 0.0)
    acc = acc + throughput.sum() + light.sum()
    if stop == "albedo_sky":
        return acc
    new_origin = sh["world_position"] + sh["normal"] * 1e-3
    rng, jit_vec = random_unit_vec3(rng)
    shadow_dir = lights.sun_position()[None, :] + jit_vec * 1.5
    occ = anyhit(torch.where(hit, new_origin, tuning.PARK), shadow_dir)
    sun_col = lights.sun_color * lights.sun_intensity
    light = light + torch.where(hit & ~occ[:, None],
                                sun_col[None, :] * throughput, 0.0)
    acc = acc + light.sum()
    if stop == "nee":
        return acc
    rng, ball = random_in_ball(rng)
    return acc + (sh["normal"] + ball).sum()


def measure(scene, camera, lights, settings, size: int, rows: list,
            label: str) -> list:
    from dustraytracer_tpu_torch.render.integrator import render_sample

    def run(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    prev = {"wall_ms": 0.0, "device_ms": 0.0}
    for stop in STOPS:
        call = run(lambda stop=stop: prefix(scene, camera, lights, settings,
                                            size, stop))
        rec = {"prefix": stop, "scene": label,
               "wall_ms": tuning.dispatch_ms(call, REPS),
               "device_ms": tuning.profiled_ms(call, reps=REPS)}
        rec.update({f"delta_{k}": rec[k] - prev[k] for k in prev})
        rec["idle_pct"] = 100.0 * (1.0 - rec["device_ms"] / rec["wall_ms"])
        prev = {k: rec[k] for k in prev}
        tuning.emit(rows, rec)
    full = run(lambda: render_sample(scene, camera, lights, 0, width=size,
                                     height=size, settings=settings))
    rec = {"prefix": "render_sample", "scene": label,
           "wall_ms": tuning.dispatch_ms(full, REPS),
           "device_ms": tuning.profiled_ms(full, reps=REPS)}
    rec["idle_pct"] = 100.0 * (1.0 - rec["device_ms"] / rec["wall_ms"])
    tuning.emit(rows, rec)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.bisect_segment")
    p.add_argument("--scene", default="16.1k")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", help="also write every row as JSON here")
    args = p.parse_args(argv)
    tuning.require_cuda("bisect_segment")
    from dustraytracer_tpu_torch.render.integrator import _resolve_fetch
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)

    dev = torch.device("cuda")
    rows = []
    tuning.emit(rows, tuning.header("bisect_segment"))
    scene, camera, label, _ = tuning.build(args.scene, dev)
    settings = RenderSettings(bounces=1, enable_tonemap=False,
                              enable_gamma=False)
    lights = LightParams.from_settings(settings, device=dev)
    tuning.emit(rows, {"scene": label, "triangles": scene.n_tris,
                       "size": args.size,
                       "shade_fetch": _resolve_fetch(scene, settings)})
    measure(scene, camera, lights, settings, args.size, rows, label)
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
