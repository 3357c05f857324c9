"""The stage table of one sample on one CUDA card (port of the JAX tool
tools/profile_stages.py): forward and backward, whole and in parts.

    python -m dustraytracer_tpu_torch.tools.profile_stages [--scene 16.1k]
        [--size 512] [--bounces 4] [--shading reference|pbr]
        [--soft-edges X] [--out FILE.json]

--scene is a stand-in name of tools/tuning.py (the 16.1k default is
chip_smoke.py's bench sphere; with --shading pbr its PBR variant) or a
.glb path. --shading pbr and --soft-edges 0.05 are the settings of
chip_smoke.py's phases 11 and 13. At 1 bounce in reference shading the
image does not depend on the vertices, and step_tri_pos has nothing to
differentiate. One JSON line per stage:

  whole (wall_ms: host-clock ms per call of back-to-back calls,
  delta_time_dispatch; device_ms: summed device kernels per call,
  torch.profiler; idle_pct = 100 (1 - device / wall); syncs: the
  places where one call makes the host wait for the card, by
  torch.cuda.set_sync_debug_mode):
    fwd                  render_sample under inference_mode
    fwd_no_sun           the same without the sun's NEE
    fwd_fetch_<f>        the other applicable shade fetch
    fwd_b1, fwd_b2       1 and 2 bounces (fwd is --bounces)
    fwd_sort_on, _off    ray_sort "on" and "off" (fwd is "auto")
    step_mat             fwd+bwd to mat_albedo, mat_emissive and every
                         light field: the bench's step
    step_tri_pos         fwd+bwd to tri_pos, Scene.replace's refit inside
  parts (the same, and slope_ms: device ms per call by
  device_seconds_per_call, null where the slope stays inside the noise
  or the call syncs):
    refit                Scene.replace(tri_pos) and the kernel's table
                         packing, as the vertex step pays them
    raygen               PCG seeds and camera rays
    sort_leg             ray_sort_key, argsort and the two ray gathers
    unsort_leg           the scatter of the closest results to ray order
    k1_<kind>_<wave>     K1 on the primary and bounce waves in pixel
                         order, closest (in the fetch's emit mode) and
                         any-hit; with _sorted, on the same rays sorted
    sorted_<kind>_<wave> _sorted_tracers' composite: sort, K1, unsort
    shade_hits_fwd       shade_hits of the primary hits, every output
    shade_hits_bwd       its VJP to tri_pos
    fetch_fwd            material row and albedo texel fetch
    fetch_bwd_albedo     its VJP to mat_albedo
    fetch_bwd_texels     its VJP to the float texel stack
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from dustraytracer_tpu_torch.tools import tuning

WHOLE_REPS = 2   # delta_time_dispatch's R for a whole sample or step
PART_REPS = 4
PART_N_HI = 8    # device_seconds_per_call's n_hi for a part


def shade_sum(scene, o, d, hit):
    """Every output of shade_hits, summed (the JAX tool's sh_sum)."""
    from dustraytracer_tpu_torch.render.integrator import shade_hits

    return sum(v.to(torch.float32).sum()
               for v in shade_hits(scene, o, d, hit).values())


def shade_vjp(scene, o, d, hit):
    """d shade_sum / d tri_pos (no refit: shade_hits reads tri_pos only)."""
    tp = scene.tri_pos.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(
        shade_sum(dataclasses.replace(scene, tri_pos=tp), o, d, hit), tp)
    return g


def fetch_sum(scene, mats, uv):
    """The material row fetch and the albedo texel fetch, summed."""
    from dustraytracer_tpu_torch.render.integrator import (_albedo,
                                                           _fetch_material)

    return _albedo(scene, _fetch_material(scene, mats), uv).sum()


def fetch_vjp(scene, mats, uv):
    """(d fetch_sum / d mat_albedo, d fetch_sum / d tex_stack) on the
    float texel stack (decode_textures)."""
    from dustraytracer_tpu_torch.render.texture import decode_textures

    fs = decode_textures(scene)
    alb = fs.mat_albedo.detach().requires_grad_(True)
    tex = fs.tex_stack.detach().requires_grad_(True)
    return torch.autograd.grad(
        fetch_sum(dataclasses.replace(fs, mat_albedo=alb, tex_stack=tex),
                  mats, uv), (alb, tex))


def settings_for(bounces: int, shading: str, soft_edges: float):
    from dustraytracer_tpu_torch.scene.settings import RenderSettings

    return RenderSettings(bounces=bounces, enable_tonemap=False,
                          enable_gamma=False, shading=shading,
                          soft_edges=soft_edges)


def whole_stages(scene, camera, lights, settings, size: int) -> dict:
    """name -> fn() of the whole-sample and whole-step stages."""
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           render_sample)
    from dustraytracer_tpu_torch.scene.settings import LightParams
    from dustraytracer_tpu_torch.tools.grad_bench import (LIGHT_KEYS,
                                                          grad_step)

    def fwd(st, li=lights):
        def run():
            with torch.inference_mode():
                return render_sample(scene, camera, li, 0, width=size,
                                     height=size, settings=st)
        return run

    resolved = _resolve_fetch(scene, settings)
    nosun = settings.replace(enable_sunlight=False)
    out = {"fwd": fwd(settings),
           "fwd_no_sun": fwd(nosun, LightParams.from_settings(
               nosun, device=scene.device))}
    for f in ("gather", "kernel"):
        alt = settings.replace(shade_fetch=f)
        if f == resolved:
            continue
        try:
            _resolve_fetch(scene, alt)
        except ValueError:  # the kernel fetch does not apply here
            continue
        out[f"fwd_fetch_{f}"] = fwd(alt)
    for b in (1, 2):
        if b < settings.bounces:
            out[f"fwd_b{b}"] = fwd(settings.replace(bounces=b))
    for sort in ("on", "off"):
        out[f"fwd_sort_{sort}"] = fwd(settings.replace(ray_sort=sort))
    out["step_mat"] = lambda: grad_step(
        scene, camera, lights, settings, size, size,
        wrt=("mat_albedo", "mat_emissive", *LIGHT_KEYS))
    out["step_tri_pos"] = lambda: grad_step(scene, camera, lights, settings,
                                            size, size, wrt=("tri_pos",))
    return out


def part_stages(scene, camera, lights, settings, size: int) -> dict:
    """name -> fn() of the stages inside one sample, on the sample's own
    primary and bounce waves (tools/tuning.py's pixel_waves)."""
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts
    from dustraytracer_tpu_torch.ops.rng import seed_pixels
    from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                           _sorted_tracers,
                                                           shade_hits)
    from dustraytracer_tpu_torch.render.texture import decode_textures
    from dustraytracer_tpu_torch.scene.camera import generate_rays

    cb = scene.cluster
    dev = scene.device
    n = size * size
    emit = _resolve_fetch(scene, settings) == "kernel"
    ids = torch.arange(n, device=dev)
    waves = tuning.pixel_waves(scene, camera, lights, size)
    o, d = waves["primary"]

    def closest(oo, dd):
        return ts.traverse_cluster_sweep(cb, oo, dd, emit_attrs=emit)

    def anyhit(oo, dd):
        return ts.traverse_cluster_sweep(cb, oo, dd, anyhit=True)[
            "hit_idx"] >= 0

    s_closest, s_anyhit = _sorted_tracers(scene, closest, anyhit)
    perm = tuning.sort_perm(scene, o, d)
    res = closest(o[perm].contiguous(), d[perm].contiguous())

    def unsort():
        out = {}
        for key, val in res.items():
            out[key] = torch.empty_like(val)
            out[key][perm] = val
        return out

    hit = unsort()["hit_idx"]
    with torch.no_grad():
        sh = shade_hits(scene, o, d, hit)
    mats, uv = sh["material"], sh["uv"]
    fscene = decode_textures(scene)

    def refit():
        new = scene.replace(tri_pos=scene.tri_pos.clone())
        ts.device_tables(new.cluster)
        if emit:
            ts.device_attr_table(new.cluster)
        return new

    def sort_leg():
        p = tuning.sort_perm(scene, o, d)
        return o[p], d[p]

    out = {"refit": refit,
           "raygen": lambda: generate_rays(camera, size, size,
                                           seed_pixels(ids, 0),
                                           pixel_ids=ids),
           "sort_leg": sort_leg, "unsort_leg": unsort}
    mode = "emit" if emit else "closest"
    for wave in ("primary", "bounce"):
        wo, wd = waves[wave]
        so, sd = tuning.sort_rays(scene, wo, wd)
        for kind, bare, comp in ((mode, closest, s_closest),
                                 ("anyhit", anyhit, s_anyhit)):
            out[f"k1_{kind}_{wave}"] = lambda f=bare, o=wo, d=wd: f(o, d)
            out[f"k1_{kind}_{wave}_sorted"] = lambda f=bare: f(so, sd)
            out[f"sorted_{kind}_{wave}"] = lambda f=comp, o=wo, d=wd: f(o, d)

    def under_no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    out = {k: under_no_grad(f) for k, f in out.items()}
    out["shade_hits_fwd"] = under_no_grad(lambda: shade_sum(scene, o, d,
                                                            hit))
    out["shade_hits_bwd"] = lambda: shade_vjp(scene, o, d, hit)
    out["fetch_fwd"] = under_no_grad(lambda: fetch_sum(scene, mats, uv))
    alb = fscene.mat_albedo.detach().requires_grad_(True)
    tex = fscene.tex_stack.detach().requires_grad_(True)

    def fetch_bwd(leaf):
        sc = dataclasses.replace(fscene, mat_albedo=alb, tex_stack=tex)
        return torch.autograd.grad(fetch_sum(sc, mats, uv), leaf)

    out["fetch_bwd_albedo"] = lambda: fetch_bwd(alb)
    out["fetch_bwd_texels"] = lambda: fetch_bwd(tex)
    return out


def measure(scene, camera, lights, settings, size: int, rows: list,
            label: str) -> list:
    """Time every stage and emit its row into `rows`."""
    whole = whole_stages(scene, camera, lights, settings, size)
    parts = part_stages(scene, camera, lights, settings, size)
    for name, fn in {**whole, **parts}.items():
        is_part = name in parts
        wall = tuning.dispatch_ms(fn, PART_REPS if is_part else WHOLE_REPS)
        # a whole sample is thousands of kernels: one profiled call
        dev_ms = tuning.profiled_ms(fn, reps=PART_REPS if is_part else 1)
        rec = {"stage": name, "scene": label, "wall_ms": wall,
               "device_ms": dev_ms,
               "idle_pct": 100.0 * (1.0 - dev_ms / wall),
               "syncs": tuning.syncs(fn)}
        if is_part:  # a call that syncs cannot be queued behind a hold
            rec["slope_ms"] = (None if rec["syncs"]
                               else tuning.slope_ms(fn, PART_N_HI))
        tuning.emit(rows, rec)
    return rows


def build_parser():
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.profile_stages")
    p.add_argument("--scene", default="16.1k")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--shading", default="reference",
                   choices=("reference", "pbr"))
    p.add_argument("--soft-edges", type=float, default=0.0)
    p.add_argument("--out", help="also write every row as JSON here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tuning.require_cuda("profile_stages")
    from dustraytracer_tpu_torch.scene.settings import LightParams

    dev = torch.device("cuda")
    rows = []
    tuning.emit(rows, tuning.header("profile_stages"))
    scene, camera, label, build_s = tuning.build(
        args.scene, dev, pbr=args.shading == "pbr")
    settings = settings_for(args.bounces, args.shading, args.soft_edges)
    lights = LightParams.from_settings(settings, device=dev)
    tuning.emit(rows, {"scene": label, "triangles": scene.n_tris,
                       "cluster_nodes": scene.cluster.n_nodes,
                       "size": args.size, "bounces": args.bounces,
                       "shading": args.shading,
                       "soft_edges": args.soft_edges,
                       "build_seconds": build_s})
    measure(scene, camera, lights, settings, args.size, rows, label)
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
