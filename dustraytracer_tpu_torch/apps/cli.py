"""Headless CLI (port of apps/cli.py): render a glTF scene progressively
to PNG and print a metrics JSON with the same keys as the JAX CLI, or
print a scene's statistics.

Usage:
  python -m dustraytracer_tpu_torch.apps.cli render --scene scene.glb \\
      --spp 64 --bounces 2 --size 512x512 --out img.png [--device cuda]
  python -m dustraytracer_tpu_torch.apps.cli render --debug-view bvh ...
  python -m dustraytracer_tpu_torch.apps.cli stats --scene scene.glb

`--device cuda` (the default) needs a CUDA card and raises without one;
`--device cpu`, or `--cpu` as in the JAX CLI, renders with the
traversal's plain PyTorch twin (`--cpu` with `--device cuda` is a usage
error). `stats --cpu` is accepted and changes nothing: ingest runs on
the host.
`--checkpoint film.npz` resumes the film from that file if it exists
and saves it when the render ends. `--devices` (pixels sharded over
devices) is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _parse_vec3(s: str):
    return tuple(float(x) for x in s.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dustraytracer_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", required=True, help="path to .glb/.gltf")
    r.add_argument("--out", default="render.png")
    r.add_argument("--size", type=_parse_size, default=(640, 360),
                   help="WxH")
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--bounces", type=int, default=3)
    r.add_argument("--max-samples", type=int, default=500)
    r.add_argument("--camera-pos", type=_parse_vec3, default=(0, 1, 4))
    r.add_argument("--look-at", type=_parse_vec3, default=(0, 1, 0))
    r.add_argument("--vfov", type=float, default=60.0)
    r.add_argument("--focus-dist", type=float, default=10.0)
    r.add_argument("--defocus-angle", type=float, default=0.0)
    r.add_argument("--exposure", type=float, default=2.0)
    r.add_argument("--no-tonemap", action="store_true")
    r.add_argument("--no-gamma", action="store_true")
    r.add_argument("--no-sun", action="store_true")
    r.add_argument("--sun-intensity", type=float, default=30.0)
    r.add_argument("--sky-intensity", type=float, default=20.0)
    r.add_argument("--sky-color", type=_parse_vec3, default=(0.2, 0.4, 1.0))
    r.add_argument("--alpha-test", action="store_true")
    r.add_argument("--russian-roulette", action="store_true")
    r.add_argument("--smooth-shading", action="store_true")
    r.add_argument("--tex-filter", choices=["point", "bilinear"],
                   default="point")
    r.add_argument("--shade-fetch",
                   choices=["auto", "onehot", "gather", "kernel"],
                   default="auto")
    r.add_argument("--shading", choices=["reference", "pbr"],
                   default="reference")
    r.add_argument("--debug-view",
                   choices=["albedo", "normal", "barycentric", "uvs", "bvh"],
                   help="render a debug head instead of the beauty pass")
    r.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (not yet ported)")
    r.add_argument("--device", choices=["cuda", "cpu"],
                   help="cuda (the default) runs the CUDA kernels and "
                   "needs a card")
    r.add_argument("--cpu", action="store_true",
                   help="render on the CPU: --device cpu")
    r.add_argument("--metrics-out", help="write render metrics JSON here")
    r.add_argument("--checkpoint", help="film checkpoint path (.npz); "
                   "resumes if it exists, saves on completion")

    st = sub.add_parser("stats", help="print scene statistics JSON")
    st.add_argument("--scene", required=True)
    st.add_argument("--cpu", action="store_true",
                    help="accepted for the JAX CLI's command lines; ingest "
                    "runs on the host either way")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """build_parser's arguments with render's device resolved: `--cpu` is
    `--device cpu`, and is a usage error beside `--device cuda`."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.command == "render":
        if args.cpu and args.device == "cuda":
            p.error("--cpu conflicts with --device cuda")
        args.device = "cpu" if args.cpu else args.device or "cuda"
    return args


def _not_ported(flag: str):
    return NotImplementedError(f"{flag} not yet ported, see ROADMAP.md")


def cmd_stats(args) -> int:
    from dustraytracer_tpu_torch.scene import load_scene

    t0 = time.perf_counter()
    out = dict(load_scene(args.scene).stats)
    out["ingest_seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(out, indent=2))
    return 0


def cmd_render(args) -> int:
    import torch

    from dustraytracer_tpu_torch.render.film import (film_accumulate,
                                                     film_image, film_init)
    from dustraytracer_tpu_torch.render.integrator import render_sample
    from dustraytracer_tpu_torch.scene import load_scene, make_camera
    from dustraytracer_tpu_torch.scene.settings import (DebugMode,
                                                        LightParams,
                                                        RenderMode,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.utils.checkpoint import (load_film,
                                                          save_film)
    from dustraytracer_tpu_torch.utils.image import save_png

    if args.devices > 0:
        raise _not_ported("--devices")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (use --device cpu for the CPU twin)")
    device = torch.device(args.device)
    cuda = device.type == "cuda"

    width, height = args.size
    t0 = time.perf_counter()
    scene = load_scene(args.scene).to(device)
    ingest_s = time.perf_counter() - t0

    camera = make_camera(position=args.camera_pos, look_at=args.look_at,
                         vfov_deg=args.vfov, focus_dist=args.focus_dist,
                         defocus_angle=args.defocus_angle,
                         exposure=args.exposure, device=device)
    settings = RenderSettings(
        bounces=args.bounces, max_samples=args.max_samples,
        enable_tonemap=not args.no_tonemap, enable_gamma=not args.no_gamma,
        enable_sunlight=not args.no_sun, sun_intensity=args.sun_intensity,
        sky_intensity=args.sky_intensity, sky_color=tuple(args.sky_color),
        alpha_test=args.alpha_test, russian_roulette=args.russian_roulette,
        smooth_shading=args.smooth_shading, tex_filter=args.tex_filter,
        shading=args.shading, shade_fetch=args.shade_fetch)
    if args.debug_view:
        settings = settings.replace(
            render_mode=RenderMode.DEBUG,
            debug_mode=DebugMode[args.debug_view.upper()])
    lights = LightParams.from_settings(settings, device=device)
    film = film_init(width, height, device=device)
    if args.checkpoint:
        resumed = load_film(args.checkpoint, width, height, device=device)
        if resumed is not None:
            film = resumed
            print(f"resumed from {args.checkpoint} at sample {film.frame}",
                  file=sys.stderr)
    spp = min(args.spp, settings.max_samples)
    todo = max(spp - film.frame, 0)

    # set-up outside the timed render (the JAX CLI's compile step): build
    # or load the kernel, pack the scene's device tables and load torch's
    # kernels through one throwaway 8x8 sample
    t0 = time.perf_counter()
    with torch.inference_mode():  # forward only: no autograd graph
        render_sample(scene, camera, lights, 0, width=8, height=8,
                      settings=settings)
    if cuda:
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    film = film_accumulate(scene, camera, lights, film, todo, width=width,
                           height=height, settings=settings)
    if cuda:
        ev1.record()
        torch.cuda.synchronize(device)
        render_s = ev0.elapsed_time(ev1) / 1e3
    else:
        render_s = time.perf_counter() - t0

    save_png(args.out, film_image(film))
    if args.checkpoint:
        save_film(args.checkpoint, film)

    metrics = {
        "scene": args.scene,
        "triangles": scene.n_tris,
        "size": [width, height],
        "spp": todo,
        "bounces": args.bounces,
        "ingest_seconds": round(ingest_s, 3),
        "compile_seconds": round(compile_s, 3),
        "render_seconds": round(render_s, 4),
        "samples_per_second": round(todo / render_s, 2) if render_s > 0
        and todo else None,
        "mrays_per_second": round(
            width * height * todo * 2 * args.bounces / render_s / 1e6, 2)
        if render_s > 0 and todo else None,
        "devices": 1,
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "out": args.out,
    }
    print(json.dumps(metrics, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(metrics, fh)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.command == "stats":
        return cmd_stats(args)
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
