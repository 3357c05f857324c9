"""What the port's device tuning tools share (profile_stages,
bisect_segment, retune_fetch, bench_anyhit_sort, bench_cluster_k and
attr_sweep in this package): the scenes they measure, the waves they
trace, the card's line, the timers, the alternating rounds, and the rule
by which a measurement may change one of the port's `auto` picks.

Scenes. The JAX tools measured .glb files of the reference models
(suzanne_plane 970 triangles, cs16_dust 11.2k, dense_monkey 15.7k,
valorant_katana 90.7k), which are not in the repository. A tool here
takes a seeded stand-in of a given triangle count instead: the displaced
sphere of grad_bench.sphere_doc at the segments of STAND_INS, seen from
the bench pose. A path to a .glb loads that scene, with the JAX bench's
camera for the reference models it names (CAMERAS, a copy: the tools
import nothing of bench_scenes.py) and the bench pose otherwise.

Timers, all on the card (each raises without CUDA):
  wall_ms      CUDA events around one call: the device's timeline, host
               gaps included
  profiled_ms  the summed duration of every device kernel of one call,
               by torch.profiler (grad_bench.device_ms); `profiled` also
               names the timer
  slope_ms     utils/roofline.device_seconds_per_call: the slope between
               two counts of back-to-back calls queued while the device
               holds still; device time, for calls without a host sync
  dispatch_ms  utils/roofline.delta_time_dispatch with a synchronise:
               host-clock seconds per call of a run of calls
Where the wall and the device times differ, the difference is the time
the card waits for the host: idle_pct = 100 (1 - device / wall).

The rule (`beats`). A pick changes only where the alternative's median
beats the current pick's by at least MARGIN, in device ms and in wall
ms, over at least MIN_ROUNDS rounds taken in alternating order (A B B A
...), with the two sides' min-max ranges apart."""

from __future__ import annotations

import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

MARGIN = 0.10
MIN_ROUNDS = 5
PARK = 3.0e37  # the integrator's origin for lanes with nothing to trace
# stand-in name -> sphere_doc (n_lon, n_lat): 2 n_lon (n_lat - 1) + 2
# triangles, about the named count; "16.1k" is chip_smoke.py's sphere
STAND_INS = {"4k": (64, 32), "8k": (90, 45), "11.2k": (112, 51),
             "12.3k": (128, 49), "16.1k": (128, 64), "24k": (156, 78),
             "32k": (180, 90), "64k": (256, 126), "90.7k": (324, 141)}
# the JAX bench's cameras for the reference models (bench_scenes.py)
CAMERAS = {
    "cornell_box.glb": dict(position=(0, 1.25, 1.18),
                            look_at=(0, 1.1, -1.25), vfov_deg=75.0),
    "suzanne_plane.glb": dict(position=(0, 1.5, 5), look_at=(0, 0.5, 0),
                              vfov_deg=45.0),
    "dense_monkey.glb": dict(position=(0, 1.0, 4), look_at=(0, 0.5, 0),
                             vfov_deg=45.0),
    "cs16_dust.glb": dict(position=(45, 30, 45), look_at=(-5, 0, -25),
                          vfov_deg=55.0),
    "valorant_katana.glb": dict(position=(0, 2.9, 3.2),
                                look_at=(-0.5, 2.9, 0), vfov_deg=70.0),
}


def require_cuda(tool: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"torch.cuda.is_available() is False: {tool} "
                           "measures on a CUDA card")


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def header(tool: str) -> dict:
    return {"tool": tool, "nvidia_smi": card_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def emit(rows: list, rec: dict) -> dict:
    """Print one JSON line and keep it."""
    rows.append(rec)
    print(json.dumps(rec), flush=True)
    return rec


def write_out(path, rows: list) -> None:
    if path:
        Path(path).write_text(json.dumps(rows, indent=1))


def split_list(text: str) -> list:
    return [x for x in text.split(",") if x]


def document(spec: str, pbr: bool = False):
    """(glTF document, camera pose, label) of a stand-in name or a .glb
    path."""
    from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc

    if spec in STAND_INS:
        n_lon, n_lat = STAND_INS[spec]
        return (sphere_doc(n_lon, n_lat, pbr=pbr), POSE,
                f"sphere_{spec}_{n_lon}x{n_lat}")
    if spec.endswith(".glb"):
        from dustraytracer_tpu_torch.scene.gltf import load_gltf

        name = Path(spec).name
        return load_gltf(spec), CAMERAS.get(name, POSE), name
    raise ValueError(f"scene {spec!r}: neither a stand-in "
                     f"({', '.join(STAND_INS)}) nor a .glb path")


def build(spec: str, dev, cluster_k="auto", pbr: bool = False):
    """(scene on dev, camera, label, build seconds of build_scene)."""
    import time

    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene

    doc, pose, label = document(spec, pbr)
    t0 = time.perf_counter()
    scene = build_scene(doc, cluster_k=cluster_k)
    build_s = time.perf_counter() - t0
    return scene.to(dev), make_camera(**pose, device=dev), label, build_s


BOUNCES = ("bounce", "bounce2", "bounce3")  # pixel_waves' bounce waves


def pixel_waves(scene, camera, lights, size: int, seed: int = 1) -> dict:
    """The waves of one 4-bounce sample's size * size rays in pixel
    order, as the integrator hands them to its tracers before any sort:
    "primary" (camera rays, frame 0); "bounce", "bounce2" and "bounce3"
    (each from the previous wave's hits, just above the surface, along
    normal + a point in the unit ball: the diffuse bounce; lanes that
    missed stay parked); and "nee" (the JAX tool bench_anyhit_sort's
    shadow wave: from each primary hit point toward the sun, jittered by
    1.5 * N(0, 0.5); misses parked). Each value is (origin, direction).
    Numpy `seed` makes the balls and the jitter."""
    from dustraytracer_tpu_torch.ops.rng import seed_pixels
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep
    from dustraytracer_tpu_torch.render.integrator import shade_hits
    from dustraytracer_tpu_torch.scene.camera import generate_rays

    dev = scene.device
    n = size * size
    rng = np.random.default_rng(seed)
    ids = torch.arange(n, device=dev)
    _, o, d = generate_rays(camera, size, size, seed_pixels(ids, 0),
                            pixel_ids=ids)
    waves = {"primary": (o.contiguous(), d.contiguous())}
    for name in ("nee", *BOUNCES):
        with torch.no_grad():
            res = traverse_cluster_sweep(scene.cluster, o, d)
            hit = (res["hit_idx"] >= 0)[:, None]
            sh = shade_hits(scene, o, d, res["hit_idx"])
        if name == "nee":
            jit = torch.from_numpy(
                (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)).to(dev)
            t_hit = torch.where(hit[:, 0], res["t"], 0.0)
            waves[name] = (
                torch.where(hit, o + d * t_hit[:, None], PARK).contiguous(),
                (lights.sun_position()[None, :] + jit * 1.5).contiguous())
            continue
        ball = rng.normal(size=(n, 3))
        ball *= (rng.uniform(size=(n, 1)) ** (1.0 / 3.0)
                 / np.linalg.norm(ball, axis=-1, keepdims=True))
        ball = torch.from_numpy(ball.astype(np.float32)).to(dev)
        o = torch.where(hit, sh["world_position"] + sh["normal"] * 1e-3,
                        PARK).contiguous()
        d = (sh["normal"] + ball).contiguous()
        waves[name] = (o, d)
    return waves


def sort_perm(scene, o, d):
    """_sorted_tracers' permutation: the stable argsort of ray_sort_key
    over the scene BVH's root box."""
    from dustraytracer_tpu_torch.render.integrator import ray_sort_key

    return torch.argsort(ray_sort_key(scene.node_min[0], scene.node_max[0],
                                      o, d), stable=True)


def sort_rays(scene, o, d):
    """The rays in ray_sort_key order, as _sorted_tracers sorts them."""
    perm = sort_perm(scene, o, d)
    return o[perm].contiguous(), d[perm].contiguous()


# --- timers (card only) ---------------------------------------------------

def wall_ms(fn) -> float:
    """ms between CUDA events around one fn() call."""
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def profiled_ms(fn, reps: int = 1) -> float:
    """Summed device-kernel ms per fn() call, torch.profiler."""
    return profiled(fn, reps)[0]


def profiled(fn, reps: int = 1) -> tuple[float, str]:
    """(profiled_ms, the timer that took it): "torch.profiler", or the
    CUDA-event timer grad_bench.device_ms fell back to when the profiler
    lost the kernels."""
    from dustraytracer_tpu_torch.tools import grad_bench

    misses = len(grad_bench.PROFILER_MISSES)
    ms = grad_bench.device_ms(fn, reps=reps)
    if len(grad_bench.PROFILER_MISSES) > misses:
        return ms, grad_bench.PROFILER_MISSES[-1]["timer"]
    return ms, "torch.profiler"


def slope_ms(fn, n_hi: int = 8) -> float | None:
    """Device ms per fn() call by device_seconds_per_call; n_hi doubles
    up to three times while the slope is not positive (a call inside
    the timing noise), and then None: no negative or zero time is
    returned. None too for a call that waits for the device (the host
    cannot queue the calls while the device holds)."""
    from dustraytracer_tpu_torch.utils.roofline import \
        device_seconds_per_call

    for _ in range(4):
        try:
            return 1e3 * device_seconds_per_call(
                lambda _i: fn(), n_lo=2, n_hi=n_hi, strict=True)
        except RuntimeError as err:
            if "could not queue" in str(err):
                return None
            if "non-positive slope" not in str(err):
                raise
            n_hi *= 2
    return None


def dispatch_ms(fn, reps: int) -> float:
    """Host-clock ms per call of back-to-back calls ending in a
    synchronise (delta_time_dispatch)."""
    from dustraytracer_tpu_torch.utils.roofline import delta_time_dispatch

    return 1e3 * delta_time_dispatch(fn, torch.cuda.synchronize, reps=reps)


def syncs(fn) -> list:
    """Where one fn() call makes the host wait for the card: the
    "file:line" of each synchronizing CUDA operation that
    torch.cuda.set_sync_debug_mode("warn") reports (a copy to or from
    pageable host memory, a value read back)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def peak_mib(fn) -> float:
    """Peak memory of one fn() call above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def alternate(fns: dict, rounds: int, device=profiled_ms) -> dict:
    """Each fn once to warm up (builds, packed tables, allocator), then
    `rounds` rounds in alternating order (A B, B A, A B, ...); in each
    round every fn's wall_ms and then its `device` ms. Returns {name:
    {"wall_ms": [...], "device_ms": [...]}}, one entry per round."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    out = {k: {"wall_ms": [], "device_ms": []} for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k]["wall_ms"].append(wall_ms(fns[k]))
            out[k]["device_ms"].append(device(fns[k]))
    return out


# --- the rule --------------------------------------------------------------

def summary(values: list) -> dict:
    vals = [v for v in values if v is not None]
    if not vals:
        return {"median": None, "min": None, "max": None, "n": 0}
    return {"median": statistics.median(vals), "min": min(vals),
            "max": max(vals), "n": len(vals)}


def beats(alt: dict, cur: dict, margin: float = MARGIN,
          min_rounds: int = MIN_ROUNDS) -> dict:
    """Whether `alt` beats `cur`: for both "wall_ms" and "device_ms"
    (lists of per-round ms), at least `min_rounds` rounds on each side,
    alt's median at most (1 - margin) of cur's, and alt's max below
    cur's min. Returns {"wins": bool, "<metric>": {"gain_pct", "apart",
    "rounds"}}, gain_pct = 100 (1 - alt median / cur median)."""
    out = {"wins": True}
    for metric in ("wall_ms", "device_ms"):
        a = [v for v in alt[metric] if v is not None]
        c = [v for v in cur[metric] if v is not None]
        rounds = min(len(a), len(c))
        if not (a and c):
            out[metric] = {"gain_pct": None, "apart": False,
                           "rounds": rounds}
            out["wins"] = False
            continue
        gain = 100.0 * (1.0 - statistics.median(a) / statistics.median(c))
        apart = max(a) < min(c)
        out[metric] = {"gain_pct": gain, "apart": apart, "rounds": rounds}
        out["wins"] &= (rounds >= min_rounds and gain >= 100.0 * margin
                        and apart)
    return out
