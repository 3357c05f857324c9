"""Does a sweep wave pay for its ray sort on this card? (port of the JAX
tool tools/bench_anyhit_sort.py, widened to the closest waves)

    python -m dustraytracer_tpu_torch.tools.bench_anyhit_sort
        [--scenes 11.2k,16.1k,90.7k] [--size 512] [--rounds 5]
        [--out FILE.json]

On each scene, the waves of a 4-bounce sample in pixel order, as the
integrator hands them to its tracers (tools/tuning.py's pixel_waves):
the primary wave, three diffuse bounces, each from the hits of the one
before, and the JAX tool's NEE wave (each primary hit toward the
jittered sun). Each is traced bare (K1 on the rays as they come) and
through _sorted_tracers (ray_sort_key, argsort, gathers, K1,
the scatter back), in alternating rounds: per round the wall ms (CUDA
events around one call) and the device ms (device_seconds_per_call).
The closest waves run K1's plain instance and, where the scene takes
the kernel fetch, its emit instance too. Sorted and bare results must be
equal bit for bit (hit ids, t, visits and every emitted attribute; the
occlusion of the NEE wave): each ray's walk depends on that ray alone.

A 4-bounce sample traces the primary and the three bounce waves closest
and four shadow waves any-hit, so the "kinds" line sums each round over
the four closest waves, and takes the NEE wave for the any-hit kind;
`pick_sort` gives the verdict on integrator.AUTO_SORTED.
"""

from __future__ import annotations

import argparse

import torch

from dustraytracer_tpu_torch.tools import tuning

SCENES = ("11.2k", "16.1k", "90.7k")
N_HI = 8
CLOSEST = ("primary", *tuning.BOUNCES)  # a 4-bounce sample's closest waves


def tracers(scene, emit: bool = False):
    """(bare closest, bare any-hit, sorted closest, sorted any-hit), the
    sweep tracers of _make_tracers without and with _sorted_tracers."""
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep
    from dustraytracer_tpu_torch.render.integrator import _sorted_tracers

    cb = scene.cluster

    def closest(o, d):
        return traverse_cluster_sweep(cb, o, d, emit_attrs=emit)

    def anyhit(o, d):
        return traverse_cluster_sweep(cb, o, d, anyhit=True)["hit_idx"] >= 0

    return (closest, anyhit, *_sorted_tracers(scene, closest, anyhit))


def sorted_equals_bare(scene, waves: dict, emit: bool = False) -> dict:
    """Per wave, whether the sorted tracer's result equals the bare
    one's bit for bit (closest on the primary and bounce waves, any-hit
    on "nee")."""
    closest, anyhit, s_closest, s_anyhit = tracers(scene, emit)
    out = {}
    with torch.no_grad():
        for wave in CLOSEST:
            a, b = closest(*waves[wave]), s_closest(*waves[wave])
            out[wave] = a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
        out["nee"] = torch.equal(anyhit(*waves["nee"]),
                                 s_anyhit(*waves["nee"]))
    return out


def summed(res: dict, waves) -> dict:
    """Per round, the sum over `waves` of each side's ms: {side:
    {"wall_ms": [...], "device_ms": [...]}}; a round with a None (a
    slope inside the noise) gives None."""
    out = {}
    for side in res[waves[0]]:
        out[side] = {}
        for metric in ("wall_ms", "device_ms"):
            out[side][metric] = [
                None if None in vals else sum(vals)
                for vals in zip(*(res[w][side][metric] for w in waves))]
    return out


def measure(specs, size: int, rounds: int, dev, rows: list) -> list:
    """One row per scene, wave and instance, and one "kinds" row per
    scene and closest instance; returns the "kinds" rows."""
    from dustraytracer_tpu_torch.render.integrator import _resolve_fetch
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)

    got = []
    lights = LightParams.from_settings(RenderSettings(), device=dev)
    for spec in specs:
        scene, camera, label, _ = tuning.build(spec, dev)
        waves = tuning.pixel_waves(scene, camera, lights, size)
        modes = [False]
        try:
            _resolve_fetch(scene, RenderSettings(shade_fetch="kernel"))
            modes.append(True)
        except ValueError:
            pass
        nee = None
        for emit in modes:
            same = sorted_equals_bare(scene, waves, emit)
            if not all(same.values()):
                raise RuntimeError(f"{label}: sorted and bare tracers "
                                   f"differ: {same}")
            closest, anyhit, s_closest, s_anyhit = tracers(scene, emit)
            res = {}
            for wave in CLOSEST:
                o, d = waves[wave]
                res[wave] = tuning.alternate(
                    {"sorted": lambda o=o, d=d: s_closest(o, d),
                     "bare": lambda o=o, d=d: closest(o, d)}, rounds,
                    device=lambda fn: tuning.slope_ms(fn, N_HI))
            if nee is None:
                o, d = waves["nee"]
                nee = tuning.alternate(
                    {"sorted": lambda: s_anyhit(o, d),
                     "bare": lambda: anyhit(o, d)}, rounds,
                    device=lambda fn: tuning.slope_ms(fn, N_HI))
                res["nee"] = nee
            inst = "emit" if emit else "plain"
            for wave, r in res.items():
                tuning.emit(rows, {
                    "scene": label, "wave": wave,
                    "instance": "anyhit" if wave == "nee" else inst,
                    "rays": size * size, "equal_bit_for_bit": True,
                    **{side: {"wall": tuning.summary(v["wall_ms"]),
                              "device": tuning.summary(v["device_ms"]),
                              **v} for side, v in r.items()}})
            got.append(tuning.emit(rows, {
                "scene": label, "kinds": True, "closest_instance": inst,
                "closest": summed(res, CLOSEST),
                "anyhit": nee}))
        del scene, waves
        torch.cuda.empty_cache()
    return got


def pick_sort(kinds: list, current=None) -> dict:
    """The wave kinds "auto" should sort, from "kinds" rows of one
    closest instance. A kind sorted now (`current`, default
    integrator.AUTO_SORTED) stops being sorted only where bare beats
    sorted (tuning.beats) on every scene measured, and a kind not
    sorted starts only where sorted beats bare on every scene. Returns
    {"sorted": tuple, "changed", per kind the evidence per scene}."""
    if current is None:
        from dustraytracer_tpu_torch.render.integrator import \
            AUTO_SORTED as current
    out = {"old_sorted": tuple(current)}
    new = []
    for kind in ("closest", "anyhit"):
        cur = "sorted" if kind in current else "bare"
        alt = "bare" if cur == "sorted" else "sorted"
        ev = [{"scene": k["scene"],
               "alternative_beats": tuning.beats(k[kind][alt],
                                                 k[kind][cur])}
              for k in kinds]
        switch = bool(ev) and all(e["alternative_beats"]["wins"]
                                  for e in ev)
        if (alt if switch else cur) == "sorted":
            new.append(kind)
        out[kind] = {"current": cur, "alternative": alt, "switch": switch,
                     "scenes": ev}
    out["sorted"] = tuple(new)
    out["changed"] = out["sorted"] != out["old_sorted"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.bench_anyhit_sort")
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--rounds", type=int, default=tuning.MIN_ROUNDS)
    p.add_argument("--out", help="also write every row as JSON here")
    args = p.parse_args(argv)
    tuning.require_cuda("bench_anyhit_sort")
    dev = torch.device("cuda")
    rows = []
    tuning.emit(rows, tuning.header("bench_anyhit_sort"))
    kinds = measure(tuning.split_list(args.scenes), args.size, args.rounds,
                    dev, rows)
    for inst in ("plain", "emit"):
        sel = [k for k in kinds if k["closest_instance"] == inst]
        if sel:
            tuning.emit(rows, {"verdict": "auto_sorted",
                               "closest_instance": inst,
                               **pick_sort(sel)})
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
