"""Which cluster size K the sweep kernel K1 should get on this card
(port of the JAX tool tools/bench_cluster_k.py, with the K axis of
tools/tune_sweep.py).

    python -m dustraytracer_tpu_torch.tools.bench_cluster_k
        [--ks 8,16,32,64,128] [--scenes 11.2k,16.1k,90.7k] [--size 512]
        [--rounds 5] [--twin] [--out FILE.json]

On each scene (tools/tuning.py's stand-ins, or .glb paths) and at each
K: build_scene(cluster_k=K) and its seconds, the cluster BVH's nodes and
clusters, and K1 on the waves of a 4-bounce grad step as the integrator
feeds them (tools/tuning.py's pixel_waves, sorted where
integrator.AUTO_SORTED sorts that kind): the primary and the three
bounce waves in the emit instance (closest, with the kernel fetch's
attributes) and the NEE wave any-hit. Per wave: the counting instance's
exec_windows, exec_leafs and leaf_tests, and in alternating rounds (K
order forward, then reversed, ...) the wall ms (CUDA events around one
launch) and the device ms (device_seconds_per_call). Each round is also
weighed as the step's 8 launches: the 4 closest waves once each and
the NEE wave 4 times. With --twin each K's kernel results are held
against K1's plain PyTorch twin on every wave, bit for bit (slow on
large scenes).
The last line is `pick_k`'s verdict on scene.AUTO_CLUSTER_K.
"""

from __future__ import annotations

import argparse

import torch

from dustraytracer_tpu_torch.tools import tuning

KS = (8, 16, 32, 64, 128)
SCENES = ("11.2k", "16.1k", "90.7k")
# wave -> (launch keyword arguments, launches per grad step)
WAVES = {**{w: ({"emit_attrs": True}, 1) for w in ("primary",
                                                   *tuning.BOUNCES)},
         "nee": ({"anyhit": True}, 4)}
BUILD_SLOWDOWN = 2.0  # a new K may build at most this much slower
N_HI = 8


def k_waves(scene, camera, size: int) -> dict:
    """{wave: (origin, direction)} of WAVES on `scene`, each sorted where
    integrator.AUTO_SORTED sorts its kind."""
    from dustraytracer_tpu_torch.render.integrator import AUTO_SORTED
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)

    lights = LightParams.from_settings(RenderSettings(bounces=4),
                                       device=scene.device)
    waves = tuning.pixel_waves(scene, camera, lights, size)
    out = {}
    for w in WAVES:
        kind = "anyhit" if "anyhit" in WAVES[w][0] else "closest"
        out[w] = (tuning.sort_rays(scene, *waves[w]) if kind in AUTO_SORTED
                  else waves[w])
    return out


def counts(cb, waves: dict) -> dict:
    """Per wave the counting instance's summed work."""
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep

    out = {}
    for wave, (o, d) in waves.items():
        r = traverse_cluster_sweep(cb, o, d, counters=True,
                                   anyhit="anyhit" in WAVES[wave][0])
        out[wave] = {key: int(r[key].sum()) for key in
                     ("exec_windows", "exec_leafs", "leaf_tests")}
    return out


def twin_equal(cb, waves: dict) -> dict:
    """Per wave, whether K1 equals its twin bit for bit, every output."""
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    out = {}
    for wave, (o, d) in waves.items():
        kw = WAVES[wave][0]
        a = ts.traverse_cluster_sweep(cb, o, d, **kw)
        b = ts.traverse_cluster_sweep_reference(cb, o, d, **kw)
        out[wave] = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                                 for k in a)
    return out


def measure(specs, ks, size: int, rounds: int, dev, rows: list,
            twin: bool = False) -> list:
    """One row per scene and K; returns one record per scene: {"scene",
    "ks": {K: {"build_seconds", "wall_ms", "device_ms"}}} with the
    weighted per-round sums."""
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep

    got = []
    for spec in specs:
        built = {}
        for k in ks:
            scene, camera, label, build_s = tuning.build(spec, dev,
                                                         cluster_k=k)
            built[k] = (scene, build_s)
        waves = k_waves(built[ks[0]][0], camera, size)
        calls = {}
        for k, (scene, _) in built.items():
            for wave, (o, d) in waves.items():
                calls[(k, wave)] = (
                    lambda cb=scene.cluster, o=o, d=d, kw=WAVES[wave][0]:
                    traverse_cluster_sweep(cb, o, d, **kw))
        timed = tuning.alternate(
            calls, rounds, device=lambda fn: tuning.slope_ms(fn, N_HI))
        rec = {"scene": label, "ks": {}}
        for k, (scene, build_s) in built.items():
            cb = scene.cluster
            per_wave = {w: timed[(k, w)] for w in waves}
            sums = {}
            for metric in ("wall_ms", "device_ms"):
                sums[metric] = [
                    None if None in vals else
                    sum(WAVES[w][1] * v for w, v in zip(waves, vals))
                    for vals in zip(*(per_wave[w][metric] for w in waves))]
            row = {"scene": label, "k": k, "triangles": scene.n_tris,
                   "cluster_nodes": cb.n_nodes, "clusters": cb.n_clusters,
                   "build_seconds": build_s, "rays": size * size,
                   "counters": counts(cb, waves),
                   "waves": {w: {"wall": tuning.summary(v["wall_ms"]),
                                 "device": tuning.summary(v["device_ms"])}
                             for w, v in per_wave.items()},
                   "step_weighted": {
                       "wall": tuning.summary(sums["wall_ms"]),
                       "device": tuning.summary(sums["device_ms"]),
                       **sums}}
            if twin:
                row["twin_equal"] = twin_equal(cb, waves)
            tuning.emit(rows, row)
            rec["ks"][k] = {"build_seconds": build_s, **sums}
        got.append(rec)
        del built, waves, calls
        torch.cuda.empty_cache()
    return got


def pick_k(recs: list, current=None) -> dict:
    """The one K for every scene. An alternative K replaces `current`
    (default scene.AUTO_CLUSTER_K) only where it beats it on the
    weighted sums (tuning.beats) on every scene and builds at most
    BUILD_SLOWDOWN times as slowly on every scene; among several such,
    the one with the lowest median weighted device ms summed over the
    scenes. Returns {"k", "changed", per candidate the evidence}."""
    import statistics

    if current is None:
        from dustraytracer_tpu_torch.scene.scene import \
            AUTO_CLUSTER_K as current
    cands = {}
    for k in sorted({k for r in recs for k in r["ks"]} - {current}):
        ev = []
        for r in recs:
            if k not in r["ks"] or current not in r["ks"]:
                ev = None
                break
            alt, cur = r["ks"][k], r["ks"][current]
            ev.append({"scene": r["scene"],
                       "beats": tuning.beats(alt, cur),
                       "build_ratio": alt["build_seconds"]
                       / cur["build_seconds"]})
        if not ev:
            continue
        wins = all(e["beats"]["wins"] and e["build_ratio"]
                   <= BUILD_SLOWDOWN for e in ev)
        cands[k] = {"wins": wins, "scenes": ev}
    winners = [k for k, c in cands.items() if c["wins"]]
    new = current
    if winners:
        new = min(winners, key=lambda k: sum(
            statistics.median([v for v in r["ks"][k]["device_ms"]
                               if v is not None]) for r in recs))
    return {"k": new, "changed": new != current, "old_k": current,
            "candidates": cands}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.bench_cluster_k")
    p.add_argument("--ks", default=",".join(map(str, KS)))
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--rounds", type=int, default=tuning.MIN_ROUNDS)
    p.add_argument("--twin", action="store_true",
                   help="hold each K's kernel against its twin")
    p.add_argument("--out", help="also write every row as JSON here")
    args = p.parse_args(argv)
    tuning.require_cuda("bench_cluster_k")
    dev = torch.device("cuda")
    rows = []
    tuning.emit(rows, tuning.header("bench_cluster_k"))
    recs = measure(tuning.split_list(args.scenes),
                   [int(k) for k in tuning.split_list(args.ks)], args.size,
                   args.rounds, dev, rows, twin=args.twin)
    tuning.emit(rows, {"verdict": "auto_cluster_k", **pick_k(recs)})
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
