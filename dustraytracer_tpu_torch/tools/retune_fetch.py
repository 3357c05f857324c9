"""Where shade_fetch="auto" should pick the kernel fetch on this card
(port of the JAX tool tools/retune_fetch.py).

    python -m dustraytracer_tpu_torch.tools.retune_fetch
        [--scenes 4k,8k,11.2k,12.3k,16.1k,24k,32k,64k,90.7k] [--rounds 5]
        [--out FILE.json]

On each scene (tools/tuning.py's stand-ins, or .glb paths), the kernel
fetch against the gather fetch, in alternating rounds (k g, g k, ...):

  sample  the forward sample at 512x512, 2 bounces, under inference_mode
          (the JAX tool's workload): per round the wall ms (CUDA events)
          and the device ms (torch.profiler) of one sample
  step    the bench's 512x512 b4 fwd+bwd step (grad_bench.fetch_section)

Each scene's line gives per fetch and workload the median, min and max
wall and device ms and the peak memory above the resident scene. The
last line is `new_band`'s verdict on integrator.KERNEL_FETCH_BAND, the
padded-triangle range where "auto" picks the kernel fetch on a card.
"""

from __future__ import annotations

import argparse

import torch

from dustraytracer_tpu_torch.tools import tuning

FETCHES = ("kernel", "gather")
SAMPLE_SIZE = 512
SAMPLE_BOUNCES = 2
SCENES = ("4k", "8k", "11.2k", "12.3k", "16.1k", "24k", "32k", "64k",
          "90.7k")


def sample_rounds(scene, camera, rounds: int) -> dict:
    """{fetch: {"wall_ms": [...], "device_ms": [...], "mem_mib": x}} of
    the forward sample at SAMPLE_SIZE², SAMPLE_BOUNCES bounces."""
    from dustraytracer_tpu_torch.render.integrator import render_sample
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)

    st = RenderSettings(bounces=SAMPLE_BOUNCES, enable_tonemap=False,
                        enable_gamma=False)
    lights = LightParams.from_settings(st, device=scene.device)

    def sample(f):
        def run():
            with torch.inference_mode():
                return render_sample(scene, camera, lights, 0,
                                     width=SAMPLE_SIZE, height=SAMPLE_SIZE,
                                     settings=st.replace(shade_fetch=f))
        return run

    fns = {f: sample(f) for f in FETCHES}
    out = tuning.alternate(fns, rounds)
    for f, fn in fns.items():
        out[f]["mem_mib"] = tuning.peak_mib(fn)
    return out


def measure(specs, rounds: int, dev, rows: list) -> list:
    """One row per scene (see the module docstring); returns them."""
    from dustraytracer_tpu_torch.render.integrator import _resolve_fetch
    from dustraytracer_tpu_torch.scene.settings import RenderSettings
    from dustraytracer_tpu_torch.tools.grad_bench import fetch_section

    got = []
    for spec in specs:
        scene, camera, label, build_s = tuning.build(spec, dev)
        rec = {"scene": label, "triangles": scene.n_tris,
               "padded_triangles": int(scene.tri_pos.shape[0]),
               "auto": _resolve_fetch(scene, RenderSettings()),
               "build_seconds": build_s}
        try:
            _resolve_fetch(scene, RenderSettings(shade_fetch="kernel"))
        except ValueError as err:
            got.append(tuning.emit(rows, {**rec, "skipped": str(err)}))
            continue
        samp = sample_rounds(scene, camera, rounds)
        step = fetch_section(scene, camera, rounds, dev, label)
        for f in FETCHES:
            rec[f] = {
                "sample": {"wall_ms": samp[f]["wall_ms"],
                           "device_ms": samp[f]["device_ms"],
                           "wall": tuning.summary(samp[f]["wall_ms"]),
                           "device": tuning.summary(samp[f]["device_ms"]),
                           "mem_mib": samp[f]["mem_mib"]},
                "step": {"wall_ms": step[f]["wall_ms_rounds"],
                         "device_ms": step[f]["device_ms_rounds"],
                         "wall": tuning.summary(step[f]["wall_ms_rounds"]),
                         "device": tuning.summary(
                             step[f]["device_ms_rounds"]),
                         "mem_mib": step[f]["step_mem_gib"] * 1024}}
        got.append(tuning.emit(rows, rec))
        del scene
        torch.cuda.empty_cache()
    return got


def new_band(recs: list, band=None) -> dict:
    """The kernel-fetch band that the measured rows support.

    At each measured size the current pick is "kernel" inside `band`
    (default integrator.KERNEL_FETCH_BAND; None: nowhere) and "gather"
    outside; it switches only where the other fetch beats it
    (tuning.beats) on both workloads, the b2 sample and the b4 step. The
    new band spans the measured sizes that pick "kernel" when they are
    one run of consecutive sizes: its ends stay the old band's where the
    run's end sizes lay inside it, else they are those sizes' padded
    counts. No size picks "kernel": the band is None ("auto" picks
    "gather" on the card everywhere), unless no size inside the band was
    measured. Kernel picks that are not one run leave the band as it
    was. Returns {"band", "changed", "sizes": [per
    size: padded, current, pick, and the evidence]}."""
    if band is None:
        from dustraytracer_tpu_torch.render.integrator import \
            KERNEL_FETCH_BAND as band

    def inside(p):
        return band is not None and band[0] <= p <= band[1]

    sizes = []
    for rec in sorted((r for r in recs if "kernel" in r),
                      key=lambda r: r["padded_triangles"]):
        p = rec["padded_triangles"]
        cur = "kernel" if inside(p) else "gather"
        alt = "gather" if cur == "kernel" else "kernel"
        ev = {w: tuning.beats(rec[alt][w], rec[cur][w])
              for w in ("sample", "step")}
        pick = alt if all(e["wins"] for e in ev.values()) else cur
        sizes.append({"scene": rec["scene"], "padded": p, "current": cur,
                      "pick": pick, "alternative_beats": ev})
    run = [i for i, s in enumerate(sizes) if s["pick"] == "kernel"]
    if not any(inside(s["padded"]) for s in sizes) and not run:
        new = band  # the band's sizes were not measured
    elif not run:
        new = None
    elif run != list(range(run[0], run[-1] + 1)):
        new = band
    else:
        first, last = sizes[run[0]]["padded"], sizes[run[-1]]["padded"]
        new = (band[0] if inside(first) else first,
               band[1] if inside(last) else last)
    new = None if new is None else tuple(new)
    old = None if band is None else tuple(band)
    return {"band": new, "changed": new != old, "old_band": old,
            "sizes": sizes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.retune_fetch")
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--rounds", type=int, default=tuning.MIN_ROUNDS)
    p.add_argument("--out", help="also write every row as JSON here")
    args = p.parse_args(argv)
    tuning.require_cuda("retune_fetch")
    dev = torch.device("cuda")
    rows = []
    tuning.emit(rows, tuning.header("retune_fetch"))
    recs = measure(tuning.split_list(args.scenes), args.rounds, dev, rows)
    tuning.emit(rows, {"verdict": "kernel_fetch_band", **new_band(recs)})
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
