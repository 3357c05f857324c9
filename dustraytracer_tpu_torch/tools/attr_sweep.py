"""K1's device time on one scene, term by term (port of the JAX tool
tools/attr_sweep.py): a thin command line over utils/roofline.py's
calibrate_sweep_rates and sweep_attribution, as chip_smoke.py's phase
24 runs them on the bench sphere.

    python -m dustraytracer_tpu_torch.tools.attr_sweep [--scene 16.1k]
        [--size 512] [--cluster-k auto] [--out FILE.json]

Lines: "calibration" (K1's rates per warp iteration, leaf iteration and
served leaf from the chain scenes at the scene's K and cluster count),
then one "attribution" per wave of ab_main_paths.sweep_waves (primary,
bounce, shadow any-hit): the device ms by device_seconds_per_call, the
counted exec_windows, exec_leafs and leaf_tests, and their price at the
calibrated rates (sol_pct, sol_raw_pct, window and leaf shares).
"""

from __future__ import annotations

import argparse

import torch

from dustraytracer_tpu_torch.tools import tuning


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.attr_sweep")
    p.add_argument("--scene", default="16.1k")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--cluster-k", default="auto",
                   help='"auto" or a cluster size K')
    p.add_argument("--out", help="also write every row as JSON here")
    args = p.parse_args(argv)
    tuning.require_cuda("attr_sweep")
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.ab_main_paths import sweep_waves
    from dustraytracer_tpu_torch.utils.roofline import (calibrate_sweep_rates,
                                                        sweep_attribution)

    dev = torch.device("cuda")
    k = args.cluster_k if args.cluster_k == "auto" else int(args.cluster_k)
    rows = []
    tuning.emit(rows, tuning.header("attr_sweep"))
    scene, camera, label, _ = tuning.build(args.scene, dev, cluster_k=k)
    cb = scene.cluster
    tuning.emit(rows, {"scene": label, "triangles": scene.n_tris,
                       "cluster_nodes": cb.n_nodes, "k": cb.k,
                       "c_pad": cb.v0.shape[0], "rays": args.size ** 2})
    rates = calibrate_sweep_rates(k=cb.k, c_pad=cb.v0.shape[0])
    tuning.emit(rows, {"calibration": True, **{
        key: rates[key] for key in ("window_ns", "leaf_ns", "leaf_iter_ns",
                                    "n_tiles", "leaf_iteration_ns")}})
    lights = LightParams.from_settings(RenderSettings(bounces=4), device=dev)
    waves = sweep_waves(scene, camera, lights, args.size)
    for wave, (o, d, anyhit) in waves.items():
        attr = sweep_attribution(cb, o, d, rates=rates, anyhit=anyhit)
        tuning.emit(rows, {"attribution": wave, "scene": label,
                           "device_ms": attr["measured_s"] * 1e3, **attr})
    tuning.write_out(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
