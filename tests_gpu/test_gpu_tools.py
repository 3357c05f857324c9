"""The device tuning tools (dustraytracer_tpu_torch/tools/: profile_stages,
bisect_segment, retune_fetch, bench_anyhit_sort, bench_cluster_k,
attr_sweep) in their smallest form on the card, on the 4k stand-in: each
gives its rows with finite, positive times, and the sorted and bare
tracers, and K1 at each K and its twin, agree bit for bit. The benchmark
line (tools/bench.py) prints one JSON object."""

import json
import math

import pytest
import torch

pytestmark = pytest.mark.gpu

SIZE = 64
SCENE = "4k"


def _positive(*vals):
    return all(v is not None and math.isfinite(v) and v > 0 for v in vals)


@pytest.fixture(scope="module")
def bench():
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools import tuning

    scene, camera, label, _ = tuning.build(SCENE, "cuda")
    # 2 bounces: at 1 the image does not depend on the vertices
    settings = RenderSettings(bounces=2, enable_tonemap=False,
                              enable_gamma=False)
    return (scene, camera, LightParams.from_settings(settings,
                                                     device="cuda"),
            settings, label)


def test_profile_stages(bench):
    from dustraytracer_tpu_torch.tools import profile_stages

    scene, camera, lights, settings, label = bench
    rows = profile_stages.measure(scene, camera, lights, settings, SIZE, [],
                                  label)
    names = {r["stage"] for r in rows}
    assert {"fwd", "step_mat", "step_tri_pos", "refit", "sort_leg",
            "shade_hits_bwd", "fetch_bwd_texels"} <= names
    for r in rows:
        assert _positive(r["wall_ms"], r["device_ms"]), r
        assert r.get("slope_ms") is None or r["slope_ms"] > 0, r


def test_bisect_segment(bench):
    from dustraytracer_tpu_torch.tools import bisect_segment

    scene, camera, lights, settings, label = bench
    rows = bisect_segment.measure(scene, camera, lights, settings, SIZE, [],
                                  label)
    assert [r["prefix"] for r in rows] == [*bisect_segment.STOPS,
                                          "render_sample"]
    for r in rows:
        assert _positive(r["wall_ms"], r["device_ms"]), r


def test_retune_fetch():
    from dustraytracer_tpu_torch.tools import retune_fetch

    (rec,) = retune_fetch.measure([SCENE], 1, torch.device("cuda"), [])
    for f in retune_fetch.FETCHES:
        for w in ("sample", "step"):
            assert _positive(*rec[f][w]["wall_ms"], *rec[f][w]["device_ms"])
    json.dumps(retune_fetch.new_band([rec]))


def test_bench_anyhit_sort():
    from dustraytracer_tpu_torch.tools import bench_anyhit_sort

    rows = []
    kinds = bench_anyhit_sort.measure([SCENE], SIZE, 1,
                                      torch.device("cuda"), rows)
    assert all(r["equal_bit_for_bit"] for r in rows if "wave" in r)
    for k in kinds:
        for kind in ("closest", "anyhit"):
            for side in ("sorted", "bare"):
                assert _positive(*k[kind][side]["wall_ms"],
                                 *k[kind][side]["device_ms"])


def test_bench_cluster_k():
    from dustraytracer_tpu_torch.tools import bench_cluster_k

    rows = []
    (rec,) = bench_cluster_k.measure([SCENE], [16, 32], SIZE, 1,
                                     torch.device("cuda"), rows, twin=True)
    for r in rows:
        assert all(r["twin_equal"].values()), r["twin_equal"]
        assert r["counters"]["primary"]["exec_windows"] > 0
    for k in (16, 32):
        assert _positive(rec["ks"][k]["build_seconds"],
                         *rec["ks"][k]["wall_ms"], *rec["ks"][k]["device_ms"])


def test_attr_sweep(tmp_path, capsys):
    from dustraytracer_tpu_torch.tools import attr_sweep

    out = tmp_path / "attr.json"
    assert attr_sweep.main(["--scene", SCENE, "--size", str(SIZE),
                            "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    attrs = [r for r in rows if "attribution" in r]
    assert [r["attribution"] for r in attrs] == ["primary", "bounce",
                                                 "shadow_anyhit"]
    for r in attrs:
        assert _positive(r["device_ms"], r["sol_raw_pct"]), r


def test_bench_prints_one_line(capsys):
    from dustraytracer_tpu_torch.tools import bench

    assert bench.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "rays_per_sec_chip_fwd_bwd"
    assert res["vs_baseline"] is None and res["wave_order"] == "pixel"
    assert _positive(res["value"], res["ms_per_sample"],
                     res["device_ms_per_sample"], res["sol_raw_pct"],
                     res["vol_eff_pct"])
