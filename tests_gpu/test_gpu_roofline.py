"""utils/roofline.py's measurements on the card: the FP32 peak kernel
(csrc/peaks.cu) against its float64 plain version, the measured peaks at
or below 105% of NVIDIA's figures, a calibration of K1 that is not
degenerate, and K1's speed of light on a 64x64 wave of the bench sphere
within the 170% guard, with the replay agreeing with the kernel's
counters."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def sphere():
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.ab_main_paths import sweep_waves
    from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc

    scene = build_scene(sphere_doc()).to("cuda")
    lights = LightParams.from_settings(RenderSettings(bounces=4),
                                       device="cuda")
    waves = sweep_waves(scene, make_camera(**POSE, device="cuda"), lights, 64)
    return scene.cluster, waves


@pytest.fixture(scope="module")
def rates(sphere):
    from dustraytracer_tpu_torch.utils import roofline as rl

    cb, _ = sphere
    return rl.calibrate_sweep_rates(cb.k, cb.v0.shape[0])


@pytest.mark.parametrize("iters", [1, 1024, 33792])
def test_fma_kernel_matches_plain(iters):
    from dustraytracer_tpu_torch.ops import peaks as pk
    from dustraytracer_tpu_torch.utils import profiling

    def launches():
        return profiling.counters("drt.launch.fma_peak").get(
            "drt.launch.fma_peak", 0)

    n = pk.fill_threads()
    x0 = torch.linspace(1.0, 1.25, n, device="cuda")
    before = launches()
    got = pk.fma_chain(x0, iters)
    torch.cuda.synchronize()
    assert launches() == before + 1
    ref = pk.fma_chain_reference(x0, iters)
    err = (got.double() - ref).abs()
    assert bool((err <= pk.fma_tolerance(ref, iters)).all()), float(err.max())


def test_peaks_within_published():
    from dustraytracer_tpu_torch.utils import roofline as rl

    peaks = rl.measure_peaks()
    assert peaks["device"] == torch.cuda.get_device_name(0)
    for key, pub in rl.PUBLISHED.items():
        assert 0.0 < peaks[key] <= rl.PEAK_CEILING * pub, (key, peaks[key])


def test_calibration_not_degenerate(rates):
    assert rates["window_ns"] > 0 and rates["leaf_ns"] > 0
    assert min(rates["leaf_iteration_ns"].values()) > 0
    for name, (a, b) in rates["chains"].items():
        assert b["exec_windows"] > a["exec_windows"], name
        assert b["seconds"] > a["seconds"], name


@pytest.mark.parametrize("wave", ["primary", "bounce", "shadow_anyhit"])
def test_attribution_and_volume(sphere, rates, wave):
    from dustraytracer_tpu_torch.utils import roofline as rl

    cb, waves = sphere
    o, d, anyhit = waves[wave]
    att = rl.sweep_attribution(cb, o, d, rates, anyhit=anyhit)
    assert att["measured_s"] > 0
    assert 0.0 < att["sol_raw_pct"] <= rl.SOL_CEILING_PCT
    assert att["sol_pct"] == min(att["sol_raw_pct"], 100.0)
    vol = rl.volume_efficiency(cb, o, d, rates, max_tiles=4096 // rl.WARP,
                               anyhit=anyhit)
    assert vol["visits_equal_pct"] >= 99.0, vol
    assert abs(vol["vol_eff_window_pct"] - vol["kernel_window_pct"]) <= 1.0
    assert 0.0 < vol["vol_eff_pct"] <= 101.0
