"""The program's spans and counters (utils/profiling.py) on the card: in
one profiled sample every K1 launch lies inside its bounce's trace or NEE
span on the profiler's own timeline; entering and leaving every span,
with the device counter on, makes the host wait for nothing; and the
launch counters count each kernel's launches on a render and a step."""

import json

import pytest
import torch

from dustraytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu
BOUNCES = 2
W = H = 64


@pytest.fixture(scope="module")
def sphere():
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import LightParams
    from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                          sphere_doc)

    scene = build_scene(sphere_doc(*SMALL_SPHERE)).to("cuda")
    cam = make_camera(**POSE, device="cuda")
    return scene, cam, LightParams


def _settings(fetch):
    from dustraytracer_tpu_torch.scene.settings import RenderSettings

    return RenderSettings(bounces=BOUNCES, traversal="sweep",
                          shade_fetch=fetch)


def _sample(sphere, fetch):
    from dustraytracer_tpu_torch.render.integrator import render_sample

    scene, cam, light_cls = sphere
    st = _settings(fetch)
    with torch.inference_mode():
        return render_sample(scene, cam, light_cls.from_settings(
            st, device="cuda"), 0, width=W, height=H, settings=st)


@pytest.mark.parametrize("fetch", ["gather", "kernel"])
def test_k1_launches_lie_inside_their_spans(sphere, fetch, tmp_path):
    _sample(sphere, fetch)  # loads the kernels
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has lost a process's kernels before
        with profiling.trace(str(tmp_path)):
            _sample(sphere, fetch)
            torch.cuda.synchronize()
        events = json.loads((tmp_path / "trace.json").read_text())
        evs = events["traceEvents"]
        k1 = [e for e in evs if e.get("cat") == "kernel"
              and "traverse_sweep_kernel" in e.get("name", "")]
        if k1:
            break
    assert len(k1) == 2 * BOUNCES
    launch = {e["args"]["correlation"]: e for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = [e for e in evs if e.get("name", "").startswith("drt.b")
             and e.get("cat") != "gpu_user_annotation" and "dur" in e]
    seen = []
    for k in k1:
        rt = launch[k["args"]["correlation"]]
        holders = [s["name"] for s in spans if s["ts"] <= rt["ts"]
                   and rt["ts"] + rt.get("dur", 0) <= s["ts"] + s["dur"]]
        assert len(holders) == 1, (k["name"], holders)
        seen.append(holders[0])
    assert sorted(seen) == sorted(f"drt.b{i}.{part}" for i in range(BOUNCES)
                                  for part in ("trace", "nee"))


def test_spans_make_the_host_wait_for_nothing():
    names = ["drt.frame", "drt.sample", "drt.raygen", "drt.post",
             "drt.film_add", "drt.film_image", "drt.step",
             "drt.step.forward", "drt.step.backward", "drt.step.adam",
             "drt.step.project", "drt.bwd.shade", "drt.bwd.rows",
             *(f"drt.b{i}.{part}" for i in range(BOUNCES)
               for part in ("trace", "shade", "nee", "scatter"))]
    live = torch.ones(4096, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    profiling.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.recording():
            for name in names:
                with profiling.span(name):
                    profiling.count("drt.k4.lanes", live.shape[0])
                    profiling.count_device("drt.k4.live_lanes", live.sum())
            for i in range(BOUNCES):
                profiling.chain(f"drt.bwd.b{i}")
            profiling.end_chain()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert set(profiling.span_totals()) == set(names) | {
        f"drt.bwd.b{i}" for i in range(BOUNCES)}
    got = profiling.counters("drt.k4.")
    assert got == {"drt.k4.lanes": 4096 * len(names),
                   "drt.k4.live_lanes": 4096 * len(names)}
    profiling.clear()


@pytest.mark.parametrize("fetch", ["gather", "kernel"])
def test_launch_counters_count_each_kernel(sphere, fetch):
    from dustraytracer_tpu_torch.tools.grad_bench import grad_step

    scene, cam, light_cls = sphere
    profiling.clear()
    _sample(sphere, fetch)
    torch.cuda.synchronize()
    emit = BOUNCES if fetch == "kernel" else 0
    assert profiling.counters("drt.launch.") == {
        "drt.launch.k1": 2 * BOUNCES - emit,
        **({"drt.launch.k1_emit": emit} if emit else {})}
    if fetch == "gather":  # the bench step: 2 x bounces - 1 K4 calls
        profiling.clear()
        st = _settings(fetch)
        with profiling.recording():
            grad_step(scene, cam, light_cls.from_settings(st, device="cuda"),
                      st, W, H)
        torch.cuda.synchronize()
        got = profiling.counters("drt.launch.")
        assert got["drt.launch.k4"] == 2 * BOUNCES - 1, got
        # each segment's backward span ended with the backward, on
        # autograd's thread
        ends = [r for r in profiling.spans() if r["name"].startswith(
            "drt.bwd.b")]
        assert sorted(r["name"] for r in ends) == [
            f"drt.bwd.b{i}" for i in range(BOUNCES)]
    profiling.clear()
