"""The forward sample replayed as CUDA graphs (render/graphed.py) on the
card: torch.profiler sees the replayed kernels, K1 among them; graphed
and eager films are equal bit for bit on both benchmark configurations
over two views of 8 samples, and on every option the predicate lets
through; a graphed frame makes the host wait for nothing; each option
the predicate names as syncing does make the eager sample wait; a new
scene or size recaptures; and the counters count captures, replays and
the kernels' launches."""

import pytest
import torch

from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.film import (Film, film_accumulate,
                                                 film_add, film_image,
                                                 film_init,
                                                 render_progressive)
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      sphere_doc)
from dustraytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu
# the benchmark's two configurations: sphere, size, bounces, camera
CONFIGS = {
    "suzanne_512": ((22, 23), 512, 512, 4,
                    dict(position=(0.0, 1.5, 5.0), look_at=(0.0, 0.5, 0.0),
                         vfov_deg=45.0)),
    "dense_monkey_1k": ((128, 64), 1024, 1024, 2,
                        dict(position=(0.0, 1.0, 4.0),
                             look_at=(0.0, 0.5, 0.0), vfov_deg=45.0)),
}
SECOND_VIEW = dict(position=(2.5, 2.0, 3.5), look_at=(0.0, 0.6, 0.0),
                   vfov_deg=40.0, exposure=1.5)
W, H = 64, 48


@pytest.fixture(scope="module")
def small():
    return build_scene(sphere_doc(*SMALL_SPHERE)).to("cuda")


@pytest.fixture(autouse=True)
def _clean():
    torch.cuda.set_sync_debug_mode("default")
    profiling.clear()
    yield
    torch.cuda.set_sync_debug_mode("default")
    profiling.clear()


def _eager(scene, cam, lights, film, count, w, h, st):
    with torch.inference_mode():
        for _ in range(count):
            film = film_add(film, render_sample(
                scene, cam, lights, film.frame, width=w, height=h,
                settings=st))
    return film


def _views(scene, st, w, h, poses, spp, accumulate):
    """One film per pose, view i starting at frame i * spp, so that every
    frame index differs."""
    lights = LightParams.from_settings(st, device="cuda")
    out = []
    for i, pose in enumerate(poses):
        cam = make_camera(**pose, device="cuda")
        film = Film(torch.zeros((h, w, 3), device="cuda"), i * spp)
        out.append(accumulate(scene, cam, lights, film, spp, w, h, st).accum)
    return out


def _graphed(scene, cam, lights, film, count, w, h, st):
    return film_accumulate(scene, cam, lights, film, count, width=w,
                           height=h, settings=st)


def _runner():
    """The one device's graph runner."""
    (run,) = graphed._RUNNERS.values()
    return run


def _kernels(prof) -> list:
    return [e.name for e in profiling.device_ops(prof)
            if not e.name.startswith(("Memcpy", "Memset"))]


def test_profiler_sees_the_replayed_kernels(small):
    st = RenderSettings(bounces=2, traversal="sweep")
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    film = film_accumulate(small, cam, lights, film_init(W, H, "cuda"), 1,
                           width=W, height=H, settings=st)  # captures
    run = _runner()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has lost a process's kernels before
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            film = film_accumulate(small, cam, lights, film, 1, width=W,
                                   height=H, settings=st)
            torch.cuda.synchronize()
        graphed_k = _kernels(prof)
        if graphed_k:
            break
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _eager(small, cam, lights, film, 1, W, H, st)
        torch.cuda.synchronize()
    eager_k = _kernels(prof)
    assert _runner() is run
    k1 = [n for n in graphed_k if "traverse_sweep_kernel" in n]
    assert len(k1) == 2 * st.bounces, graphed_k
    # the same kernels but: the eager sample's live-lane count (on under
    # a profiler, 2 a bounce) and pixel ids (1); the graphs' inputs copy
    # and fill (2) and the frame's salt, hashed on the card (11)
    extra = 2 + 11 - 2 * st.bounces - 1
    assert len(graphed_k) == len(eager_k) + extra, (len(graphed_k),
                                                    len(eager_k))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_graphed_films_equal_eager_films(config):
    sphere, w, h, bounces, pose = CONFIGS[config]
    scene = build_scene(sphere_doc(*sphere)).to("cuda")
    st = RenderSettings(bounces=bounces)
    poses = [pose, SECOND_VIEW]
    got = _views(scene, st, w, h, poses, 8, _graphed)
    assert _runner().scene() is scene
    want = _views(scene, st, w, h, poses, 8, _eager)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert not torch.equal(got[0], got[1])


def test_graphed_frames_make_the_host_wait_for_nothing():
    sphere, w, h, bounces, pose = CONFIGS["suzanne_512"]
    scene = build_scene(sphere_doc(*sphere)).to("cuda")
    st = RenderSettings(bounces=bounces)
    cam = make_camera(**pose, device="cuda")
    # capture, and the lights built on the card once
    render_progressive(scene, cam, st, width=w, height=h, spp=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    film = None
    for _ in range(3):
        film = render_progressive(scene, cam, st, width=w, height=h, spp=1,
                                  film=film)
        film_image(film)
    torch.cuda.set_sync_debug_mode("default")
    assert film.frame == 3


def test_new_scene_or_size_recaptures_and_counts(small):
    st = RenderSettings(bounces=2, traversal="sweep")
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    graphed._RUNNERS.clear()

    def frames(scene, w, h, n=2):
        film_accumulate(scene, cam, lights, film_init(w, h, "cuda"), n,
                        width=w, height=h, settings=st)

    frames(small, W, H)
    n = len(_runner().graphs)
    assert n == 2 + 4 * st.bounces
    assert profiling.counters("drt.graph.")["drt.graph.captures"] == n
    frames(small, W, H)  # the same key replays
    assert profiling.counters("drt.graph.")["drt.graph.captures"] == n
    frames(small, W + 16, H)  # a new size
    assert profiling.counters("drt.graph.")["drt.graph.captures"] == 2 * n
    other = build_scene(sphere_doc(*SMALL_SPHERE, seed=1)).to("cuda")
    frames(other, W + 16, H)  # a new scene
    assert profiling.counters("drt.graph.")["drt.graph.captures"] == 3 * n
    frames(other, W + 16, H, 3)
    assert "drt.graph.replays" not in profiling.counters("drt.graph.")
    with profiling.recording():
        frames(other, W + 16, H, 3)
    assert profiling.counters("drt.graph.")["drt.graph.replays"] == 3 * n


@pytest.mark.parametrize("fetch", ["gather", "kernel"])
def test_replays_count_the_kernels_launches(small, fetch):
    st = RenderSettings(bounces=2, traversal="sweep", shade_fetch=fetch)
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    film_accumulate(small, cam, lights, film_init(W, H, "cuda"), 1,
                    width=W, height=H, settings=st)  # capture
    profiling.clear()
    film_accumulate(small, cam, lights, film_init(W, H, "cuda"), 3,
                    width=W, height=H, settings=st)
    graphed_c = profiling.counters("drt.launch.")
    profiling.clear()
    _eager(small, cam, lights, film_init(W, H, "cuda"), 3, W, H, st)
    assert graphed_c == profiling.counters("drt.launch.")
    emit = st.bounces if fetch == "kernel" else 0
    assert graphed_c.get("drt.launch.k1", 0) == 3 * (2 * st.bounces - emit)


# every option the predicate lets through, on the small sphere
GRAPHABLE = {
    "brute": {"traversal": "auto"},
    "pbr": {"shading": "pbr"},
    "soft_edges": {"soft_edges": 0.05},
    "kernel_fetch": {"shade_fetch": "kernel"},
    "roulette": {"russian_roulette": True, "rr_start_bounce": 1},
    "cosine": {"cosine_weighted": True, "nee_cosine": True},
    "smooth_bilinear": {"smooth_shading": True, "tex_filter": "bilinear"},
    "no_sun": {"enable_sunlight": False},
    "no_post": {"enable_tonemap": False, "enable_gamma": False},
    "ray_sort": {"ray_sort": "on"},
}


@pytest.mark.parametrize("option", list(GRAPHABLE))
def test_graphable_option_equals_eager_and_never_waits(small, option):
    st = RenderSettings(bounces=3, **{"traversal": "sweep",
                                      **GRAPHABLE[option]})
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    with torch.inference_mode():
        assert graphed.eager_reason(small, cam, lights, st) is None
    got = _views(small, st, W, H, [POSE, SECOND_VIEW], 3, _graphed)
    want = _views(small, st, W, H, [POSE, SECOND_VIEW], 3, _eager)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    film_accumulate(small, cam, lights, film_init(W, H, "cuda"), 2, width=W,
                    height=H, settings=st)
    torch.cuda.set_sync_debug_mode("default")


SYNCING = {"traversal=cluster": {"traversal": "cluster"},
           "traversal=gather": {"traversal": "gather"},
           "alpha_test": {"alpha_test": True}}


@pytest.mark.parametrize("option", list(SYNCING))
def test_syncing_option_stays_eager_and_does_wait(small, option):
    assert set(SYNCING) == set(graphed.SYNCING)
    st = RenderSettings(bounces=2, **SYNCING[option])
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    with torch.inference_mode():
        assert graphed.eager_reason(small, cam, lights, st) == \
            graphed.SYNCING[option]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    with pytest.raises(RuntimeError, match="synchroniz"):
        with torch.inference_mode():
            render_sample(small, cam, lights, 0, width=W, height=H,
                          settings=st)
    torch.cuda.set_sync_debug_mode("default")
