"""The forward sample's CUDA-graph path (render/graphed.py) on the CPU,
where it never engages: the host-wait-free pieces it rests on (the RNG
salt of an int or a 0-d tensor frame, the tonemap's white point), the
stages read through static inputs equal to render_pixels bit for bit,
the predicate's reason for each setting that keeps a sample eager (and
the train step's, without the grad rule), the ForwardRecord that the
train step's forward reports to, the lights built once per settings,
and the benchmark's reader of the replay counter."""

import pytest
import torch

from bench_port import harness
from dustraytracer_tpu_torch.ops import rng, tonemap
from dustraytracer_tpu_torch.render import film as film_mod
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.apps import optimize
from dustraytracer_tpu_torch.render.integrator import (_resolve_fetch,
                                                       render_pixels,
                                                       render_sample,
                                                       reporting_to,
                                                       sample_stages)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (DebugMode, LightParams,
                                                    RenderMode,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      sphere_doc)
from dustraytracer_tpu_torch.utils import profiling

W, H = 24, 16


@pytest.fixture(scope="module")
def scene():
    return build_scene(sphere_doc(*SMALL_SPHERE))


@pytest.mark.parametrize("frame", [0, 1, 7, 123456789, 2 ** 32 + 5, -3])
def test_seed_pixels_int_and_tensor_frames_agree(frame):
    ids = torch.arange(5000, dtype=torch.int64) * 7919
    host = rng.seed_pixels(ids, frame)
    dev = rng.seed_pixels(ids, torch.tensor(frame, dtype=torch.int64))
    assert host.dtype == dev.dtype == torch.int64
    assert torch.equal(host, dev)
    assert int(host.min()) >= 0 and int(host.max()) < 2 ** 32


def test_tonemap_constant_is_the_float32_white_point():
    white = tonemap._uncharted2_partial(torch.tensor(11.2,
                                                     dtype=torch.float32))
    old = (1.0 / white)  # the float32 0-d tensor the tonemap multiplied by
    assert torch.tensor(tonemap.INV_WHITE, dtype=torch.float32).view(
        torch.int32) == old.view(torch.int32)
    assert tonemap.INV_WHITE == old.item()
    x = torch.rand(4096, 3, generator=torch.Generator().manual_seed(3)) * 40
    curr = tonemap._uncharted2_partial(x * 2.0)
    assert torch.equal(tonemap.uncharted2_filmic(x, 2.0), curr * old)


@pytest.mark.parametrize("kw", [
    {}, {"shading": "pbr"}, {"soft_edges": 0.05},
    {"traversal": "sweep", "shade_fetch": "kernel"},
    {"enable_sunlight": False}, {"enable_tonemap": False,
                                 "enable_gamma": False}],
    ids=["reference", "pbr", "soft_edges", "kernel_fetch", "no_sun",
         "no_post"])
def test_stages_on_static_inputs_equal_render_pixels(scene, kw):
    """The stages built once on StaticInputs and run after each load read
    the loaded camera, lights and frame, as a graph's replay does: each
    run equals render_sample bit for bit."""
    st = RenderSettings(bounces=2, **kw)
    cams = [make_camera(**POSE),
            make_camera(position=(1.0, 2.0, 4.0), look_at=(0.0, 0.6, 0.0),
                        vfov_deg=50.0, exposure=1.5)]
    lights = [LightParams.from_settings(st),
              LightParams.from_settings(st.replace(sun_azimuth=2.0,
                                                   sky_intensity=7.0))]
    inputs = graphed.StaticInputs(cams[0], lights[0], scene.device)
    stages = sample_stages(
        scene, inputs.camera, inputs.lights, inputs.frame,
        torch.arange(W * H), width=W, height=H, count_lanes=False,
        settings=st.replace(shade_fetch=_resolve_fetch(scene, st)))
    with torch.inference_mode():
        for cam, lit, frame in [(cams[0], lights[0], 3),
                                (cams[1], lights[1], 4),
                                (cams[0], lights[1], 2 ** 33 + 1)]:
            inputs.load(cam, lit, frame)
            state = None
            for _, stage in stages:
                state = stage(state)
            want = render_sample(scene, cam, lit, frame, width=W, height=H,
                                 settings=st)
            assert torch.equal(state["light"].view(H, W, 3), want)


def _cuda_stand_in(scene):
    """The scene's tables on a stand-in whose device reads "cuda", so that
    the predicate passes its device check on the CPU."""
    return type("S", (), {"device": torch.device("cuda"),
                          "cluster": scene.cluster})()


CASES = ["cpu", "grad", "debug", "cluster", "gather", "alpha_test", "fields"]


@pytest.mark.parametrize("case,reason", [
    *(pytest.param(c, "eager_reason", id=c) for c in CASES),
    *(pytest.param(c, "forward_reason", id=f"{c}-forward_reason")
      for c in CASES)])
def test_eager_reason_names_each_setting(scene, case, reason):
    st = RenderSettings(bounces=2)
    cam, lit = make_camera(**POSE), LightParams.from_settings(st)
    fake = _cuda_stand_in(scene)
    want = {"cpu": "not CUDA", "grad": "grad is on", "debug": "DEBUG",
            "cluster": graphed.SYNCING["traversal=cluster"],
            "gather": graphed.SYNCING["traversal=gather"],
            "alpha_test": graphed.SYNCING["alpha_test"],
            "fields": "not float32 on the device"}[case]
    if reason == "forward_reason" and case == "grad":
        # the grad rule is eager_reason's alone: a capture of the train
        # step records autograd's ops too
        want = "not float32 on the device"
    kw = {"scene": fake, "camera": cam, "lights": lit, "settings": st}
    if case == "cpu":
        kw["scene"] = scene
    elif case == "debug":
        kw["settings"] = st.replace(render_mode=RenderMode.DEBUG,
                                    debug_mode=DebugMode.NORMAL)
    elif case in ("cluster", "gather"):
        kw["settings"] = st.replace(traversal=case)
    elif case == "alpha_test":
        kw["settings"] = st.replace(alpha_test=True)
    if case == "grad":
        with torch.enable_grad():
            got = getattr(graphed, reason)(**kw)
    else:
        with torch.inference_mode():
            got = getattr(graphed, reason)(**kw)
    assert got is not None and want in got


def test_forward_record_collects_each_render_call(scene):
    """A loss's render_pixels calls report their reason, card and
    resolved settings to the ForwardRecord of reporting_to, through a
    plain closure around the loss as the benchmark wraps it, and a
    mesh's tiles one call each; a loss that renders nothing, or on two
    devices, cannot be captured either."""
    st = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    cam, lit = make_camera(**POSE), LightParams.from_settings(st)
    cpu = torch.device("cpu")
    params = optimize.as_leaves({"mat_albedo": scene.mat_albedo})
    target = torch.zeros((H, W, 3))

    def loss(mesh=None):
        base = optimize.make_loss_fn(scene, cam, lit, target, width=W,
                                     height=H, settings=st, mesh=mesh)

        def wrapped(p, frame):
            return base(p, frame)

        return wrapped

    for mesh, calls in [(None, 1), ([cpu, cpu], 2)]:
        rec = graphed.ForwardRecord()
        with reporting_to(rec):
            loss(mesh)(params, 0)
        assert len(rec.calls) == calls
        assert all("not CUDA" in r and d == cpu for r, d, _ in rec.calls)
        assert rec.settings() == [st.replace(
            shade_fetch=_resolve_fetch(scene, st))] * calls
        assert "not CUDA" in rec.reason(cpu)
        assert "not one card" in rec.reason(torch.device("meta"))
    assert "no render_pixels" in graphed.ForwardRecord().reason(cpu)
    # outside the block nothing reports
    rec = graphed.ForwardRecord()
    loss()(params, 0)
    assert not rec.calls


def test_capturing_record_keeps_the_live_lanes(scene):
    """Inside a capturing ForwardRecord, with spans off, each material
    fetch reports its lanes and live-lane sum: the counts that the eager
    sample adds to drt.k4.lanes and drt.k4.live_lanes while spans are
    on."""
    st = RenderSettings(bounces=3)
    cam, lit = make_camera(**POSE), LightParams.from_settings(st)
    ids = torch.arange(W * H)

    def sample():
        return render_pixels(scene, cam, lit, 5, ids, width=W, height=H,
                             settings=st)

    profiling.clear()
    with profiling.recording():
        want = sample()
        counted = profiling.counters("drt.k4.")
    profiling.clear()
    for capturing in (False, True):
        rec = graphed.ForwardRecord(capturing=capturing)
        with reporting_to(rec):
            got = sample()
        assert torch.equal(got, want)
        if not capturing:
            assert rec.n_lanes == 0 and not rec.live
    assert rec.n_lanes == counted["drt.k4.lanes"] == st.bounces * W * H
    assert len(rec.live) == st.bounces
    assert int(torch.stack(rec.live).sum()) == counted["drt.k4.live_lanes"]
    # muted spans count nothing, and report to the record
    rec = graphed.ForwardRecord(capturing=True)
    with profiling.recording(), profiling.muted(), reporting_to(rec):
        sample()
        assert profiling.span("drt.x") is profiling._OFF
        assert not profiling.enabled()
    assert rec.n_lanes == st.bounces * W * H
    assert not profiling.counters("drt.k4.") and not profiling.spans()


def test_film_on_the_cpu_stays_eager(scene):
    st = RenderSettings(bounces=2)
    graphed._RUNNERS.clear()
    film = film_mod.render_progressive(scene, make_camera(**POSE), st,
                                       width=W, height=H, spp=2)
    assert film.frame == 2 and not graphed._RUNNERS


def test_render_progressive_builds_lights_once_per_settings(scene,
                                                            monkeypatch):
    calls = []
    build = LightParams.from_settings.__func__

    def counted(cls, s, device="cpu"):
        calls.append(s)
        return build(cls, s, device)

    monkeypatch.setattr(LightParams, "from_settings", classmethod(counted))
    monkeypatch.setattr(film_mod, "_LIGHTS", {})
    cam = make_camera(**POSE)
    st = RenderSettings(bounces=1)
    film = None
    for _ in range(3):
        film = film_mod.render_progressive(scene, cam, st, width=W,
                                           height=H, spp=1, film=film)
    assert len(calls) == 1
    # the same light fields in other settings reuse them; new ones do not
    film_mod.render_progressive(scene, cam, st.replace(bounces=2), width=W,
                                height=H, spp=1)
    assert len(calls) == 1
    other = st.replace(sun_intensity=12.0)
    film_mod.render_progressive(scene, cam, other, width=W, height=H, spp=1)
    film_mod.render_progressive(scene, cam, other, width=W, height=H, spp=1)
    assert len(calls) == 2
    # and the film is the one that explicit lights give
    again = None
    for _ in range(3):
        again = film_mod.render_progressive(
            scene, cam, st, width=W, height=H, spp=1, film=again,
            lights=build(LightParams, st, "cpu"))
    assert torch.equal(again.accum, film.accum)


@pytest.mark.parametrize("replays", [None, 0, 36])
def test_graph_replay_reader(scene, monkeypatch, replays):
    read = harness.reader(harness.DATA, "graph_replays_per_frame.render")
    profiling.clear()
    with profiling.recording():
        cam = make_camera(**POSE)
        film = None
        for _ in range(2):
            film = film_mod.render_progressive(
                scene, cam, RenderSettings(bounces=2), width=W, height=H,
                spp=1, film=film)
    assert read({"loop": "train"}) is None
    if replays is None:  # a program without a counter table
        monkeypatch.delattr(profiling, "counters")
        assert read({"loop": "render"}) is None
        return
    if replays:
        profiling.count("drt.graph.replays", replays)
    assert read({"loop": "render"}) == replays / 2
    totals = profiling.span_totals()
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        k: v for k, v in totals.items() if k != "drt.frame"})
    with pytest.raises(RuntimeError, match="graph_replays_per_frame"):
        read({"loop": "render"})
    profiling.clear()
