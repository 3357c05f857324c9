"""The film over a mesh of cards (render/film.py's TileFilm) on the card.
With four cards or more (the others skip): the graphed four-card film
equals the one-card graphed film of the same views bit for bit on both
benchmark configurations; a mesh frame issues every card and gathers the
tiles with no host wait up to the caller's synchronize; each card
replays its stages' graphs, ten a sample on the dense scene, with a
device timer each; and the gather's copies are the frame's only
peer-to-peer copies, as the benchmark's `gather_ms_per_frame.tiles4`
reads them. On any card: the mesh [cuda:0] * 4 keeps one runner per
tile, replays graphs and equals the one-card film; and
sharded_render_sample over [cuda:0] * 1, 2 and 4 replays its tiles'
runners, with a tile's launches of render_sample each, and equals
render_sample bit for bit."""

import pytest
import torch

from dustraytracer_tpu_torch.parallel.mesh import replicate_scene
from dustraytracer_tpu_torch.parallel.shard import sharded_render_sample
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.film import (TileFilm, film_image,
                                                 render_progressive)
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import sphere_doc
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


def _four_cards() -> list:
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four cards, {n} here")
    return [torch.device("cuda", i) for i in range(4)]


def _sync(mesh):
    for card in dict.fromkeys(mesh):
        torch.cuda.synchronize(card)


@pytest.fixture(autouse=True)
def _clean():
    torch.cuda.set_sync_debug_mode("default")
    profiling.clear()
    yield
    torch.cuda.set_sync_debug_mode("default")
    profiling.clear()
    _sync([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    graphed._RUNNERS.clear()


def _config(name):
    sphere, w, h, bounces, pose = CONFIGS[name]
    scene = build_scene(sphere_doc(*sphere)).to("cuda:0")
    return scene, w, h, RenderSettings(bounces=bounces), pose


def _images(scene, st, w, h, poses, spp, mesh=None):
    """film_image after `spp` frames of render_progressive(spp=1) per
    pose; with a mesh, the scene replicated and the camera made on every
    entry's device."""
    scenes = replicate_scene(scene, mesh) if mesh else scene
    out = []
    for pose in poses:
        cam = ([make_camera(**pose, device=d) for d in mesh] if mesh
               else make_camera(**pose, device="cuda:0"))
        film = None
        for _ in range(spp):
            film = render_progressive(scenes, cam, st, width=w, height=h,
                                      spp=1, film=film, mesh=mesh)
        out.append(film_image(film))
        assert isinstance(film, TileFilm) == bool(mesh)
    _sync(mesh or [torch.device("cuda", 0)])
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_four_card_film_equals_one_card_film(config):
    mesh = _four_cards()
    scene, w, h, st, pose = _config(config)
    poses = [pose, SECOND_VIEW]
    one = _images(scene, st, w, h, poses, 8)
    four = _images(scene, st, w, h, poses, 8, mesh)
    tiles = sorted((k for k in graphed._RUNNERS if k[2] - k[1] < w * h),
                   key=lambda k: k[1])
    assert [k[0] for k in tiles] == mesh
    for a, b in zip(one, four):
        assert b.device == mesh[0]
        assert torch.equal(a, b)
    assert not torch.equal(four[0], four[1])


def test_mesh_frame_never_makes_the_host_wait():
    mesh = _four_cards()
    scene, w, h, st, pose = _config("dense_monkey_1k")
    scenes = replicate_scene(scene, mesh)
    cams = [make_camera(**pose, device=d) for d in mesh]
    # capture every card's graphs, and the lights built on every card
    film_image(render_progressive(scenes, cams, st, width=w, height=h,
                                  spp=1, mesh=mesh))
    _sync(mesh)
    torch.cuda.set_sync_debug_mode("error")
    film = None
    with profiling.recording():
        for _ in range(3):
            film = render_progressive(scenes, cams, st, width=w, height=h,
                                      spp=1, film=film, mesh=mesh)
            film_image(film)
    torch.cuda.set_sync_debug_mode("default")
    _sync(mesh)
    assert film.frame == 3
    issued = [r["name"] for r in profiling.spans()
              if r["name"].startswith("drt.tile.c")]
    assert issued == [f"drt.tile.c{i}" for i in range(4)] * 3


def test_each_card_replays_its_stages():
    mesh = _four_cards()
    scene, w, h, st, pose = _config("dense_monkey_1k")
    scenes = replicate_scene(scene, mesh)
    cams = [make_camera(**pose, device=d) for d in mesh]
    film = render_progressive(scenes, cams, st, width=w, height=h, spp=1,
                              mesh=mesh)  # captures
    runs = [graphed._RUNNERS[(d,) + b] for d, b in
            zip(mesh, [(i * w * h // 4, (i + 1) * w * h // 4)
                       for i in range(4)])]
    assert [len(r.graphs) for r in runs] == [10] * 4
    captures = profiling.counters("drt.graph.")["drt.graph.captures"]
    _sync(mesh)
    with profiling.recording():
        for _ in range(2):
            film = render_progressive(scenes, cams, st, width=w, height=h,
                                      spp=1, film=film, mesh=mesh)
    got = profiling.counters("drt.")
    assert got["drt.graph.replays"] == 2 * 4 * 10
    assert got["drt.graph.captures"] == captures
    assert got["drt.tiles.cards"] == 2 * 4
    ms = [got[f"drt.tile.c{i}.device_ms"] for i in range(4)]
    assert all(m > 0 for m in ms), ms


def test_gather_copies_are_the_frames_peer_copies():
    mesh = _four_cards()
    scene, w, h, st, pose = _config("dense_monkey_1k")
    scenes = replicate_scene(scene, mesh)
    cams = [make_camera(**pose, device=d) for d in mesh]
    film = render_progressive(scenes, cams, st, width=w, height=h, spp=1,
                              mesh=mesh)
    film_image(film)
    _sync(mesh)
    for _ in range(3):  # the profiler has lost a process's events before
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                film = render_progressive(scenes, cams, st, width=w,
                                          height=h, spp=1, film=film,
                                          mesh=mesh)
                film_image(film)
            _sync(mesh)
        names = [e.name for e in profiling.device_ops(prof)]
        if names:
            break
    copies = sorted({n for n in names if n.startswith("Memcpy")})
    peer = [n for n in names if n.startswith("Memcpy PtoP")]
    assert len(peer) == 2 * 3, copies


def test_one_card_named_four_times_keeps_a_runner_per_tile():
    scene, w, h, st, pose = _config("suzanne_512")
    mesh = [torch.device("cuda", 0)] * 4
    poses = [pose, SECOND_VIEW]
    one = _images(scene, st, w, h, poses, 4)
    profiling.clear()
    with profiling.recording():
        four = _images(scene, st, w, h, poses, 4, mesh)
    assert len(graphed._RUNNERS) == 4
    got = profiling.counters("drt.graph.")
    # four tiles captured once each (the whole image's runner freed),
    # then replayed every sample
    n = len(next(iter(graphed._RUNNERS.values())).graphs)
    assert got["drt.graph.captures"] == 4 * n
    assert got["drt.graph.replays"] == 2 * 4 * 4 * n
    for a, b in zip(one, four):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_sharded_render_sample_replays_the_tile_runners(tiles):
    scene, w, h, st, pose = _config("suzanne_512")
    cam = make_camera(**pose, device="cuda:0")
    lights = LightParams.from_settings(st, device="cuda:0")
    mesh = [torch.device("cuda", 0)] * tiles

    def sharded():
        return sharded_render_sample(scene, cam, lights, 3, mesh=mesh,
                                     width=w, height=h, settings=st)

    with torch.inference_mode():
        ref = render_sample(scene, cam, lights, 3, width=w, height=h,
                            settings=st)
        torch.cuda.synchronize()
        per_tile = {k: n for k, n in profiling.counters("drt.launch.").items()
                    if n}
        sharded()  # captures each tile's runner after an eager warm-up
        torch.cuda.synchronize()
        profiling.clear()
        with profiling.recording():
            out = sharded()
        torch.cuda.synchronize()
    got = profiling.counters("drt.")
    assert per_tile["drt.launch.k1"] > 0
    assert {k: n for k, n in profiling.counters("drt.launch.").items()
            if n} == {k: tiles * n for k, n in per_tile.items()}
    assert len(graphed._RUNNERS) == tiles
    n = len(next(iter(graphed._RUNNERS.values())).graphs)
    assert got["drt.graph.replays"] == tiles * n
    assert got.get("drt.graph.captures", 0) == 0
    assert torch.equal(out, ref)
