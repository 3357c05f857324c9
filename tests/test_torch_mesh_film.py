"""The film over a mesh (render/film.py's TileFilm: tile i of the pixels
rendered and accumulated on mesh[i], film_image gathering them onto
mesh[0]) on the CPU, with the meshes [cpu] * 4 and [cpu] * 2 over the
benchmark's seeded sphere (bench_port/scenes.py::sphere) at a tiny size:
equal to the single-device film bit for bit over samples and a change of
view, within the benchmark's limits of the plain reference, its spans
and counters, the refusal of pixels that do not divide the mesh, the
checkpoint's whole film and back, the CLI and the viewer over tiles,
and the graph runners' keying by (card, tile) with a stand-in capture."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import compare, scenes
from bench_port.reference import path as ref
from dustraytracer_tpu_torch.parallel import shard
from dustraytracer_tpu_torch.parallel.mesh import (replicate_scene,
                                                   tile_bounds)
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.film import (Film, TileFilm,
                                                 film_accumulate, film_image,
                                                 film_init, film_split,
                                                 film_whole,
                                                 render_progressive)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (DebugMode, LightParams,
                                                    RenderMode,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
W, H = 32, 24
SEED = 20251018
LIGHTS = json.loads((ROOT / "bench_port" / "configs" / "dense_monkey_1k.json")
                    .read_text())["lights"]
VIEWS = [dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0),
              vfov_deg=45.0, focus_dist=10.0),
         dict(position=(2.5, 2.0, 3.0), look_at=(0.0, 0.5, 0.0),
              vfov_deg=45.0, focus_dist=10.0)]
MESHES = {"cpu4": [CPU] * 4, "cpu2": [CPU] * 2}


@pytest.fixture(scope="module")
def soup():
    return scenes.sphere(16, 17, SEED)


@pytest.fixture(scope="module")
def scene(soup):
    return build_scene(scenes.to_document(soup))


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear()
    yield
    profiling.clear()


def _settings(**kw):
    return RenderSettings(bounces=2, **{**LIGHTS, "sun_color":
                                        tuple(LIGHTS["sun_color"]),
                                        "sky_color":
                                        tuple(LIGHTS["sky_color"]), **kw})


def _films(scene, mesh, st, spp=3):
    """Per view: the film after `spp` frames of render_progressive(spp=1),
    on one device and over the mesh."""
    out = []
    for view in VIEWS:
        cam = make_camera(**view)
        one = tiled = None
        for _ in range(spp):
            one = render_progressive(scene, cam, st, width=W, height=H,
                                     spp=1, film=one)
            tiled = render_progressive(scene, cam, st, width=W, height=H,
                                       spp=1, film=tiled, mesh=mesh)
        out.append((one, tiled))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_film_equals_single_device_film(scene, mesh):
    films = _films(scene, MESHES[mesh], _settings())
    for one, tiled in films:
        assert isinstance(one, Film) and isinstance(tiled, TileFilm)
        assert tiled.frame == one.frame == 3
        assert len(tiled.tiles) == len(MESHES[mesh])
        assert torch.equal(torch.cat(tiled.tiles),
                           one.accum.reshape(-1, 3))
        assert torch.equal(film_image(tiled), film_image(one))
        assert film_image(tiled).shape == (H, W, 3)
    assert not torch.equal(film_image(films[0][1]), film_image(films[1][1]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_film_agrees_with_the_plain_reference(soup, scene, mesh):
    """The cell's check at 8 spp: the mesh film's pixels drawn from a
    seed against bench_port/reference/path.py::film_pixels, within the
    render cells' limits."""
    st = _settings()
    limits = json.loads((ROOT / "bench_port" / "limits"
                         / "dense_monkey_1k_tiles4.render_orbit.json")
                        .read_text())
    rs = ref.RefScene(soup, CPU, torch.float32)
    alb = torch.tensor(np.float32([m["base_color"]
                                   for m in soup["materials"]]))
    lights = {k: torch.tensor(np.float32(LIGHTS[k])) for k in ref.LIGHT_KEYS}
    px = torch.as_tensor(np.random.default_rng(SEED).choice(W * H, 256,
                                                           replace=False))
    for view in VIEWS:
        film = None
        for _ in range(8):
            film = render_progressive(scene, make_camera(**view), st,
                                      width=W, height=H, spp=1, film=film,
                                      mesh=MESHES[mesh])
        got = film_image(film).reshape(-1, 3)[px]
        want = ref.film_pixels(rs, view, alb, lights, px, 8, width=W,
                               height=H, bounces=2, tonemap=True,
                               gamma=True, exposure=2.0)
        ok, checks = compare.judge(compare.pixel_numbers(got, want), limits)
        assert ok, checks


def test_a_frame_records_its_tiles_spans_and_counters(scene):
    mesh = MESHES["cpu4"]
    st = _settings()
    cam = make_camera(**VIEWS[0])
    film = render_progressive(scene, cam, st, width=W, height=H, spp=1,
                              mesh=mesh)
    assert not profiling.counters("drt.tiles.")  # off without recording
    with profiling.recording():
        for _ in range(2):
            film = render_progressive(scene, cam, st, width=W, height=H,
                                      spp=1, film=film, mesh=mesh)
            film_image(film)
        film_image(film)
    rows = profiling.spans()
    totals = profiling.span_totals()
    assert totals["drt.frame"]["count"] == 2
    assert totals["drt.tiles"]["count"] == 2
    assert totals["drt.tiles.gather"]["count"] == 3
    assert totals["drt.film_image"]["count"] == 3
    for i in range(4):
        assert totals[f"drt.tile.c{i}"]["count"] == 2
    assert "drt.tile.c4" not in totals
    by_id = {r["id"]: r for r in rows}

    def parent(r):
        return by_id[r["parent"]]["name"]

    for r in rows:
        if r["name"] == "drt.tiles":
            assert parent(r) == "drt.frame"
        elif r["name"].startswith("drt.tile.c"):
            assert parent(r) == "drt.tiles"
        elif r["name"] == "drt.tiles.gather":
            assert parent(r) == "drt.film_image"
    issued = [r["name"] for r in rows if r["name"].startswith("drt.tile.c")]
    assert issued == [f"drt.tile.c{i}" for i in range(4)] * 2
    got = profiling.counters("drt.tiles.")
    assert got["drt.tiles.cards"] == 2 * 4
    assert got["drt.tiles.gather_bytes"] == 3 * (3 * W * H // 4 * 3 * 4)
    # the CPU has no device timer
    assert not [k for k in profiling.counters() if k.endswith("device_ms")]


@pytest.mark.parametrize("size", [(5, 5), (30, 3)])
def test_pixels_that_do_not_divide_the_mesh_raise(scene, size):
    w, h = size
    cam = make_camera(**VIEWS[0])
    with pytest.raises(ValueError, match="must divide mesh size"):
        render_progressive(scene, cam, _settings(), width=w, height=h,
                           spp=1, mesh=MESHES["cpu4"])
    with pytest.raises(ValueError, match="must divide mesh size"):
        film_init(w, h, mesh=MESHES["cpu4"])


def test_a_mesh_of_one_device_is_the_whole_film(scene):
    st = _settings()
    cam = make_camera(**VIEWS[1])
    one = render_progressive(scene, cam, st, width=W, height=H, spp=2)
    mesh1 = render_progressive(scene, cam, st, width=W, height=H, spp=2,
                               mesh=[CPU])
    assert isinstance(mesh1, Film)
    assert torch.equal(one.accum, mesh1.accum)
    with profiling.recording():
        render_progressive(scene, cam, st, width=W, height=H, spp=1,
                           mesh=[CPU])
    assert "drt.tiles" not in profiling.span_totals()


def test_camera_and_lights_lists_and_replicas(scene):
    """A per-device list of scene, camera and lights (replicate_scene's)
    renders what single values do; film_accumulate renders over the
    TileFilm's devices, as the viewer calls it."""
    mesh = MESHES["cpu4"]
    st = _settings()
    cam = make_camera(**VIEWS[0])
    lights = LightParams.from_settings(st)
    a = render_progressive(scene, cam, st, width=W, height=H, spp=2,
                           mesh=mesh)
    b = render_progressive(replicate_scene(scene, mesh),
                           replicate_scene(cam, mesh), st, width=W, height=H,
                           spp=2, lights=replicate_scene(lights, mesh),
                           mesh=mesh)
    c = film_accumulate(scene, cam, lights, film_init(W, H, mesh=mesh), 2,
                        width=W, height=H, settings=st)
    for f in (b, c):
        assert torch.equal(torch.cat(f.tiles), torch.cat(a.tiles))
    with pytest.raises(ValueError, match="replicas for a mesh"):
        render_progressive(scene, [cam] * 3, st, width=W, height=H, spp=1,
                           mesh=mesh)


def test_max_samples_caps_the_mesh_film(scene):
    st = _settings(max_samples=3)
    cam = make_camera(**VIEWS[0])
    film = render_progressive(scene, cam, st, width=W, height=H, spp=2,
                              mesh=MESHES["cpu2"])
    film = render_progressive(scene, cam, st, width=W, height=H, spp=2,
                              film=film, mesh=MESHES["cpu2"])
    assert film.frame == 3
    one = render_progressive(scene, cam, st, width=W, height=H, spp=5)
    assert torch.equal(film_image(film), film_image(one))


def test_debug_view_over_the_mesh(scene):
    st = _settings(render_mode=RenderMode.DEBUG, debug_mode=DebugMode.NORMAL)
    cam = make_camera(**VIEWS[1])
    one = render_progressive(scene, cam, st, width=W, height=H, spp=1)
    tiled = render_progressive(scene, cam, st, width=W, height=H, spp=1,
                               mesh=MESHES["cpu4"])
    assert torch.equal(film_image(tiled), film_image(one))


def test_whole_film_and_split_round_trip(scene):
    mesh = MESHES["cpu4"]
    cam = make_camera(**VIEWS[0])
    tiled = render_progressive(scene, cam, _settings(), width=W, height=H,
                               spp=2, mesh=mesh)
    whole = film_whole(tiled)
    assert isinstance(whole, Film) and whole.frame == 2
    assert torch.equal(whole.accum.reshape(-1, 3), torch.cat(tiled.tiles))
    back = film_split(whole, mesh)
    assert back.frame == 2 and (back.width, back.height) == (W, H)
    for t, u in zip(back.tiles, tiled.tiles):
        assert torch.equal(t, u)
    assert film_whole(whole) is whole
    # a mesh of one device lays it out as film_init does: the whole Film
    one = film_split(whole, [CPU])
    assert isinstance(one, Film) and one.frame == 2
    assert torch.equal(one.accum, whole.accum)


def test_a_given_film_renders_where_it_lies(scene):
    """render_progressive continues a film on its own devices: a Film
    passed with a mesh stays one Film, a TileFilm passed without a mesh
    stays tiled, and both equal the single-device film."""
    st = _settings()
    cam = make_camera(**VIEWS[0])
    one = render_progressive(scene, cam, st, width=W, height=H, spp=2)
    start = render_progressive(scene, cam, st, width=W, height=H, spp=1)
    plain = render_progressive(scene, cam, st, width=W, height=H, spp=1,
                               film=start, mesh=MESHES["cpu4"])
    tiled = render_progressive(scene, cam, st, width=W, height=H, spp=1,
                               mesh=MESHES["cpu4"])
    tiled = render_progressive(scene, cam, st, width=W, height=H, spp=1,
                               film=tiled)
    assert isinstance(plain, Film) and isinstance(tiled, TileFilm)
    assert torch.equal(plain.accum, one.accum)
    assert torch.equal(film_image(tiled), film_image(one))


def test_render_tiles_keeps_its_results(scene):
    """render_tiles through the runners' path (eager on the CPU): the
    tiles of a frame, with an offset and a global tile count as a
    process of a multi-process job renders them."""
    st = _settings()
    cam = make_camera(**VIEWS[1])
    lights = LightParams.from_settings(st)
    whole = shard.sharded_render_sample(scene, cam, lights, 4,
                                        mesh=MESHES["cpu4"], width=W,
                                        height=H, settings=st)
    part = shard.render_tiles(scene, cam, lights, 4, mesh=MESHES["cpu2"],
                              width=W, height=H, settings=st, tile0=2,
                              n_tiles=4)
    assert torch.equal(part, whole.reshape(-1, 3)[W * H // 2:])
    assert tile_bounds(W * H, 4, 2, 2) == [(W * H // 2, 3 * W * H // 4),
                                           (3 * W * H // 4, W * H)]


class _FakeRunner:
    """A stand-in for a captured runner: records its key, renders
    nothing."""

    made = []

    def __init__(self, scene, camera, lights, *, width, height, settings,
                 shapes, tile):
        self.scene_ref, self.key = scene, (width, height, settings, shapes)
        self.tile = tile
        _FakeRunner.made.append(tile)

    def matches(self, scene, width, height, settings, shapes):
        return scene is self.scene_ref and self.key == (width, height,
                                                        settings, shapes)


def test_runners_are_keyed_by_card_and_tile(scene, monkeypatch):
    """With the capture stood in for: a mesh naming one device four times
    keeps four runners and captures none again on the next sample; the
    whole image frees every tile runner it overlaps; another device's
    runners stay."""
    monkeypatch.setattr(graphed, "_RUNNERS", {})
    monkeypatch.setattr(graphed, "_Runner", _FakeRunner)
    monkeypatch.setattr(graphed, "eager_reason", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _FakeRunner.made = []
    st = _settings()
    cam = make_camera(**VIEWS[0])
    lights = LightParams.from_settings(st)
    n = W * H

    def runners(dev, n_tiles):
        return [graphed.runner(scene, cam, lights, width=W, height=H,
                               settings=st, tile=b)
                for b in tile_bounds(n, n_tiles)]

    first = runners(CPU, 4)
    assert runners(CPU, 4) == first
    assert _FakeRunner.made == tile_bounds(n, 4)
    assert sorted(graphed._RUNNERS) == [(CPU,) + b for b in
                                        tile_bounds(n, 4)]
    other = torch.device("meta")
    graphed._RUNNERS[(other, 0, n)] = "kept"
    whole = graphed.runner(scene, cam, lights, width=W, height=H,
                           settings=st)
    assert whole.tile == (0, n)
    assert sorted(graphed._RUNNERS, key=str) == sorted(
        [(CPU, 0, n), (other, 0, n)], key=str)
    runners(CPU, 2)
    assert set(graphed._RUNNERS) == {(CPU,) + b for b in tile_bounds(n, 2)} \
        | {(other, 0, n)}
    # a new size recaptures the same tiles
    made = len(_FakeRunner.made)
    graphed.runner(scene, cam, lights, width=W, height=H // 2, settings=st,
                   tile=(0, n // 2))
    assert len(_FakeRunner.made) == made + 1


def test_film_accumulate_issues_every_card_in_turn(scene, monkeypatch):
    """One sample over the mesh issues tile 0, 1, 2, 3 in order, each with
    its own tile's global pixel ids, and a runner's output where
    eager_reason lets it replay."""
    mesh = MESHES["cpu4"]
    calls = []
    orig = shard.render_pixels

    def record(scene, camera, lights, frame, ids, **kw):
        calls.append((int(ids[0]), int(ids[-1]) + 1, frame))
        return orig(scene, camera, lights, frame, ids, **kw)

    monkeypatch.setattr(shard, "render_pixels", record)
    st = _settings()
    film = film_accumulate(scene, make_camera(**VIEWS[0]),
                           LightParams.from_settings(st),
                           film_init(W, H, mesh=mesh), 2, width=W, height=H,
                           settings=st)
    assert film.frame == 2
    assert calls == [b + (f,) for f in (0, 1) for b in tile_bounds(W * H, 4)]


def test_cli_devices_through_the_tile_film(soup, tmp_path):
    """`render --cpu --devices 4` with a checkpoint: the image and the
    checkpoint equal the single-device run's, and a second run resumes
    over the tiles."""
    from chip_smoke import write_glb
    from dustraytracer_tpu_torch.utils.checkpoint import load_film

    glb = tmp_path / "s.glb"
    plain = dict(soup, images=[], materials=[dict(m, texture=-1) for m in
                                             soup["materials"]])
    write_glb(glb, scenes.to_document(plain))

    def cli(out, *extra):
        return subprocess.run(
            [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli",
             "render", "--scene", str(glb), "--size", "16x12", "--bounces",
             "1", "--camera-pos", "0,1,4", "--look-at", "0,0.5,0", "--cpu",
             "--out", str(tmp_path / out), *extra], cwd=ROOT,
            capture_output=True, text=True, timeout=300)

    one = cli("one.png", "--spp", "2", "--checkpoint", str(tmp_path / "1.npz"))
    four = cli("four.png", "--spp", "2", "--devices", "4", "--checkpoint",
               str(tmp_path / "4.npz"))
    assert one.returncode == 0 and four.returncode == 0, four.stderr
    assert json.loads(four.stdout)["devices"] == 4
    assert (tmp_path / "four.png").read_bytes() == \
        (tmp_path / "one.png").read_bytes()
    a, b = (load_film(tmp_path / f, 16, 12) for f in ("1.npz", "4.npz"))
    assert a.frame == b.frame == 2 and torch.equal(a.accum, b.accum)
    more = cli("more.png", "--spp", "3", "--devices", "4", "--checkpoint",
               str(tmp_path / "4.npz"))
    assert more.returncode == 0, more.stderr
    assert "resumed" in more.stderr
    assert json.loads(more.stdout)["spp"] == 1
    assert load_film(tmp_path / "4.npz", 16, 12).frame == 3
    # one device resumes the same checkpoint as a whole film
    once = cli("once.png", "--spp", "4", "--devices", "1", "--checkpoint",
               str(tmp_path / "4.npz"))
    assert once.returncode == 0, once.stderr
    assert "resumed" in once.stderr
    assert json.loads(once.stdout)["spp"] == 1
    assert load_film(tmp_path / "4.npz", 16, 12).frame == 4


def test_viewer_renders_over_the_mesh(scene):
    """The viewer's render thread with a mesh of four CPU tiles shows the
    single-device film; a resize the tiles cannot take is refused."""
    import threading
    import time

    from dustraytracer_tpu_torch.apps.viewer import ViewerState

    st = _settings()
    cam = make_camera(**VIEWS[0])
    mesh = MESHES["cpu4"]
    state = ViewerState(scene, cam, st.replace(max_samples=2), W, H,
                        speed=0.1, mesh=mesh)
    t = threading.Thread(target=state.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with state.lock:
                if state.samples == 2:
                    img = state.image.copy()
                    break
            time.sleep(0.02)
        else:
            pytest.fail("the viewer showed no second sample in 120 s")
        state.apply({"resize": [30, 3]})
        assert (state.width, state.height) == (W, H)
        assert "refused" in state.console[-1]
    finally:
        state.running = False
        t.join(timeout=30)
    assert not t.is_alive()
    want = render_progressive(scene, cam, st, width=W, height=H, spp=2)
    assert np.array_equal(img, film_image(want).numpy())
