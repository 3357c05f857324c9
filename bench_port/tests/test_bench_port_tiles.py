"""The four-card deployment `dense_monkey_1k_tiles4.render_orbit` on the
CPU: its `tiles` loop runs through the harness on a throwaway tiny
benchmark, the frame's pixels split over four CPU tiles, and is correct
against the plain reference; the benchmark's files admit the cell with
four chips; its seven readers read the tiles loop alone and fail loudly
where their span, counter or copy is missing."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from bench_port import harness, scenes
from bench_port.tests.conftest import DATA, REPO
from bench_port.tests.test_bench_port_files import check_cells
# imported at collection: the program's package is then the real one in
# every later test of this process
from dustraytracer_tpu_torch.render.film import (TileFilm, film_image,
                                                 render_progressive)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import RenderSettings
from dustraytracer_tpu_torch.utils import profiling

CELL = "dense_monkey_1k_tiles4.render_orbit"
TINY = "tiny4.render_orbit_tiles"
READERS = ("tile_skew_pct.tiles4", "gather_ms_per_frame.tiles4",
           "dispatch_host_ms.tiles4", "graph_replays_per_frame.tiles4",
           "host_waits_per_frame.tiles4", "k1_ms_per_frame.tiles4",
           "kernels_per_frame.tiles4")


@pytest.fixture
def tiles(tiny, tmp_path) -> dict:
    """The tiny benchmark copied, plus a tiny four-tile cell that uses the
    new cell's loop, traffic and readers."""
    root = tmp_path / "bench"
    shutil.copytree(tiny["bench"].parent, root)
    data = root / "bench_port"
    cfg = json.loads((data / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny4", cards=4)
    (data / "configs" / "tiny4.json").write_text(json.dumps(cfg))
    traffic = json.loads((data / "traffic" / "render_orbit_tiles.json")
                         .read_text())
    traffic.update(warmup_views=1,
                   check={"views": 3, "pixels_per_view": 24 * 16})
    (data / "traffic" / "render_orbit_tiles.json").write_text(
        json.dumps(traffic))
    shutil.copy(DATA / "limits" / f"{CELL}.json",
                data / "limits" / f"{TINY}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny4", "source": "https://example.org",
                            "file": "bench_port/configs/tiny4.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": TINY, "config": "tiny4",
                              "traffic": "render_orbit_tiles", "chips": 4,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in READERS:
            m["workloads"] = [TINY]
        elif m["name"] in ("render_mrays_per_s", "render_frame_ms_p95"):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return {"bench": root / "BENCHMARK.json", "data": data, "spec": spec}


def test_tiles_loop_runs_to_correct(tiles):
    res = harness.run(TINY, 987654321987, 0.3, False,
                      t_start=time.perf_counter(), device="cpu",
                      bench=tiles["bench"], data=tiles["data"])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"render_mrays_per_s",
                                   "render_frame_ms_p95", "setup_s"}
    check_cells(tiles["spec"], tiles["data"])
    _, _, cfg, traffic = harness.load_cell(TINY, tiles["bench"],
                                           tiles["data"])
    cls = harness.loop_type(traffic["loop"], tiles["data"])
    lp = cls(cfg, traffic, 5, "cpu", data=tiles["data"])
    lp.setup()
    assert lp.mesh == [torch.device("cpu")] * 4
    assert isinstance(lp.film, TileFilm) and len(lp.film.tiles) == 4


def test_files_admit_the_four_card_cell():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 4
    assert sum(w["chips"] == 4 for w in spec["workloads"]) == 1
    _, _, cfg, traffic = harness.load_cell(CELL)
    assert traffic["loop"] == "tiles" and cfg["cards"] == 4
    assert harness.loop_type("tiles", DATA).chips == (4,)
    one = json.loads((DATA / "configs" / "dense_monkey_1k.json")
                     .read_text())
    same = ("scene", "triangles", "width", "height", "bounces",
            "precision", "camera", "lights", "reduced")
    assert {k: cfg[k] for k in same} == {k: one[k] for k in same}
    assert cfg["source"] != one["source"]
    assert cfg["source"].startswith(one["source"] + ", ")
    plain = json.loads((DATA / "traffic" / "render_orbit.json").read_text())
    assert set(traffic) == set(plain)
    assert {k: v for k, v in traffic.items() if k not in ("loop", "entry")} \
        == {k: v for k, v in plain.items() if k not in ("loop", "entry")}
    e2e, layer = harness.cell_metrics(spec, cell)
    assert {m["name"] for m in e2e} == {"render_mrays_per_s",
                                        "render_frame_ms_p95", "setup_s"}
    assert {m["name"] for m in layer} == set(READERS)
    check_cells(spec, DATA)


def _record(**kw):
    rec = {"loop": "tiles", "units": 4, "waits": 1, "wait_units": 8,
           "device_ops": [("Memcpy PtoP (Device -> Device)", 2e-5),
                          ("Memcpy DtoD (Device -> Device)", 1e-3),
                          ("traverse_sweep_kernel", 1e-3)]}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name", READERS)
def test_readers_read_the_tiles_loop_alone(name):
    assert harness.reader(DATA, name)(_record(loop="render")) is None


def test_device_trace_readers():
    gather = harness.reader(DATA, "gather_ms_per_frame.tiles4")
    assert gather(_record()) == pytest.approx(1e3 * 2e-5 / 4)
    with pytest.raises(RuntimeError, match="Memcpy PtoP"):
        gather(_record(device_ops=[("Memcpy DtoD (Device -> Device)",
                                    1e-3)]))
    waits = harness.reader(DATA, "host_waits_per_frame.tiles4")
    assert waits(_record()) == 1 / 8
    k1 = harness.reader(DATA, "k1_ms_per_frame.tiles4")
    assert k1(_record()) == pytest.approx(1e3 * 1e-3 / 4)
    with pytest.raises(RuntimeError, match="traverse_sweep_kernel"):
        k1(_record(device_ops=[("Memcpy PtoP (Device -> Device)", 2e-5)]))
    kernels = harness.reader(DATA, "kernels_per_frame.tiles4")
    assert kernels(_record(device_ops=[("traverse_sweep_kernel", 1e-3)] * 6
                           + [("Memset (Device)", 1e-6)])) == 6 / 4
    with pytest.raises(RuntimeError, match="no device kernel"):
        kernels(_record(device_ops=[("Memcpy PtoP (Device -> Device)",
                                     2e-5)]))


def test_span_and_counter_readers():
    """The program's span table and counters of two frames over four CPU
    tiles; the card timers, which need CUDA, are planted."""
    scene = build_scene(scenes.to_document(scenes.sphere(16, 17, 3)))
    cam = make_camera(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0))
    mesh = [torch.device("cpu")] * 4
    read = {n: harness.reader(DATA, n) for n in READERS}
    profiling.clear()
    try:
        with profiling.recording():
            film = None
            for _ in range(2):
                film = render_progressive(scene, cam, RenderSettings(
                    bounces=1), width=16, height=8, spp=1, film=film,
                    mesh=mesh)
                film_image(film)
        assert read["dispatch_host_ms.tiles4"](_record()) > 0
        # the CPU replays no graph
        assert read["graph_replays_per_frame.tiles4"](_record()) == 0
        with pytest.raises(RuntimeError, match="device_ms"):
            read["tile_skew_pct.tiles4"](_record())
        profiling._timed.update({
            f"drt.tile.c{i}.device_ms": [(_Event(0.0), _Event(ms))]
            for i, ms in enumerate([2.0, 4.0, 3.0, 1.0])})
        assert read["tile_skew_pct.tiles4"](_record()) == 75.0
        profiling.clear()
        for name in ("dispatch_host_ms.tiles4",
                     "graph_replays_per_frame.tiles4"):
            with pytest.raises(RuntimeError, match="span"):
                read[name](_record())
    finally:
        profiling.clear()


class _Event:
    """A stand-in for a recorded CUDA event at `ms`."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms
