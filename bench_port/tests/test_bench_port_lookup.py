"""A deployment added as new files only: a loop from
`<data>/loop_types/`, a scene generator from `<data>/generators/`, with
their traffic, configuration, limits and metric reader, run through the
harness on the CPU at the tiny size. The built-in names still resolve to
the built-ins, an unknown name names the file it looked for, a loop's
`chips` admits its cells, and the result's peak is the fullest card's."""

from __future__ import annotations

import json
import re
import shutil
import time

import numpy as np
import pytest
import torch

from bench_port import harness, loops, scenes
from bench_port.tests.conftest import DATA
from bench_port.tests.test_bench_port_files import check_cells

SPIRAL_LOOP = '''"""The viewer on a spiral: view k at azimuth start + step_deg k, the
start drawn from the seed, and an elevation that climbs the traffic's
range by the golden ratio and wraps."""

import math

import numpy as np

from bench_port.loops import RenderLoop


class SpiralLoop(RenderLoop):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        rng = np.random.default_rng([self.seed % 2 ** 63, 5])
        self.start, self.k = float(rng.uniform(0.0, 360.0)), 0

    def control_views(self):
        self.k = 0
        return super().control_views()

    def _next_view(self):
        t = self.traffic
        lo, hi = t["elevation_deg"]
        az = math.radians(self.start + t["step_deg"] * self.k)
        el = math.radians(lo + (hi - lo) * (self.k * 0.6180339887 % 1.0))
        self.k += 1
        off = self.dist * np.float64([math.cos(el) * math.sin(az),
                                      math.sin(el),
                                      math.cos(el) * math.cos(az)])
        return {"position": np.float32(self.look + off).tolist(),
                "look_at": np.float32(self.look).tolist(),
                "vfov_deg": float(self.cfg["camera"]["vfov_deg"]),
                "focus_dist": float(self.cfg["camera"]["focus_dist"])}


LOOP = SpiralLoop
'''

QUAD_GENERATOR = '''"""The seeded sphere scene with a two-triangle wall behind the sphere,
of a third, untextured material."""

import numpy as np

from bench_port.scenes import sphere


def make(seed, n_lon, n_lat):
    soup = sphere(n_lon, n_lat, seed)
    n = len(soup["material"])
    wall = np.float32([[-2, 0, -2], [2, 0, -2], [2, 3, -2], [-2, 3, -2]])
    soup["positions"] = np.concatenate([soup["positions"],
                                        wall[[[0, 1, 2], [0, 2, 3]]]])
    soup["normals"] = np.concatenate([
        soup["normals"], np.broadcast_to(np.float32([0, 0, 1]), (2, 3, 3))])
    soup["uvs"] = np.concatenate([soup["uvs"],
                                  np.zeros((2, 3, 2), np.float32)])
    soup["material"] = np.concatenate([soup["material"],
                                       np.full(2, 2, np.int32)])
    soup["materials"].append({"name": "wall", "base_color": [0.3, 0.6, 0.3],
                              "texture": -1})
    soup["meshes"].append(("wall", n, 2))
    return soup
'''

WAITS_READER = '''"""Host waits for the card per frame of the spiral viewer."""


def read(record):
    if record["loop"] != "spiral":
        return None
    return record["waits"] / record["wait_units"]
'''

TILES_LOOP = '''from bench_port.loops import RenderLoop


class TilesLoop(RenderLoop):
    chips = (4,)


LOOP = TilesLoop
'''


def _tree(root):
    return sorted((str(p.relative_to(root)), p.stat().st_mtime_ns)
                  for p in root.rglob("*") if "__pycache__" not in p.parts)


@pytest.fixture
def added(tiny, tmp_path) -> dict:
    """The tiny benchmark copied, plus the files of one new deployment
    (`quad.spiral_orbit`) and nothing else."""
    root = tmp_path / "bench"
    shutil.copytree(tiny["bench"].parent, root)
    data = root / "bench_port"
    for folder, name, text in [("loop_types", "spiral", SPIRAL_LOOP),
                               ("loop_types", "tiles", TILES_LOOP),
                               ("generators", "quad_sphere", QUAD_GENERATOR),
                               ("metrics", "host_waits_per_frame.spiral",
                                WAITS_READER)]:
        (data / folder).mkdir(exist_ok=True)
        (data / folder / f"{name}.py").write_text(text)
    cfg = json.loads((data / "configs" / "tiny.json").read_text())
    cfg.update(name="quad", scene=dict(cfg["scene"], generator="quad_sphere"))
    (data / "configs" / "quad.json").write_text(json.dumps(cfg))
    traffic = json.loads((data / "traffic" / "render_orbit.json").read_text())
    traffic.update(loop="spiral", step_deg=137.5)
    (data / "traffic" / "spiral_orbit.json").write_text(json.dumps(traffic))
    shutil.copy(data / "limits" / "tiny.render_orbit.json",
                data / "limits" / "quad.spiral_orbit.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "quad", "source": "https://example.org",
                            "file": "bench_port/configs/quad.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "quad.spiral_orbit", "config": "quad",
                              "traffic": "spiral_orbit", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "render_orbit" in str(m.get("workloads")):
            m["workloads"].append("quad.spiral_orbit")
    spec["per_layer"].append({
        "name": "host_waits_per_frame.spiral", "unit": "count",
        "better": "lower", "source": "program_counter",
        "layer": "integrator host side", "moves": "render_mrays_per_s",
        "workloads": ["quad.spiral_orbit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return {"bench": root / "BENCHMARK.json", "data": data, "spec": spec}


def test_new_files_run_to_correct(added):
    before = _tree(DATA)
    res = harness.run("quad.spiral_orbit", 987654321987, 0.3, False,
                      t_start=time.perf_counter(), device="cpu",
                      bench=added["bench"], data=added["data"])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"render_mrays_per_s",
                                   "render_frame_ms_p95", "setup_s"}
    read = harness.reader(added["data"], "host_waits_per_frame.spiral")
    assert read({"loop": "spiral", "waits": 3, "wait_units": 8}) == 3 / 8
    assert read({"loop": "render", "waits": 3, "wait_units": 8}) is None
    check_cells(added["spec"], added["data"])
    assert _tree(DATA) == before


def test_new_files_are_used(added):
    _, _, cfg, traffic = harness.load_cell("quad.spiral_orbit",
                                           added["bench"], added["data"])
    cls = loops.loop_type(traffic["loop"], added["data"])
    assert cls.__name__ == "SpiralLoop" and issubclass(cls, loops.RenderLoop)
    lp = cls(cfg, traffic, 11, "cpu", data=added["data"])
    assert lp.soup["materials"][-1]["name"] == "wall"
    assert len(lp.soup["material"]) == len(
        scenes.sphere(16, 17, 11)["material"]) + 2
    views = [v["position"] for v in lp.control_views()]
    assert views == [v["position"] for v in lp.control_views()]
    plain = loops.RenderLoop(cfg, traffic, 11, "cpu", data=added["data"])
    assert views != [v["position"] for v in plain.control_views()]


def test_built_in_names(tmp_path):
    (tmp_path / "loop_types").mkdir()
    (tmp_path / "loop_types" / "render.py").write_text("LOOP = None\n")
    assert loops.loop_type("render", tmp_path) is loops.RenderLoop
    assert loops.loop_type("train", tmp_path) is loops.TrainLoop


@pytest.mark.parametrize("config", ["suzanne_512", "dense_monkey_1k"])
def test_built_in_generator_is_sphere(config):
    spec = json.loads((DATA / "configs" / f"{config}.json").read_text())
    args = {k: v for k, v in spec["scene"].items() if k != "generator"}
    got, want = scenes.make(spec["scene"], 7, DATA), scenes.sphere(seed=7,
                                                                   **args)
    assert got.keys() == want.keys()
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype
            assert got[key].tobytes() == val.tobytes(), key
        elif key == "images":
            assert all(a.tobytes() == b.tobytes() for a, b in zip(got[key],
                                                                  val))
        else:
            assert got[key] == val, key


def test_unknown_names_name_the_file(tmp_path):
    path = tmp_path / "loop_types" / "nowhere.py"
    with pytest.raises(LookupError, match=re.escape(str(path))):
        loops.loop_type("nowhere", tmp_path)
    path = tmp_path / "generators" / "nothing.py"
    with pytest.raises(LookupError, match=re.escape(str(path))):
        scenes.make({"generator": "nothing"}, 7, tmp_path)


def test_loop_must_be_a_loop(tmp_path):
    (tmp_path / "loop_types").mkdir()
    (tmp_path / "loop_types" / "plain.py").write_text("LOOP = dict\n")
    with pytest.raises(TypeError, match="plain.py"):
        loops.loop_type("plain", tmp_path)


@pytest.mark.parametrize("chips,admitted", [(4, True), (1, False)])
def test_loop_chips_admit_cells(added, chips, admitted):
    spec = json.loads(json.dumps(added["spec"]))
    data = added["data"]
    traffic = json.loads((data / "traffic" / "spiral_orbit.json")
                         .read_text())
    (data / "traffic" / "tiles_orbit.json").write_text(
        json.dumps(dict(traffic, loop="tiles")))
    shutil.copy(data / "limits" / "quad.spiral_orbit.json",
                data / "limits" / "quad.tiles_orbit.json")
    spec["workloads"].append({"name": "quad.tiles_orbit", "config": "quad",
                              "traffic": "tiles_orbit", "chips": chips,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "quad.spiral_orbit" in m.get("workloads", []):
            m["workloads"].append("quad.tiles_orbit")
    if admitted:
        check_cells(spec, data)
    else:
        with pytest.raises(AssertionError):
            check_cells(spec, data)


class _Own:
    def memory_peak_bytes(self):
        return 123456789


@pytest.mark.parametrize("loop,chips,peak", [(object(), 1, 500),
                                             (object(), 4, 900),
                                             (_Own(), 4, 123456789)])
def test_device_reports_fullest_card(monkeypatch, loop, chips, peak):
    cards = {0: 500, 1: 900, 2: 700, 3: 100}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", cards.__getitem__)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(harness, "power_limit_w", lambda: 700.0)
    got = harness._device(torch.device("cuda"), {"chips": chips}, loop)
    assert got["memory_peak_bytes"] == peak and got["count"] == chips
    assert got["platform"] == "gpu"
