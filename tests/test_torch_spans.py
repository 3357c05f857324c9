"""The program's spans and counters (utils/profiling.py) on the CPU: off
outside a profiler and recording(); the names, nesting and step ids of a
profiled render and train step, and the exported trace; self time on a
hand-built nest with a patched clock; the bounded table's drops; traced
and untraced renders and steps equal bit for bit; the benchmark's
readers of the spans (bench_port/metrics/) on a 24x16 render and step,
and their raise when their span is missing; the material fetch's lane
counters; and the CLIs' --trace."""

import json
import math
import re
import sys
import threading
from collections import deque

import pytest
import torch

from bench_port import harness
from dustraytracer_tpu_torch.apps import optimize
from dustraytracer_tpu_torch.render.film import film_image, render_progressive
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      sphere_doc)
from dustraytracer_tpu_torch.utils import profiling

W, H = 24, 16
BOUNCES = 2
# the kernel fetch (the twin on the CPU) puts _KernelShade's backward on
# the step; the vertices as a leaf make it run
SETTINGS = RenderSettings(bounces=BOUNCES, traversal="sweep",
                          shade_fetch="kernel")
RENDER_PARENTS = {"drt.frame": None, "drt.sample": "drt.frame",
                  "drt.film_add": "drt.frame", "drt.film_image": None,
                  "drt.raygen": "drt.sample", "drt.post": "drt.sample",
                  **{f"drt.b{i}.{part}": "drt.sample"
                     for i in range(BOUNCES)
                     for part in ("trace", "shade", "nee", "scatter")}}
STEP_PARENTS = {"drt.step": None, "drt.step.forward": "drt.step",
                "drt.step.backward": "drt.step", "drt.step.adam": "drt.step",
                "drt.step.project": "drt.step",
                "drt.sample": "drt.step.forward",
                **{k: v for k, v in RENDER_PARENTS.items()
                   if v == "drt.sample"},
                **{f"drt.bwd.b{i}": "drt.step.backward"
                   for i in range(BOUNCES)},
                "drt.bwd.loss": "drt.step.backward",
                "drt.bwd.shade": "drt.bwd.b*",
                "drt.bwd.rows": "drt.bwd.*"}
# where a reader's span or counter is taken away to see it raise
READERS = {"raygen_host_ms.render": "drt.raygen",
           "shade_host_ms.render": r"drt\.b\d+\.shade",
           "scatter_host_ms.render": r"drt\.b\d+\.scatter",
           "film_host_ms.render": "drt.film_image",
           "backward_host_ms.train": "drt.step.backward",
           "adam_host_ms.train": "drt.step.adam",
           "k4_live_lane_pct.train": "drt.k4.live_lanes"}


@pytest.fixture(scope="module")
def scene():
    return build_scene(sphere_doc(*SMALL_SPHERE))


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear()
    yield
    profiling.clear()


def _frames(scene, n=2, settings=SETTINGS, camera=None):
    """n frames of one view, as the viewer makes them; the last image."""
    cam = camera or make_camera(**POSE)
    film, img = None, None
    for _ in range(n):
        film = render_progressive(scene, cam, settings, width=W, height=H,
                                  spp=1, film=film)
        img = film_image(film)
    return img


def _trainer(scene):
    """(params, optimizer, loss_fn) of a step on the albedo, the lights and
    the vertices from a fixed start."""
    cam = make_camera(**POSE)
    lights = LightParams.from_settings(SETTINGS)
    with torch.inference_mode():
        target = _frames(scene, 1).clone()
    params = optimize.as_leaves({"mat_albedo": scene.mat_albedo * 0.5,
                                 "lights": lights,
                                 "tri_pos": scene.tri_pos})
    opt = optimize.make_optimizer(params, 0.02)
    loss_fn = optimize.make_loss_fn(scene, cam, lights, target, width=W,
                                    height=H, settings=SETTINGS)
    return params, opt, loss_fn


def _steps(trainer, n=2):
    params, opt, loss_fn = trainer
    losses = [optimize.train_step(params, opt, loss_fn, s) for s in range(n)]
    return params, opt, losses


@pytest.mark.parametrize("unit", ["render", "step"])
def test_spans_off_record_nothing(scene, unit):
    assert not profiling.enabled()
    assert profiling.span("drt.frame") is profiling.span("drt.b0.trace")
    if unit == "render":
        _frames(scene)
    else:
        _steps(_trainer(scene), 1)
    profiling.count_device("drt.test", torch.ones((), dtype=torch.int64))
    assert profiling.spans() == [] and profiling.span_totals() == {}
    assert profiling.counters("drt.k4.") == {}
    assert "drt.test" not in profiling.counters()


def _parent_names(rows):
    by_id = {r["id"]: r for r in rows}
    return [(r["name"], by_id[r["parent"]]["name"]
             if r["parent"] in by_id else None) for r in rows]


@pytest.mark.parametrize("unit", ["render", "step"])
def test_profiled_spans_nest_as_listed(scene, unit, tmp_path):
    want = RENDER_PARENTS if unit == "render" else STEP_PARENTS
    trainer = _trainer(scene) if unit == "step" else None
    with profiling.trace(str(tmp_path)):
        if unit == "render":
            _frames(scene)
        else:
            _steps(trainer)
    rows = profiling.spans()
    got = {}
    for name, parent in _parent_names(rows):
        got.setdefault(name, set()).add(parent)
    assert set(got) == set(want)
    for name, parents in got.items():
        pattern = want[name]
        assert all(pattern is None and p is None or p is not None
                   and re.fullmatch(pattern.replace(".", r"\.")
                                    .replace("*", ".*"), p)
                   for p in parents), (name, parents)
    for r in rows:  # a chain of the backward ends inside it
        if r["name"].startswith("drt.bwd."):
            assert any(b["name"] == "drt.step.backward"
                       and b["start_ns"] <= r["start_ns"]
                       and r["end_ns"] <= b["end_ns"] for b in rows)
    units = [r for r in rows if r["name"] in profiling.UNITS]
    assert len(units) == 2 and len({r["unit"] for r in units}) == 2
    for u in units:  # every span inside a frame or step carries its id
        inside = [r for r in rows if u["start_ns"] <= r["start_ns"]
                  and r["end_ns"] <= u["end_ns"]]
        assert {r["unit"] for r in inside} == {u["unit"]}
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {ev.get("name") for ev in events["traceEvents"]}
    assert set(got) <= names, sorted(set(got) - names)
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written["spans"] == rows and written["dropped"] == 0
    assert set(written["totals"]) == set(got)


@pytest.mark.parametrize("nest", ["with", "chain"])
def test_self_time_with_a_patched_clock(monkeypatch, nest):
    ticks = iter(range(0, 10 ** 9, 1_000_000))  # 1 ms a reading
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    with profiling.recording():
        with profiling.span("drt.step"):                  # 0 ..
            with profiling.span("drt.step.forward"):      # 1 .. 4
                with profiling.span("drt.sample"):        # 2 .. 3
                    pass
            if nest == "with":
                with profiling.span("drt.bwd.b1"):        # 5 .. 6
                    pass
                with profiling.span("drt.bwd.b0"):        # 7 .. 8
                    pass
            else:  # a chain ends at the next one and at its parent's end
                profiling.chain("drt.bwd.b1")             # 5 .. 6
                profiling.chain("drt.bwd.b1")             # no new span
                profiling.chain("drt.bwd.b0")             # 6 .. 7
    step_ms = {"with": 9.0, "chain": 8.0}[nest]         # .. 9 or .. 8
    totals = profiling.span_totals()
    assert totals["drt.step"] == {"count": 1, "total_ms": step_ms,
                                  "self_ms": step_ms - 5.0}
    assert totals["drt.step.forward"] == {"count": 1, "total_ms": 3.0,
                                          "self_ms": 2.0}
    assert totals["drt.sample"]["self_ms"] == 1.0
    for name in ("drt.bwd.b1", "drt.bwd.b0"):
        assert totals[name] == {"count": 1, "total_ms": 1.0, "self_ms": 1.0}
    rows = profiling.spans()
    assert len({r["unit"] for r in rows}) == 1
    assert {p for n, p in _parent_names(rows) if n.startswith("drt.bwd")} \
        == {"drt.step"}


def test_full_table_counts_its_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_table", deque(maxlen=4))
    with profiling.recording():
        for i in range(6):
            with profiling.span(f"drt.test{i}"):
                pass
    assert profiling.dropped() == 2
    assert [r["name"] for r in profiling.spans()] == [
        f"drt.test{i}" for i in range(2, 6)]
    profiling.clear()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_spans_of_many_threads_keep_their_ids_and_parents():
    """Spans are entered from autograd's thread too: under a short switch
    interval, 16 threads' nested spans get unique ids and parents on
    their own thread."""
    threads, per = 16, 200

    def work():
        for _ in range(per):
            with profiling.span("drt.step"):
                with profiling.span("drt.step.adam"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    rows = profiling.spans()
    assert len(rows) == 2 * threads * per
    assert len({r["id"] for r in rows}) == len(rows)
    by_id = {r["id"]: r for r in rows}
    for r in rows:
        if r["name"] == "drt.step.adam":
            parent = by_id[r["parent"]]
            assert parent["name"] == "drt.step"
            assert parent["thread"] == r["thread"]


@pytest.mark.parametrize("unit", ["render", "step"])
def test_traced_equals_untraced(scene, unit):
    def run():
        if unit == "render":
            with torch.inference_mode():
                return {"image": _frames(scene, 3)}
        params, opt, losses = _steps(_trainer(scene), 2)
        leaves = optimize.param_leaves(params)
        return {"losses": torch.stack(losses),
                **{f"leaf{i}": t.detach().clone()
                   for i, t in enumerate(leaves)},
                **{f"exp_avg{i}": opt.state[t]["exp_avg"].clone()
                   for i, t in enumerate(leaves)}}

    plain = run()
    with torch.profiler.profile():
        traced = run()
    assert profiling.span_totals()
    assert plain.keys() == traced.keys()
    for key in plain:
        assert torch.equal(plain[key], traced[key]), key


@pytest.mark.parametrize("missing", [False, True], ids=["reads", "missing"])
@pytest.mark.parametrize("metric", list(READERS))
def test_metric_reader(scene, monkeypatch, metric, missing):
    read = harness.reader(harness.DATA, metric)
    loop = "render" if metric.endswith(".render") else "train"
    trainer = _trainer(scene) if loop == "train" else None
    with profiling.recording():
        if loop == "render":
            _frames(scene)
        else:
            _steps(trainer)
    assert read({"loop": "train" if loop == "render" else "render"}) is None
    if missing:
        gone = re.compile(READERS[metric])
        totals, counts = profiling.span_totals(), profiling.counters()
        monkeypatch.setattr(profiling, "span_totals", lambda: {
            k: v for k, v in totals.items() if not gone.fullmatch(k)})
        monkeypatch.setattr(profiling, "counters", lambda prefix="drt.": {
            k: v for k, v in counts.items()
            if k.startswith(prefix) and not gone.fullmatch(k)})
        with pytest.raises(RuntimeError, match=metric):
            read({"loop": loop})
        return
    got = read({"loop": loop})
    rows = profiling.spans()
    totals = profiling.span_totals(rows)
    units = totals["drt.frame" if loop == "render" else "drt.step"]["count"]
    assert units == 2
    if metric.startswith("k4"):
        c = profiling.counters()
        assert c["drt.k4.lanes"] == 2 * BOUNCES * W * H
        want = 100.0 * c["drt.k4.live_lanes"] / c["drt.k4.lanes"]
    elif metric.startswith("film"):
        want = sum(totals[n]["self_ms"] for n in
                   ("drt.frame", "drt.film_add", "drt.film_image")) / units
    elif metric.startswith("backward"):
        want = totals["drt.step.backward"]["total_ms"] / units
    elif metric.startswith("adam"):
        want = (totals["drt.step.adam"]["total_ms"]
                + totals["drt.step.project"]["total_ms"]) / units
    else:
        pattern = re.compile(READERS[metric])
        want = sum(t["self_ms"] for n, t in totals.items()
                   if pattern.fullmatch(n)) / units
    assert math.isfinite(got) and got > 0.0
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("view", ["outside", "inside"])
def test_live_lanes_at_most_lanes(scene, view):
    """Inside the closed sphere every camera ray hits: live == lanes."""
    settings = RenderSettings(bounces=1, traversal="sweep")
    cam = (make_camera(**POSE) if view == "outside" else
           make_camera(position=(0.0, 1.0, 0.0), look_at=(0.0, 1.0, -1.0),
                       vfov_deg=60.0))
    with profiling.recording(), torch.inference_mode():
        _frames(scene, 1, settings=settings, camera=cam)
    c = profiling.counters("drt.k4.")
    assert c["drt.k4.lanes"] == W * H
    if view == "outside":
        assert 0 < c["drt.k4.live_lanes"] < c["drt.k4.lanes"]
    else:
        assert c["drt.k4.live_lanes"] == c["drt.k4.lanes"]


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    from chip_smoke import write_glb
    from dustraytracer_tpu_torch.scene.gltf import GltfDocument
    from tests.util_scenes import make_random_tri_doc

    doc = make_random_tri_doc(200, seed=7)
    path = tmp_path_factory.mktemp("spans_cli") / "soup.glb"
    write_glb(path, GltfDocument(meshes=doc.meshes, materials=doc.materials,
                                 images=[], cameras=[]))
    return path


@pytest.mark.parametrize("app", ["render", "optimize"])
def test_cli_trace_writes_both_files(glb, tmp_path, capsys, app):
    out = tmp_path / "trace"
    common = ["--scene", str(glb), "--size", "16x12", "--bounces", "1",
              "--camera-pos", "0,0,14", "--look-at", "0,0,0", "--cpu",
              "--trace", str(out)]
    if app == "render":
        from dustraytracer_tpu_torch.apps import cli

        assert cli.main(["render", *common, "--spp", "2",
                         "--out", str(tmp_path / "x.png")]) == 0
        unit = "drt.sample"
    else:
        assert optimize.main([*common, "--self-test", "--steps", "2",
                              "--checkpoint-every", "0",
                              "--out", str(tmp_path / "opt")]) == 0
        unit = "drt.step"
    capsys.readouterr()
    events = json.loads((out / "trace.json").read_text())
    assert unit in {ev.get("name") for ev in events["traceEvents"]}
    totals = json.loads((out / "spans.json").read_text())["totals"]
    assert totals[unit]["count"] == 2 and "drt.b0.trace" in totals
