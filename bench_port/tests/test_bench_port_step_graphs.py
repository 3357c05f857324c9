"""The reader of the graphed train step's engagement,
`graphed_step_pct.train`, on the CPU: train steps of the program under
recording(), which run eagerly on the CPU; replays planted in the
program's counter. It reads 100 where every step replayed, 0 with
counters but no replay, None outside a train loop or without a counter
table, and fails where the span table has no drt.step."""

from __future__ import annotations

import pytest
import torch

from bench_port import harness, scenes
from bench_port.tests.conftest import DATA
from dustraytracer_tpu_torch.apps import optimize
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils import profiling

STEPS = 3


@pytest.fixture(scope="module")
def steps():
    """STEPS profiled steps of albedo and lights on a small sphere."""
    scene = build_scene(scenes.to_document(scenes.sphere(16, 17, 3)))
    st = RenderSettings(bounces=1, enable_tonemap=False, enable_gamma=False)
    cam = make_camera(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0))
    lights = LightParams.from_settings(st)
    target = torch.zeros((8, 16, 3))
    params = optimize.as_leaves({"mat_albedo": scene.mat_albedo,
                                 "lights": lights})
    opt = optimize.make_optimizer(params, 0.02)
    loss_fn = optimize.make_loss_fn(scene, cam, lights, target, width=16,
                                    height=8, settings=st)
    profiling.clear()
    with profiling.recording():
        for frame in range(STEPS):
            optimize.train_step(params, opt, loss_fn, frame)
    totals = profiling.span_totals()
    profiling.clear()
    return totals


@pytest.mark.parametrize("replayed", [None, 0, STEPS])
def test_graphed_step_reader(steps, monkeypatch, replayed):
    read = harness.reader(DATA, "graphed_step_pct.train")
    monkeypatch.setattr(profiling, "span_totals", lambda: steps)
    profiling.clear()
    try:
        assert read({"loop": "render"}) is None
        if replayed is None:  # a program without a counter table
            monkeypatch.delattr(profiling, "counters")
            assert read({"loop": "train"}) is None
            return
        # the CPU runs every step eagerly
        assert read({"loop": "train"}) == 0
        if replayed:
            profiling.count("drt.step.replayed", replayed)
        assert read({"loop": "train"}) == 100.0 * replayed / STEPS
        monkeypatch.setattr(profiling, "span_totals", lambda: {
            k: v for k, v in steps.items() if k != "drt.step"})
        with pytest.raises(RuntimeError, match="graphed_step_pct.train"):
            read({"loop": "train"})
    finally:
        profiling.clear()
