"""Tests of the benchmark harness. Run them alone, from the repository's
root, in one process:

    python -m pytest bench_port/tests -q -o addopts=""

Cases marked `card` need a CUDA card and skip without one (decided in
the `card` fixture, never at import). `tiny` is a throwaway benchmark in
a temporary directory: a 514-triangle stand-in at 24x16 with its own
configuration, limits and copies of the traffic mixes, metric readers,
loops and scene generators, so a run on the CPU takes seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parents[1]
REPO = DATA.parent
TINY_CELLS = ("tiny.render_orbit", "tiny.train_material")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> dict:
    """{"bench": BENCHMARK.json path, "data": data folder} of a throwaway
    benchmark whose cells are TINY_CELLS."""
    root = tmp_path_factory.mktemp("tiny")
    data = root / "bench_port"
    for sub in ("traffic", "metrics", "loop_types", "generators"):
        if (DATA / sub).is_dir():
            shutil.copytree(DATA / sub, data / sub)
    (data / "configs").mkdir()
    (data / "limits").mkdir()
    cfg = json.loads((DATA / "configs" / "suzanne_512.json").read_text())
    cfg.update(name="tiny", width=24, height=16, bounces=2,
               scene={"generator": "sphere", "n_lon": 16, "n_lat": 17})
    (data / "configs" / "tiny.json").write_text(json.dumps(cfg))
    render = json.loads((data / "traffic" / "render_orbit.json").read_text())
    render.update(warmup_views=1,
                  check={"views": 3, "pixels_per_view": 24 * 16})
    (data / "traffic" / "render_orbit.json").write_text(json.dumps(render))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "https://example.org",
                        "file": "bench_port/configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    spec["workloads"] = [{"name": c, "config": "tiny",
                          "traffic": c.split(".")[1], "chips": 1,
                          "why": "a test"} for c in TINY_CELLS]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "render" if "render" in m["workloads"][0] else "train"
            m["workloads"] = [c for c in TINY_CELLS if kind in c]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell in TINY_CELLS:
        src = DATA / "limits" / f"suzanne_512.{cell.split('.')[1]}.json"
        shutil.copy(src, data / "limits" / f"{cell}.json")
    return {"bench": root / "BENCHMARK.json", "data": data}
