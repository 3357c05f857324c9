"""BENCHMARK.json and the data files it names: they parse, every name
and unit keeps to the allowed characters, and every name finds its
file."""

from __future__ import annotations

import json
import re

import pytest

from bench_port import harness
from bench_port.loops import Loop, loop_type
from bench_port.tests.conftest import DATA, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_port"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(set(names)) == len(names)
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)


def check_cells(spec: dict, data) -> None:
    """Every configuration is used; each cell's traffic names a loop that
    allows the cell's `chips`, and the cell has limits, `setup_s`, another
    end-to-end metric and a per-layer metric."""
    configs = {c["name"] for c in spec["configs"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == configs
    for w in spec["workloads"]:
        traffic = json.loads((data / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert w["chips"] in loop_type(traffic["loop"], data).chips
        assert (data / "limits" / f"{w['name']}.json").is_file()
        e2e, layer = harness.cell_metrics(spec, w)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_cells_name_their_files():
    check_cells(SPEC, DATA)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_parse(entry):
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("width", "height", "bounces", "scene", "camera", "lights",
                "assumed"):
        assert key in cfg


@pytest.mark.parametrize("path", sorted((DATA / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_files_parse(path):
    assert issubclass(loop_type(json.loads(path.read_text())["loop"], DATA),
                      Loop)


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    assert callable(harness.reader(DATA, metric["name"]))
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert metric["moves"] in names


@pytest.mark.parametrize("path", sorted((DATA / "limits").glob("*.json")),
                         ids=lambda p: p.stem)
def test_limit_files_parse(path):
    numbers = json.loads(path.read_text())["numbers"]
    assert numbers and all(v["limit"] >= 0 for v in numbers.values())
