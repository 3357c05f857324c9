"""One short run of each cell on the card, through the command that the
benchmark's checks run. Skips without a CUDA card. On a card:

    python -m pytest bench_port/tests -q -o addopts="" -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_port.tests.conftest import REPO

CELLS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", cell["name"],
         "--seed", "2147483648", "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == cell["chips"]
    assert "setup_s" in res["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
