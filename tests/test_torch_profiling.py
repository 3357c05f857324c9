"""The port's profiling helpers (utils/profiling.py) against the JAX
package's: FrameStats' report for the same frame times, and trace()
writing a Chrome trace. The spans and counters are in
test_torch_spans.py."""

import itertools
import json

import pytest
import torch

from dustraytracer_tpu.utils import profiling as j_prof
from dustraytracer_tpu_torch.utils import profiling

# host-clock readings: frames of 12.5, 3.25, 40.0, 7.0 and 0.001 ms
CLOCK = [0.0, 0.0125, 1.0, 1.00325, 2.0, 2.04, 3.0, 3.007, 4.0, 4.000001]


def _report(module, monkeypatch, frames):
    ticks = itertools.chain(CLOCK, itertools.count(5.0))
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
    stats = module.FrameStats()
    for _ in range(frames):
        stats.begin()
        stats.end()
    return stats.report()


@pytest.mark.parametrize("frames", [0, 1, 5])
def test_frame_stats_report_matches_jax(monkeypatch, frames):
    want = _report(j_prof, monkeypatch, frames)
    got = _report(profiling, monkeypatch, frames)
    assert got == want


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]
