"""One run of one cell: find the cell's configuration, traffic mix,
limits and metric readers by name, set the program up, measure the
window, check the answers against the plain reference, and build the
result line.

Everything is found by name. A configuration is the file that
BENCHMARK.json's `configs` entry names, and its "scene.generator" a
built-in of scenes.py or `<data>/generators/<name>.py`; a traffic mix is
`<data>/traffic/<traffic>.json`, whose "loop" is a built-in of loops.py
or `<data>/loop_types/<name>.py`; a per-layer metric is
`<data>/metrics/<name>.py`, whose `read(record)` returns its value or
None; a cell's limits are `<data>/limits/<cell>.json`. <data> is this
folder unless a caller gives another. So a cell that needs its own loop,
scene and reference comes as new files and BENCHMARK.json entries."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench_port import compare, scenes, trace
from bench_port.loops import loop_type

DATA = Path(__file__).resolve().parent
BENCH = DATA.parent / "BENCHMARK.json"
# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "dustraytracer_tpu")
PROFILED = {"frame": 24, "step": 12}  # units in the profiled slice
WAITED = {"frame": 8, "step": 4}      # units in the host-wait slice


def load_cell(workload: str, bench: Path = BENCH, data: Path = DATA):
    """(BENCHMARK.json, cell, configuration, traffic) of a workload."""
    spec = json.loads(Path(bench).read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((Path(bench).parent / entry["file"]).read_text())
    traffic = json.loads((data / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return spec, cell, cfg, traffic


def cell_metrics(spec: dict, cell: dict) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    name = cell["name"]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return e2e, layer


def reader(data: Path, metric: str):
    """The `read` function of `<data>/metrics/<metric>.py`."""
    return scenes.from_file(data, "metrics", metric, "read")


def power_limit_w():
    """nvidia-smi's power limit of card 0 in watts, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device="cuda", bench: Path = BENCH,
        data: Path = DATA, log=None) -> dict:
    """One run; returns the result object (without printing it). `log`
    collects the lines to print last on standard error."""
    log = log if log is not None else []
    spec, cell, cfg, traffic = load_cell(workload, bench, data)
    limits = compare.load_limits(data, cell["name"])
    dev = torch.device(device)
    if traced and dev.type != "cuda":
        raise RuntimeError("a traced run reads the device: it needs CUDA")
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator knows the cards once CUDA is up
        for card in range(cell["chips"]):
            torch.cuda.reset_peak_memory_stats(card)
    loop = loop_type(traffic["loop"], data)(cfg, traffic, seed, dev,
                                           trace=traced, data=data)
    loop.setup()

    times = []
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    while True:
        t0 = time.perf_counter()
        loop.unit()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    record = None
    if traced:
        record = _traced(loop, times)
    loop.finish()
    device = _device(dev, cell, loop)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")

    got = loop.answers()
    loop.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.numbers(got, loop.reference(torch.float32))
    correct, checks = compare.judge(numbers, limits)

    e2e, layer = cell_metrics(spec, cell)
    metrics = {}
    if traced:
        for m in layer:
            val = reader(data, m["name"])(record)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        values = dict(loop.e2e(times, window_s), setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(times), "failed": 0,
              "metrics": metrics, "device": device}
    if traced:
        result["device"].update(busy_s=record["busy_s"],
                                window_s=record["window_s"])
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in record["top_ops"]],
            "idle_gaps": [[n, s] for n, s in record["idle_gaps"]]}
    result["checks"] = checks
    half = len(times) // 2
    log.append(f"window {len(times)} units in {window_s!r} s; median ms "
               f"{1e3 * statistics.median(times)!r}, first half mean ms "
               f"{1e3 * sum(times[:half]) / max(half, 1)!r}, second half "
               f"{1e3 * sum(times[half:]) / (len(times) - half)!r}")
    for name, c in checks.items():
        log.append(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def _traced(loop, times: list) -> dict:
    """The traced slices after the timed part of the window: the
    profiled units, then the host-wait units; with them the host-clock
    seconds of every unit of the window (`unit_s`)."""
    unit = loop.unit_name
    spans = loop.spans() if hasattr(loop, "spans") else {}
    rec = trace.profile_units(loop.unit, PROFILED[unit], unit)
    loop.counting = True
    try:
        waits = trace.count_waits(loop.unit, WAITED[unit])
    finally:
        loop.counting = False
    rec.update(spans, loop=loop.traffic["loop"], width=loop.width,
               height=loop.height, bounces=loop.bounces,
               n_materials=len(loop.soup["materials"]),
               wait_units=WAITED[unit], waits=waits, unit_s=list(times))
    return rec


def _device(dev, cell, loop) -> dict:
    """The result's `device`, read once the window has closed and before
    the reference runs: `memory_peak_bytes` is the fullest of the cell's
    cards in this process, or the loop's own `memory_peak_bytes()` where
    its work runs in other processes."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if hasattr(loop, "memory_peak_bytes"):
        peak = loop.memory_peak_bytes()
    else:
        peak = max(torch.cuda.max_memory_allocated(card)
                   for card in range(cell["chips"]))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"], "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w()}
