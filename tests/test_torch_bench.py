"""The port's benchmark harness (dustraytracer_tpu_torch/tools/bench.py,
bench_scenes.py, update_readme_perf.py) on the CPU: tools/bench.py refuses
to run without a card and writes nothing, the sweep's usage errors, its
CPU report under the JAX sweep's key names with --merge keeping earlier
entries, the stand-ins' triangle counts, and the README rewrite touching
only the port's table."""

import json
import re
from pathlib import Path

import pytest
import torch

from dustraytracer_tpu_torch.tools import bench, bench_scenes, \
    update_readme_perf
from dustraytracer_tpu_torch.tools.grad_bench import sphere_doc

ROOT = Path(__file__).resolve().parent.parent
# the per-config keys of the JAX sweep without its speed-of-light section
# (bench_scenes.py:152-229)
JAX_KEYS = ("config", "scene", "size", "bounces", "triangles", "bvh_nodes",
            "fwd_compile_s", "fwd_ms_per_sample", "fwd_mrays_per_s",
            "fwd_ms_per_sample_dispatched", "fwdbwd_compile_s",
            "fwdbwd_ms_per_sample", "fwdbwd_mrays_per_s",
            "fwd_kernelfetch_ms_per_sample", "fwd_kernelfetch_mrays_per_s",
            "fwdbwd_kernelfetch_mrays_per_s")
TINY = ("tiny_32", "suzanne_plane.glb", 32, 32, 1, 1)


def test_jax_keys_are_the_jax_sweeps():
    src = (ROOT / "bench_scenes.py").read_text()
    for key in JAX_KEYS:
        assert f'"{key}"' in src, key


def test_bench_raises_without_cuda_and_writes_nothing(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


def test_bench_scenes_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="is_available"):
        bench_scenes.main(["--skip-sol", "--out", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("argv", [["--cpu"],
                                  ["--cpu", "--skip-sol", "--configs",
                                   "suzanne_512,nope"]],
                         ids=["cpu_without_skip_sol", "unknown_config"])
def test_bench_scenes_usage_errors(tmp_path, argv):
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as err:
        bench_scenes.main([*argv, "--out", str(out)])
    assert err.value.code == 2
    assert not out.exists()


def test_stand_in_triangle_counts():
    counts = {name: bench_scenes.stand_in_triangles(*seg)
              for name, (seg, _) in bench_scenes.STAND_INS.items()}
    assert counts == {"cornell_256": 34, "suzanne_512": 970,
                      "dense_monkey_1k": 16130, "cs16_dust_512": 11202,
                      "katana_512": 90722}
    assert [c[0] for c in bench_scenes.CONFIGS] == list(counts)
    for seg in ((8, 3), (22, 23)):  # the formula against sphere_doc itself
        doc = sphere_doc(*seg)
        built = sum(p.positions.shape[0] for _, prims in doc.meshes
                    for p in prims)
        assert built == bench_scenes.stand_in_triangles(*seg)


def test_bench_scenes_cpu_report_and_merge(tmp_path, monkeypatch):
    """One 32x32 b1 config on the CPU (530 triangles: past brute_max_tris,
    so the kernel-fetch variant runs too): the entry has the JAX sweep's
    keys and no device key; --configs keeps the other config's entry."""
    monkeypatch.setattr(bench_scenes, "CONFIGS",
                        [TINY, ("kept", "x.glb", 8, 8, 1, 1)])
    monkeypatch.setitem(bench_scenes.STAND_INS, "tiny_32", ((24, 12), ""))
    out = tmp_path / "r.json"
    prior = {"config": "kept", "marker": 7}
    out.write_text(json.dumps({"configs": [{"config": "tiny_32"}, prior]}))
    assert bench_scenes.main(["--cpu", "--skip-sol", "--configs", "tiny_32",
                              "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["nvidia_smi"] is None
    entry, kept = report["configs"]
    assert kept == prior
    assert set(JAX_KEYS) <= set(entry)
    assert entry["triangles"] == 530 and entry["size"] == [32, 32]
    assert "stand-in for suzanne_plane.glb" in entry["scene"]
    assert not [k for k in entry if "device" in k or "idle" in k]
    for key in ("fwd_ms_per_sample", "fwdbwd_ms_per_sample"):
        assert entry[key] > 0


def _tables(text):
    def between(a, b):
        return text.split(a, 1)[1].split(b, 1)[0]
    jax_begin = "<!-- BENCH_TABLE_BEGIN (tools/update_readme_perf.py) -->"
    return (between(jax_begin, "<!-- BENCH_TABLE_END -->"),
            between(update_readme_perf.BEGIN, update_readme_perf.END))


def test_update_readme_perf_rewrites_only_the_port_table(tmp_path):
    readme = tmp_path / "README.md"
    original = (ROOT / "README.md").read_text()
    readme.write_text(original)
    report = tmp_path / "r.json"
    report.write_text(json.dumps({
        "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
        "configs": [{"config": "suzanne_512", "scene": "a stand-in",
                     "size": [512, 512], "bounces": 4, "triangles": 970,
                     "fwd_mrays_per_s": 101.25, "fwdbwd_mrays_per_s": 61.5,
                     "traversal_mrays_per_s": 1400.0, "sol_raw_pct": 55.4,
                     "vol_eff_pct": 91.2}]}))
    argv = ["--report", str(report), "--readme", str(readme)]
    assert update_readme_perf.main(argv) == 0
    once = readme.read_text()
    update_readme_perf.main(argv)
    assert readme.read_text() == once  # idempotent
    jax_before, _ = _tables(original)
    jax_after, table = _tables(once)
    assert jax_after == jax_before
    assert "| suzanne_512 512x512 b4: a stand-in (970 tris) | 101.2 " \
        "Mrays/s | **61.5 Mrays/s** | 1400.0 Mrays/s | 55% | **91%** |" \
        in table
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in table
    # outside the port's markers nothing moved
    strip = re.compile(re.escape(update_readme_perf.BEGIN) + ".*?"
                       + re.escape(update_readme_perf.END), re.S)
    assert strip.sub("", once) == strip.sub("", original)


def test_update_readme_perf_needs_its_markers(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("no markers\n")
    report = tmp_path / "r.json"
    report.write_text(json.dumps({"nvidia_smi": None, "configs": []}))
    with pytest.raises(ValueError, match="markers"):
        update_readme_perf.main(["--report", str(report), "--readme",
                                 str(readme)])
    assert readme.read_text() == "no markers\n"


def test_device_ms_times_by_events_where_the_profiler_loses_kernels(
        monkeypatch, capsys):
    """A profile with no device kernel (as on the CPU here) in every try:
    device_ms takes device_seconds_per_call's slope instead, records the
    call in PROFILER_MISSES, names it on stderr, and tuning.profiled
    reports that timer; an unrelated failure of the slope still raises."""
    from dustraytracer_tpu_torch.tools import grad_bench, tuning
    from dustraytracer_tpu_torch.utils import roofline

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(grad_bench, "PROFILER_MISSES", [])
    monkeypatch.setattr(roofline, "device_seconds_per_call",
                        lambda call, **kw: (call(0), 0.0025)[1])
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4) + 1

    ms, timer = tuning.profiled(fn, reps=2)
    assert ms == 2.5 and timer == "device_seconds_per_call"
    assert grad_bench.PROFILER_MISSES == [
        {"name": None, "reps": 2, "seen": 0,
         "timer": "device_seconds_per_call"}]
    # the warm-up, PROFILE_TRIES profiles of 2 calls, the slope's call
    assert len(calls) == 1 + 2 * grad_bench.PROFILE_TRIES + 1
    assert "timed by device_seconds_per_call" in capsys.readouterr().err

    def broken(call, **kw):
        raise RuntimeError("an unrelated failure")

    monkeypatch.setattr(roofline, "device_seconds_per_call", broken)
    with pytest.raises(RuntimeError, match="unrelated"):
        grad_bench.device_ms(fn, name="kernel", reps=1)
    assert len(grad_bench.PROFILER_MISSES) == 1
