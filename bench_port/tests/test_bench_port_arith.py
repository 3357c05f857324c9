"""The yardstick's arithmetic and the per-layer readers on made-up
records."""

from __future__ import annotations

import pytest

from bench_port import arith, harness, trace
from bench_port.tests.conftest import DATA


def test_rays_count_segments_and_shadow_rays():
    assert arith.rays(512, 512, 4) == 512 * 512 * 8
    assert arith.rays(1024, 1024, 2) == 4 * 2 ** 20


def test_percentile_interpolates_like_numpy():
    xs = [float(x) for x in range(1, 101)]
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    assert arith.percentile([3.0], 95) == 3.0
    assert arith.percentile([2.0, 1.0], 50) == 1.5


def test_k4_bytes():
    # 4 fetches of 262,144 lanes x (12 + 4) bytes, and a 2 x 3 table
    assert arith.k4_material_bytes(512, 512, 4, 2) == 4 * 262144 * 16 + 24


def test_union_and_gaps():
    dev = [(10.0, 20.0, "a"), (15.0, 30.0, "b"), (50.0, 60.0, "a")]
    host = [(0.0, 100.0, "bench:frame"), (30.0, 50.0, "aten::nonzero")]
    rec = trace.reading(dev, host, 1)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx(30e-6)
    gaps = dict(rec["idle_gaps"])
    assert gaps["bench:frame:aten::nonzero"] == pytest.approx(20e-6)
    assert gaps["bench:frame:host"] == pytest.approx(50e-6)
    assert dict(rec["top_ops"])["a"] == pytest.approx(20e-6)


def record(loop, ops):
    return {"loop": loop, "units": 2, "busy_s": 0.25, "window_s": 1.0,
            "device_ops": ops, "waits": 6, "wait_units": 2,
            "fwd_s": [0.01, 0.03], "step_s": [0.03, 0.05], "width": 512,
            "height": 512, "bounces": 4, "n_materials": 2}


def test_readers():
    ops = [("void traverse_sweep_kernel<true, false>(Params)", 0.002),
           ("rows_grad_tiles", 1e-5), ("rows_grad_tile_sum", 1e-5),
           ("Memcpy HtoD (Pageable -> Device)", 1e-6)]
    r, t = record("render", ops), record("train", ops)
    read = lambda name, rec: harness.reader(DATA, name)(rec)  # noqa: E731
    assert read("idle_pct.render", r) == pytest.approx(75.0)
    assert read("idle_pct.render", t) is None
    assert read("idle_pct.train", t) == pytest.approx(75.0)
    assert read("host_waits_per_frame.render", r) == 3.0
    assert read("kernels_per_frame.render", r) == 1.5
    assert read("k1_ms_per_frame.render", r) == pytest.approx(1.0)
    assert read("fwd_host_ms.train", t) == pytest.approx(20.0)
    assert read("bwd_opt_host_ms.train", t) == pytest.approx(20.0)
    bound = arith.k4_material_bytes(512, 512, 4, 2) / arith.HBM_BYTES_PER_S
    assert read("k4_roofline.train", t) == pytest.approx(
        100 * bound / 1e-5)


def test_step_p95_reader():
    """The per-layer step tail is the end-to-end one's arithmetic over
    the window's unit times, and reads nothing in a render cell."""
    read = harness.reader(DATA, "step_ms_p95.train")
    times = [0.001 * k for k in range(1, 101)]
    t = dict(record("train", []), unit_s=times)
    assert read(t) == pytest.approx(95.05)
    assert read(t) == 1e3 * arith.percentile(times, 95)
    assert read(dict(record("render", []), unit_s=times)) is None
    assert read(record("train", [])) is None


@pytest.mark.parametrize("name,loop", [("k1_ms_per_frame.render", "render"),
                                       ("k4_roofline.train", "train"),
                                       ("kernels_per_frame.render",
                                        "render")])
def test_kernel_name_guard(name, loop):
    """A reader that selects kernels by name fails loudly where the slice
    holds none of them, so a renamed kernel never reads as 0."""
    with pytest.raises(RuntimeError):
        harness.reader(DATA, name)(record(loop, [("Memset (Device)",
                                                  1e-6)]))
