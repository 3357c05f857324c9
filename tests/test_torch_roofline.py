"""The port's utils/roofline.py against the JAX module's on the CPU: the
float64 replay (_sim_tile, _replay_tabs, _sorted_rays) on the same
tables and rays, the calibration chains through the sweep twin against
the JAX chains through the Pallas kernel in interpret mode, the chains'
designed counters, the replay against the twin's own counts, the timing
guards, the SoL pricing and the FMA chain's plain version. Scenes cross
from the JAX package through interop.py. The measuring functions run
only on the card (tests_gpu/, chip_smoke.py); here they must raise."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dustraytracer_tpu.ops.traverse_sweep import (
    traverse_cluster_sweep as j_sweep)
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu.utils import roofline as jr
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import peaks as pk
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.ops.cuda_build import CSRC
from dustraytracer_tpu_torch.utils import profiling
from dustraytracer_tpu_torch.utils import roofline as rl
from tests.util_scenes import make_random_tri_doc

RATES = {"window_ns": 0.2, "leaf_iter_ns": 0.05, "leaf_ns": 0.1}


@pytest.fixture(scope="module")
def soup():
    """test_roofline.py's soup (600 triangles, seed 3): the JAX cluster
    tables and the port's, crossed through interop."""
    jcb = build_scene(make_random_tri_doc(600, seed=3),
                      use_native=False).cluster
    tcb = interop.cluster_from_numpy(interop.scene_to_numpy(jcb))
    return jcb, tcb


def _rays(n, seed=1):
    """test_roofline.py's rays: origins in [-10, 10]^3 toward points in
    [-4, 4]^3."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_sorted_rays_match_jax(soup):
    jcb, tcb = soup
    o, d = _rays(3000)
    jo, jd = jr._sorted_rays(jcb, o, d)
    to, td = rl._sorted_rays(tcb, o, d)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("oct_id", [None, *range(8)])
def test_replay_tabs_match_jax(soup, oct_id):
    jcb, tcb = soup
    want = jr._replay_tabs(jcb, oct_id)
    got = rl._replay_tabs(tcb, oct_id)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sim_tile_matches_jax(soup):
    """The same tables and rays of one octant: visited, entered and leaf
    visits equal, exactly."""
    jcb, tcb = soup
    o, d = _rays(4000)
    octs = rl._ray_octant(d)
    oc = int(np.bincount(octs).argmax())
    o64, d64 = (x[octs == oc][:512].astype(np.float64) for x in (o, d))
    want = jr._sim_tile(jr._replay_tabs(jcb, oc), o64, d64)
    got = rl._sim_tile(rl._replay_tabs(tcb, oc), o64, d64)
    assert want[0].any() and want[2].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("leaf", [False, True, 4])
def test_chain_matches_jax(leaf):
    """The port's chain through the twin and the JAX chain through the
    Pallas kernel in interpret mode (test_sweep.py's mode), k = 8, m =
    16: no ray hits, and every ray stands on all m nodes in both."""
    m = 16
    o, d = rl._chain_rays(100)
    rj = j_sweep(jr._chain_bvh(m, leaf, 8, 4), jnp.asarray(o.numpy()),
                 jnp.asarray(d.numpy()), interpret=True)
    rp = ts.traverse_cluster_sweep(rl._chain_bvh(m, leaf, 8, 4), o, d)
    np.testing.assert_array_equal(rp["hit_idx"].numpy(),
                                  np.asarray(rj["hit_idx"]))
    np.testing.assert_array_equal(rp["t"].numpy(), np.asarray(rj["t"]))
    assert (np.asarray(rj["visits"]) == m).all()
    assert (rp["visits"].numpy() == m).all()


@pytest.mark.parametrize("m", [16, 30])
@pytest.mark.parametrize("chain", ["interior", "all_leaf", "dense_leaf",
                                   "sparse_leaf"])
def test_chain_counters(chain, m):
    """The twin's counters on the calibration chains equal their designed
    counts: m warp iterations per warp; one leaf iteration per leaf a ray
    enters (every leaf but the last node, which ends the walk); 32 leaves
    served in each (the sparse chain: the first CHAIN_LANES lanes)."""
    leaf, lanes = {"interior": (False, None), "all_leaf": (True, None),
                   "dense_leaf": (rl.CHAIN_LEAF_EVERY, None),
                   "sparse_leaf": (rl.CHAIN_LEAF_EVERY,
                                   rl.CHAIN_LANES)}[chain]
    cb = rl._chain_bvh(m, leaf, 8, 3, lanes)
    leaves = int((cb.node_cluster[:m - 1] >= 0).sum())
    n = 4 * rl.WARP
    o, d = rl._chain_rays(n)
    r = ts.traverse_cluster_sweep(cb, o, d, counters=True)
    assert (r["visits"] == m).all()
    assert (r["exec_windows"] == m).all()
    assert (r["exec_leafs"] == leaves).all()
    entering = np.arange(n) % rl.WARP < (lanes or rl.WARP)
    np.testing.assert_array_equal(r["leaf_tests"].numpy(),
                                  np.where(entering, leaves, 0))
    assert (r["hit_idx"] == -1).all()


def test_volume_efficiency_bounds(soup):
    """test_roofline.py's bounds on the port, through the twin."""
    _, tcb = soup
    o, d = _rays(4096)
    vol = rl.volume_efficiency(tcb, o, d, max_tiles=2)
    assert 0.0 < vol["vol_eff_window_pct"] <= 115.0, vol
    assert 0.0 < vol["vol_eff_leaf_pct"] <= 115.0, vol
    assert vol["useful_node_steps"] > 0
    assert vol["exec_node_slots"] >= vol["useful_node_steps"] * 0.85
    # a negative leaf-iteration intercept is priced at 0 on both sides
    for rates in (RATES, {**RATES, "leaf_iter_ns": -0.09}):
        vol2 = rl.volume_efficiency(tcb, o, d, rates=rates, max_tiles=2)
        assert 0.0 < vol2["vol_eff_pct"] <= 115.0


@pytest.mark.parametrize("anyhit", [False, True])
def test_replay_matches_twin_counts(soup, anyhit):
    """Over every warp of a wave, the replay's visits equal the twin's on
    >= 99% of rays, its window share equals sweep_work's
    walk_useful_share within one point (its leaf share useful_share),
    and walk_stats' per-warp steps and leaf iterations equal the twin's
    exec_windows and exec_leafs on >= 99% of warps."""
    _, tcb = soup
    o, d = _rays(4096, seed=2)
    warps = 4096 // rl.WARP
    vol = rl.volume_efficiency(tcb, o, d, max_tiles=warps, anyhit=anyhit)
    so, sd = rl._sorted_rays(tcb, o, d)
    r = ts.traverse_cluster_sweep(tcb, torch.from_numpy(so),
                                  torch.from_numpy(sd), anyhit=anyhit,
                                  counters=True)
    work = rl.sweep_work(r, tcb.k)
    assert vol["n_tiles_sampled"] == warps
    assert vol["visits_equal_pct"] >= 99.0, vol
    assert abs(vol["vol_eff_window_pct"]
               - 100.0 * work["walk_useful_share"]) <= 1.0
    assert abs(vol["vol_eff_leaf_pct"] - 100.0 * work["useful_share"]) <= 1.0
    ws = rl.walk_stats(tcb, o, d, max_tiles=warps, anyhit=anyhit)
    np.testing.assert_array_equal(ws["tiles"], np.arange(warps))
    assert (ws["tile_steps"] == r["exec_windows"].numpy()).mean() >= 0.99
    assert (ws["tile_leaf_steps"] == r["exec_leafs"].numpy()).mean() >= 0.99
    assert abs(ws["mean_visits_per_ray"]
               - float(r["visits"].float().mean())) <= 0.05


def test_delta_time_dispatch_raises_on_nonpositive(monkeypatch):
    """test_roofline.py's shrinking wall clock: every R segment lasts
    longer than its 2R partner, so the median delta is negative and the
    function raises after the doubled-reps retry."""
    state = {"t": 0.0, "call": 0, "run": 0}

    def fake_perf():
        state["call"] += 1
        if state["call"] % 2 == 0:  # end of a run
            state["run"] += 1
            k = state["run"]
            state["t"] += 5.0 if (k > 1 and k % 2 == 0) else 1.0
        return state["t"]

    monkeypatch.setattr(rl.time, "perf_counter", fake_perf)
    with pytest.raises(RuntimeError, match="non-positive delta"):
        rl.delta_time_dispatch(lambda: None, lambda _o: None, reps=2,
                               rounds=3)


def _measurements():
    cb = rl._chain_bvh(8, 4, 8, 2)
    o, d = rl._chain_rays(64)
    return {
        "delta_time_dispatch": lambda: rl.delta_time_dispatch(
            lambda: None, torch.cuda.synchronize),
        "device_seconds_per_call": lambda: rl.device_seconds_per_call(
            lambda _i: None),
        "measure_peaks": lambda: rl.measure_peaks(),
        "calibrate_sweep_rates": lambda: rl.calibrate_sweep_rates(8, 2),
        "sweep_attribution": lambda: rl.sweep_attribution(cb, o, d, RATES),
    }


@pytest.mark.parametrize("name", ["delta_time_dispatch",
                                  "device_seconds_per_call", "measure_peaks",
                                  "calibrate_sweep_rates",
                                  "sweep_attribution"])
def test_measuring_raises_without_cuda(name):
    """No fallback: a measurement of the card on a machine without one
    raises, and never times the CPU under a device name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="is_available"):
        _measurements()[name]()


def test_price_sweep_clips_and_guards():
    counters = {"exec_windows": 1000, "exec_leafs": 100, "leaf_tests": 800}
    model_s = (1000 * 0.2 + 100 * 0.05 + 800 * 0.1) * 1e-9
    low = rl.price_sweep(counters, RATES, 2.0 * model_s, 4096)
    assert low["sol_pct"] == pytest.approx(50.0)
    assert low["sol_raw_pct"] == pytest.approx(50.0)
    assert low["window_share_pct"] + low["leaf_share_pct"] \
        == pytest.approx(50.0)
    assert low["window_share_pct"] == pytest.approx(50.0 * 200 / 285)
    high = rl.price_sweep(counters, RATES, model_s / 1.5, 4096)
    assert high["sol_pct"] == 100.0
    assert high["sol_raw_pct"] == pytest.approx(150.0)
    assert high["sol_mrays_per_s"] == pytest.approx(4096 / model_s / 1e6)
    with pytest.raises(RuntimeError, match="inconsistent SoL"):
        rl.price_sweep(counters, RATES, model_s / 1.8, 4096)


def _closed_form(x0, iters):
    """The chain's exact value: sum over c of A^n x_c + B (A^n - 1) /
    (A - 1), float64."""
    x = np.asarray(x0, np.float64)[:, None] + pk.STEP * np.arange(pk.CHAINS)
    an = pk.A ** iters
    return (an * x + pk.B * (an - 1.0) / (pk.A - 1.0)).sum(axis=1)


def _fmaf_chain_f32(x0, iters):
    """The kernel's arithmetic in numpy: x * A + B is exact in float64 for
    float32 x near 1 (a 48-bit product plus B within 53 bits), so one
    rounding to float32 is fmaf's one rounding; then the float32 sum of
    the chains, left to right."""
    x = (x0[:, None] + np.float32(pk.STEP)
         * np.arange(pk.CHAINS, dtype=np.float32)).astype(np.float32)
    for _ in range(iters):
        x = (x.astype(np.float64) * pk.A + pk.B).astype(np.float32)
    s = np.zeros(x.shape[0], np.float32)
    for c in range(pk.CHAINS):
        s = s + x[:, c]
    return s


@pytest.mark.parametrize("iters", [0, 1, 257, 4096])
def test_fma_chain_plain_matches_closed_form(iters):
    """The plain version (float64) equals the closed form sum_c A^n x_c +
    B (A^n - 1) / (A - 1) within rtol 1e-12 (float64 rounding of n steps);
    the float32 chain the kernel computes lies within fma_tolerance of
    it; the wrapper on a CPU tensor returns the plain version."""
    x0 = np.linspace(1.0, 1.25, 300, dtype=np.float32)
    ref = pk.fma_chain_reference(torch.from_numpy(x0), iters)
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(ref.numpy(), _closed_form(x0, iters),
                               rtol=1e-12, atol=0.0)
    f32 = _fmaf_chain_f32(x0, iters)
    err = np.abs(f32.astype(np.float64) - ref.numpy())
    assert (err <= pk.fma_tolerance(ref, iters).numpy()).all()
    launches = profiling.counters("drt.launch.")
    got = pk.fma_chain(torch.from_numpy(x0), iters)
    assert profiling.counters("drt.launch.") == launches
    torch.testing.assert_close(got, ref.to(torch.float32), rtol=0, atol=0)


def test_fma_kernel_constants_match_the_wrapper():
    """csrc/peaks.cu holds the chain's A, B, STEP and CHAINS that
    ops/peaks.py's plain version uses."""
    src = (CSRC / "peaks.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([0-9.e-]+)f?;",
                         src).group(1)

    assert float(np.float32(float(const("kA")))) == pk.A
    assert float(np.float32(float(const("kB")))) == pk.B
    assert float(const("kStep")) == pk.STEP
    assert int(const("kChains")) == pk.CHAINS


def test_fma_flops_and_input_checks():
    assert pk.fma_flops(10, 100) == 10 * pk.CHAINS * 202
    with pytest.raises(ValueError):
        pk.fma_chain(torch.ones(4, 2), 3)
    with pytest.raises(ValueError):
        pk.fma_chain(torch.ones(4, dtype=torch.float64), 3)
    with pytest.raises(ValueError):
        pk.fma_chain(torch.ones(4), -1)
