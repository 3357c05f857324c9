"""The train step replayed as CUDA graphs (apps/optimize.py train_step) on
the card: on both benchmark configurations' settings at a small size,
replayed steps equal the eager steps of a capturable Adam bit for bit
(loss, leaves, exp_avg, exp_avg_sq, step); replayed steps make the host
wait for nothing; a new lr, new leaves or a new loss function captures
anew; a mesh loss, alpha_test and traversal=cluster stay eager with
their reasons; under recording() a replayed step counts what the eager
step counts (K4's lanes and live lanes, the kernels' launches) and adds
1 to drt.step.replayed; a loss wrapped in a plain closure, as the
benchmark wraps it, replays."""

import pytest
import torch

from dustraytracer_tpu_torch.apps import optimize
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      sphere_doc)
from dustraytracer_tpu_torch.utils import profiling
from dustraytracer_tpu_torch.utils.checkpoint import param_leaves

pytestmark = pytest.mark.gpu
W, H = 64, 48
# the benchmark's two configurations' settings: suzanne_512 fetches by
# gathers over 4 bounces, dense_monkey_1k in the kernel (emit_attrs) over 2
CONFIGS = {
    "suzanne_512": dict(bounces=4, traversal="sweep", shade_fetch="gather"),
    "dense_monkey_1k": dict(bounces=2, traversal="sweep",
                            shade_fetch="kernel"),
}
FRAMES = [0, 5, 1, 63, 7]
CARD = torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small():
    return build_scene(sphere_doc(*SMALL_SPHERE)).to("cuda")


@pytest.fixture(autouse=True)
def _clean():
    torch.cuda.set_sync_debug_mode("default")
    optimize._STEPS.clear()
    profiling.clear()
    yield
    torch.cuda.set_sync_debug_mode("default")
    optimize._STEPS.clear()
    profiling.clear()


def _trainer(scene, lr=0.02, mesh=None, **kw):
    """(params, optimizer, loss_fn) of the benchmark's step: albedo and
    lights from a fixed scramble, against the target at the true ones."""
    st = RenderSettings(enable_tonemap=False, enable_gamma=False,
                        **{**CONFIGS["suzanne_512"], **kw})
    cam = make_camera(**POSE, device="cuda")
    lights = LightParams.from_settings(st, device="cuda")
    with torch.inference_mode():
        target = render_sample(scene, cam, lights, 9999, width=W, height=H,
                               settings=st).clone()
    params = optimize.as_leaves({
        "mat_albedo": scene.mat_albedo * 0.5 + 0.1,
        "lights": LightParams.from_settings(st.replace(sun_azimuth=1.1,
                                                       sky_intensity=14.0),
                                            device="cuda")})
    opt = optimize.make_optimizer(params, lr)
    loss_fn = optimize.make_loss_fn(scene, cam, lights, target, width=W,
                                    height=H, settings=st, mesh=mesh)
    return params, opt, loss_fn


def _eager_step(params, opt, loss_fn, frame):
    """train_step's eager branch, on any device."""
    opt.zero_grad(set_to_none=True)
    return optimize._run_eager(optimize._step_stages(
        params, opt, loss_fn, frame, graphed.ForwardRecord()))["loss"] \
        .detach()


def _state(params, opt) -> list:
    out = []
    for t in param_leaves(params):
        st = opt.state[t]
        out += [t.detach().clone(), st["exp_avg"].clone(),
                st["exp_avg_sq"].clone(), st["step"].clone()]
    return out


def _replays(params, opt, loss_fn) -> bool:
    return (optimize.step_reason(params, opt, loss_fn) is None
            and isinstance(optimize._STEPS.get(CARD), optimize._StepGraphs))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_replayed_steps_equal_eager_steps(small, config):
    params, opt, loss_fn = _trainer(small, **CONFIGS[config])
    assert opt.param_groups[0]["capturable"]
    e_params, e_opt, e_loss_fn = _trainer(small, **CONFIGS[config])
    for i, frame in enumerate(FRAMES):
        got = optimize.train_step(params, opt, loss_fn, frame)
        want = _eager_step(e_params, e_opt, e_loss_fn, frame)
        assert torch.equal(got, want), (i, float(got), float(want))
        for g, e in zip(_state(params, opt), _state(e_params, e_opt)):
            assert torch.equal(g, e), i
    assert _replays(params, opt, loss_fn)
    assert float(opt.state[params["mat_albedo"]]["step"]) == len(FRAMES)
    # the returned loss is the caller's: the next replay leaves it be
    kept = optimize.train_step(params, opt, loss_fn, 2)
    before = kept.clone()
    optimize.train_step(params, opt, loss_fn, 3)
    assert torch.equal(kept, before)


def test_replayed_steps_make_the_host_wait_for_nothing(small):
    params, opt, loss_fn = _trainer(small)
    for frame in FRAMES[:2]:  # the warm-up and the capture
        optimize.train_step(params, opt, loss_fn, frame)
    assert _replays(params, opt, loss_fn)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    losses = [optimize.train_step(params, opt, loss_fn, f) for f in FRAMES]
    torch.cuda.set_sync_debug_mode("default")
    assert all(float(x) > 0 for x in losses)


def _captures() -> int:
    return profiling.counters("drt.graph.").get("drt.graph.captures", 0)


def test_new_lr_leaves_or_loss_captures_anew(small):
    params, opt, loss_fn = _trainer(small)

    def steps(fn=None, n=3):
        for f in FRAMES[:n]:
            optimize.train_step(params, opt, fn or loss_fn, f)
        assert _replays(params, opt, fn or loss_fn)

    steps()
    per = _captures()
    assert per == 4
    steps()  # the same key replays
    assert _captures() == per
    opt.param_groups[0]["lr"] = 0.01
    assert optimize.step_reason(params, opt, loss_fn) is not None
    steps()
    assert _captures() == 2 * per
    with torch.no_grad():  # the same values at new addresses
        params["mat_albedo"].data = params["mat_albedo"].data.clone()
    steps()
    assert _captures() == 3 * per

    def wrapped(p, frame):
        return loss_fn(p, frame)

    steps(wrapped)
    assert _captures() == 4 * per


@pytest.mark.parametrize("case", ["mesh", "alpha_test", "cluster"])
def test_syncing_or_mesh_loss_stays_eager(small, case):
    if case == "mesh":  # a tile on another device than the leaves' card
        params, opt, loss_fn = _trainer(small, mesh=[CARD,
                                                     torch.device("cpu")])
        want = "not one card"
    elif case == "alpha_test":
        params, opt, loss_fn = _trainer(small, alpha_test=True,
                                        traversal="auto")
        want = graphed.SYNCING["alpha_test"]
    else:
        params, opt, loss_fn = _trainer(small, traversal="cluster")
        want = graphed.SYNCING["traversal=cluster"]
    for f in FRAMES[:3]:
        optimize.train_step(params, opt, loss_fn, f)
    reason = optimize.step_reason(params, opt, loss_fn)
    assert reason is not None and want in reason, reason
    assert isinstance(optimize._STEPS[CARD], optimize._Decided)
    assert _captures() == 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_replayed_step_counts_what_the_eager_step_counts(small, config):
    params, opt, loss_fn = _trainer(small, **CONFIGS[config])
    e_params, e_opt, e_loss_fn = _trainer(small, **CONFIGS[config])
    for f in FRAMES[:2]:
        optimize.train_step(params, opt, loss_fn, f)
        _eager_step(e_params, e_opt, e_loss_fn, f)
    assert _replays(params, opt, loss_fn)
    profiling.clear()
    with profiling.recording():
        optimize.train_step(params, opt, loss_fn, 4)
    got = profiling.counters()
    profiling.clear()
    with profiling.recording():
        _eager_step(e_params, e_opt, e_loss_fn, 4)
    want = profiling.counters()
    assert got["drt.step.replayed"] == 1 and "drt.step.replayed" not in want
    for key in ("drt.k4.lanes", "drt.k4.live_lanes"):
        assert got[key] == want[key] > 0, key
    launches = {k: v for k, v in got.items() if k.startswith("drt.launch.")}
    assert launches == {k: v for k, v in want.items()
                        if k.startswith("drt.launch.")}
    assert launches.get("drt.launch.k4", 0) > 0
    totals = profiling.span_totals()
    assert totals  # the eager step's spans
    profiling.clear()
    with profiling.recording():
        optimize.train_step(params, opt, loss_fn, 5)
    names = set(profiling.span_totals())
    assert {"drt.step", "drt.step.forward", "drt.step.backward",
            "drt.step.adam", "drt.step.project"} <= names


def test_loss_in_a_plain_closure_replays(small):
    params, opt, base = _trainer(small)
    calls = []

    def loss_fn(p, frame):  # as bench_port/loops.py TrainLoop._timed
        calls.append(frame)
        return base(p, frame)

    for f in FRAMES:
        optimize.train_step(params, opt, loss_fn, f)
    assert _replays(params, opt, loss_fn)
    # the warm-up and the capture call it; the replays do not
    assert len(calls) == 2 and isinstance(calls[1], torch.Tensor)
