"""The check that decides `correct`, on the CPU at the tiny cells' size:
the port (its kernels' PyTorch twins) agrees with the plain reference;
the control (the reference in bfloat16 in the program's place) reads
incorrect; and a run with the timed path broken underneath reads
incorrect for each fault a cell can have. The tracer's chunked culling
gives what a test of every pair gives."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_port import compare, harness, loops
from bench_port.reference.tracer import Tracer, moller_trumbore


def run(tiny, cell):
    return harness.run(cell, 987654321987, 0.3, False,
                       t_start=time.perf_counter(), device="cpu",
                       bench=tiny["bench"], data=tiny["data"])


def loop_of(tiny, cell, seed=4242):
    _, _, cfg, traffic = harness.load_cell(cell, tiny["bench"], tiny["data"])
    return loops.loop_type(traffic["loop"], tiny["data"])(
        cfg, traffic, seed, "cpu", data=tiny["data"])


@pytest.mark.parametrize("cell", ["tiny.render_orbit", "tiny.train_material"])
def test_port_agrees_with_reference(tiny, cell):
    res = run(tiny, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def test_control_reads_incorrect_render(tiny):
    lp = loop_of(tiny, "tiny.render_orbit")
    views = lp.control_views()
    want = lp.reference(torch.float32, views)
    got = lp.reference(torch.bfloat16, views)
    ok, _ = compare.judge(lp.numbers(got, want),
                          compare.load_limits(tiny["data"],
                                              "tiny.render_orbit"))
    assert not ok


def test_control_reads_incorrect_train(tiny):
    lp = loop_of(tiny, "tiny.train_material")
    want = lp.reference(torch.float32)
    ok, _ = compare.judge(lp.numbers(lp.reference(torch.bfloat16), want),
                          compare.load_limits(tiny["data"],
                                              "tiny.train_material"))
    assert not ok


def _state_unchanged_film(film, sample):
    return film


def _altered_sample(render_sample):
    def altered(*a, **kw):
        return render_sample(*a, **kw) * 1.01
    return altered


def _half_image(render_sample):
    """Half of the pixels left out, filled with the mean of the rest."""
    def half(*a, **kw):
        img = render_sample(*a, **kw).clone()
        flat = img.reshape(-1, 3)
        n = flat.shape[0] // 2
        flat[n:] = flat[:n].mean(0)
        return img
    return half


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_render_faults_read_incorrect(tiny, monkeypatch, fault):
    from dustraytracer_tpu_torch.render import film

    if fault == "state_unchanged":
        monkeypatch.setattr(film, "film_add", _state_unchanged_film)
    elif fault == "half_batch":
        monkeypatch.setattr(film, "render_sample",
                            _half_image(film.render_sample))
    else:
        monkeypatch.setattr(film, "render_sample",
                            _altered_sample(film.render_sample))
    assert not run(tiny, "tiny.render_orbit")["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "stale_frame_in_window"])
def test_train_faults_read_incorrect(tiny, monkeypatch, fault):
    from dustraytracer_tpu_torch.apps import optimize

    if fault == "state_unchanged":
        make = optimize.make_optimizer

        def frozen(params, lr):
            opt = make(params, lr)
            step = opt.step

            def step_back():
                keep = [p.detach().clone() for p in
                        opt.param_groups[0]["params"]]
                step()
                with torch.no_grad():
                    for p, k in zip(opt.param_groups[0]["params"], keep):
                        p.copy_(k)
            opt.step = step_back
            return opt
        monkeypatch.setattr(optimize, "make_optimizer", frozen)
    elif fault == "half_batch":
        monkeypatch.setattr(optimize, "render_pixels",
                            _half_pixels(optimize.render_pixels))
    elif fault == "answer_altered":
        make_loss = optimize.make_loss_fn

        def altered(*a, **kw):
            fn = make_loss(*a, **kw)
            return lambda params, frame: fn(params, frame) * 1.01
        monkeypatch.setattr(optimize, "make_loss_fn", altered)
    else:
        # right through the set-up's steps, then a frame cached from the
        # last of them: only the window's steps go wrong
        make_loss = optimize.make_loss_fn

        def cached(*a, **kw):
            fn, seen = make_loss(*a, **kw), []

            def loss_fn(params, frame):
                seen.append(frame)
                return fn(params, seen[min(len(seen), 3) - 1])
            return loss_fn
        monkeypatch.setattr(optimize, "make_loss_fn", cached)
    assert not run(tiny, "tiny.train_material")["correct"]


def _half_pixels(render_pixels):
    """The loss over the first half of the pixels: the second half's
    colours are replaced by the first half's mean, detached."""
    def half(*a, **kw):
        col = render_pixels(*a, **kw)
        n = col.shape[0] // 2
        fill = col[:n].mean(0, keepdim=True).detach().expand(
            col.shape[0] - n, 3)
        return torch.cat([col[:n], fill])
    return half


def test_tracer_equals_all_pairs():
    rng = np.random.default_rng(5)
    v = torch.tensor(rng.uniform(-1, 1, (700, 3, 3)), dtype=torch.float32)
    v[:, 1:] = v[:, :1] + 0.2 * (v[:, 1:] - v[:, :1])
    o = torch.tensor(rng.uniform(-2, 2, (3000, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(3000, 3)), dtype=torch.float32)
    tr = Tracer(v[:, 0], v[:, 1], v[:, 2])
    hit, tri, t, u, w = tr.closest(o, d)
    ok, tt, _, _ = moller_trumbore(o[:, None], d[:, None], v[None, :, 0],
                                   (v[:, 1] - v[:, 0])[None],
                                   (v[:, 2] - v[:, 0])[None])
    tt = torch.where(ok, tt, float("inf"))
    best, arg = tt.min(1)
    assert torch.equal(hit, torch.isfinite(best))
    assert torch.equal(tri[hit], arg[hit])
    assert torch.equal(t[hit], best[hit])
    assert torch.equal(tr.occluded(o, d), ok.any(1))
