"""The port's inverse-rendering step and optimizer CLI
(apps/optimize.py, utils/checkpoint.py, parallel/shard.py): Adam steps
against optax.adam steps of the JAX package from the same initial
params, train-state checkpoints read across the two packages, the CLI's
self-test on the CPU with every --optimize choice, and the option that
is not ported yet (--devices)."""

import functools
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.apps.optimize import project_params as j_project
from dustraytracer_tpu.parallel.shard import apply_params as j_apply
from dustraytracer_tpu.render.integrator import render_pixels as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu.utils import checkpoint as j_ckpt
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.apps import optimize
from dustraytracer_tpu_torch.parallel.shard import apply_params
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils import checkpoint
from tests.util_scenes import make_random_tri_doc

W = H = 16
STEPS = 3
LR = 2e-2
POSE = dict(position=(0.0, 2.0, 12.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=50.0)
PARAM_TOL = 1e-5


def _settings(cls):
    return cls(bounces=2, enable_tonemap=False, enable_gamma=False,
               traversal="sweep")


@pytest.fixture(scope="module")
def scenes():
    js = j_build(make_random_tri_doc(400, seed=7), use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


@pytest.fixture(scope="module")
def runs(scenes):
    """STEPS steps of both packages from the same scrambled albedo, the
    true lights and the same (JAX-rendered) target; params after each."""
    js, tsc = scenes
    init = optimize.scramble(tsc, ["albedo"], self_test=True)
    init_np = {k: v.numpy() for k, v in init.items()}

    # JAX: the train step of apps/optimize.py, built from its parts
    jset = _settings(JSettings)
    jcam = j_camera(**POSE)
    jlights = JLights.from_settings(jset)
    ids = jnp.arange(W * H, dtype=jnp.int32)
    target = j_render(js, jcam, jlights, jnp.uint32(0), ids, width=W,
                      height=H, settings=jset)

    def j_loss(p):
        sc, c, li = j_apply(js, jcam, jlights, p)
        color = j_render(sc, c, li, jnp.uint32(0), ids, width=W, height=H,
                         settings=jset)
        return jnp.sum((color - target) ** 2) / (W * H * 3)

    import optax

    tx = optax.adam(LR)

    @jax.jit
    def j_step(p, s):
        loss, g = jax.value_and_grad(j_loss)(p)
        upd, s = tx.update(g, s, p)
        return j_project(optax.apply_updates(p, upd)), s, loss

    jp = {"mat_albedo": jnp.asarray(init_np["mat_albedo"]),
          "lights": jlights}
    js_state = tx.init(jp)
    j_hist = []
    for _ in range(STEPS):
        jp, js_state, loss = j_step(jp, js_state)
        j_hist.append((float(loss), [np.asarray(x)
                                     for x in jax.tree.leaves(jp)]))

    # the port
    tset = _settings(RenderSettings)
    tcam = make_camera(**POSE)
    tlights = LightParams.from_settings(tset)
    tp = optimize.as_leaves({**init, "lights": tlights})
    opt = optimize.make_optimizer(tp, LR)
    loss_fn = optimize.make_loss_fn(
        tsc, tcam, tlights,
        torch.from_numpy(np.array(target)).reshape(H, W, 3), width=W,
        height=H, settings=tset)
    t_hist = []
    for _ in range(STEPS):
        loss = optimize.train_step(tp, opt, loss_fn, 0)
        t_hist.append((float(loss), [x.detach().numpy().copy() for x in
                                     checkpoint.param_leaves(tp)]))
    return {"j": j_hist, "t": t_hist, "tp": tp, "opt": opt, "jp": jp,
            "j_state": js_state, "tx": tx}


@pytest.mark.parametrize("step", range(STEPS))
def test_adam_steps_match_optax(runs, step):
    (jl, jleaves), (tl, tleaves) = runs["j"][step], runs["t"][step]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert len(jleaves) == len(tleaves) == 7  # 6 light fields + albedo
    for jv, tv in zip(jleaves, tleaves):
        np.testing.assert_allclose(tv, jv, rtol=0, atol=PARAM_TOL)


def test_steps_move_the_params(runs):
    first = runs["t"][0][1]
    last = runs["t"][-1][1]
    assert not np.array_equal(first[-1], last[-1])  # mat_albedo


def test_param_leaves_follow_jax_flatten_order(runs):
    tl = checkpoint.param_leaves(runs["tp"])
    jl = jax.tree.leaves(runs["jp"])
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]


def test_port_checkpoint_loads_in_jax(runs, tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_train_state(path, runs["tp"], runs["opt"], step=STEPS)
    example_p = jax.tree.map(jnp.zeros_like, runs["jp"])
    example_o = runs["tx"].init(example_p)
    params, opt_state, step = j_ckpt.load_train_state(path, example_p,
                                                      example_o)
    assert step == STEPS
    for jv, tv in zip(jax.tree.leaves(params),
                      checkpoint.param_leaves(runs["tp"])):
        np.testing.assert_array_equal(np.asarray(jv), tv.detach().numpy())
    # optax's (count, mu, nu) against torch's (step, exp_avg, exp_avg_sq)
    o = jax.tree.leaves(opt_state)
    n = len(checkpoint.param_leaves(runs["tp"]))
    assert int(o[0]) == STEPS and len(o) == 1 + 2 * n
    for i, t in enumerate(checkpoint.param_leaves(runs["tp"])):
        st = runs["opt"].state[t]
        np.testing.assert_array_equal(np.asarray(o[1 + i]),
                                      st["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(o[1 + n + i]),
                                      st["exp_avg_sq"].numpy())


def test_jax_checkpoint_loads_in_port(runs, tmp_path, monkeypatch):
    # the JAX package writes the npz layout when orbax is not importable
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = str(tmp_path / "ckpt")
    j_ckpt.save_train_state(path, runs["jp"], runs["j_state"], step=5)
    assert (tmp_path / "ckpt.npz").exists()

    example = optimize.as_leaves(
        {"mat_albedo": torch.zeros(runs["tp"]["mat_albedo"].shape),
         "lights": LightParams.from_settings(RenderSettings())})
    opt = optimize.make_optimizer(example, LR)
    params, r_opt, step = checkpoint.load_train_state(path, example, opt)
    assert step == 5 and r_opt is opt
    for jv, tv in zip(jax.tree.leaves(runs["jp"]),
                      checkpoint.param_leaves(params)):
        np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    adam = runs["j_state"][0]
    mu, nu = jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)
    for i, t in enumerate(checkpoint.param_leaves(params)):
        st = opt.state[t]
        assert float(st["step"]) == float(adam.count)
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(mu[i]))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(nu[i]))


def test_missing_checkpoint_is_none(tmp_path):
    assert checkpoint.load_train_state(str(tmp_path / "none"), {}) is None


def test_film_roundtrip_across_packages(tmp_path):
    from dustraytracer_tpu.render.film import Film as JFilm
    from dustraytracer_tpu_torch.render.film import Film

    film = Film(accum=torch.arange(48.0).reshape(4, 4, 3), frame=7)
    checkpoint.save_film(tmp_path / "f.npz", film)
    back = j_ckpt.load_film(tmp_path / "f.npz", 4, 4)
    np.testing.assert_array_equal(np.asarray(back.accum), film.accum.numpy())
    assert int(back.frame) == 7
    j_ckpt.save_film(tmp_path / "j.npz",
                     JFilm(accum=jnp.ones((2, 3, 3)), frame=jnp.int32(4)))
    got = checkpoint.load_film(tmp_path / "j.npz", 3, 2)
    assert got.frame == 4 and torch.equal(got.accum, torch.ones((2, 3, 3)))
    assert checkpoint.load_film(tmp_path / "j.npz", 8, 8) is None


def test_apply_params_overlays(scenes):
    _, tsc = scenes
    cam = make_camera(**POSE)
    lights = LightParams.from_settings(RenderSettings())
    cam2 = cam.replace(vfov_deg=torch.tensor(30.0))
    alb = tsc.mat_albedo * 0.5
    sc, c, li = apply_params(tsc, cam, lights, {
        "mat_albedo": alb, "camera": cam2})
    assert sc.mat_albedo is alb and c is cam2 and li is lights
    assert sc.cluster is tsc.cluster  # no tri_pos: no refit


# --- the CLI ---

@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    from chip_smoke import write_glb
    from dustraytracer_tpu_torch.scene.gltf import GltfDocument

    doc = make_random_tri_doc(600, seed=5)
    path = tmp_path_factory.mktemp("opt") / "soup.glb"
    write_glb(path, GltfDocument(meshes=doc.meshes, materials=doc.materials,
                                 images=[], cameras=[]))
    return str(path)


def _cli(glb, out, *extra):
    return ["--scene", glb, "--self-test", "--size", "16x16", "--steps",
            str(STEPS), "--bounces", "1", "--cpu", "--camera-pos", "0,0,14",
            "--look-at", "0,0,0", "--out", str(out), *extra]


@pytest.mark.parametrize("what", [
    ["--optimize", "albedo", "lights"],
    ["--optimize", "camera"],
    # a second bounce starts at the hit point, so the image depends on
    # the vertices even with hard edges
    ["--optimize", "vertices", "--soft-edges", "0", "--perturb-vertices",
     "0.02", "--bounces", "2"],
])
def test_cli_self_test_on_cpu(glb, tmp_path, capsys, what):
    out = tmp_path / "run"
    assert optimize.main(_cli(glb, out, "--checkpoint-every", "1",
                              *what)) == 0
    res = json.loads(capsys.readouterr().out)
    assert [h["step"] for h in res["history"]] == [0, STEPS - 1]
    assert np.isfinite(res["final_loss"]) and res["seconds_per_step"] > 0
    assert (out / "ckpt.npz").exists() and (out / "final.png").exists()
    if "albedo" in what:
        assert res["history"][-1]["loss"] < res["history"][0]["loss"]
        assert set(res["param_mae"]) == {"mat_albedo"}


def test_cli_camera_with_kernel_fetch(glb, tmp_path, capsys, monkeypatch):
    """--optimize camera through the kernel fetch (what "auto" picks on a
    card for scenes in its band; on the CPU "auto" picks the gather
    fetch): the rays are the only differentiable input of its backward."""
    monkeypatch.setattr(optimize, "RenderSettings", functools.partial(
        RenderSettings, shade_fetch="kernel"))
    out = tmp_path / "run"
    assert optimize.main(_cli(glb, out, "--optimize", "camera",
                              "--bounces", "2")) == 0
    res = json.loads(capsys.readouterr().out)
    assert np.isfinite(res["final_loss"])
    assert [h["step"] for h in res["history"]] == [0, STEPS - 1]


def test_cli_resume(glb, tmp_path, capsys):
    out = tmp_path / "run"
    base = _cli(glb, out, "--checkpoint-every", "2")
    assert optimize.main(base) == 0  # checkpoint at step 2
    capsys.readouterr()
    assert optimize.main(base[:base.index("--steps")] + ["--steps", "5"]
                         + base[base.index("--steps") + 2:]
                         + ["--resume"]) == 0
    cap = capsys.readouterr()
    assert "resumed from step 2" in cap.err
    assert [h["step"] for h in json.loads(cap.out)["history"]] == [4]


@pytest.mark.parametrize("flag", [["--devices", "2"]])
def test_cli_not_ported_options_raise(glb, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        optimize.main(_cli(glb, tmp_path / "x", *flag))


# options that were refused before PBR shading, float textures and soft
# edges were ported: each optimizes on the CPU and lowers the loss (the
# PBR parameters change the image only in shading="pbr", which they
# switch on; vertices take the default soft edges 0.05)
FORMERLY_UNPORTED = {
    "emissive": ["--optimize", "emissive"],
    "albedo_roughness": ["--optimize", "albedo", "roughness", "metallic"],
    "textures": ["--optimize", "textures"],
    "vertices": ["--optimize", "vertices", "--perturb-vertices", "0.02",
                 "--bounces", "2", "--lr", "2e-3"],
}


@pytest.mark.parametrize("name", sorted(FORMERLY_UNPORTED))
def test_cli_formerly_unported_options(tmp_path, capsys, monkeypatch, name):
    from tests.util_torch import two_material_doc

    textured = interop.scene_from_numpy(interop.scene_to_numpy(
        j_build(two_material_doc(), use_native=False)))
    monkeypatch.setattr(optimize, "load_scene", lambda path: textured)
    out = tmp_path / "run"
    assert optimize.main(_cli("textured.glb", out, "--steps", "5",
                              *FORMERLY_UNPORTED[name])) == 0
    res = json.loads(capsys.readouterr().out)
    first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
    assert 0.0 < last < first, (first, last)
    assert set(res["param_mae"]) == {
        optimize.PARAM_KEYS[k] for k in FORMERLY_UNPORTED[name][1:]
        if k in optimize.PARAM_KEYS}


def test_cli_cuda_without_card_raises(glb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    argv = _cli(glb, tmp_path / "x")
    argv.remove("--cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        optimize.main(argv)
