"""Soft edges in the port against the JAX package on the CPU: the
silhouette gradient of an edge seen against the sky (the deterministic
blend) and of an occluder against a wall (the reweighted pass-through),
hard visibility's zero gradient, soft_edges=0, and a soft-edged render
and vertex gradient of a triangle soup through the sweep traversal
(tests/test_grad.py:142-292)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import render_sample as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.gltf import GltfDocument, GltfMaterial
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from tests.util_scenes import make_quad, make_random_tri_doc
from tests.util_torch import (assert_grad_close, compare_images,
                              jax_loss_grads, port_loss_grads, port_scene)

W = H = 16


def _doc(meshes, colors):
    return GltfDocument(
        meshes=meshes, images=[], cameras=[],
        materials=[GltfMaterial(base_color=np.float32(c)) for c in colors])


# environment-backed: a quad seen against the sky; geometry-backed: an
# occluder against a big back wall (tests/test_grad.py's two scenes)
EDGES = {
    "sky": dict(
        doc=lambda: _doc([("wall", [make_quad((0, 4, -2), 2, axis=2)])],
                         [[0.9, 0.2, 0.2]]),
        pose=dict(position=(0.0, 1.0, 2.0), look_at=(0.0, 4.0, -2.0),
                  vfov_deg=60.0),
        settings=dict(bounces=1, enable_sunlight=False), true_dx=0.3),
    "wall": dict(
        doc=lambda: _doc(
            [("occluder", [make_quad((0, 2.0, -1), 1.0, axis=2, mat=0)]),
             ("backwall", [make_quad((0, 2.0, -3), 8.0, axis=2, mat=1)])],
            [[0.9, 0.2, 0.2], [0.2, 0.9, 0.3]]),
        pose=dict(position=(0.0, 2.0, 2.0), look_at=(0.0, 2.0, -1.0),
                  vfov_deg=55.0),
        settings=dict(bounces=2), true_dx=0.25),
}


def _kw(edge, soft=0.08):
    return dict(enable_tonemap=False, enable_gamma=False, soft_edges=soft,
                traversal="gather", **EDGES[edge]["settings"])


@pytest.fixture(scope="module")
def edge_scenes():
    out = {}
    for name, e in EDGES.items():
        js = j_build(e["doc"](), use_native=False)
        out[name] = (js, port_scene(js))
    return out


_JAX_LOSS = {}


def _jax_loss(js, edge, soft):
    """loss(dx, frame) and its gradient, jitted once per edge and
    softness: mean squared error against the target at the true
    translation of triangles 0-1 along x, in the JAX package."""
    if (edge, soft) not in _JAX_LOSS:
        _JAX_LOSS[edge, soft] = _make_jax_loss(js, edge, soft)
    return _JAX_LOSS[edge, soft]


def _make_jax_loss(js, edge, soft):
    e = EDGES[edge]
    s = JSettings(**_kw(edge, soft))
    cam, lights = j_camera(**e["pose"]), JLights.from_settings(s)
    base = jnp.asarray(np.asarray(js.tri_pos))

    def render(dx, frame):
        tp = base.at[:2, :, 0].add(dx)
        return j_render(js.replace(tri_pos=tp), cam, lights, frame,
                        width=W, height=H, settings=s)

    target = render(jnp.float32(e["true_dx"]), jnp.uint32(0))
    return jax.jit(jax.value_and_grad(
        lambda dx, f: jnp.mean((render(dx, f) - target) ** 2)))


def _port_loss(ts, edge, soft):
    e = EDGES[edge]
    s = RenderSettings(**_kw(edge, soft))
    cam, lights = make_camera(**e["pose"]), LightParams.from_settings(s)
    base = ts.tri_pos.clone()

    def render(dx, frame):
        off = torch.zeros_like(base)
        off[:2, :, 0] = 1.0
        return render_sample(ts.replace(tri_pos=base + off * dx), cam,
                             lights, frame, width=W, height=H, settings=s)

    with torch.no_grad():
        target = render(torch.tensor(e["true_dx"]), 0)

    def loss(dx, frame):
        return ((render(dx, frame) - target) ** 2).mean()
    return loss


@pytest.mark.parametrize("frame", [0, 3])
@pytest.mark.parametrize("dx", [0.0, 0.15])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_silhouette_gradient_matches_jax(edge_scenes, edge, dx, frame):
    js, ts = edge_scenes[edge]
    jl, jg = _jax_loss(js, edge, 0.08)(jnp.float32(dx), jnp.uint32(frame))
    x = torch.tensor(dx, requires_grad=True)
    tl = _port_loss(ts, edge, 0.08)(x, frame)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(x.grad) != 0.0  # the silhouette moves the image
    assert_grad_close(np.float32(x.grad), np.float32(jg), edge)


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_hard_visibility_has_no_silhouette_gradient(edge_scenes, edge):
    _, ts = edge_scenes[edge]
    x = torch.tensor(0.0, requires_grad=True)
    loss = _port_loss(ts, edge, 0.0)(x, 0)
    # with one bounce and no sun the loss does not reach the vertices
    if loss.requires_grad:
        (g,) = torch.autograd.grad(loss, x, allow_unused=True)
        assert g is None or float(g) == 0.0


def test_sky_backed_descent_recovers_translation(edge_scenes):
    """tests/test_grad.py::test_soft_edge_silhouette_gradient's
    behavioural gate in the port: Adam on the silhouette alone finds the
    quad's true translation."""
    _, ts = edge_scenes["sky"]
    loss = _port_loss(ts, "sky", 0.08)
    dx = torch.tensor(0.0, requires_grad=True)
    opt = torch.optim.Adam([dx], lr=0.03)
    for step in range(200):
        opt.zero_grad()
        loss(dx, step % 8).backward()
        opt.step()
    got = float(dx.detach())
    assert abs(got - EDGES["sky"]["true_dx"]) < 0.05, got


def test_soft_edges_off_is_the_reference(tri_scene):
    """soft_edges=0 leaves the image bit for bit, and matches JAX."""
    ts = port_scene(tri_scene)
    pose = dict(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50.0)
    s0 = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(s0)
    a = render_sample(ts, make_camera(**pose), lights, 0, width=W, height=H,
                      settings=s0)
    b = render_sample(ts, make_camera(**pose), lights, 0, width=W, height=H,
                      settings=s0.replace(soft_edges=0.0))
    assert torch.equal(a, b)
    js0 = JSettings(bounces=2, enable_tonemap=False, enable_gamma=False,
                    soft_edges=0.0)
    j = j_render(tri_scene, j_camera(**pose), JLights.from_settings(js0),
                 jnp.uint32(0), width=W, height=H, settings=js0)
    np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-6)


SOUP_POSE = dict(position=(0.0, 2.0, 12.0), look_at=(0.0, 0.0, 0.0),
                 vfov_deg=50.0)


@pytest.fixture(scope="module")
def soup():
    js = j_build(make_random_tri_doc(600, seed=3), use_native=False)
    return js, port_scene(js)


@pytest.mark.parametrize("traversal", ["sweep", "gather"])
def test_soft_edge_render_matches_jax(soup, traversal):
    js, ts = soup
    kw = dict(bounces=3, soft_edges=0.05, traversal=traversal)
    t = render_sample(ts, make_camera(**SOUP_POSE),
                      LightParams.from_settings(RenderSettings(**kw)), 1,
                      width=32, height=24, settings=RenderSettings(**kw))
    j = j_render(js, j_camera(**SOUP_POSE),
                 JLights.from_settings(JSettings(**kw)), jnp.uint32(1),
                 width=32, height=24, settings=JSettings(**kw))
    compare_images(t.detach().numpy(), j)


SOUP_KEYS = ("tri_pos", "mat_albedo", "sky_color")


@pytest.fixture(scope="module")
def soup_grads(soup):
    js, ts = soup
    kw = dict(bounces=2, soft_edges=0.05, traversal="sweep",
              enable_tonemap=False, enable_gamma=False)
    return (jax_loss_grads(js, SOUP_POSE, JSettings(**kw), SOUP_KEYS,
                           (24, 24)),
            port_loss_grads(ts, SOUP_POSE, RenderSettings(**kw), SOUP_KEYS,
                            (24, 24)))


@pytest.mark.parametrize("key", SOUP_KEYS)
def test_soft_edge_soup_grads_match_jax(soup_grads, key):
    (jv, jg), (tv, tg) = soup_grads
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    assert np.isfinite(tg[key]).all() and np.abs(tg[key]).max() > 0.0
    assert_grad_close(tg[key], jg[key], key)
