"""Gradients of the mean image: the port's autograd against
jax.value_and_grad, for materials, every light field, the camera
position and the vertices, with the kernel fetch (the traversal twin's
emit mode against the Pallas kernel in interpret mode) and the gather
fetch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import render_pixels as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.render.integrator import render_pixels
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from tests.util_torch import assert_grad_close, two_material_doc

W = H = 24
BOUNCES = 2
POSE = dict(position=(0.0, 2.0, 12.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=50.0)
LIGHT_KEYS = ("sun_azimuth", "sun_elevation", "sun_color", "sun_intensity",
              "sky_color", "sky_intensity")
PARAMS = ("mat_albedo", "mat_emissive", *LIGHT_KEYS, "position", "tri_pos")
LOSS_RTOL = 1e-5


def _settings(cls, fetch):
    # nee_cosine puts the sun direction into the shading, so the sun
    # angles get a gradient too (without it they only steer shadow rays)
    return cls(bounces=BOUNCES, enable_tonemap=False, enable_gamma=False,
               traversal="sweep", shade_fetch=fetch, tex_filter="bilinear",
               nee_cosine=True)


def jax_value_and_grad(js, fetch, pose=POSE, size=(W, H)):
    w, h = size
    settings = _settings(JSettings, fetch)
    cam = j_camera(**pose)
    ids = jnp.arange(w * h, dtype=jnp.int32)

    def loss(p):
        sc = js.replace(mat_albedo=p["mat_albedo"],
                        mat_emissive=p["mat_emissive"], tri_pos=p["tri_pos"])
        img = j_render(sc, cam.replace(position=p["position"]), p["lights"],
                       jnp.uint32(0), ids, width=w, height=h,
                       settings=settings)
        return jnp.mean(img)

    params = {"mat_albedo": js.mat_albedo, "mat_emissive": js.mat_emissive,
              "tri_pos": js.tri_pos, "position": cam.position,
              "lights": JLights.from_settings(settings)}
    val, g = jax.jit(jax.value_and_grad(loss))(params)
    out = {k: np.asarray(g[k]) for k in params if k != "lights"}
    out.update({k: np.asarray(getattr(g["lights"], k)) for k in LIGHT_KEYS})
    return float(val), out


def port_value_and_grad(tsc, fetch, pose=POSE, size=(W, H), device="cpu",
                        wrt=PARAMS):
    """Loss and gradients of the port; only the leaves in `wrt` require
    grad, the others are constants with zero gradient."""
    w, h = size
    settings = _settings(RenderSettings, fetch)
    tsc = tsc.to(device)
    cam = make_camera(**pose, device=device)
    lights = LightParams.from_settings(settings, device=device)
    leaves = {"mat_albedo": tsc.mat_albedo, "mat_emissive": tsc.mat_emissive,
              "tri_pos": tsc.tri_pos, "position": cam.position,
              **{k: getattr(lights, k) for k in LIGHT_KEYS}}
    leaves = {k: v.detach().clone().requires_grad_(k in wrt)
              for k, v in leaves.items()}
    sc = tsc.replace(mat_albedo=leaves["mat_albedo"],
                     mat_emissive=leaves["mat_emissive"],
                     tri_pos=leaves["tri_pos"])
    img = render_pixels(sc, cam.replace(position=leaves["position"]),
                        lights.replace(**{k: leaves[k] for k in LIGHT_KEYS}),
                        0, torch.arange(w * h, device=device), width=w,
                        height=h, settings=settings)
    loss = img.mean()
    loss.backward()
    # a leaf the image does not depend on keeps grad None: JAX's zeros
    return float(loss.detach()), {
        k: (v.grad if v.grad is not None else torch.zeros_like(v))
        .cpu().numpy() for k, v in leaves.items()}


@pytest.fixture(scope="module")
def scenes():
    js = j_build(two_material_doc(), use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


_RESULTS = {}


@pytest.fixture(scope="module")
def grads(scenes):
    def get(fetch):
        if fetch not in _RESULTS:
            js, tsc = scenes
            _RESULTS[fetch] = (jax_value_and_grad(js, fetch),
                               port_value_and_grad(tsc, fetch))
        return _RESULTS[fetch]
    return get


@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_loss_matches_jax(grads, fetch):
    (jv, _), (tv, _) = grads(fetch)
    assert 0.0 < tv
    assert abs(tv - jv) <= LOSS_RTOL * abs(jv), (tv, jv)


@pytest.mark.parametrize("param", PARAMS)
@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_grad_matches_jax(grads, fetch, param):
    (_, jg), (_, tg) = grads(fetch)
    assert tg[param].shape == jg[param].shape
    assert np.isfinite(tg[param]).all()
    assert_grad_close(tg[param], jg[param], param)
    if param not in ("mat_emissive",):  # reference shading ignores it
        assert np.abs(tg[param]).max() > 0.0, param


def test_kernel_and_gather_fetch_agree(grads):
    # the same port, two fetches: the kernel fetch's backward recomputes
    # what the gather fetch differentiates directly
    (_, _), (tv_k, tg_k) = grads("kernel")
    (_, _), (tv_g, tg_g) = grads("gather")
    assert abs(tv_k - tv_g) <= LOSS_RTOL * abs(tv_g)
    for param in PARAMS:
        assert_grad_close(tg_k[param], tg_g[param], param)


@pytest.mark.parametrize("param", ["position", "tri_pos", "sky_color"])
def test_kernel_fetch_grad_of_one_leaf(scenes, grads, param):
    """Each leaf differentiated alone. With the camera alone the kernel
    fetch's recomputed normal is a constant (it depends on tri_pos only),
    so its backward must pull the cotangents only through the outputs
    that depend on a differentiable input."""
    (_, jg), _ = grads("kernel")
    _, tsc = scenes
    _, tg = port_value_and_grad(tsc, "kernel", wrt=(param,))
    assert np.abs(tg[param]).max() > 0.0
    assert_grad_close(tg[param], jg[param], param)


@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_grads_finite_where_most_rays_miss(scenes, fetch):
    """Masked miss lanes read an arbitrary triangle through `safe`; no
    0 * inf may reach a gradient. Looking away from the soup, most
    primary rays miss."""
    _, tsc = scenes
    pose = dict(position=(0.0, 2.0, 12.0), look_at=(9.0, 6.0, 0.0),
                vfov_deg=50.0)
    loss, g = port_value_and_grad(tsc, fetch, pose=pose, size=(16, 16))
    assert np.isfinite(loss)
    for name, val in g.items():
        assert np.isfinite(val).all(), name
    assert np.abs(g["sky_intensity"]).max() > 0.0


def test_render_pixels_builds_no_graph_in_inference_mode(scenes):
    _, tsc = scenes
    settings = _settings(RenderSettings, "kernel")
    albedo = tsc.mat_albedo.clone().requires_grad_(True)
    with torch.inference_mode():
        img = render_pixels(tsc.replace(mat_albedo=albedo),
                            make_camera(**POSE),
                            LightParams.from_settings(settings), 0,
                            torch.arange(8 * 8), width=8, height=8,
                            settings=settings)
    assert not img.requires_grad
