"""The port's debug views (render_mode=DEBUG) against the JAX package on
the CPU: every DebugMode on a textured triangle soup; the BVH heat with
the cluster and brute walks, whose visit counts the JAX package shares;
the shading views with the kernel fetch and smooth normals."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer_tpu.render.integrator import render_sample as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import DebugMode as JDebug
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderMode as JMode
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (DebugMode, LightParams,
                                                    RenderMode,
                                                    RenderSettings)
from tests.util_scenes import make_random_tri_doc
from tests.util_torch import compare_images, port_scene

W, H = 40, 32
POSE = dict(position=(0.0, 2.0, 13.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=50.0)


@pytest.fixture(scope="module")
def scenes():
    doc = make_random_tri_doc(600, seed=1)  # 608 padded: a cluster scene
    img = np.random.default_rng(9).integers(0, 256, (16, 16, 4), np.uint8)
    doc.materials[0].base_color_texture = 0
    doc = dataclasses.replace(doc, images=[img])
    js = j_build(doc, use_native=False)
    return js, port_scene(js)


def _render(scenes, mode, **kw):
    js, ts = scenes
    tset = RenderSettings(render_mode=RenderMode.DEBUG, debug_mode=mode,
                          **kw)
    jset = JSettings(render_mode=JMode.DEBUG, debug_mode=JDebug[mode.name],
                     **kw)
    t = render_sample(ts, make_camera(**POSE),
                      LightParams.from_settings(tset), 2, width=W, height=H,
                      settings=tset)
    j = j_render(js, j_camera(**POSE), JLights.from_settings(jset),
                 jnp.uint32(2), width=W, height=H, settings=jset)
    return t.detach().numpy(), np.asarray(j)


@pytest.mark.parametrize("mode", list(DebugMode), ids=lambda m: m.name)
def test_debug_view_matches_jax(scenes, mode):
    kw = {"traversal": "cluster"} if "BVH" in mode.name else {}
    t, j = _render(scenes, mode, **kw)
    assert t.shape == (H, W, 3)
    compare_images(t, j)
    if mode == DebugMode.NORMAL:  # raw normals: no tonemap, no gamma
        assert t.min() < -0.5
    if "BVH" in mode.name:  # heat on every pixel, the base on hits
        assert (t > 0).all() and t[..., 0].max() > 0.05


@pytest.mark.parametrize("traversal", ["brute", "cluster"])
def test_bvh_heat_is_visits_exactly(scenes, traversal):
    t, j = _render(scenes, DebugMode.BVH, traversal=traversal)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", [DebugMode.NORMAL, DebugMode.BARYCENTRIC,
                                  DebugMode.UVS, DebugMode.ALBEDO],
                         ids=lambda m: m.name)
def test_debug_view_kernel_fetch_matches_jax(scenes, mode):
    t, j = _render(scenes, mode, traversal="sweep", shade_fetch="kernel")
    compare_images(t, j)


def test_smooth_normal_view_matches_jax(scenes):
    t, j = _render(scenes, DebugMode.NORMAL, smooth_shading=True)
    compare_images(t, j)


def test_albedo_view_is_tonemapped(scenes):
    raw, _ = _render(scenes, DebugMode.ALBEDO, enable_tonemap=False,
                     enable_gamma=False)
    post, _ = _render(scenes, DebugMode.ALBEDO)
    assert raw.max() > 10.0 and post.max() < 1.5  # the sky, compressed


def test_debug_view_builds_no_bounce(scenes):
    """One closest trace and no shadow ray: the view is the same for any
    bounce count and with the sun off."""
    a, _ = _render(scenes, DebugMode.UVS, bounces=1)
    b, _ = _render(scenes, DebugMode.UVS, bounces=5, enable_sunlight=False)
    np.testing.assert_array_equal(a, b)
