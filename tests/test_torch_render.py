"""The port's forward render (render_sample, render_progressive) against
the JAX package on the same scene, carried across through interop."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.film import film_image as j_film_image
from dustraytracer_tpu.render.film import render_progressive as j_progressive
from dustraytracer_tpu.render.integrator import render_sample as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderMode as JRenderMode
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.render.film import film_image
from dustraytracer_tpu_torch.render.film import render_progressive
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams, RenderMode,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils.image import save_png, to_uint8
from tests.util_scenes import make_random_tri_doc
from tests.util_torch import compare_images

W, H = 48, 32
POSE = dict(position=(0.0, 2.0, 13.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=50.0)


@pytest.fixture(scope="module")
def scenes():
    doc = make_random_tri_doc(600, seed=1)  # 608 padded > 512: cluster path
    img = np.random.default_rng(9).integers(0, 256, (16, 16, 4), np.uint8)
    img[..., 3] = 255
    doc.materials[0].base_color_texture = 0
    doc = dataclasses.replace(doc, images=[img])
    js = j_build(doc, use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


@pytest.mark.parametrize("frame", [0, 1])
def test_render_sample_matches_jax(scenes, frame):
    js, ts = scenes
    settings = RenderSettings(bounces=3)
    jset = JSettings(bounces=3)
    t_img = render_sample(ts, make_camera(**POSE),
                          LightParams.from_settings(settings), frame,
                          width=W, height=H, settings=settings)
    j_img = j_render(js, j_camera(**POSE), JLights.from_settings(jset),
                     jnp.uint32(frame), width=W, height=H, settings=jset)
    assert tuple(t_img.shape) == (H, W, 3)
    compare_images(t_img.numpy(), j_img)
    assert 0.05 < float(t_img.mean()) < 1.2  # lit, not blank


def test_render_progressive_matches_jax(scenes):
    js, ts = scenes
    t_film = render_progressive(ts, make_camera(**POSE),
                                RenderSettings(bounces=3, max_samples=5),
                                width=W, height=H, spp=3)
    j_film = j_progressive(js, j_camera(**POSE),
                           JSettings(bounces=3, max_samples=5),
                           width=W, height=H, spp=3)
    assert t_film.frame == int(j_film.frame) == 3
    compare_images(film_image(t_film).numpy(), j_film_image(j_film))
    # the max_samples gate: 3 more samples stop at 5
    t_film = render_progressive(ts, make_camera(**POSE),
                                RenderSettings(bounces=3, max_samples=5),
                                width=W, height=H, spp=3, film=t_film)
    assert t_film.frame == 5


def test_save_png_pixels(tmp_path):
    from PIL import Image  # decoding only; the writer needs no Pillow

    img = np.random.default_rng(2).uniform(-0.2, 1.2, (5, 7, 3))
    save_png(tmp_path / "a.png", torch.from_numpy(img).float())
    back = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, to_uint8(img.astype(np.float32))
                                  [::-1])


# every traversal backend and alpha_test, against the JAX package with
# the same settings (tests/test_torch_alpha.py renders real cutouts)
BACKENDS = {
    "alpha_test": dict(alpha_test=True),
    "brute": dict(traversal="brute"),
    "gather": dict(traversal="gather"),
    "auto_small": dict(brute_max_tris=4096),  # auto picks brute
    "cluster": dict(traversal="cluster"),
    "sweep": dict(traversal="sweep"),
}


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_render_backend_matches_jax(scenes, name):
    js, ts = scenes
    settings = RenderSettings(bounces=3, **BACKENDS[name])
    jset = JSettings(bounces=3, **BACKENDS[name])
    t_img = render_sample(ts, make_camera(**POSE),
                          LightParams.from_settings(settings), 0,
                          width=W, height=H, settings=settings)
    j_img = j_render(js, j_camera(**POSE), JLights.from_settings(jset),
                     jnp.uint32(0), width=W, height=H, settings=jset)
    compare_images(t_img.numpy(), j_img)
    assert 0.05 < float(t_img.mean()) < 1.2


# the options that were refused before they were ported; each renders
# as the JAX package does (tests/test_torch_pbr.py, test_torch_debug.py
# and test_torch_soft_edges.py cover them in depth)
OPTIONS = {
    "debug": (dict(render_mode=RenderMode.DEBUG),
              dict(render_mode=JRenderMode.DEBUG)),
    "pbr": (dict(shading="pbr"), dict(shading="pbr")),
    "soft_edges": (dict(soft_edges=0.05), dict(soft_edges=0.05)),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_formerly_unported_option_matches_jax(scenes, name):
    js, ts = scenes
    t_kw, j_kw = OPTIONS[name]
    settings = RenderSettings(bounces=2, **t_kw)
    jset = JSettings(bounces=2, **j_kw)
    t_img = render_sample(ts, make_camera(**POSE),
                          LightParams.from_settings(settings), 0, width=W,
                          height=H, settings=settings)
    j_img = j_render(js, j_camera(**POSE), JLights.from_settings(jset),
                     jnp.uint32(0), width=W, height=H, settings=jset)
    compare_images(t_img.detach().numpy(), j_img)
