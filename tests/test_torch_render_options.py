"""The port's render options beside the default path (russian roulette,
cosine-weighted bounce, N·L on the sun, bilinear texels, smooth
shading, no sun, linear output) against the JAX package, and the ray
sort's invisibility."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import render_sample as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import traverse_sweep as ts_mod
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from tests.util_scenes import make_random_tri_doc

W, H = 32, 24
POSE = dict(position=(1.0, 3.0, 12.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=55.0)
PIX_TOL = 2e-3   # the golden bound of tests/test_reference_parity.py
PIX_FRAC = 0.999

OPTIONS = {
    "russian_roulette": dict(russian_roulette=True, rr_start_bounce=1),
    "cosine_weighted": dict(cosine_weighted=True),
    "nee_cosine": dict(nee_cosine=True),
    "bilinear": dict(tex_filter="bilinear"),
    "smooth_shading": dict(smooth_shading=True),
    "no_sun_linear": dict(enable_sunlight=False, enable_tonemap=False,
                          enable_gamma=False),
}


@pytest.fixture(scope="module")
def scenes():
    doc = make_random_tri_doc(640, seed=6)
    rng = np.random.default_rng(3)
    prim = doc.meshes[0][1][0]
    prim.normals[:] = rng.normal(size=prim.normals.shape)  # smooth shading
    img = rng.integers(0, 256, (8, 12, 4), np.uint8)
    doc.materials[0].base_color_texture = 0
    doc = dataclasses.replace(doc, images=[img])
    js = j_build(doc, use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_jax(scenes, name):
    js, ts = scenes
    opts = dict(bounces=3, **OPTIONS[name])
    settings, jset = RenderSettings(**opts), JSettings(**opts)
    t_img = render_sample(ts, make_camera(**POSE),
                          LightParams.from_settings(settings), 2,
                          width=W, height=H, settings=settings).numpy()
    j_img = np.asarray(j_render(js, j_camera(**POSE),
                                JLights.from_settings(jset), jnp.uint32(2),
                                width=W, height=H, settings=jset))
    diff = np.abs(t_img - j_img).max(axis=-1)
    print(f"{name}: pixels over {PIX_TOL}: {int((diff > PIX_TOL).sum())}")
    assert (diff <= PIX_TOL).mean() >= PIX_FRAC
    assert np.isfinite(t_img).all() and t_img.max() > 0.0


def test_ray_sort_is_invisible(scenes):
    _, ts = scenes
    imgs = []
    for sort in ("on", "off"):
        settings = RenderSettings(bounces=2, ray_sort=sort,
                                  traversal="sweep")
        imgs.append(render_sample(ts, make_camera(**POSE),
                                  LightParams.from_settings(settings), 0,
                                  width=W, height=H, settings=settings))
    # per-ray traversal results do not depend on the order: bit-equal
    assert torch.equal(imgs[0], imgs[1])
    assert ts_mod.LAUNCHES == 0
