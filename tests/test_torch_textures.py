"""Learnable float texture stacks in the port (render/texture.py
decode_textures) against the JAX package on the CPU: the decoded stack,
float renders equal to u8 renders, texel gradients with point and
bilinear sampling, and alpha cutout read from a float stack."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import render_sample as j_render
from dustraytracer_tpu.render.texture import decode_textures as j_decode
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.render.texture import decode_textures
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import SMALL_SPHERE, sphere_doc
from tests.util_torch import (assert_grad_close, compare_images, jax_doc,
                              jax_loss_grads, port_loss_grads, port_scene,
                              two_material_doc)

W, H = 32, 24
POSE = dict(position=(0.0, 2.0, 12.0), look_at=(0.0, 0.0, 0.0),
            vfov_deg=50.0)
FILTERS = ("point", "bilinear")


@pytest.fixture(scope="module")
def scenes():
    """A soup split into a flat and a textured (8x8 texels) half."""
    js = j_build(two_material_doc(), use_native=False)
    return js, port_scene(js)


def _settings(cls, tex_filter, **kw):
    return cls(bounces=2, enable_tonemap=False, enable_gamma=False,
               tex_filter=tex_filter, **kw)


def _render(ts, tex_filter, **kw):
    s = _settings(RenderSettings, tex_filter, **kw)
    with torch.inference_mode():
        return render_sample(ts, make_camera(**POSE),
                             LightParams.from_settings(s), 0, width=W,
                             height=H, settings=s)


def test_decode_matches_jax(scenes):
    js, ts = scenes
    f = decode_textures(ts)
    assert f.tex_stack.dtype == torch.float32
    np.testing.assert_array_equal(f.tex_stack.numpy(),
                                  np.asarray(j_decode(js).tex_stack))
    assert decode_textures(f) is f  # a float stack stays as it is


@pytest.mark.parametrize("tex_filter", FILTERS)
def test_float_render_equals_u8(scenes, tex_filter):
    js, ts = scenes
    u8 = _render(ts, tex_filter)
    f = _render(decode_textures(ts), tex_filter)
    assert torch.equal(u8, f)
    s = _settings(JSettings, tex_filter)
    j = j_render(j_decode(js), j_camera(**POSE), JLights.from_settings(s),
                 jnp.uint32(0), width=W, height=H, settings=s)
    compare_images(f.numpy(), j)


@pytest.mark.parametrize("tex_filter", FILTERS)
def test_texel_grads_match_jax(scenes, tex_filter):
    js, ts = scenes
    jv, jg = jax_loss_grads(j_decode(js), POSE,
                            _settings(JSettings, tex_filter), ["tex_stack"],
                            (24, 24))
    tv, tg = port_loss_grads(decode_textures(ts), POSE,
                             _settings(RenderSettings, tex_filter),
                             ["tex_stack"], (24, 24))
    g = tg["tex_stack"]
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    assert np.isfinite(g).all() and np.abs(g[..., :3]).max() > 0.0
    assert not g[..., 3].any()  # alpha does not shade
    assert_grad_close(g, jg["tex_stack"], "tex_stack")


def test_alpha_cutout_reads_float_alpha():
    """_sample_alpha reads a float stack's alpha as it is (a u8 stack's
    / 255): the cutout renders the same from either stack."""
    doc = sphere_doc(*SMALL_SPHERE, cutout=True)
    js = j_build(jax_doc(doc), use_native=False)
    ts = port_scene(js)
    pose = dict(position=(0.0, 1.5, 5.0), look_at=(0.0, 0.5, 0.0),
                vfov_deg=45.0)
    s = RenderSettings(bounces=2, alpha_test=True)
    lights = LightParams.from_settings(s)
    with torch.inference_mode():
        u8, f, opaque = (
            render_sample(sc, make_camera(**pose), lights, 0, width=W,
                          height=H, settings=st)
            for sc, st in ((ts, s), (decode_textures(ts), s),
                           (decode_textures(ts),
                            dataclasses.replace(s, alpha_test=False))))
        assert torch.equal(u8, f)
        assert not torch.equal(f, opaque)
