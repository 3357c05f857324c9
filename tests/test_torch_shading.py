"""The port's per-hit stages (ray sort key, texture sampling, shade_hits,
material fetch, sky) against the JAX package on one scene."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render import integrator as j_int
from dustraytracer_tpu.render.texture import sample_texture as j_sample
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.render import integrator as t_int
from dustraytracer_tpu_torch.render.texture import sample_texture as t_sample
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from tests.util_scenes import make_random_tri_doc

N = 3000


@pytest.fixture(scope="module")
def scenes():
    doc = make_random_tri_doc(200, seed=8)
    rng = np.random.default_rng(4)
    prim = doc.meshes[0][1][0]
    prim.normals[:] = rng.normal(size=prim.normals.shape)
    imgs = [rng.integers(0, 256, (7, 9, 4), np.uint8),
            rng.integers(0, 256, (4, 3, 4), np.uint8)]
    doc.materials[0].base_color_texture = 1
    doc = dataclasses.replace(doc, images=imgs)
    js = j_build(doc, use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


def _rays(n, seed, park=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:park] = 3.0e37
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_ray_sort_key_equal(scenes):
    js, ts = scenes
    o, d = _rays(N, 1, park=50)
    jk = j_int.ray_sort_key(js.node_min[0], js.node_max[0], jnp.asarray(o),
                            jnp.asarray(d))
    tk = t_int.ray_sort_key(ts.node_min[0], ts.node_max[0],
                            torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))  # integers


@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_texture(scenes, bilinear):
    js, ts = scenes
    rng = np.random.default_rng(2)
    tex = rng.integers(0, 2, N).astype(np.int32)
    uv = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    uv[:20] = [[-1e-9, 1.0]]  # wrap edge cases
    jr = j_sample(js, jnp.asarray(tex), jnp.asarray(uv), bilinear=bilinear)
    tr = t_sample(ts, torch.from_numpy(tex), torch.from_numpy(uv),
                  bilinear=bilinear)
    if bilinear:  # blend weights round in another order: 1e-6
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    else:  # point sampling is a gather and one square: equal
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("smooth", [False, True])
def test_shade_hits_and_material(scenes, smooth):
    js, ts = scenes
    o, d = _rays(N, 3)
    rng = np.random.default_rng(5)
    hit = rng.integers(-1, ts.n_tris, N).astype(np.int32)
    jr = j_int.shade_hits(js, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(hit), "gather", smooth=smooth)
    tr = t_int.shade_hits(ts, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(hit), smooth=smooth)
    np.testing.assert_array_equal(tr["material"].numpy(),
                                  np.asarray(jr["material"]))
    np.testing.assert_array_equal(tr["front_face"].numpy(),
                                  np.asarray(jr["front_face"]))
    # recomputed Möller–Trumbore solutions of arbitrary ray/triangle
    # pairs: rounding order differs, t and u/v can be large -> rtol 1e-4
    for key in ("t", "bary", "world_position", "normal", "uv"):
        np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    jm = j_int._fetch_material(js, jr["material"], "gather")
    tm = t_int._fetch_material(ts, tr["material"])
    for key in jm:
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))


def test_sky(scenes):
    _, d = _rays(N, 6)
    jl = JLights.from_settings(JSettings(sky_color=(0.3, 0.1, 0.9)))
    tl = LightParams.from_settings(RenderSettings(sky_color=(0.3, 0.1, 0.9)))
    np.testing.assert_allclose(
        t_int._sky(torch.from_numpy(d), tl).numpy(),
        np.asarray(j_int._sky(jnp.asarray(d), jl)), atol=1e-6)
    np.testing.assert_allclose(tl.sun_position().numpy(),
                               np.asarray(jl.sun_position()), atol=1e-4)
