"""The port's pure math (dustraytracer_tpu_torch.ops, scene.camera) against
the JAX package on identical inputs made with numpy."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.ops import intersect as j_isect
from dustraytracer_tpu.ops import rng as j_rng
from dustraytracer_tpu.ops import tonemap as j_tone
from dustraytracer_tpu.scene import camera as j_cam
from dustraytracer_tpu_torch.ops import intersect as t_isect
from dustraytracer_tpu_torch.ops import rng as t_rng
from dustraytracer_tpu_torch.ops import tonemap as t_tone
from dustraytracer_tpu_torch.scene import camera as t_cam

N_IDS = 100_000


def _words(x):
    return np.asarray(x).astype(np.uint64)


@pytest.mark.parametrize("frame", [0, 1, 7919])
def test_pcg_words_equal(frame):
    # integers: equal, word for word
    ids = np.arange(N_IDS, dtype=np.int64)
    js = j_rng.seed_pixels(jnp.asarray(ids, jnp.uint32), jnp.uint32(frame))
    ts = t_rng.seed_pixels(torch.from_numpy(ids), frame)
    np.testing.assert_array_equal(_words(js), ts.numpy().astype(np.uint64))
    for _ in range(3):
        js, ju = j_rng.random_float(js)
        ts, tu = t_rng.random_float(ts)
        np.testing.assert_array_equal(_words(js),
                                      ts.numpy().astype(np.uint64))
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_samplers_match():
    # sin/cos/cbrt differ between XLA and torch by a few ulp; 1e-6 absolute
    # on unit-scale samples covers that
    ids = np.arange(N_IDS, dtype=np.int64)
    js = j_rng.seed_pixels(jnp.asarray(ids, jnp.uint32), jnp.uint32(3))
    ts = t_rng.seed_pixels(torch.from_numpy(ids), 3)
    js, jv = j_rng.random_unit_vec3(js)
    ts, tv = t_rng.random_unit_vec3(ts)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    js, jb = j_rng.random_in_ball(js)
    ts, tb = t_rng.random_in_ball(ts)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=0)
    js, jd = j_rng.random_in_disk(js)
    ts, td = t_rng.random_in_disk(ts)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_words(js), ts.numpy().astype(np.uint64))


def test_tonemap_gamma():
    x = np.random.default_rng(0).uniform(0, 40, (4096, 3)).astype(np.float32)
    jt = np.asarray(j_tone.uncharted2_filmic(jnp.asarray(x), 2.0))
    tt = t_tone.uncharted2_filmic(torch.from_numpy(x), 2.0).numpy()
    np.testing.assert_allclose(tt, jt, atol=1e-6, rtol=0)
    jg = np.asarray(j_tone.gamma_correct(jnp.asarray(x - 1.0)))
    tg = t_tone.gamma_correct(torch.from_numpy(x - 1.0)).numpy()
    np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=0)


def _rays_and_tris(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    # aim at a jittered centroid so that about half the rays hit
    d = v.mean(axis=0) + rng.normal(0, 0.3, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:64, 0] = 0.0  # axis-parallel rays exercise the fmin/fmax NaN rule
    return o, d, v


def test_moller_trumbore():
    o, d, (v0, v1, v2) = _rays_and_tris(20_000, 1)
    jv, jt, ju, jw = map(np.asarray, j_isect.moller_trumbore(
        *map(jnp.asarray, (o, d, v0, v1, v2))))
    tv, tt, tu, tw = (x.numpy() for x in t_isect.moller_trumbore(
        *map(torch.from_numpy, (o, d, v0, v1, v2))))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 1000
    # 1e-5 relative: the 3-term dot products may round in another order
    for a, b in ((tt, jt), (tu, ju), (tw, jw)):
        np.testing.assert_allclose(a[jv], b[jv], rtol=1e-5, atol=1e-6)


def test_ray_aabb_entry():
    o, d, (v0, v1, _) = _rays_and_tris(20_000, 2)
    lo, hi = np.minimum(v0, v1), np.maximum(v0, v1)
    lo[:64, 0] = hi[:64, 0] = o[:64, 0]  # origin on a slab plane
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    jh, je = map(np.asarray, j_isect.ray_aabb_entry(
        *map(jnp.asarray, (o, inv, lo, hi))))
    th, te = (x.numpy() for x in t_isect.ray_aabb_entry(
        *map(torch.from_numpy, (o, inv, lo, hi))))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(te[jh], je[jh], rtol=1e-5, atol=0)


@pytest.mark.parametrize("defocus", [0.0, 2.5])
def test_generate_rays(defocus):
    kw = dict(position=(0.3, 1.5, 5.0), look_at=(0.0, 0.5, 0.0),
              vfov_deg=45.0, focus_dist=4.0, defocus_angle=defocus)
    w, h = 40, 24
    ids = np.arange(w * h, dtype=np.int64)
    js, jo, jd = j_cam.generate_rays(
        j_cam.make_camera(**kw), w, h,
        j_rng.seed_pixels(jnp.asarray(ids, jnp.uint32), jnp.uint32(1)))
    ts, to, td = t_cam.generate_rays(
        t_cam.make_camera(**kw), w, h,
        t_rng.seed_pixels(torch.from_numpy(ids), 1))
    np.testing.assert_array_equal(_words(js), ts.numpy().astype(np.uint64))
    # trig and norms differ by ulps between XLA and torch: 1e-5
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
