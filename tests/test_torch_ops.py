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


def _sphere_xy_atol(z):
    """Per-element bound on the x, y of a unit-vector sample.

    r = sqrt(1 - z*z) is ill conditioned near the poles: one ulp of the
    cancelling 1 - z*z (an FMA contraction in XLA, say) moves r by about
    eps32 / (2 r). The bound allows 2 eps32 / r on top of the 1e-6 that
    covers sin/cos ulps; away from the poles it is 1e-6 plus ~2.4e-7."""
    eps = float(np.finfo(np.float32).eps)
    z = np.asarray(z, np.float64)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return 1e-6 + 2.0 * eps / np.maximum(r, eps)


def _assert_sphere_close(t, j, z):
    # x, y within the conditioning bound; z (and anything scaled by a
    # well-conditioned radius) within 1e-6
    err = np.abs(t[..., :2] - j[..., :2])
    bound = _sphere_xy_atol(z)[:, None]
    assert (err <= bound).all(), float((err - bound).max())
    np.testing.assert_allclose(t[..., 2], j[..., 2], atol=1e-6, rtol=0)


def test_samplers_match():
    # sin/cos/cbrt differ between XLA and torch by a few ulp: 1e-6
    # absolute on unit-scale samples, widened for x and y only where
    # sqrt(1 - z*z) amplifies an ulp (_sphere_xy_atol)
    ids = np.arange(N_IDS, dtype=np.int64)
    js = j_rng.seed_pixels(jnp.asarray(ids, jnp.uint32), jnp.uint32(3))
    ts = t_rng.seed_pixels(torch.from_numpy(ids), 3)
    js, jv = j_rng.random_unit_vec3(js)
    ts, tv = t_rng.random_unit_vec3(ts)
    jv = np.asarray(jv)
    _assert_sphere_close(tv.numpy(), jv, jv[:, 2])
    # the ball scales a unit vector drawn from the same stream state: that
    # vector's z gives the conditioning of the ball's x, y
    _, j_sphere = j_rng.random_unit_vec3(js)
    js, jb = j_rng.random_in_ball(js)
    ts, tb = t_rng.random_in_ball(ts)
    _assert_sphere_close(tb.numpy(), np.asarray(jb),
                         np.asarray(j_sphere)[:, 2])
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
