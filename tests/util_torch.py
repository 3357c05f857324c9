"""Helpers of the port's parity tests: carry a document or scene across
from the JAX package, compare images and gradients at the tests'
tolerances, and differentiate the mean image in both packages."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import dustraytracer_tpu.scene.gltf as jgltf
from dustraytracer_tpu.render.integrator import render_pixels as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.gltf import GltfMaterial, GltfPrimitive
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.render.integrator import render_pixels
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import LightParams
from tests.util_scenes import make_random_tri_doc

# tests/test_reference_parity.py's golden bound: XLA and torch differ by
# ulps in sin/cos/cbrt, which can flip a grazing hit in a few pixels
PIX_TOL = 2e-3
PIX_FRAC = 0.999
MIN_PSNR = 50.0
LIGHT_KEYS = ("sun_azimuth", "sun_elevation", "sun_color", "sun_intensity",
              "sky_color", "sky_intensity")


def jax_doc(doc):
    """The port's GltfDocument as the JAX package's (same fields)."""
    def conv(obj, cls):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)})

    return jgltf.GltfDocument(
        meshes=[(name, [conv(p, jgltf.GltfPrimitive) for p in prims])
                for name, prims in doc.meshes],
        materials=[conv(m, jgltf.GltfMaterial) for m in doc.materials],
        images=list(doc.images), cameras=list(doc.cameras))


def two_material_doc(n_tris=400, seed=4):
    """A random soup split in two: a flat-albedo half and a half with a
    bilinear-sampled 8x8 texture, so the image is continuous in the
    camera position and still depends on mat_albedo."""
    doc = make_random_tri_doc(n_tris, seed=seed)
    prim = doc.meshes[0][1][0]
    half = n_tris // 2

    def part(sl, mat):
        return GltfPrimitive(positions=prim.positions[sl],
                             normals=prim.normals[sl], uvs=prim.uvs[sl],
                             material=mat)

    tex = np.random.default_rng(0).integers(0, 255, (8, 8, 4),
                                            dtype=np.uint8)
    tex[..., 3] = 255
    return dataclasses.replace(
        doc, meshes=[("flat", [part(slice(0, half), 0)]),
                     ("textured", [part(slice(half, None), 1)])],
        materials=[GltfMaterial(name="flat", base_color=np.float32(
            [0.7, 0.5, 0.3])), GltfMaterial(name="tex",
                                            base_color_texture=0)],
        images=[tex])


def port_scene(js):
    """The JAX scene's tables as the port's Scene on the CPU."""
    return interop.scene_from_numpy(interop.scene_to_numpy(js))


def compare_images(t_img, j_img, tol=PIX_TOL, frac=PIX_FRAC,
                   min_psnr=MIN_PSNR):
    """At least `frac` of the pixels within `tol`, PSNR above `min_psnr`,
    all finite; returns the largest difference."""
    a, b = np.asarray(t_img), np.asarray(j_img)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    diff = np.abs(a - b).max(axis=-1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    print(f"pixels over {tol}: {int((diff > tol).sum())} of {diff.size}; "
          f"max {diff.max():.3g}; PSNR {psnr:.1f} dB")
    assert (diff <= tol).mean() >= frac
    assert psnr > min_psnr
    return float(diff.max())


def assert_grad_close(g_port, g_jax, name=""):
    """tests/test_sweep.py:277's bound: rtol 2e-3, atol 2e-4 max|g|."""
    scale = float(np.abs(g_jax).max())
    np.testing.assert_allclose(g_port, g_jax, rtol=2e-3, atol=2e-4 * scale,
                               err_msg=name)


def jax_loss_grads(js, pose, settings, names, size, frame=0):
    """Mean image of one JAX sample and its gradient with respect to
    `names`: Scene fields, "position" (the camera) and LightParams
    fields."""
    w, h = size
    cam = j_camera(**pose)
    base = JLights.from_settings(settings)
    ids = jnp.arange(w * h, dtype=jnp.int32)

    def loss(p):
        sc = js.replace(**{k: v for k, v in p.items()
                           if k not in LIGHT_KEYS and k != "position"})
        c = cam.replace(position=p["position"]) if "position" in p else cam
        li = JLights(*[p.get(k, getattr(base, k)) for k in LIGHT_KEYS])
        img = j_render(sc, c, li, jnp.uint32(frame), ids, width=w, height=h,
                       settings=settings)
        return jnp.mean(img)

    params = {k: (cam.position if k == "position" else getattr(
        base, k) if k in LIGHT_KEYS else getattr(js, k)) for k in names}
    val, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), {k: np.asarray(v) for k, v in g.items()}


def port_loss_grads(ts, pose, settings, names, size, frame=0):
    """The port's counterpart of jax_loss_grads on the CPU; a leaf the
    image does not reach gets zeros, as in JAX."""
    w, h = size
    cam = make_camera(**pose)
    lights = LightParams.from_settings(settings)
    leaves = {k: (cam.position if k == "position" else getattr(
        lights, k) if k in LIGHT_KEYS else getattr(ts, k))
        .detach().clone().requires_grad_(True) for k in names}
    sc = ts.replace(**{k: v for k, v in leaves.items()
                       if k not in LIGHT_KEYS and k != "position"})
    c = cam.replace(position=leaves["position"]) if "position" in leaves \
        else cam
    li = lights.replace(**{k: v for k, v in leaves.items()
                           if k in LIGHT_KEYS})
    img = render_pixels(sc, c, li, frame, torch.arange(w * h), width=w,
                        height=h, settings=settings)
    loss = img.mean()
    loss.backward()
    return float(loss.detach()), {
        k: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
        for k, v in leaves.items()}
