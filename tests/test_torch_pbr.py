"""PBR shading in the port (emission, the metal lobe, glass) against the
JAX package on the CPU: the committed glass_panes golden regenerated by
the port, the glass cases of tests/test_glass.py, emissive and metallic
images, and the gradients of every material parameter with the kernel
and the gather fetch on the small PBR sphere."""

import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import render_pixels as j_render
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.gltf import (GltfDocument, GltfMaterial)
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.render.integrator import (_pbr_bounce,
                                                       render_pixels)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      glass_panes_doc,
                                                      sphere_doc)
from tests.util_scenes import make_glass_panes_scene, make_quad
from tests.util_torch import (assert_grad_close, compare_images, jax_doc,
                              jax_loss_grads, port_loss_grads, port_scene)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "glass_panes_exact.npz"
GLASS_POSE = dict(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
PBR = dict(bounces=3, shading="pbr", enable_tonemap=False,
           enable_gamma=False, enable_sunlight=False)
MAT_KEYS = ("mat_albedo", "mat_emissive", "mat_metallic", "mat_roughness",
            "mat_transmission", "mat_ior")
IMG_TOL = 1e-5  # linear radiance of the order of 1: float32 rounding


def glass_doc(transmission=1.0, ior=1.5, roughness=0.0, pane=True,
              metallic=0.0):
    """tests/test_glass.py's scene: a pane before an emissive red wall
    whose black albedo ends every path, so a pixel shows the wall's
    emission carried through whatever the pane does."""
    meshes = [("wall", [make_quad((0, 1, -3), 8, axis=2, mat=1)])]
    if pane:
        meshes.insert(0, ("pane", [make_quad((0, 1, -1), 4, axis=2,
                                             mat=0)]))
    return GltfDocument(
        meshes=meshes,
        materials=[
            GltfMaterial(name="glass", base_color=np.ones(3, np.float32),
                         roughness=roughness, transmission=transmission,
                         ior=ior, metallic=metallic),
            GltfMaterial(name="wall", base_color=np.zeros(3, np.float32),
                         emissive=np.array([4.5, 0.5, 0.5], np.float32),
                         roughness=1.0)],
        images=[], cameras=[])


def _both(doc):
    js = j_build(doc, use_native=False)
    return js, port_scene(js)


def _render_both(js, ts, kw, size=(24, 24), pose=GLASS_POSE, frame=0):
    w, h = size
    jset, tset = JSettings(**kw), RenderSettings(**kw)
    j_img = j_render(js, j_camera(**pose), JLights.from_settings(jset),
                     jnp.uint32(frame), jnp.arange(w * h, dtype=jnp.int32),
                     width=w, height=h, settings=jset)
    t_img = render_pixels(ts, make_camera(**pose),
                          LightParams.from_settings(tset), frame,
                          torch.arange(w * h), width=w, height=h,
                          settings=tset)
    return t_img.detach().numpy(), np.asarray(j_img)


def test_glass_panes_doc_matches_jax_scene():
    a = interop.scene_to_numpy(make_glass_panes_scene())
    b = interop.scene_to_numpy(build_scene(glass_panes_doc()))

    def same(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                same(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            assert x == y, path

    same(a, b, "scene")


def test_glass_panes_golden():
    """The port regenerates tests/goldens/glass_panes_exact.npz at
    tests/test_reference_parity.py::test_exact_golden's rule."""
    with np.load(GOLDEN) as z:
        golden = z["image"].astype(np.float32)
        meta = json.loads(str(z["meta"]))
    ts = build_scene(glass_panes_doc())
    settings = RenderSettings(bounces=meta["bounces"], **meta["overrides"])
    cam = make_camera(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in meta["camera"].items()})
    lights = LightParams.from_settings(settings)
    n = meta["size"]
    with torch.inference_mode():
        img = sum(render_pixels(ts, cam, lights, i, torch.arange(n * n),
                                width=n, height=n, settings=settings)
                  for i in range(meta["spp"])) / meta["spp"]
    img = img.reshape(n, n, 3).numpy()
    diff = np.abs(img - golden)
    assert diff.max() < 2e-3, diff.max()
    psnr = 10 * np.log10(1.0 / max(float(np.mean((img - golden) ** 2)),
                                   1e-12))
    assert psnr > 55.0, psnr


GLASS_CASES = {
    "ior_one": dict(transmission=1.0, ior=1.0),
    "opaque": dict(transmission=0.0),
    "refract": dict(transmission=1.0, ior=1.5),
    "partial": dict(transmission=0.7, ior=1.5),
    "frosted": dict(transmission=0.9, ior=1.5, roughness=0.3),
    "metal": dict(transmission=0.5, metallic=0.5, roughness=0.2),
    "no_pane": dict(pane=False),
}


@pytest.mark.parametrize("case", sorted(GLASS_CASES))
@pytest.mark.parametrize("sun", [False, True])
def test_glass_render_matches_jax(case, sun):
    js, ts = _both(glass_doc(**GLASS_CASES[case]))
    t_img, j_img = _render_both(js, ts, dict(PBR, enable_sunlight=sun),
                                frame=5)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=IMG_TOL)
    assert np.abs(t_img).max() > 0.1


@pytest.mark.parametrize("sun", [False, True])
def test_ior_one_glass_is_invisible(sun):
    """A clear pane of ior 1 bends and absorbs nothing, and NEE scaled by
    1 - transmission adds no sun on it: the render equals the paneless
    scene (tests/test_glass.py, both cases)."""
    kw = dict(PBR, enable_sunlight=sun)
    with_pane = _render_both(*_both(glass_doc(1.0, 1.0)), kw)[0]
    without = _render_both(*_both(glass_doc(pane=False)), kw)[0]
    np.testing.assert_allclose(with_pane, without, atol=1e-4)


def test_refraction_bends_rays():
    straight = _render_both(*_both(glass_doc(1.0, 1.0)), PBR)[0]
    bent = _render_both(*_both(glass_doc(1.0, 1.5)), PBR)[0]
    assert np.abs(bent - straight).max() > 1e-3


@pytest.mark.parametrize("key", ["mat_transmission", "mat_ior",
                                 "mat_metallic", "mat_roughness"])
def test_glass_gradients_match_jax(key):
    """d(mean image) reaches transmission and ior only through the
    w / w.detach() reweights and the refracted direction."""
    js, ts = _both(glass_doc(transmission=0.5, ior=1.5, metallic=0.3,
                             roughness=0.2))
    jv, jg = jax_loss_grads(js, GLASS_POSE, JSettings(**PBR), [key],
                            (16, 16))
    tv, tg = port_loss_grads(ts, GLASS_POSE, RenderSettings(**PBR), [key],
                             (16, 16))
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    assert np.isfinite(tg[key]).all() and abs(tg[key][0]) > 0.0
    assert_grad_close(tg[key], jg[key], key)


def test_metallic_gradient_at_zero_matches_jax():
    """With metallic 0 every lane's lobe weight 1 - metallic sits on its
    clip's upper bound, where jnp.clip's gradient is half (torch.clamp
    would pass all of it: twice JAX's gradient)."""
    js, ts = _both(glass_doc(transmission=0.5, ior=1.5, roughness=0.2))
    _, jg = jax_loss_grads(js, GLASS_POSE, JSettings(**PBR),
                           ["mat_metallic"], (16, 16))
    _, tg = port_loss_grads(ts, GLASS_POSE, RenderSettings(**PBR),
                            ["mat_metallic"], (16, 16))
    assert abs(jg["mat_metallic"][0]) > 0.0
    assert_grad_close(tg["mat_metallic"], jg["mat_metallic"], "metallic")


def test_metal_lane_transmission_gradient_unbiased():
    """A fully metallic pane never flips the glass coin, so its
    transmission gets a zero gradient, as in JAX."""
    js, ts = _both(glass_doc(transmission=0.5, ior=1.5, metallic=1.0))
    _, jg = jax_loss_grads(js, GLASS_POSE, JSettings(**PBR),
                           ["mat_transmission"], (16, 16))
    _, tg = port_loss_grads(ts, GLASS_POSE, RenderSettings(**PBR),
                            ["mat_transmission"], (16, 16))
    np.testing.assert_allclose(tg["mat_transmission"][0], 0.0, atol=1e-7)
    np.testing.assert_allclose(jg["mat_transmission"][0], 0.0, atol=1e-7)


def test_refraction_at_the_critical_angle_has_a_finite_gradient():
    """A glass lane whose k = 1 - eta^2 (1 - cos^2) rounds to exactly 0 (a
    ray leaving the glass at the critical angle, common in float32) takes
    no sqrt'(0) = inf into d/d(ior): its gradient stays finite, as the
    TIR lanes' does, and its direction is sqrt(max(k, 0))'s."""
    ior = torch.tensor([1.9690980911254883, 1.5], requires_grad=True)
    direction = torch.tensor([[0.5078462362289429, -0.8614465594291687,
                               -2.883442675738479e-07],
                              [0.3, -0.9, 0.1]])
    nrm = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    d_n = direction / torch.linalg.vector_norm(direction, dim=-1,
                                               keepdim=True)
    cos_in = -(d_n * nrm).sum(dim=-1)
    k = 1.0 - ior.detach() ** 2 * (1.0 - cos_in * cos_in)
    assert k[0] == 0.0 and k[1] > 0.0  # lane 0 sits on the boundary
    n = 2
    sh = {"normal": nrm, "front_face": torch.tensor([False, False]),
          "world_position": torch.zeros((n, 3))}
    matd = {"metallic": torch.zeros(n), "roughness": torch.zeros(n),
            "transmission": torch.ones(n), "ior": ior}
    for seed in range(8):  # both sides of the Fresnel coin
        rng = torch.full((n,), 12345 + 7919 * seed, dtype=torch.int64)
        out = _pbr_bounce(sh, matd, direction, torch.zeros((n, 3)),
                          nrm.clone(), torch.zeros((n, 3)),
                          torch.ones((n, 3)), torch.ones(n, dtype=bool),
                          rng)
        grad, = torch.autograd.grad((out[0].sum() + out[2].sum()), ior)
        assert torch.isfinite(grad).all(), (seed, grad)
    assert torch.isfinite(out[0]).all()


TRI_POSE = dict(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50.0)


@pytest.mark.parametrize("what", ["emissive", "metallic"])
def test_emissive_and_metallic_match_jax(tri_scene, what):
    """tests/test_pbr.py's scenes: a red emitter, and mirror metal."""
    ts = port_scene(tri_scene)
    if what == "emissive":
        over = {"mat_emissive": np.float32([[5.0, 0, 0], [0, 0, 0]])}
    else:
        over = {"mat_metallic": np.float32([1.0, 1.0]),
                "mat_roughness": np.float32([0.0, 0.0])}
    js = tri_scene.replace(**{k: jnp.asarray(v) for k, v in over.items()})
    ts = ts.replace(**{k: torch.from_numpy(v) for k, v in over.items()})
    kw = dict(bounces=2, enable_tonemap=False, enable_gamma=False)
    t_pbr, j_pbr = _render_both(js, ts, dict(kw, shading="pbr"),
                                size=(32, 32), pose=TRI_POSE)
    compare_images(t_pbr, j_pbr)
    t_ref, _ = _render_both(js, ts, kw, size=(32, 32), pose=TRI_POSE)
    if what == "emissive":  # emission shades in pbr only, mostly red
        gain = t_pbr.reshape(-1, 3) - t_ref.reshape(-1, 3)
        assert gain.mean() > 0 and gain[:, 0].sum() > gain[:, 1].sum()
    else:
        assert not np.array_equal(t_pbr, t_ref)


@pytest.fixture(scope="module")
def pbr_sphere():
    js = j_build(jax_doc(sphere_doc(*SMALL_SPHERE, pbr=True)),
                 use_native=False)
    return js, port_scene(js)


def _sphere_settings(cls, fetch):
    # bilinear texels give the camera position a gradient through the
    # ground's uv (point sampling is flat in it)
    return cls(bounces=2, shading="pbr", enable_tonemap=False,
               enable_gamma=False, traversal="sweep", shade_fetch=fetch,
               nee_cosine=True, tex_filter="bilinear")


@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_pbr_sphere_render_matches_jax(pbr_sphere, fetch):
    """The small PBR sphere (metal sphere, glass pane, emissive panel)
    through the sweep traversal, with the kernel fetch (front_face from
    the emitted normal) and the gather fetch, tonemapped."""
    js, ts = pbr_sphere
    kw = dict(bounces=3, shading="pbr", traversal="sweep",
              shade_fetch=fetch)
    t_img, j_img = _render_both(js, ts, kw, size=(32, 24), pose=POSE)
    compare_images(t_img, j_img)


_GRADS = {}


@pytest.fixture(scope="module")
def sphere_grads(pbr_sphere):
    names = list(MAT_KEYS) + ["tri_pos", "sun_intensity", "position"]

    def get(fetch):
        if fetch not in _GRADS:
            js, ts = pbr_sphere
            _GRADS[fetch] = (
                jax_loss_grads(js, POSE, _sphere_settings(JSettings, fetch),
                               names, (24, 24)),
                port_loss_grads(ts, POSE,
                                _sphere_settings(RenderSettings, fetch),
                                names, (24, 24)))
        return _GRADS[fetch]
    return get


@pytest.mark.parametrize("key", list(MAT_KEYS) + ["tri_pos",
                                                  "sun_intensity",
                                                  "position"])
@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_pbr_sphere_grads_match_jax(sphere_grads, fetch, key):
    (jv, jg), (tv, tg) = sphere_grads(fetch)
    assert abs(tv - jv) <= 1e-5 * abs(jv), (tv, jv)
    assert np.isfinite(tg[key]).all()
    assert np.abs(tg[key]).max() > 0.0, key
    assert_grad_close(tg[key], jg[key], key)
