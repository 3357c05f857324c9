"""Alpha cutout in the port against the JAX package: renders with
alpha_test through every backend (the re-trace on the cluster paths, the
in-walk test of the gather walk) on the synthetic sphere with a
checker-alpha quad, the alpha_rounds bound, the re-trace against the
gather walk ray by ray, and the render CLI's --alpha-test flag."""

import json
import subprocess
import sys
from pathlib import Path

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
from dustraytracer_tpu_torch.ops import traverse as tg
from dustraytracer_tpu_torch.render.integrator import (_make_tracers,
                                                       render_sample)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools.grad_bench import (POSE, SMALL_SPHERE,
                                                      sphere_doc)
from dustraytracer_tpu_torch.utils import profiling
from tests.util_torch import jax_doc

ROOT = Path(__file__).resolve().parent.parent
W, H = 48, 32
PIX_TOL = 2e-3   # the golden bound of tests/test_reference_parity.py
PIX_FRAC = 0.999
MIN_PSNR = 50.0


@pytest.fixture(scope="module")
def scenes():
    js = j_build(jax_doc(sphere_doc(*SMALL_SPHERE, cutout=True)),
                 use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


def _render(scenes, **kw):
    js, ts_ = scenes
    settings = RenderSettings(bounces=3, alpha_test=True, **kw)
    jset = JSettings(bounces=3, alpha_test=True, **kw)
    t_img = render_sample(ts_, make_camera(**POSE),
                          LightParams.from_settings(settings), 0, width=W,
                          height=H, settings=settings).numpy()
    j_img = np.asarray(j_render(js, j_camera(**POSE),
                                JLights.from_settings(jset), jnp.uint32(0),
                                width=W, height=H, settings=jset))
    return t_img, j_img


def _compare(a, b):
    diff = np.abs(a - b).max(axis=-1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    assert (diff <= PIX_TOL).mean() >= PIX_FRAC, diff.max()
    assert psnr > MIN_PSNR
    assert np.isfinite(a).all()


def test_cutout_scene():
    plain = sphere_doc(*SMALL_SPHERE)
    doc = sphere_doc(*SMALL_SPHERE, cutout=True)
    # the same sphere and ground from the same seed, plus the quad
    for (_, pa), (_, pb) in zip(plain.meshes, doc.meshes):
        np.testing.assert_array_equal(pa[0].positions, pb[0].positions)
    assert [name for name, _ in doc.meshes][-1] == "cutout"
    scene = build_scene(doc)
    assert scene.n_tris == 2 * 16 * 7 + 2 + 2
    assert scene.cluster.n_clusters * scene.cluster.k <= 512  # brute
    assert scene.tex_has_alpha.tolist() == [False, True]
    alpha = scene.tex_stack[1, :64, :64, 3]
    assert set(alpha.unique().tolist()) == {0, 255}


@pytest.mark.parametrize("traversal", ["auto", "cluster", "gather",
                                       "sweep"])
def test_alpha_render_matches_jax(scenes, traversal):
    t_img, j_img = _render(scenes, traversal=traversal)
    _compare(t_img, j_img)


def test_alpha_changes_the_image(scenes):
    _, scene = scenes
    cam = make_camera(**POSE)
    imgs = [render_sample(scene, cam, LightParams.from_settings(s), 0,
                          width=W, height=H, settings=s)
            for s in (RenderSettings(bounces=3),
                      RenderSettings(bounces=3, alpha_test=True))]
    changed = (imgs[0] - imgs[1]).abs().amax(dim=-1) > 0.05
    assert 0.02 < float(changed.float().mean()) < 0.5


def test_alpha_rounds_bound_matches_jax(scenes):
    """One round: a ray whose first hit is a transparent texel is left a
    miss, in both packages alike."""
    t1, j1 = _render(scenes, alpha_rounds=1)
    _compare(t1, j1)
    t8, _ = _render(scenes, alpha_rounds=8)
    assert (np.abs(t1 - t8).max(axis=-1) > 0.05).mean() > 0.02


@pytest.mark.parametrize("traversal", ["cluster", "sweep", "brute"])
def test_retrace_matches_the_gather_walk(scenes, traversal):
    """The cluster paths' re-trace finds what the gather walk's in-walk
    cutout finds, ray by ray, with t measured from the first origin."""
    _, scene = scenes
    rng = np.random.default_rng(4)
    n = 600
    o = np.tile(np.float32([0.0, 1.5, 5.0]), (n, 1))
    tgt = rng.uniform([-0.7, 0.4, 2.2], [0.7, 1.8, 2.2], (n, 3))
    d = torch.from_numpy((tgt - o).astype(np.float32))
    o = torch.from_numpy(o)
    closest, anyhit = _make_tracers(
        scene, RenderSettings(traversal=traversal, alpha_test=True))
    launches = profiling.counters("drt.launch.")
    got = closest(o, d)
    # the CPU runs the twins
    assert profiling.counters("drt.launch.") == launches
    want = tg.traverse_closest(scene, o, d, alpha_test=True)
    hit = want["hit_idx"] >= 0
    assert torch.equal(got["hit_idx"] >= 0, hit)
    assert float((got["hit_idx"] == want["hit_idx"]).float().mean()) > 0.99
    torch.testing.assert_close(got["t"][hit], want["t"][hit], rtol=1e-4,
                               atol=0.0)
    # about half the rays pass the quad's transparent texels
    quad = scene.n_tris - 2
    through = ~((want["hit_idx"] == quad) | (want["hit_idx"] == quad + 1))
    assert 0.3 < float(through.float().mean()) < 0.7
    assert torch.equal(anyhit(o, d), hit)
    assert (got["visits"] >= 1).all()


def test_cli_alpha_test_on_cpu(tmp_path):
    from chip_smoke import write_glb

    glb = tmp_path / "cutout.glb"
    write_glb(glb, sphere_doc(*SMALL_SPHERE, cutout=True))
    out = tmp_path / "img.png"
    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli", "render",
         "--scene", str(glb), "--size", "24x16", "--spp", "1", "--bounces",
         "2", "--camera-pos", "0,1.5,5", "--look-at", "0,0.5,0",
         "--alpha-test", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["triangles"] == 2 * 16 * 7 + 4
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
