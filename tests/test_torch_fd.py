"""The port's finite-difference checker (diff/fd.py) on its renders, as
tests/test_grad.py:41-80 runs the JAX package's: albedo, sun intensity
and sky colour on an all-interior view; and the checker itself against
the JAX package's fd_grad."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.diff.fd import fd_grad as j_fd_grad
from dustraytracer_tpu_torch.diff.fd import check_grads_vs_fd, fd_grad
from dustraytracer_tpu_torch.render.integrator import render_sample
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from tests.util_torch import port_scene

W = H = 16


@pytest.fixture(scope="module")
def setup(tri_scene):
    # straight down at the ground quad: every ray hits a triangle's
    # interior, far from its edges
    cam = make_camera(position=(0.2, 4.0, 0.3), forward=(0, -1, 0),
                      vfov_deg=25.0)
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False,
                       nee_cosine=True)
    return port_scene(tri_scene), cam, s, LightParams.from_settings(s)


def _mean(scene, cam, lights, s):
    return render_sample(scene, cam, lights, 0, width=W, height=H,
                         settings=s).mean()


def test_albedo_grads_match_fd(setup):
    scene, cam, s, lights = setup
    check_grads_vs_fd(
        lambda alb: _mean(scene.replace(mat_albedo=alb), cam, lights, s),
        scene.mat_albedo.numpy(), eps=5e-2, rtol=2e-2)


def test_sun_intensity_grad_matches_fd(setup):
    scene, cam, s, lights = setup
    ad, _ = check_grads_vs_fd(
        lambda x: _mean(scene, cam, lights.replace(
            sun_intensity=x.reshape(())), s),
        np.array([30.0]), eps=5e-1, rtol=2e-2)
    assert ad[0] > 0.0


def test_sky_color_grad_matches_fd(setup):
    scene, cam, s, lights = setup
    check_grads_vs_fd(
        lambda x: _mean(scene, cam, lights.replace(sky_color=x), s),
        np.array([0.2, 0.4, 1.0]), eps=2e-2, rtol=2e-2)


def test_fd_grad_matches_jax():
    def f_t(x):
        return (torch.sin(x) * x.flip(0)).sum()

    def f_j(x):
        return jnp.sum(jnp.sin(x) * x[::-1])

    x = np.array([0.3, -1.2, 2.0], np.float32)
    # an ulp of f between torch's and XLA's sin is 1e-5 after / 2 eps
    np.testing.assert_allclose(fd_grad(f_t, x, 1e-2),
                               j_fd_grad(f_j, x, 1e-2), rtol=0, atol=1e-4)


def test_check_raises_on_a_wrong_gradient():
    def f(x):  # autograd sees x, the value also 3 * x.detach()
        return (x + 3.0 * x.detach()).sum()

    with pytest.raises(AssertionError, match="AD/FD mismatch"):
        check_grads_vs_fd(f, np.ones(2), eps=1e-2)
