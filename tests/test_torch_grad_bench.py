"""The port's gradient-step measurement tool (tools/grad_bench.py) on the
CPU: the synthetic scene's size, the step's two fetches and its `wrt`
subset, and the refusal to measure without a card."""

import numpy as np
import pytest
import torch

from dustraytracer_tpu_torch.render.integrator import _resolve_fetch
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools import grad_bench


def test_smoke_sphere_lies_in_the_kernel_fetch_band():
    # chip_smoke.py relies on "auto" picking the kernel fetch on a card
    scene = build_scene(grad_bench.sphere_doc(*grad_bench.SMOKE_SPHERE))
    assert scene.n_tris == 2 * 128 * 63 + 2
    assert 12288 <= scene.tri_pos.shape[0] <= 16384
    assert _resolve_fetch(scene, RenderSettings()) == "gather"  # the CPU


@pytest.fixture(scope="module")
def small():
    scene = build_scene(grad_bench.sphere_doc(16, 8, seed=3))
    settings = RenderSettings(bounces=2, enable_tonemap=False,
                              enable_gamma=False, traversal="sweep")
    return (scene, make_camera(**grad_bench.POSE),
            LightParams.from_settings(settings), settings)


def test_grad_step_fetches_agree(small):
    scene, cam, lights, settings = small
    got = {f: grad_bench.grad_step(scene, cam, lights,
                                   settings.replace(shade_fetch=f), 16, 16)
           for f in ("kernel", "gather")}
    (lk, gk), (lg, gg) = got["kernel"], got["gather"]
    assert abs(float(lk) - float(lg)) <= 1e-5 * abs(float(lg))
    assert set(gk) == set(grad_bench.GRAD_PARAMS)
    for k in grad_bench.GRAD_PARAMS:
        assert torch.isfinite(gk[k]).all(), k
        scale = float(gg[k].abs().max())
        np.testing.assert_allclose(gk[k].numpy(), gg[k].numpy(), rtol=2e-3,
                                   atol=2e-4 * scale, err_msg=k)
    assert float(gk["tri_pos"].abs().max()) > 0.0


def test_grad_step_wrt_subset(small):
    scene, cam, lights, settings = small
    _, full = grad_bench.grad_step(scene, cam, lights, settings, 16, 16)
    _, sub = grad_bench.grad_step(scene, cam, lights, settings, 16, 16,
                                  wrt=("sky_color", "tri_pos"))
    assert set(sub) == {"sky_color", "tri_pos"}
    for k in sub:
        scale = float(full[k].abs().max())
        np.testing.assert_allclose(sub[k].numpy(), full[k].numpy(),
                                   rtol=2e-3, atol=2e-4 * scale, err_msg=k)


def test_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="is_available"):
        grad_bench.main([])
