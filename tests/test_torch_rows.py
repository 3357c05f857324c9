"""ops/rows.py (K4's twin and the kernel's summation plan) on the CPU: the
row fetch's gradient against the JAX package's one-hot transpose
(render/integrator.py::_onehot_rows) and against index_add_ in float64,
its repeatability, gradcheck, the forward against index_select, the plan
the CUDA kernel sums in, and the render's row fetches going through it.
The kernel itself runs on the card (tests_gpu/test_gpu_kernels.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import _onehot_rows
from dustraytracer_tpu_torch.ops import rows
from dustraytracer_tpu_torch.ops.rows import (gather_rows, plan, rows_grad,
                                              rows_grad_reference)

LANES = 4096
# (rows, columns): the material table, and triangle tables of the
# gather fetch (19 columns) and the smooth-normal fetch (28)
TABLES = [(2, 11), (300, 19), (300, 28)]


def _case(n_rows, cols, seed=0, dtype=np.float32):
    """A table, ids and a cotangent: 40% of the lanes on row 0 (the
    clamped miss lanes, one long run), the rest on every third row, so
    the other rows stay empty."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, cols)).astype(dtype)
    used = np.arange(0, n_rows, 3) if n_rows > 2 else np.arange(n_rows)
    idx = np.where(rng.uniform(size=LANES) < 0.4, 0,
                   rng.choice(used, LANES)).astype(np.int64)
    g = rng.normal(size=(LANES, cols)).astype(dtype)
    return table, idx, g


def _backward(table, idx, g):
    t = torch.from_numpy(table).requires_grad_(True)
    gather_rows(t, torch.from_numpy(idx)).backward(torch.from_numpy(g))
    return t.grad


@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_grad_matches_onehot_transpose(shape):
    # the gradient tolerance of the port's parity tests
    # (tests/test_sweep.py:277): atol 2e-4 max|g|, rtol 2e-3
    table, idx, g = _case(*shape)
    _, vjp = jax.vjp(lambda tab: _onehot_rows(jnp.asarray(idx, jnp.int32),
                                              tab), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    got = _backward(table, idx, g).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * np.abs(want).max())
    empty = np.setdiff1d(np.arange(shape[0]), idx)
    assert (got[empty] == 0.0).all()


@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_grad_matches_index_add_float64(shape):
    table, idx, g = _case(*shape, dtype=np.float64)
    got = _backward(table, idx, g).numpy()
    want = torch.zeros(shape, dtype=torch.float64).index_add_(
        0, torch.from_numpy(idx), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
    by_hand = np.zeros(shape)
    np.add.at(by_hand, idx, g)
    np.testing.assert_allclose(got, by_hand, rtol=0.0, atol=1e-12)


def test_backward_repeats_bit_for_bit():
    table, idx, g = _case(300, 19, seed=3)
    assert torch.equal(_backward(table, idx, g), _backward(table, idx, g))


def test_gradcheck_twin_float64():
    table, idx, _ = _case(7, 3, seed=1, dtype=np.float64)
    t = torch.from_numpy(table).requires_grad_(True)
    ids = torch.from_numpy(idx[:64])
    assert torch.autograd.gradcheck(lambda x: gather_rows(x, ids), (t,))


@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_forward_equals_index_select(shape):
    table, idx, _ = _case(*shape, seed=2)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert torch.equal(gather_rows(t, i.to(torch.int32)),
                       t.index_select(0, i))


@pytest.mark.parametrize("chunk", [rows.CHUNK, 7])
@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_plan_sums_every_lane_once(shape, chunk):
    """The CUDA kernel's order, replayed in float64 from the plan: each
    chunk's sorted lanes in order, then each row's chunks; every lane in
    exactly one chunk of its own row, at most `chunk` lanes a chunk, no
    more chunks than max_chunks."""
    table, idx, g = _case(*shape, seed=4, dtype=np.float64)
    n_rows = shape[0]
    perm, starts, off, max_chunks = (
        x.numpy() if torch.is_tensor(x) else x
        for x in plan(torch.from_numpy(idx), n_rows, chunk))
    assert off[-1] <= max_chunks
    seen = np.zeros(LANES, np.int64)
    out = np.zeros_like(table)
    for r in range(n_rows):
        run = perm[starts[r]:starts[r + 1]]
        assert (idx[run] == r).all() and (np.diff(run) > 0).all()
        n_chunks = off[r + 1] - off[r]
        assert n_chunks == -(-len(run) // chunk)
        partial = [g[run[j * chunk:(j + 1) * chunk]].sum(axis=0)
                   for j in range(n_chunks)]
        out[r] = np.sum(partial, axis=0) if partial else 0.0
        seen[run] += 1
    assert (seen == 1).all()
    want = rows_grad_reference(torch.from_numpy(g), torch.from_numpy(idx),
                               n_rows).numpy()
    np.testing.assert_allclose(out, want, rtol=0.0, atol=1e-12)


def test_rows_grad_rejects_bad_inputs():
    g = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int64"):
        rows_grad(g, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="int64"):
        rows_grad(g, torch.zeros(5, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="device"):
        rows_grad(torch.zeros(4, 3, device="meta"),
                  torch.zeros(4, dtype=torch.int64, device="meta"), 2)


def test_render_fetches_go_through_rows_grad(monkeypatch):
    """A gradient step with float texels: the material, triangle and
    texel tables each get their cotangents from rows_grad."""
    from dustraytracer_tpu_torch.render.texture import decode_textures
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.grad_bench import (POSE, grad_step,
                                                          sphere_doc)

    calls = []
    orig = rows.rows_grad

    def counted(grad, idx, n_rows):
        calls.append((n_rows, grad.shape[1]))
        return orig(grad, idx, n_rows)

    monkeypatch.setattr(rows, "rows_grad", counted)
    scene = decode_textures(build_scene(sphere_doc(8, 3)))
    scene = scene.replace(tex_stack=scene.tex_stack.requires_grad_(True))
    # 2 bounces: at 1 the image does not depend on the vertices
    settings = RenderSettings(bounces=2, enable_tonemap=False,
                              enable_gamma=False)
    _, grads = grad_step(scene, make_camera(**POSE), LightParams
                         .from_settings(settings), settings, 16, 16,
                         wrt=("mat_albedo", "tri_pos"))
    assert all(bool(torch.isfinite(v).all()) for v in grads.values())
    n_tex = scene.tex_stack.shape[0] * scene.tex_stack.shape[1] \
        * scene.tex_stack.shape[2]
    assert {(scene.mat_albedo.shape[0], 11), (scene.tri_pos.shape[0], 19),
            (n_tex, 4)} <= set(calls)
    assert scene.tex_stack.grad is not None \
        and float(scene.tex_stack.grad.abs().max()) > 0.0
