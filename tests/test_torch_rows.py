"""ops/rows.py (K4's twin, the plain plan the plan kernels must equal and
the plan-free instance's replay) on the CPU: the row fetch's gradient
against the JAX package's one-hot transpose
(render/integrator.py::_onehot_rows) and against index_add_ in float64,
its repeatability, gradcheck, the forward against index_select, the
plan's integers against numpy's stable argsort for int32 and int64 ids,
both instances' orders replayed in float64, a strided cotangent, and the
render's row fetches going through it. The kernels themselves run on the
card (tests_gpu/test_gpu_kernels.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.render.integrator import _onehot_rows
from dustraytracer_tpu_torch.ops import rows
from dustraytracer_tpu_torch.ops.rows import (gather_rows, plan, rows_grad,
                                              rows_grad_reference,
                                              rows_grad_small_replay,
                                              small_layout)

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


def _group_width(cols):
    """csrc/rows_grad.cu::group_width: the next power of two >= cols, at
    most 32."""
    w = 1
    while w < cols and w < 32:
        w *= 2
    return w


def _tree(parts, width):
    """The shuffle tree over the lane groups of one warp: parts[g] is
    group g's sum; shfl_down by 16, 8, ... down to the group width."""
    vals = list(parts)
    gw = 32 // width
    off = gw // 2
    while off >= 1:
        vals = [vals[g] + vals[g + off] if g + off < gw else vals[g]
                for g in range(gw)]
        off //= 2
    return vals[0]


@pytest.mark.parametrize("chunk", [rows.CHUNK, 7])
@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_plan_sums_every_lane_once(shape, chunk):
    """The planned instance's order, replayed in float64 from the plan:
    pass 1 sums each chunk's sorted lanes in order; pass 2 adds a row's
    chunks with group g of a 1,024-thread block on chunks g, g + G, ...,
    the shuffle tree over the groups of a warp, then the warps in order.
    Every lane lies in exactly one chunk of its own row, at most `chunk`
    lanes a chunk; the rows' chunk slots never overlap and lie below
    max_chunks."""
    table, idx, g = _case(*shape, seed=4, dtype=np.float64)
    n_rows, cols = shape
    perm, starts, first, max_chunks = (
        x.numpy() if torch.is_tensor(x) else x
        for x in plan(torch.from_numpy(idx), n_rows, chunk))
    width = _group_width(cols)
    groups = 1024 // width
    slot_owner = np.full(max_chunks, -1)
    seen = np.zeros(LANES, np.int64)
    out = np.zeros_like(table)
    for r in range(n_rows):
        run = perm[starts[r]:starts[r + 1]]
        assert (idx[run] == r).all() and (np.diff(run) > 0).all()
        n_chunks = -(-len(run) // chunk)
        assert first[r] == starts[r] // chunk + r
        slots = slot_owner[first[r]:first[r] + n_chunks]
        assert len(slots) == n_chunks and (slots == -1).all()
        slot_owner[first[r]:first[r] + n_chunks] = r
        partial = []
        for j in range(n_chunks):
            lanes = run[j * chunk:(j + 1) * chunk]
            acc = np.zeros(cols)
            for lane in lanes:
                acc = acc + g[lane]
            partial.append(acc)
            seen[lanes] += 1
        if n_chunks == 1:
            out[r] = partial[0]
        elif n_chunks > 1:
            parts = [np.sum(partial[k::groups], axis=0) if partial[k::groups]
                     else np.zeros(cols) for k in range(groups)]
            per_warp = 32 // width
            warps = [_tree(parts[w * per_warp:(w + 1) * per_warp], width)
                     for w in range(32)]
            out[r] = np.sum(warps, axis=0)
    assert (seen == 1).all()
    want = rows_grad_reference(torch.from_numpy(g), torch.from_numpy(idx),
                               n_rows).numpy()
    np.testing.assert_allclose(out, want, rtol=0.0, atol=1e-12)


def _edge_ids(kind, n_rows, n, rng):
    if kind == "spread":
        return rng.integers(0, n_rows, n)
    if kind == "one_row":
        return np.full(n, n_rows // 2)
    if kind == "last_row_only":
        return np.full(n, n_rows - 1)
    return np.where(rng.uniform(size=n) < 0.4, 0,
                    rng.integers(0, n_rows, n))  # "miss_heavy"


# (rows, columns, lanes, ids): the tests' tables, and the edge shapes: one
# row, all lanes on one row, every row empty but the last, fewer lanes
# than one sort tile (and than one chunk)
PLAN_CASES = [(2, 11, LANES, "miss_heavy"), (300, 19, LANES, "miss_heavy"),
              (300, 28, LANES, "spread"), (16130, 19, LANES, "miss_heavy"),
              (65536, 4, LANES, "spread"), (1, 19, LANES, "spread"),
              (300, 19, LANES, "one_row"), (300, 19, LANES, "last_row_only"),
              (300, 19, 100, "spread"), (70000, 4, 37, "spread")]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "%dx%d_n%d_%s" % c)
def test_plan_integers_match_stable_argsort(case):
    """perm and starts (what the plan kernels must equal on the card) are
    the same integers for int32 and int64 ids and equal numpy's stable
    argsort and searchsorted."""
    n_rows, _, n, kind = case
    idx = _edge_ids(kind, n_rows, n, np.random.default_rng(n_rows + n))
    p64 = plan(torch.from_numpy(idx.astype(np.int64)), n_rows)
    p32 = plan(torch.from_numpy(idx.astype(np.int32)), n_rows)
    for a, b in zip(p64, p32):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    perm, starts = p64[0].numpy(), p64[1].numpy()
    assert p64[0].dtype == torch.int32 and p64[1].dtype == torch.int32
    np.testing.assert_array_equal(perm, np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(
        starts, np.searchsorted(idx[perm], np.arange(n_rows + 1)))
    assert starts[0] == 0 and starts[-1] == n


SMALL_CASES = [(2, 11, LANES), (1, 4, LANES), (4, 16, LANES), (64, 1, 999),
               (2, 11, 5), (3, 7, 130), (1, 64, 300)]


@pytest.mark.parametrize("max_blocks", [rows.SMALL_MAX_BLOCKS, 3])
@pytest.mark.parametrize("case", SMALL_CASES, ids=lambda c: "%dx%d_n%d" % c)
def test_small_replay_sums_every_lane_once(case, max_blocks, monkeypatch):
    """The plan-free instance's order (fixed tiles, lanes in order, then
    tiles in order), replayed in float64: it counts every lane exactly once
    and equals index_add_. max_blocks 3 gives blocks of several tiles, as
    the card's 262,144 lanes do."""
    monkeypatch.setattr(rows, "SMALL_MAX_BLOCKS", max_blocks)
    n_rows, cols, n = case
    rng = np.random.default_rng(n + cols)
    idx = torch.from_numpy(rng.integers(0, n_rows, n))
    g = torch.from_numpy(rng.normal(size=(n, cols)))
    assert rows.is_small(n_rows, cols)
    got = rows_grad_small_replay(g, idx, n_rows)
    want = rows_grad_reference(g, idx, n_rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.0,
                               atol=1e-12)
    counts = rows_grad_small_replay(torch.ones(n, cols, dtype=torch.float64),
                                    idx, n_rows)
    assert torch.equal(counts, torch.bincount(idx, minlength=n_rows)
                       .double()[:, None].expand(n_rows, cols))
    per_block, blocks = small_layout(n)
    assert blocks <= max_blocks and per_block % rows.SMALL_TILE == 0
    assert (blocks - 1) * per_block < n <= blocks * per_block


def test_instance_choice_by_shape():
    """The plan-free instance takes the material table; the triangle,
    smooth-normal and texel tables take the planned one."""
    assert rows.is_small(2, 11)
    assert not any(rows.is_small(*s) for s in [(16130, 19), (300, 28),
                                               (65536, 4), (2, 33)])
    # the card's lane counts: fixed blocks of whole tiles
    assert small_layout(262_144) == (256, 1024)
    assert rows.max_multi(262_144, 16130) == 262_144 // 129


@pytest.mark.parametrize("shape", TABLES, ids=lambda s: "%dx%d" % s)
def test_strided_cotangent_equals_contiguous(shape):
    """A column slice of a wider cotangent (row stride past C) through
    rows_grad and through gather_rows' backward gives what its contiguous
    copy gives."""
    table, idx, _ = _case(*shape, seed=6)
    n_rows, cols = shape
    rng = np.random.default_rng(6)
    wide = torch.from_numpy(rng.normal(size=(LANES, cols + 5))
                            .astype(np.float32))
    sliced = wide[:, 2:2 + cols]
    assert not sliced.is_contiguous() and sliced.stride(0) == cols + 5
    ids = torch.from_numpy(idx)
    assert torch.equal(rows_grad(sliced, ids, n_rows),
                       rows_grad(sliced.contiguous(), ids, n_rows))
    t1 = torch.from_numpy(table).requires_grad_(True)
    t2 = torch.from_numpy(table).requires_grad_(True)
    gather_rows(t1, ids).backward(sliced)
    gather_rows(t2, ids).backward(sliced.contiguous())
    assert torch.equal(t1.grad, t2.grad)


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


def test_ab_rows_measures_in_turns(monkeypatch):
    """tools/ab_rows.py: its measuring source compiles, names every
    metric, and the sides run in the order other, this, this, other, then
    this, other, other, this, with each side's median, min and max."""
    import types

    from dustraytracer_tpu_torch.tools import ab_main_paths, ab_rows

    compile(ab_rows.CHILD, "ab_rows.CHILD", "exec")
    for case in ab_rows.CASES:
        assert f"{case}_kernels_ms" in ab_rows.METRICS
    monkeypatch.setattr(ab_main_paths.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(
                            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    seen = []

    def measure(tree):
        seen.append(tree == ab_main_paths.ROOT)
        return {m: float(len(seen)) for m in ab_rows.METRICS}

    res = ab_main_paths.in_turns("/nonexistent", measure, 2, ab_rows.METRICS)
    assert seen == [False, True, True, False, True, False, False, True]
    assert res["stats"]["this"]["step_rows_ms"] == {
        "median": 4.0, "min": 2.0, "max": 8.0}
    assert res["card"].startswith("NVIDIA") and len(res["runs"]) == 8
