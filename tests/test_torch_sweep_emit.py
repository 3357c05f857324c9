"""The traversal twin's emit mode (the in-kernel shading fetch) against
the JAX min-sweep Pallas kernel with emit_attrs in interpret mode, on the
inputs of tests/test_sweep.py, plus the packed attribute table the CUDA
kernel reads. The CUDA kernel itself is held against the twin on the
card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.ops.traverse_sweep import (
    traverse_cluster_sweep as j_sweep)
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.utils import profiling
from tests.util_scenes import make_random_tri_doc

EMIT_KEYS = ("u", "v", "uv", "face_nrm", "mat")


def _port_cluster(jscene):
    return interop.scene_from_numpy(interop.scene_to_numpy(jscene)).cluster


@pytest.fixture(scope="module")
def emit_case():
    """test_sweep.py:137-155: a 500-triangle soup, 700 rays aimed at it."""
    js = build_scene(make_random_tri_doc(500, seed=9), use_native=False)
    rng = np.random.default_rng(4)
    o = rng.uniform(-12, 12, (700, 3)).astype(np.float32)
    tgt = rng.uniform(-4, 4, (700, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jr = j_sweep(js.cluster, jnp.asarray(o), jnp.asarray(d), interpret=True,
                 tile=512, emit_attrs=True)
    tr = ts.traverse_cluster_sweep(_port_cluster(js), torch.from_numpy(o),
                                   torch.from_numpy(d), emit_attrs=True)
    return js, jr, tr


def test_emit_hits_and_materials_equal(emit_case):
    _, jr, tr = emit_case
    hit = np.asarray(jr["hit_idx"])
    assert (hit >= 0).sum() > 50
    np.testing.assert_array_equal(tr["hit_idx"].numpy(), hit)
    m = hit >= 0
    assert tr["mat"].dtype == torch.int32
    np.testing.assert_array_equal(tr["mat"].numpy()[m],
                                  np.asarray(jr["mat"])[m])


@pytest.mark.parametrize("key", ["u", "v", "uv"])
def test_emit_barycentrics_match_pallas(emit_case, key):
    # test_sweep.py:163-172's bound
    _, jr, tr = emit_case
    m = np.asarray(jr["hit_idx"]) >= 0
    np.testing.assert_allclose(tr[key].numpy()[m], np.asarray(jr[key])[m],
                               rtol=2e-3, atol=2e-4)


def test_emit_face_normal_matches_pallas(emit_case):
    # test_sweep.py:173-175's bound
    js, jr, tr = emit_case
    m = np.asarray(jr["hit_idx"]) >= 0
    np.testing.assert_allclose(tr["face_nrm"].numpy()[m],
                               np.asarray(jr["face_nrm"])[m],
                               rtol=1e-5, atol=1e-6)
    safe = np.maximum(np.asarray(jr["hit_idx"]), 0)
    np.testing.assert_allclose(tr["face_nrm"].numpy()[m],
                               np.asarray(js.tri_face_nrm)[safe][m],
                               rtol=1e-5, atol=1e-6)


def test_emit_misses_are_zero(emit_case):
    _, _, tr = emit_case
    miss = tr["hit_idx"].numpy() < 0
    assert miss.sum() > 50
    for key in EMIT_KEYS:
        assert (tr[key].numpy()[miss] == 0).all(), key


def test_emit_uv_is_the_winners_interpolation(emit_case):
    # uv = (1-u-v) uv0 + u uv1 + v uv2 of the hit triangle, as the twin
    # and the kernel compute it from the emitted u, v
    js, _, tr = emit_case
    hit = tr["hit_idx"].numpy()
    m = hit >= 0
    corners = np.asarray(js.tri_uv)[np.maximum(hit, 0)]
    u, v = tr["u"].numpy(), tr["v"].numpy()
    w = 1.0 - u - v
    ref = (w[:, None] * corners[:, 0] + u[:, None] * corners[:, 1]
           + v[:, None] * corners[:, 2])
    np.testing.assert_allclose(tr["uv"].numpy()[m], ref[m], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("anyhit", [False, True])
def test_emit_leaves_the_walk_unchanged(anyhit):
    """test_sweep.py:180-192: hit_idx, t and visits do not depend on
    emission."""
    js = build_scene(make_random_tri_doc(300, seed=2), use_native=False)
    tcb = _port_cluster(js)
    rng = np.random.default_rng(6)
    o = torch.from_numpy(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    plain = ts.traverse_cluster_sweep(tcb, o, d, anyhit=anyhit)
    emit = ts.traverse_cluster_sweep(tcb, o, d, anyhit=anyhit,
                                     emit_attrs=True)
    assert (plain["hit_idx"] >= 0).any()
    for key in ("hit_idx", "t", "visits"):
        assert torch.equal(plain[key], emit[key]), key
    assert set(EMIT_KEYS) <= set(emit) and not set(EMIT_KEYS) & set(plain)


def test_emit_without_attribute_tables_raises(emit_case):
    import dataclasses

    js, _, _ = emit_case
    bare = dataclasses.replace(_port_cluster(js), uv=None)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    launches = profiling.counters("drt.launch.")
    with pytest.raises(ValueError, match="emit_attrs requires"):
        ts.traverse_cluster_sweep(bare, o, d, emit_attrs=True)
    with pytest.raises(ValueError, match="emit_attrs requires"):
        ts.device_attr_table(bare)
    assert profiling.counters("drt.launch.") == launches


def test_attr_table_layout(emit_case):
    """The kernel's attribute rows: [uv0.xy uv1.xy] [uv2.xy fn.xy]
    [fn.z mat 0 0], mat bit for bit; packed once per device."""
    js, _, _ = emit_case
    cb = _port_cluster(js)
    tab = ts.device_attr_table(cb)
    c, k = cb.uv.shape[:2]
    assert tab.shape == (c, k, 3, 4) and tab.is_contiguous()
    assert ts.device_attr_table(cb) is tab
    assert torch.equal(tab[:, :, 0, 0:2], cb.uv[:, :, 0])
    assert torch.equal(tab[:, :, 0, 2:4], cb.uv[:, :, 1])
    assert torch.equal(tab[:, :, 1, 0:2], cb.uv[:, :, 2])
    assert torch.equal(tab[:, :, 1, 2:4], cb.face_nrm[..., 0:2])
    assert torch.equal(tab[:, :, 2, 0], cb.face_nrm[..., 2])
    assert torch.equal(tab.view(torch.int32)[:, :, 2, 1], cb.mat)
    assert (tab[:, :, 2, 2:4] == 0).all()
