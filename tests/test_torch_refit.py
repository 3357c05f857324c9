"""The port's live-vertex refit (accel/cluster.py refit_cluster_bvh,
accel/bvh.py refit_bvh_boxes) and Scene.replace's refit guard against
the JAX package, on perturbed vertices of a random soup."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.accel.bvh import refit_bvh_boxes as j_refit_boxes
from dustraytracer_tpu.accel.cluster import refit_cluster_bvh as j_refit
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.accel.bvh import refit_bvh_boxes
from dustraytracer_tpu_torch.accel.cluster import refit_cluster_bvh
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from tests.util_scenes import make_random_tri_doc

CLUSTER_KEYS = ("v0", "e1", "e2", "node_min", "node_max", "oct_min",
                "oct_max", "face_nrm")


@pytest.fixture(scope="module")
def scenes():
    js = build_scene(make_random_tri_doc(400, seed=3), use_native=False)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js))


def _perturbed(js, seed=0, scale=0.2):
    tp = np.asarray(js.tri_pos)
    noise = np.random.default_rng(seed).normal(0, scale, tp.shape)
    out = (tp + noise).astype(np.float32)
    out[js.n_tris:] = 0.0  # padding triangles stay degenerate
    return out


@pytest.mark.parametrize("key", CLUSTER_KEYS)
def test_refit_cluster_matches_jax(scenes, key):
    js, tsc = scenes
    tp = _perturbed(js)
    j_cb = j_refit(js.cluster, jnp.asarray(tp))
    t_cb = refit_cluster_bvh(tsc.cluster, torch.from_numpy(tp))
    np.testing.assert_allclose(getattr(t_cb, key).numpy(),
                               np.asarray(getattr(j_cb, key)), rtol=0,
                               atol=1e-6)


def test_refit_bvh_boxes_matches_jax(scenes):
    js, tsc = scenes
    tp = _perturbed(js, seed=1)
    kw = dict(levels=js.bvh_levels, n_tris=js.n_tris, n_nodes=js.n_nodes)
    jm, jx = j_refit_boxes(jnp.asarray(tp), js.node_min, js.node_max,
                           range_a=js.bvh_range_a, range_b=js.bvh_range_b,
                           **kw)
    tm, tx = refit_bvh_boxes(torch.from_numpy(tp), tsc.node_min,
                             tsc.node_max, range_a=tsc.bvh_range_a,
                             range_b=tsc.bvh_range_b, **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)


def test_refit_with_built_vertices_reproduces_tables(scenes):
    _, tsc = scenes
    cb = refit_cluster_bvh(tsc.cluster, tsc.tri_pos)
    for key in CLUSTER_KEYS:
        np.testing.assert_allclose(getattr(cb, key).numpy(),
                                   getattr(tsc.cluster, key).numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)
    for key in ("tri_idx", "uv", "mat", "oct_skip", "oct_cluster"):
        assert torch.equal(getattr(cb, key), getattr(tsc.cluster, key)), key
    nm, nx = refit_bvh_boxes(
        tsc.tri_pos, tsc.node_min, tsc.node_max, levels=tsc.bvh_levels,
        range_a=tsc.bvh_range_a, range_b=tsc.bvh_range_b, n_tris=tsc.n_tris,
        n_nodes=tsc.n_nodes)
    assert torch.equal(nm[:tsc.n_nodes], tsc.node_min[:tsc.n_nodes])
    assert torch.equal(nx[:tsc.n_nodes], tsc.node_max[:tsc.n_nodes])


def test_refit_takes_no_gradient(scenes):
    _, tsc = scenes
    tp = tsc.tri_pos.clone().requires_grad_(True)
    cb = refit_cluster_bvh(tsc.cluster, tp)
    assert not any(getattr(cb, k).requires_grad for k in CLUSTER_KEYS)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def test_replace_rebakes_and_drops_packed_tables(scenes):
    """The stale-table guard: tables packed for the old vertices are not
    reused, and the hits follow the new vertices."""
    _, tsc = scenes
    old_packed = ts.device_tables(tsc.cluster)
    ts.device_attr_table(tsc.cluster)
    shift = torch.tensor([0.0, 0.0, 0.75])
    tp = tsc.tri_pos.clone()
    tp[:tsc.n_tris] += shift
    moved = tsc.replace(tri_pos=tp)
    assert moved.cluster is not tsc.cluster
    assert moved.cluster.device_tables == {}
    assert tsc.cluster.device_tables  # the original keeps its own cache
    new_packed = ts.device_tables(moved.cluster)
    assert not torch.equal(new_packed[1], old_packed[1])
    assert torch.equal(new_packed[1][..., 0, :3], moved.cluster.v0)
    # rays shifted along with the geometry see the same hits at the same t
    o, d = _rays(600, 5)
    before = ts.traverse_cluster_sweep(tsc.cluster, o, d)
    after = ts.traverse_cluster_sweep(moved.cluster,
                                      (o + shift).contiguous(), d)
    assert (before["hit_idx"] >= 0).sum() > 50
    assert torch.equal(before["hit_idx"], after["hit_idx"])
    hit = before["hit_idx"] >= 0
    np.testing.assert_allclose(after["t"][hit].numpy(),
                               before["t"][hit].numpy(), rtol=1e-4)
    # and the threaded BVH's boxes moved too
    n = tsc.n_nodes
    np.testing.assert_allclose(moved.node_min[:n].numpy(),
                               (tsc.node_min[:n] + shift).numpy(),
                               rtol=0, atol=1e-5)


def test_replace_other_fields_keeps_tables(scenes):
    _, tsc = scenes
    sc = tsc.replace(mat_albedo=tsc.mat_albedo * 0.5)
    assert sc.cluster is tsc.cluster
    assert torch.equal(sc.node_min, tsc.node_min)


def test_replace_without_refit_plan_raises(scenes):
    _, tsc = scenes
    bare = dataclasses.replace(
        tsc, cluster=dataclasses.replace(tsc.cluster, refit_a=None,
                                         device_tables={}))
    with pytest.raises(ValueError, match="no refit plan"):
        bare.replace(tri_pos=tsc.tri_pos.clone())
    # an explicit cluster is taken as given
    sc = bare.replace(tri_pos=tsc.tri_pos.clone(), cluster=tsc.cluster)
    assert sc.cluster is tsc.cluster
