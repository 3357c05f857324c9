"""The rules the base-threading kernel (K2) must keep on exact t ties,
held on its twin (dustraytracer_tpu_torch.ops.traverse_pallas) against
the JAX one-hot Pallas kernel in interpret mode, at K = 8, 16, 32 and 64,
closest and any-hit.

Both walk the same base threading per ray, so unlike the sweep kernel
(tests/test_torch_sweep_ties.py) the hit ids must be equal everywhere:
a tie inside one cluster goes to the lowest id, a tie across two clusters
to the cluster the walk tests first, and an any-hit ray keeps the first
hit of its walk. chip_smoke.py's phase `kernel_ties_and_k` holds the CUDA
kernel against the twin on the same kind of soup, bit for bit."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dustraytracer_tpu.accel.cluster import build_cluster_bvh
from dustraytracer_tpu.ops.traverse_pallas import (
    traverse_cluster_pallas as j_pallas)
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import traverse_pallas as tp
from dustraytracer_tpu_torch.utils import profiling
from tests.util_scenes import make_random_tri_doc

T_RTOL = 1e-4  # tests/test_sweep.py:45-47
N_TRIS = 700
RAYS = 384  # per kind of ray; the interpret-mode walk is slow


@functools.lru_cache(maxsize=None)
def _soup_pos() -> np.ndarray:
    """The SAH-permuted (padded) triangles of the 700-triangle soup."""
    scene = build_scene(make_random_tri_doc(N_TRIS, seed=2), use_native=False)
    return np.asarray(scene.tri_pos)


@functools.lru_cache(maxsize=None)
def _tables(k: int):
    """(JAX ClusterBvh, port ClusterBvh, triangles, inside pairs, across
    pairs) at cluster size k. In every second cluster c, slot k-1 repeats
    slot 3 under its own id (a tie inside one leaf) and slot k-2 repeats
    slot 4 of cluster c+1 (a tie across two leaves), as chip_smoke.py's
    tie_soup does; pairs are (low id, high id)."""
    pos = _soup_pos().copy()
    inside, across = [], []
    for c in range(0, N_TRIS // k - 1, 2):
        base = c * k
        pos[base + k - 1] = pos[base + 3]
        inside.append((base + 3, base + k - 1))
        pos[base + k - 2] = pos[base + k + 4]
        across.append((base + k - 2, base + k + 4))
    jcb = build_cluster_bvh(pos, k=k)
    tcb = interop.cluster_from_numpy(interop.scene_to_numpy(jcb))
    return jcb, tcb, pos, np.array(inside), np.array(across)


def _aimed(pos, tris, seed):
    """Rays from uniform origins toward points inside the triangles
    `tris` (barycentric weights in [0.1, 0.45])."""
    rng = np.random.default_rng(seed)
    n = len(tris)
    a, b = (rng.uniform(0.1, 0.45, (n, 1)) for _ in range(2))
    v0, v1, v2 = pos[tris, 0], pos[tris, 1], pos[tris, 2]
    target = v0 + a * (v1 - v0) + b * (v2 - v0)
    o = rng.uniform(-12, 12, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _rays(k, pos, inside, across):
    """RAYS rays toward each kind of tied pair and RAYS toward any
    triangle."""
    rng = np.random.default_rng(50 + k)
    tris = np.concatenate([inside[rng.integers(0, len(inside), RAYS), 0],
                           across[rng.integers(0, len(across), RAYS), 1],
                           rng.integers(0, N_TRIS, RAYS)])
    return _aimed(pos, tris, 60 + k)


@pytest.mark.parametrize("mode", ["closest", "anyhit"])
@pytest.mark.parametrize("k", [8, 16, 32, 64])
def test_twin_keeps_the_pallas_tie_rules(k, mode):
    jcb, tcb, pos, inside, across = _tables(k)
    o, d = _rays(k, pos, inside, across)
    anyhit = mode == "anyhit"
    jr = j_pallas(jcb, jnp.asarray(o), jnp.asarray(d), anyhit=anyhit,
                  interpret=True)
    launches = profiling.counters("drt.launch.")
    tr = tp.traverse_cluster_pallas(tcb, torch.from_numpy(o),
                                    torch.from_numpy(d), anyhit=anyhit)
    # CPU tensors run the twin
    assert profiling.counters("drt.launch.") == launches
    hit = tr["hit_idx"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(jr["hit_idx"]))
    m = hit >= 0
    np.testing.assert_allclose(tr["t"].numpy()[m], np.asarray(jr["t"])[m],
                               rtol=T_RTOL)
    assert m.sum() > 2 * RAYS
    ins, acr = np.isin(hit, inside), np.isin(hit, across)
    if mode == "closest":
        # rays whose closest hit is a tied pair, inside one cluster and
        # across two; inside one cluster the low id always wins
        assert ins.sum() > RAYS // 2 and acr.sum() > RAYS // 2
        assert np.isin(hit[ins], inside[:, 0]).all()
    else:  # the first hits of the walks include tied triangles
        assert ins.sum() > 0 and acr.sum() > 0


def test_wrapper_rejects_clusters_of_no_triangle():
    import dataclasses

    tcb = _tables(16)[1]
    o, d = (torch.from_numpy(x) for x in _aimed(_soup_pos(), [0, 1], 3))
    launches = profiling.counters("drt.launch.")
    for fn in (tp.traverse_cluster_pallas, tp.traverse_cluster_pallas_global):
        with pytest.raises(ValueError, match="K = 0"):
            fn(dataclasses.replace(tcb, k=0), o, d)
    assert profiling.counters("drt.launch.") == launches


def test_global_instance_runs_the_twin_on_the_cpu():
    _, tcb, pos, inside, across = _tables(32)
    o, d = (torch.from_numpy(x) for x in _rays(32, pos, inside, across))
    for anyhit in (False, True):
        a = tp.traverse_cluster_pallas_global(tcb, o, d, anyhit=anyhit)
        b = tp.traverse_cluster_pallas_reference(tcb, o, d, anyhit=anyhit)
        for key in a:
            assert torch.equal(a[key], b[key]), key
