"""The rule the sweep kernel's leaf reduction must keep, held on the twin
(dustraytracer_tpu_torch.ops.traverse_sweep) against the JAX min-sweep
Pallas kernel in interpret mode: exact t ties inside one cluster go to
the lowest triangle id, and closest and any-hit agree at K = 8, 16 and 32
(tests/test_torch_traverse_sweep.py covers K = 64).

Ties across two clusters are left out here: which cluster a ray tests
first follows the walk order, and the JAX kernel walks the octant of a
ray tile's first ray where the port walks each ray's own octant, so the
two may keep different ids of a tied pair. chip_smoke.py's phase
`kernel_ties_and_k` holds the CUDA kernel against the twin on such ties
(same walk order, bit for bit)."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.accel.cluster import build_cluster_bvh
from dustraytracer_tpu.ops.traverse_sweep import (
    traverse_cluster_sweep as j_sweep)
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.utils import profiling
from tests.util_scenes import make_random_tri_doc

T_RTOL = 1e-4  # tests/test_sweep.py:45-47


@functools.lru_cache(maxsize=None)
def _soup_pos() -> np.ndarray:
    """The SAH-permuted (padded) triangles of the 700-triangle soup."""
    scene = build_scene(make_random_tri_doc(700, seed=2), use_native=False)
    return np.asarray(scene.tri_pos)


@functools.lru_cache(maxsize=None)
def _tables(k: int, ties: bool = False):
    """(JAX ClusterBvh, port ClusterBvh, triangles, tied pairs) at
    cluster size k.
    With ties, in every second cluster c slot k-1 repeats slot 3 under
    its own id, so a ray that hits one of the pair sees both at the same
    t in the same leaf; pairs are (low id, high id)."""
    pos = _soup_pos().copy()
    pairs = []
    if ties:
        for c in range(0, 700 // k, 2):
            pos[c * k + k - 1] = pos[c * k + 3]
            pairs.append((c * k + 3, c * k + k - 1))
    jcb = build_cluster_bvh(pos, k=k)
    tcb = interop.cluster_from_numpy(interop.scene_to_numpy(jcb))
    return jcb, tcb, pos, np.array(pairs, dtype=np.int64).reshape(-1, 2)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


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


def _run(jcb, tcb, o, d, **kw):
    jr = j_sweep(jcb, jnp.asarray(o), jnp.asarray(d), interpret=True,
                 tile=512, **kw)
    tr = ts.traverse_cluster_sweep(tcb, torch.from_numpy(o),
                                   torch.from_numpy(d), **kw)
    return jr, tr


def test_ties_in_one_cluster_go_to_the_lowest_id():
    k = 16
    jcb, tcb, pos, pairs = _tables(k, ties=True)
    rng = np.random.default_rng(31)
    o, d = _aimed(pos, pairs[rng.integers(0, len(pairs), 600), 1], 32)
    jr, tr = _run(jcb, tcb, o, d)
    hit = tr["hit_idx"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(jr["hit_idx"]))
    m = hit >= 0
    np.testing.assert_allclose(tr["t"].numpy()[m], np.asarray(jr["t"])[m],
                               rtol=T_RTOL)
    tied = np.isin(hit, pairs)
    assert tied.sum() > 200  # rays whose closest hit is a tied pair
    assert np.isin(hit[tied], pairs[:, 0]).all()  # always its low id


@pytest.mark.parametrize("mode", ["closest", "anyhit"])
@pytest.mark.parametrize("k", [8, 16, 32])
def test_twin_matches_pallas_at_k(k, mode):
    jcb, tcb, pos, _ = _tables(k)
    launches = profiling.counters("drt.launch.")
    if mode == "closest":
        tris = np.random.default_rng(40 + k).integers(0, 700, 500)
        o, d = _aimed(pos, tris, 41 + k)
        o2, d2 = _rays(499, 42 + k)  # mostly misses; not a tile multiple
        o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
        jr, tr = _run(jcb, tcb, o, d)
        hit = tr["hit_idx"].numpy()
        np.testing.assert_array_equal(hit, np.asarray(jr["hit_idx"]))
        assert (hit >= 0).sum() > 400
        m = hit >= 0
        np.testing.assert_allclose(tr["t"].numpy()[m],
                                   np.asarray(jr["t"])[m], rtol=T_RTOL)
    else:  # the first hit follows the walk order; occlusion does not
        o, d = _rays(512, 43 + k)
        jr, tr = _run(jcb, tcb, o, d, anyhit=True)
        occ = tr["hit_idx"].numpy() >= 0
        np.testing.assert_array_equal(occ, np.asarray(jr["hit_idx"]) >= 0)
        assert occ.any() and not occ.all()
    # CPU tensors never launch the kernel
    assert profiling.counters("drt.launch.") == launches


@pytest.mark.parametrize("k", [0, ts.MAX_K + 1])
def test_wrapper_rejects_unsupported_k(k):
    tcb = _tables(16)[1]
    o, d = (torch.from_numpy(x) for x in _rays(64, 3))
    launches = profiling.counters("drt.launch.")
    with pytest.raises(ValueError, match="K ="):
        ts.traverse_cluster_sweep(dataclasses.replace(tcb, k=k), o, d)
    assert profiling.counters("drt.launch.") == launches
