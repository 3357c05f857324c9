"""The traversal twin (dustraytracer_tpu_torch.ops.traverse_sweep) against
the JAX min-sweep Pallas kernel in interpret mode, on the test_sweep.py
soup, plus the wrapper's input checks. The CUDA kernel itself is held
against the twin on the card by chip_smoke.py."""

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
from tests.util_scenes import make_random_tri_doc


@pytest.fixture(scope="module")
def soup():
    scene = build_scene(make_random_tri_doc(700, seed=2), use_native=False)
    jcb = build_cluster_bvh(np.asarray(scene.tri_pos), k=64)
    tcb = interop.cluster_from_numpy(interop.scene_to_numpy(jcb))
    return jcb, tcb


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed_rays(jcb, n, seed):
    """Rays toward jittered triangle vertices: about 40% of them hit."""
    rng = np.random.default_rng(seed)
    v0 = np.asarray(jcb.v0).reshape(-1, 3)
    v0 = v0[np.asarray(jcb.tri_idx).reshape(-1) >= 0]
    target = v0[rng.integers(0, len(v0), n)] + rng.normal(0, 0.2, (n, 3))
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _run(jcb, tcb, o, d, **kw):
    jr = j_sweep(jcb, jnp.asarray(o), jnp.asarray(d), interpret=True,
                 tile=512, **kw)
    t_max = kw.pop("t_max", None)
    tr = ts.traverse_cluster_sweep(tcb, torch.from_numpy(o),
                                   torch.from_numpy(d), t_max=t_max, **kw)
    return jr, tr


@pytest.mark.parametrize("rays", ["test_sweep", "aimed"])
def test_twin_closest_matches_pallas(soup, rays):
    launches = ts.LAUNCHES
    # 999: deliberately not a tile multiple
    o, d = _rays(999, 7) if rays == "test_sweep" else _aimed_rays(soup[0],
                                                                  999, 8)
    jr, tr = _run(*soup, o, d)
    i_j = np.asarray(jr["hit_idx"])
    i_t = tr["hit_idx"].numpy()
    assert tr["hit_idx"].dtype == torch.int32
    assert (i_j >= 0).sum() > (20 if rays == "test_sweep" else 300)
    np.testing.assert_array_equal(i_t, i_j)
    m = i_j >= 0
    # test_sweep.py's bound: t to rtol 1e-4 where hit
    np.testing.assert_allclose(tr["t"].numpy()[m], np.asarray(jr["t"])[m],
                               rtol=1e-4)
    assert (tr["visits"].numpy() >= 1).all()
    assert ts.LAUNCHES == launches  # CPU tensors never launch the kernel


@pytest.mark.parametrize("t_max", [None, 0.5])
def test_twin_anyhit_matches_pallas(soup, t_max):
    o, d = _rays(512, 11)
    kw = {} if t_max is None else {"t_max": jnp.float32(t_max)}
    jr, tr = _run(*soup, o, d, anyhit=True, **kw)
    occ = tr["hit_idx"].numpy() >= 0
    np.testing.assert_array_equal(occ, np.asarray(jr["hit_idx"]) >= 0)
    assert occ.any() and not occ.all()


def test_parked_lanes_miss(soup):
    o, d = _rays(300, 13)
    o[::3] = 3.0e37  # dead lanes, parked as the integrator parks them
    jr, tr = _run(*soup, o, d)
    hit = tr["hit_idx"].numpy()
    assert (hit[::3] == -1).all()
    assert (tr["visits"].numpy()[::3] == 1).all()  # root test only
    np.testing.assert_array_equal(hit, np.asarray(jr["hit_idx"]))


def test_per_ray_t_max(soup):
    _, tcb = soup
    o, d = _rays(400, 17)
    full = ts.traverse_cluster_sweep(tcb, torch.from_numpy(o),
                                     torch.from_numpy(d))
    lim = torch.where(full["hit_idx"] >= 0, full["t"] * 0.5,
                      torch.full_like(full["t"], 3.4e38))
    cut = ts.traverse_cluster_sweep(tcb, torch.from_numpy(o),
                                    torch.from_numpy(d), t_max=lim)
    # a hit beyond the ray's own t_max is dropped; t_max is not mutated
    assert (cut["t"] <= lim).all()
    assert torch.equal(lim, torch.where(full["hit_idx"] >= 0,
                                        full["t"] * 0.5, 3.4e38))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "mismatch",
                                 "t_max", "device"])
def test_wrapper_rejects_bad_input(soup, bad):
    _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _rays(64, 3))
    kw = {}
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        o = o[:, :2].contiguous()
    elif bad == "contiguous":
        d = torch.from_numpy(np.asfortranarray(d.numpy()))
    elif bad == "mismatch":
        d = d[:32]
    elif bad == "device":  # rays on another device than the tables
        o, d = o.to("meta"), d.to("meta")
    else:
        kw["t_max"] = torch.ones(5)
    launches = ts.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        ts.traverse_cluster_sweep(tcb, o, d, **kw)
    assert ts.LAUNCHES == launches
