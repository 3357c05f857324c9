"""The port's traversal backends against the JAX package on the same
inputs: brute force, the lockstep cluster walk, the gather walk of the
scene BVH (with and without alpha_test), the base-threading kernel's
twin against the Pallas one-hot kernel in interpret mode, the sweep
twin's work counters, and the roofline arithmetic. The CUDA kernels
themselves are held against their twins on the card by chip_smoke.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.accel.cluster import build_cluster_bvh
from dustraytracer_tpu.ops.traverse import traverse_anyhit as j_anyhit
from dustraytracer_tpu.ops.traverse import traverse_closest as j_closest
from dustraytracer_tpu.ops.traverse_brute import traverse_brute as j_brute
from dustraytracer_tpu.ops.traverse_cluster import (
    traverse_cluster as j_cluster)
from dustraytracer_tpu.ops.traverse_pallas import (
    traverse_cluster_pallas as j_pallas)
from dustraytracer_tpu.scene.scene import build_scene
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.ops import traverse as tg
from dustraytracer_tpu_torch.ops import traverse_pallas as tp
from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.ops.traverse_brute import traverse_brute
from dustraytracer_tpu_torch.ops.traverse_cluster import traverse_cluster
from dustraytracer_tpu_torch.render.integrator import (_make_tracers,
                                                       render_sample)
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils import roofline
from tests.util_scenes import make_random_tri_doc

T_RTOL = 1e-5  # tests/test_cluster.py:88-92


def _alpha_doc(n_tris, seed):
    """The random soup with a checker-alpha texture (texels of alpha 0
    and 255) on its material, so alpha_test rejects about half the
    candidate hits."""
    doc = make_random_tri_doc(n_tris, seed=seed)
    img = np.full((16, 16, 4), 180, np.uint8)
    yy, xx = np.mgrid[0:16, 0:16]
    img[..., 3] = np.where((yy // 4 + xx // 4) % 2, 255, 0)
    doc.materials[0].base_color_texture = 0
    return dataclasses.replace(doc, images=[img])


@pytest.fixture(scope="module")
def soup():
    """tests/test_cluster.py's soup: 700 triangles, clusters of K = 64,
    with an alpha texture for the gather walk's cutout."""
    scene = build_scene(_alpha_doc(700, seed=2), use_native=False)
    jcb = build_cluster_bvh(np.asarray(scene.tri_pos), k=64)
    tscene = interop.scene_from_numpy(interop.scene_to_numpy(scene))
    tcb = interop.cluster_from_numpy(interop.scene_to_numpy(jcb))
    return scene, jcb, tscene, tcb


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed_rays(n, seed):
    """Rays toward points of the soup's volume: most of them hit."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-5, 5, (n, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _t_max(kind, n, seed):
    if kind is None:
        return None, None
    if kind == "scalar":
        return 9.0, jnp.float32(9.0)
    lim = np.random.default_rng(seed).uniform(2.0, 20.0, n).astype(
        np.float32)
    return torch.from_numpy(lim), jnp.asarray(lim)


def _same_hits(tr, jr):
    i_t, i_j = tr["hit_idx"].numpy(), np.asarray(jr["hit_idx"])
    assert tr["hit_idx"].dtype == torch.int32
    np.testing.assert_array_equal(i_t, i_j)
    m = i_j >= 0
    np.testing.assert_allclose(tr["t"].numpy()[m], np.asarray(jr["t"])[m],
                               rtol=T_RTOL)
    return m


@pytest.mark.parametrize("t_max", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_brute_matches_jax(soup, anyhit, t_max):
    _, jcb, _, tcb = soup
    o, d = _aimed_rays(999, 5)  # 999: deliberately not a tile multiple
    tl, jl = _t_max(t_max, 999, 6)
    jr = j_brute(jcb, jnp.asarray(o), jnp.asarray(d), anyhit=anyhit,
                 t_max=jl)
    tr = traverse_brute(tcb, torch.from_numpy(o), torch.from_numpy(d),
                        anyhit=anyhit, t_max=tl)
    m = _same_hits(tr, jr)
    assert 100 < m.sum() < 999
    np.testing.assert_array_equal(tr["t"].numpy()[~m],
                                  np.asarray(jr["t"])[~m])  # t_max
    assert (tr["visits"] == 1).all()


def test_brute_tiles_do_not_change_results(soup, monkeypatch):
    from dustraytracer_tpu_torch.ops import traverse_brute as tb

    _, _, _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _aimed_rays(300, 9))
    whole = traverse_brute(tcb, o, d)
    monkeypatch.setattr(tb, "ELEMS", 7 * tcb.n_clusters * tcb.k)  # 7 rays
    tiled = traverse_brute(tcb, o, d)
    for key in whole:
        assert torch.equal(whole[key], tiled[key]), key


@pytest.mark.parametrize("t_max", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_cluster_walk_matches_jax(soup, anyhit, t_max):
    _, jcb, _, tcb = soup
    # JAX's walk broadcasts an (N,) t_max onto its 512-ray tile, so the
    # per-ray case runs one full tile; the others run 999 rays
    n = 512 if t_max == "per_ray" else 999
    o, d = _aimed_rays(n, 7)
    tl, jl = _t_max(t_max, n, 8)
    jr = j_cluster(jcb, jnp.asarray(o), jnp.asarray(d), anyhit=anyhit,
                   t_max=jl)
    tr = traverse_cluster(tcb, torch.from_numpy(o), torch.from_numpy(d),
                          anyhit=anyhit, t_max=tl)
    m = _same_hits(tr, jr)
    assert 50 < m.sum() < n
    np.testing.assert_array_equal(tr["visits"].numpy(),
                                  np.asarray(jr["visits"]))


def test_cluster_walk_random_rays(soup):
    _, jcb, _, tcb = soup
    o, d = _rays(999, 7)  # tests/test_cluster.py's rays
    jr = j_cluster(jcb, jnp.asarray(o), jnp.asarray(d))
    tr = traverse_cluster(tcb, torch.from_numpy(o), torch.from_numpy(d))
    _same_hits(tr, jr)
    np.testing.assert_array_equal(tr["visits"].numpy(),
                                  np.asarray(jr["visits"]))


@pytest.mark.parametrize("alpha_test", [False, True])
def test_gather_closest_matches_jax(soup, alpha_test):
    scene, _, tscene, _ = soup
    o, d = _aimed_rays(999, 11)
    jr = j_closest(scene, jnp.asarray(o), jnp.asarray(d),
                   alpha_test=alpha_test)
    tr = tg.traverse_closest(tscene, torch.from_numpy(o),
                             torch.from_numpy(d), alpha_test=alpha_test)
    m = _same_hits(tr, jr)
    assert 100 < m.sum() < 999
    np.testing.assert_array_equal(tr["visits"].numpy(),
                                  np.asarray(jr["visits"]))


def test_gather_alpha_cuts_out(soup):
    _, _, tscene, _ = soup
    o, d = (torch.from_numpy(x) for x in _aimed_rays(999, 11))
    full = tg.traverse_closest(tscene, o, d)
    cut = tg.traverse_closest(tscene, o, d, alpha_test=True)
    changed = full["hit_idx"] != cut["hit_idx"]
    assert changed.sum() > 50
    # a cutout only lets a ray through to something farther, or nothing
    later = cut["t"][changed] > full["t"][changed]
    assert later.all()


@pytest.mark.parametrize("t_max", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("alpha_test", [False, True])
def test_gather_anyhit_matches_jax(soup, alpha_test, t_max):
    scene, _, tscene, _ = soup
    o, d = _aimed_rays(999, 13)
    tl, jl = _t_max(t_max, 999, 14)
    occ_j = np.asarray(j_anyhit(scene, jnp.asarray(o), jnp.asarray(d),
                                alpha_test=alpha_test, t_max=jl))
    occ_t = tg.traverse_anyhit(tscene, torch.from_numpy(o),
                               torch.from_numpy(d), alpha_test=alpha_test,
                               t_max=tl)
    assert occ_t.dtype == torch.bool
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    assert occ_j.any() and not occ_j.all()


def test_alpha_anyhit_direct():
    """tests/test_alpha_and_golden.py::test_alpha_anyhit_direct in the
    port: a transparent texel does not occlude, an opaque one does."""
    from tests.util_scenes import make_tri_scene

    js = make_tri_scene()
    tex = np.zeros((1, 8, 8, 4), np.uint8)
    tex[..., :3] = 128
    tex[:, :, 4:, 3] = 255  # u >= 0.5 opaque
    js = js.replace(tex_stack=jnp.asarray(tex),
                    tex_hw=jnp.asarray([[8, 8]], np.int32),
                    tex_has_alpha=jnp.asarray([True]),
                    mat_albedo_tex=jnp.asarray([-1, 0], np.int32))
    scene = interop.scene_from_numpy(interop.scene_to_numpy(js))
    o = torch.tensor([[-0.5, 1.0, 2.0], [0.5, 1.0, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    assert tg.traverse_anyhit(scene, o, d, alpha_test=True).tolist() == \
        [False, True]
    assert tg.traverse_anyhit(scene, o, d).all()


@pytest.mark.parametrize("anyhit", [False, True])
def test_pallas_twin_matches_interpret(soup, anyhit):
    _, jcb, _, tcb = soup
    o, d = _aimed_rays(999, 15)
    jr = j_pallas(jcb, jnp.asarray(o), jnp.asarray(d), anyhit=anyhit,
                  interpret=True)
    launches = tp.LAUNCHES
    tr = tp.traverse_cluster_pallas(tcb, torch.from_numpy(o),
                                    torch.from_numpy(d), anyhit=anyhit)
    assert tp.LAUNCHES == launches  # CPU tensors run the twin
    m = _same_hits(tr, jr)
    assert 100 < m.sum() < 999
    assert not tr["visits"].any()
    assert tr["visits"].dtype == torch.int32


def test_pallas_twin_t_max_and_sweep_agree(soup):
    _, _, _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _aimed_rays(700, 17))
    k2 = tp.traverse_cluster_pallas(tcb, o, d)
    k1 = ts.traverse_cluster_sweep(tcb, o, d)
    assert torch.equal(k2["t"], k1["t"])  # same tests, another walk order
    tie = k2["hit_idx"] != k1["hit_idx"]
    assert tie.sum() <= 2
    lim = torch.where(k1["hit_idx"] >= 0, k1["t"] * 0.5, 3.4e38)
    cut = tp.traverse_cluster_pallas(tcb, o, d, t_max=lim)
    assert (cut["hit_idx"][k1["hit_idx"] >= 0] == -1).all()
    assert torch.equal(cut["t"], lim)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_pallas_wrapper_rejects_bad_input(soup, bad):
    _, _, _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _rays(64, 3))
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        o = o[:, :2].contiguous()
    else:
        o, d = o.to("meta"), d.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tp.traverse_cluster_pallas(tcb, o, d)


@pytest.mark.parametrize("anyhit", [False, True])
def test_sweep_counters_in_the_twin(soup, anyhit):
    _, _, _, tcb = soup
    o, d = _aimed_rays(999, 19)
    o[::7] = 3.0e37  # parked lanes, as the integrator parks dead rays
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    plain = ts.traverse_cluster_sweep(tcb, o, d, anyhit=anyhit)
    launches = ts.COUNT_LAUNCHES
    got = ts.traverse_cluster_sweep(tcb, o, d, anyhit=anyhit, counters=True)
    assert ts.COUNT_LAUNCHES == launches
    for key in ("hit_idx", "t", "visits"):
        assert torch.equal(got[key], plain[key]), key
    n_warps = -(-999 // 32)
    ew, el, lt = got["exec_windows"], got["exec_leafs"], got["leaf_tests"]
    assert ew.shape == el.shape == (n_warps,) and lt.shape == (999,)
    assert ew.dtype == el.dtype == lt.dtype == torch.int32
    vis = torch.cat([got["visits"], torch.zeros(n_warps * 32 - 999,
                                                dtype=torch.int32)])
    assert torch.equal(ew, vis.view(-1, 32).amax(dim=1))
    assert (el <= ew).all() and (el > 0).any()
    assert int(lt.sum()) <= 32 * int(el.sum())
    lts = torch.cat([lt, torch.zeros(n_warps * 32 - 999, dtype=torch.int32)])
    assert (lts.view(-1, 32).amax(dim=1) <= el).all()
    assert (lt <= got["visits"]).all()


def test_sweep_counters_and_emit_are_exclusive(soup):
    _, _, _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _rays(8, 1))
    with pytest.raises(ValueError, match="separate"):
        ts.traverse_cluster_sweep(tcb, o, d, counters=True, emit_attrs=True)


def test_roofline_prices_the_counted_work(soup):
    _, _, _, tcb = soup
    o, d = (torch.from_numpy(x) for x in _aimed_rays(256, 21))
    out = ts.traverse_cluster_sweep(tcb, o, d, counters=True)
    nodes, tris = ts.device_tables(tcb)
    tables = roofline.nbytes(nodes, tris)
    w = roofline.sweep_work(out, tcb.k, tables)
    nt, lt = int(out["visits"].sum()), int(out["leaf_tests"].sum())
    assert w["ops"] == 26 * nt + 57 * 64 * lt + 3 * 256
    assert w["bytes"] == 28 * 256 + 12 * 256 + 4 * 256 + 8 * 8 + tables
    assert 0.0 < w["useful_share"] <= 1.0
    assert w["leaf_lane_slots"] == 32 * int(out["exec_leafs"].sum())
    assert w["walk_useful_share"] == nt / (32 * int(
        out["exec_windows"].sum()))
    assert roofline.bound_seconds(67e12, 1.0) == (1.0, "operations")
    assert roofline.bound_seconds(1.0, 3.35e12) == (1.0, "bytes")


TINY = dict(width=8, height=6)


@pytest.mark.parametrize("case", ["no_tables", "emit_needs_sweep",
                                  "unknown"])
def test_tracer_choice_rejects(soup, case):
    _, _, tscene, _ = soup
    cam = make_camera(position=(0, 0, 14), look_at=(0, 0, 0), vfov_deg=50)
    if case == "no_tables":
        sc, st = tscene.replace(cluster=None), RenderSettings(
            traversal="brute")
    elif case == "emit_needs_sweep":
        sc, st = tscene, RenderSettings(traversal="cluster",
                                        shade_fetch="kernel")
    else:
        sc, st = tscene, RenderSettings(traversal="pallas")
    with pytest.raises(ValueError):
        render_sample(sc, cam, LightParams.from_settings(st), 0, **TINY,
                      settings=st)


def test_gather_walk_serves_scenes_without_tables(soup):
    _, _, tscene, _ = soup
    bare = tscene.replace(cluster=None)
    o, d = (torch.from_numpy(x) for x in _aimed_rays(64, 23))
    closest, anyhit = _make_tracers(bare, RenderSettings())
    want = tg.traverse_closest(bare, o, d)
    got = closest(o, d)
    assert torch.equal(got["hit_idx"], want["hit_idx"])
    assert torch.equal(anyhit(o, d), tg.traverse_anyhit(bare, o, d))
