"""The port's device tuning tools (dustraytracer_tpu_torch/tools/:
profile_stages, bisect_segment, retune_fetch, bench_anyhit_sort,
bench_cluster_k, attr_sweep) on the CPU: the stages they time against
their JAX counterparts on the same numpy inputs, sorted and bare tracers
on the tools' waves, the cluster tables at each K against the JAX
package's build, the decision rules on hand-made rows, and the refusal
to measure without a card."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dustraytracer_tpu.ops.rng import (random_in_ball as j_ball,
                                       random_unit_vec3 as j_unit,
                                       seed_pixels as j_seed)
from dustraytracer_tpu.render import integrator as j_int
from dustraytracer_tpu.render.texture import decode_textures as j_decode
from dustraytracer_tpu.scene.camera import generate_rays as j_rays
from dustraytracer_tpu.scene.camera import make_camera as j_camera
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu.scene.settings import LightParams as JLights
from dustraytracer_tpu.scene.settings import RenderSettings as JSettings
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.scene.camera import make_camera
from dustraytracer_tpu_torch.scene.scene import build_scene as t_build
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.tools import (attr_sweep, bench_anyhit_sort,
                                           bench_cluster_k, bisect_segment,
                                           profile_stages, retune_fetch,
                                           tuning)
from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc
from tests.util_torch import jax_doc, port_scene

SIZE = 32
SPHERE = (24, 12)  # 530 triangles: past brute_max_tris, so the sweep


@pytest.fixture(scope="module")
def scenes():
    js = j_build(jax_doc(sphere_doc(*SPHERE)), use_native=False)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def hits(scenes):
    """Camera rays of the bench pose and hit ids (numpy): every fifth ray
    a miss, the rest spread over the triangles."""
    js, ts = scenes
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
    _, o, d = j_rays(j_camera(**POSE), SIZE, SIZE,
                     j_seed(ids.astype(jnp.uint32), jnp.uint32(0)),
                     pixel_ids=ids)
    rng = np.random.default_rng(7)
    hit = rng.integers(0, ts.n_tris, SIZE * SIZE).astype(np.int32)
    hit[::5] = -1
    return np.asarray(o), np.asarray(d), hit


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j_shade_sum(sc, o, d, hit):  # the JAX tool's sh_sum
    return sum(jnp.sum(v.astype(jnp.float32))
               for v in j_int.shade_hits(sc, o, d, hit, "gather").values())


def test_shade_hits_stage_matches_jax(scenes, hits):
    # recomputed Möller–Trumbore solutions, as test_torch_shading.py
    # holds shade_hits: rtol 1e-4
    js, ts = scenes
    o, d, hit = hits
    got = profile_stages.shade_sum(ts, *_t(o, d, hit))
    want = _j_shade_sum(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(hit))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_shade_hits_vjp_stage_matches_jax(scenes, hits):
    # the VJP of the recomputed solutions: test_torch_shading.py's rtol
    # 1e-4, with its atol 1e-4 taken relative to the largest entry
    js, ts = scenes
    o, d, hit = hits
    got = profile_stages.shade_vjp(ts, *_t(o, d, hit)).numpy()
    want = np.asarray(jax.grad(lambda tp: _j_shade_sum(
        dataclasses.replace(js, tri_pos=tp), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(hit)))(js.tri_pos))
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def fetch_inputs(scenes, hits):
    """Material ids and uvs of the hits (numpy), from JAX's shade_hits."""
    js, _ = scenes
    o, d, hit = hits
    sh = j_int.shade_hits(js, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(hit), "gather")
    return np.asarray(sh["material"]), np.asarray(sh["uv"])


def _j_fetch_sum(sc, mats, uv):
    return jnp.sum(j_int._albedo(
        sc, j_int._fetch_material(sc, jnp.asarray(mats), "gather"),
        jnp.asarray(uv)))


def test_fetch_stage_matches_jax(scenes, fetch_inputs):
    # test_torch_shading.py: the point-sampled texels and the material
    # rows are equal; their sums differ only in summation order: rtol 1e-6
    js, ts = scenes
    mats, uv = fetch_inputs
    got = profile_stages.fetch_sum(ts, *_t(mats, uv))
    np.testing.assert_allclose(float(got), float(_j_fetch_sum(js, mats, uv)),
                               rtol=1e-6)


@pytest.mark.parametrize("leaf", ["mat_albedo", "tex_stack"])
def test_fetch_vjp_stage_matches_jax(scenes, fetch_inputs, leaf):
    # the VJPs of a gather are counts of rays (sums of ones and of
    # ones times an albedo): equal, as test_torch_shading.py holds gathers
    js, ts = scenes
    mats, uv = fetch_inputs
    g_alb, g_tex = profile_stages.fetch_vjp(ts, *_t(mats, uv))
    got = {"mat_albedo": g_alb, "tex_stack": g_tex}[leaf].numpy()
    fs = j_decode(js)
    want = np.asarray(jax.grad(lambda x: _j_fetch_sum(
        dataclasses.replace(fs, **{leaf: x}), mats, uv))(getattr(fs, leaf)))
    assert np.abs(want).max() > 0.0
    np.testing.assert_array_equal(got, want)


def test_sort_permutation_matches_jax(scenes, hits):
    # integers: equal (test_torch_shading.py's ray_sort_key test)
    js, ts = scenes
    o, d, _ = hits
    got = tuning.sort_perm(ts, *_t(o, d)).numpy()
    key = j_int.ray_sort_key(js.node_min[0], js.node_max[0], jnp.asarray(o),
                             jnp.asarray(d))
    np.testing.assert_array_equal(got, np.asarray(jnp.argsort(key,
                                                              stable=True)))


def _j_prefix(js, stop):
    """The JAX tool tools/bisect_segment.py's upto(stop), eagerly."""
    settings = JSettings(bounces=1, enable_tonemap=False, enable_gamma=False)
    lights = JLights.from_settings(settings)
    fetch = j_int._resolve_fetch(js, settings)
    closest, anyhit = j_int._make_tracers(js, settings)
    n = SIZE * SIZE
    ids = jnp.arange(n, dtype=jnp.int32)
    acc = jnp.float32(0.0)
    rng = j_seed(ids.astype(jnp.uint32), jnp.uint32(0))
    rng, origin, direction = j_rays(j_camera(**POSE), SIZE, SIZE, rng,
                                    pixel_ids=ids)
    acc += jnp.sum(origin) + jnp.sum(direction)
    if stop == "raygen":
        return acc
    res = closest(origin, direction)
    hit_idx = res["hit_idx"]
    acc += jnp.sum(res["t"] * (res["t"] < 1e30)) + jnp.sum(hit_idx)
    if stop == "trace":
        return acc
    sh = j_int.shade_hits(js, origin, direction, hit_idx, fetch)
    acc += sum(jnp.sum(v.astype(jnp.float32)) for v in sh.values())
    if stop == "shade_hits":
        return acc
    matd = j_int._fetch_material(js, sh["material"], fetch)
    alb = j_int._albedo(js, matd, sh["uv"])
    throughput = jnp.where((hit_idx >= 0)[:, None], alb, 1.0)
    light = jnp.where((hit_idx < 0)[:, None],
                      j_int._sky(direction, lights) * lights.sky_intensity,
                      0.0)
    acc += jnp.sum(throughput) + jnp.sum(light)
    if stop == "albedo_sky":
        return acc
    new_origin = sh["world_position"] + sh["normal"] * 1e-3
    rng, jit_vec = j_unit(rng)
    shadow_dir = lights.sun_position()[None, :] + jit_vec * 1.5
    nee_o = jnp.where((hit_idx >= 0)[:, None], new_origin, 3.0e37)
    occ = anyhit(nee_o, shadow_dir)
    light = light + jnp.where(
        ((hit_idx >= 0) & ~occ)[:, None],
        (lights.sun_color * lights.sun_intensity)[None, :] * throughput, 0.0)
    acc += jnp.sum(light)
    if stop == "nee":
        return acc
    rng, ball = j_ball(rng)
    return acc + jnp.sum(sh["normal"] + ball)


@pytest.mark.parametrize("stop", bisect_segment.STOPS)
def test_bisect_prefix_matches_jax(scenes, stop):
    # a sum of thousands of recomputed solutions and traced t (rtol 1e-4
    # in test_torch_shading.py and tests/test_sweep.py): rtol 1e-4
    js, ts = scenes
    settings = RenderSettings(bounces=1, enable_tonemap=False,
                              enable_gamma=False)
    with torch.inference_mode():
        got = bisect_segment.prefix(ts, make_camera(**POSE),
                                    LightParams.from_settings(settings),
                                    settings, SIZE, stop)
    np.testing.assert_allclose(float(got), float(_j_prefix(js, stop)),
                               rtol=1e-4)


@pytest.mark.parametrize("emit", [False, True])
def test_sorted_and_bare_tracers_agree(scenes, emit):
    # bench_anyhit_sort's waves, traced bare and through _sorted_tracers:
    # every closest output and the NEE wave's occlusion equal bit for bit
    _, ts = scenes
    waves = tuning.pixel_waves(ts, make_camera(**POSE),
                               LightParams.from_settings(RenderSettings()),
                               SIZE)
    hit = bench_anyhit_sort.tracers(ts)[1](*waves["nee"])
    assert 0 < int(hit.sum()) < SIZE * SIZE  # some shadow rays occluded
    assert bench_anyhit_sort.sorted_equals_bare(ts, waves, emit) == {
        "primary": True, "bounce": True, "bounce2": True, "bounce3": True,
        "nee": True}


@pytest.mark.parametrize("k", [8, 16, 64, 128])
def test_cluster_k_tables_match_jax(k):
    # exact equality: both packages run the same numpy host build
    doc = sphere_doc(*SPHERE)
    want = interop.scene_to_numpy(j_build(jax_doc(doc), use_native=False,
                                          cluster_k=k))
    ts = t_build(doc, use_native=False, cluster_k=k)
    assert ts.cluster.k == k
    got = interop.scene_to_numpy(ts)

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], f"{path}{key}.")
            elif isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, path + key
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=path + key)
            else:
                assert a[key] == b[key], path + key

    walk(got, want)


def test_stand_ins_have_their_counts():
    for name, (n_lon, n_lat) in tuning.STAND_INS.items():
        tris = 2 * n_lon * (n_lat - 1) + 2
        assert abs(tris - float(name[:-1]) * 1e3) <= 0.02 * tris, name
    assert t_build(sphere_doc(*tuning.STAND_INS["16.1k"])).n_tris == 16130


# --- the rule, on hand-made rows --------------------------------------------

def _rounds(*vals, n=5):
    return {"wall_ms": list(vals) * n if len(vals) == 1 else list(vals),
            "device_ms": list(vals) * n if len(vals) == 1 else list(vals)}


@pytest.mark.parametrize("alt,cur,wins", [
    (_rounds(80.0), _rounds(100.0), True),            # 20% and apart
    (_rounds(95.0), _rounds(100.0), False),           # 5%: under MARGIN
    (_rounds(80.0, n=4), _rounds(100.0, n=4), False),  # 4 rounds
    (_rounds(70, 80, 80, 80, 101), _rounds(100, 100, 100, 100, 100),
     False),                                          # ranges overlap
    ({"wall_ms": [80.0] * 5, "device_ms": [99.0] * 5},
     _rounds(100.0), False),                          # device ms not
])
def test_beats(alt, cur, wins):
    assert tuning.beats(alt, cur)["wins"] is wins


def _fetch_rec(padded, kernel, gather):
    return {"scene": f"s{padded}", "padded_triangles": padded,
            "kernel": {"sample": _rounds(kernel), "step": _rounds(kernel)},
            "gather": {"sample": _rounds(gather), "step": _rounds(gather)}}


BAND = (12288, 16384)


@pytest.mark.parametrize("recs,band", [
    # gather wins by 20% inside the band and nothing wins outside: no band
    ([_fetch_rec(8000, 100, 100), _fetch_rec(12304, 120, 100),
      _fetch_rec(16144, 120, 100), _fetch_rec(24032, 100, 100)], None),
    # a wash inside the band: it stays
    ([_fetch_rec(12304, 100, 100), _fetch_rec(16144, 100, 105)], BAND),
    # the kernel wins just above the band too: the band grows to it
    ([_fetch_rec(16144, 100, 100), _fetch_rec(24032, 80, 100),
      _fetch_rec(32048, 100, 100)], (12288, 24032)),
    # no size inside the band measured: unchanged
    ([_fetch_rec(4000, 100, 100), _fetch_rec(64016, 100, 100)], BAND),
    # kernel picks that are not one run: unchanged
    ([_fetch_rec(4000, 80, 100), _fetch_rec(8000, 100, 100),
      _fetch_rec(12304, 100, 100)], BAND),
])
def test_new_fetch_band(recs, band):
    got = retune_fetch.new_band(recs, band=BAND)
    assert got["band"] == band
    assert got["changed"] is (band != BAND)


def _kinds(closest_sorted, closest_bare, any_sorted, any_bare):
    return {"scene": "s", "kinds": True, "closest_instance": "plain",
            "closest": {"sorted": _rounds(closest_sorted),
                        "bare": _rounds(closest_bare)},
            "anyhit": {"sorted": _rounds(any_sorted),
                       "bare": _rounds(any_bare)}}


@pytest.mark.parametrize("kinds,current,want", [
    ([_kinds(100, 150, 100, 60)], ("closest", "anyhit"), ("closest",)),
    ([_kinds(100, 150, 100, 60), _kinds(100, 150, 100, 95)],
     ("closest", "anyhit"), ("closest", "anyhit")),  # one scene: no
    ([_kinds(100, 150, 100, 100)], ("closest",), ("closest",)),
    ([_kinds(100, 150, 80, 100)], ("closest",), ("closest", "anyhit")),
])
def test_pick_sort(kinds, current, want):
    got = bench_anyhit_sort.pick_sort(kinds, current=current)
    assert got["sorted"] == want
    assert got["changed"] is (want != current)


def _k_rec(scene, ms, build):
    return {"scene": scene, "ks": {
        k: {"build_seconds": build[k], **_rounds(ms[k])} for k in ms}}


@pytest.mark.parametrize("recs,want", [
    # 64 wins by 20% on every scene and builds faster
    ([_k_rec(s, {16: 120, 32: 100, 64: 80}, {16: 2, 32: 1, 64: 0.7})
      for s in "abc"], 64),
    # 16 wins, but builds 2.5x slower
    ([_k_rec(s, {16: 80, 32: 100}, {16: 2.5, 32: 1}) for s in "abc"], 32),
    # 64 wins on two of three scenes
    ([_k_rec("a", {32: 100, 64: 80}, {32: 1, 64: 1}),
      _k_rec("b", {32: 100, 64: 80}, {32: 1, 64: 1}),
      _k_rec("c", {32: 100, 64: 95}, {32: 1, 64: 1})], 32),
])
def test_pick_cluster_k(recs, want):
    got = bench_cluster_k.pick_k(recs, current=32)
    assert got["k"] == want
    assert got["changed"] is (want != 32)


@pytest.mark.parametrize("tool", [profile_stages, bisect_segment,
                                  retune_fetch, bench_anyhit_sort,
                                  bench_cluster_k, attr_sweep])
def test_tool_needs_a_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    out = tmp_path / "rows.json"
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main(["--out", str(out)])
    assert not out.exists()
