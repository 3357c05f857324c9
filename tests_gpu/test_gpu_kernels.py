"""The hand-written CUDA kernels against their PyTorch twins on the card,
bit for bit, on chip_smoke.py's seeded 2,048-triangle soup at K = 32 with
duplicated triangles (exact t ties inside a cluster and across two): K1
(csrc/traverse_sweep.cu) in its plain, any-hit, emit_attrs and counters
calls, K2 (csrc/traverse_pallas.cu) in both node-table instances, closest
and any-hit, K3 (csrc/add_salt.cu) through the build-cache tool's child,
and K4 (csrc/rows_grad.cu, the row fetch's backward) in both instances
against its twins at the bench step's shapes and at edge shapes, its
plan's integers against the plain plan's, two launches and a CUDA-graph
replay bit for bit, with no host sync; and the bench step
itself twice, loss and gradients bit for bit, with each shading fetch.
chip_smoke.py keeps its own checks (phases 3, 3t, 3p, 10, 27, 28)."""

import numpy as np
import pytest
import torch

from chip_smoke import (ROWS_CASES, ROWS_EDGE_CASES, TIE_CALLS,
                        check_rows_kernel, rows_inputs, tie_rays,
                        tie_soup)

pytestmark = pytest.mark.gpu
K = 32


@pytest.fixture(scope="module")
def soup():
    from dustraytracer_tpu_torch.accel.cluster import build_cluster_bvh

    pos, inside, across = tie_soup(K)
    rng = np.random.default_rng(100 + K)
    nt = pos.shape[0]
    fn = rng.normal(size=(nt, 3)).astype(np.float32)
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    cb = build_cluster_bvh(
        pos, k=K, uv=rng.uniform(0, 1, (nt, 3, 2)).astype(np.float32),
        face_nrm=fn, mat=rng.integers(0, 4, nt).astype(np.int32)).to("cuda")
    o, d = (torch.from_numpy(x).to("cuda")
            for x in tie_rays(pos, np.concatenate([inside, across])))
    return cb, o, d, inside


def _launches(prefix: str) -> int:
    """Kernel launches counted under names that start with `prefix`."""
    from dustraytracer_tpu_torch.utils import profiling

    return sum(profiling.counters(prefix).values())


def _equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for key in got:
        assert torch.equal(got[key], want[key]), (
            f"{what}: {key} differs from the twin in "
            f"{int((got[key] != want[key]).sum())} entries")


@pytest.mark.parametrize("mode", list(TIE_CALLS))
def test_sweep_kernel_matches_twin(soup, mode):
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    cb, o, d, inside = soup
    kw = TIE_CALLS[mode]
    before = _launches("drt.launch.k1")  # k1, k1_emit and k1_counters
    got = ts.traverse_cluster_sweep(cb, o, d, **kw)
    torch.cuda.synchronize()
    assert _launches("drt.launch.k1") == before + 1
    _equal(got, ts.traverse_cluster_sweep_reference(cb, o, d, **kw),
           f"sweep {mode}")
    if mode == "plain":  # a ray tied inside one cluster takes the lower id
        hit = got["hit_idx"].cpu().numpy()
        tied = hit[np.isin(hit, inside)]
        assert len(tied) > 0 and np.isin(tied, inside[:, 0]).all()


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("instance", ["shared", "global"])
def test_pallas_kernel_matches_twin(soup, instance, anyhit):
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp

    cb, o, d, _ = soup
    call = {"shared": tp.traverse_cluster_pallas,
            "global": tp.traverse_cluster_pallas_global}[instance]
    assert tp.launch_config(cb, o.shape[0])["node_table"] == "shared"
    before = _launches("drt.launch.k2")
    got = call(cb, o, d, anyhit=anyhit)
    torch.cuda.synchronize()
    assert _launches("drt.launch.k2") == before + 1
    _equal(got, tp.traverse_cluster_pallas_reference(cb, o, d, anyhit=anyhit),
           f"pallas {instance} anyhit={anyhit}")


def test_add_salt_kernel_matches_twin(tmp_path):
    from dustraytracer_tpu_torch.tools import repro_cache_hang as rch

    res = rch.child(rch._write_source(tmp_path, 0.3125), tmp_path)
    assert res["salt"] == 0.3125
    assert res["ok"] and res["max_abs_err"] == 0.0, res
    assert res["launches"] == 1


# K4 at chip_smoke.py's timed shapes (the bench step's material and
# triangle tables with ~40% of the lanes on row 0, a 256 x 256 float texel
# stack, the smooth-normal fetch's 28 columns) and at its edge shapes
ROW_CASES = {**ROWS_CASES, **ROWS_EDGE_CASES}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_rows_grad_kernel_matches_twin(case):
    """One launch a call; then chip_smoke.check_rows_kernel: the twins'
    tolerance, two launches bit for bit, the plan kernels' integers equal
    to the plain plan's, a strided cotangent, no host sync, a CUDA-graph
    replay bit for bit. The plan-free instance also equals its float32
    replay (ops/rows.py::rows_grad_small_replay) bit for bit."""
    from dustraytracer_tpu_torch.ops import rows

    grad, idx, n_rows = rows_inputs(*ROW_CASES[case], seed=7)
    before = _launches("drt.launch.k4")
    rows.rows_grad(grad, idx, n_rows)
    torch.cuda.synchronize()
    assert _launches("drt.launch.k4") == before + 1
    res = check_rows_kernel(grad, idx, n_rows)
    assert res["instance"] == ("plan_free" if rows.is_small(
        n_rows, grad.shape[1]) else "planned")
    if res["instance"] == "plan_free":
        assert res["replay_bit_equal"], res


@pytest.fixture(scope="module")
def bench_sphere():
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc

    settings = RenderSettings(bounces=4, enable_tonemap=False,
                              enable_gamma=False)
    return (build_scene(sphere_doc()).to("cuda"),
            make_camera(**POSE, device="cuda"),
            LightParams.from_settings(settings, device="cuda"), settings)


@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_bench_step_repeats_bit_for_bit(bench_sphere, fetch):
    """The 512x512 b4 bench step twice on the same inputs: the loss and
    every gradient equal bit for bit (no float atomics in the backward)."""
    from dustraytracer_tpu_torch.tools.grad_bench import repeat_check

    scene, camera, lights, settings = bench_sphere
    rec = repeat_check(scene, camera, lights,
                       settings.replace(shade_fetch=fetch))
    assert rec["loss_equal"], rec
    assert all(g["equal"] for g in rec["grads"].values()), rec["grads"]
